"""Plain references the benchmark holds the program to.

Each is written in plain PyTorch from a configuration's file alone: it
imports nothing of the program under test, and works out again every
constant, boundary value and derived field the program would derive.
"""
