"""Checkpoints and observability."""
from . import checkpoint, observability  # noqa: F401
