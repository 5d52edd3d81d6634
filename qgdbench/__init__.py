"""The benchmark of `qgdsolver_tpu_torch`, the PyTorch and CUDA port, on one
NVIDIA H100: `python3 -m qgdbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json (see `harness`).

Nothing here imports JAX or the JAX package; the plain references under
`reference/` import nothing of the port either.
"""
