"""`python -m qgdsolver_tpu_torch <case_dir>` — the solver-executable surface."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
