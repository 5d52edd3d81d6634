"""Checkpoints, observability and mesh-quality screening."""
from . import checkpoint, observability, badcells  # noqa: F401
