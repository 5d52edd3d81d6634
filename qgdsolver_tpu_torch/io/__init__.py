"""OpenFOAM case I/O: dictionaries, meshes, field files, time directories."""
from . import foamdict, foam_case  # noqa: F401
