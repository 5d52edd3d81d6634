"""qgdsolver_tpu_torch — PyTorch/CUDA port of `qgdsolver_tpu`.

The JAX package stays the reference; this package mirrors its layout and
names.  Plain tensor code is PyTorch; the fused 2D and 3D QGDFoam steps run
on hand-written CUDA kernels on an NVIDIA card (ops/csrc/*.cu), built with
nvcc at first use.  `python -m qgdsolver_tpu_torch <case>` runs an OpenFOAM
case directory.  Importing the package needs neither JAX, nvcc nor a card.
"""

__version__ = "0.1.0"

from .core.mesh import Mesh  # noqa: F401
from .core import bc  # noqa: F401
