"""critic2-tpu on PyTorch and CUDA: the port of the JAX package
``critic2_tpu`` to an NVIDIA H100.

Plain tensor code is PyTorch; the Pallas kernels of the JAX package are
CUDA C++ kernels (``csrc/``), built with nvcc at first use. Entry points
run on ``cuda`` unless the caller passes ``device=``; every tensor names
its dtype (f64 by default, config.FDTYPE).

Ported so far: structure + grid density -> ``intgrid`` (YT and Bader
basins, multipoles), ``autocp`` / ``makegraph`` (critical points and
their graph), ``nciplot``, qtree, the gradient-path tools, and molecular
wavefunctions (``.wfn/.wfx/.fchk/.molden`` fields, Becke meshes,
``molcalc``); the analysis routines are imported from
``critic2_tpu_torch.analysis.*`` as in the JAX package.
"""
from .config import EDTYPE, FDTYPE, resolve_device  # noqa: F401
from .crystal.crystal import Crystal, Species  # noqa: F401
from .system import System  # noqa: F401

__version__ = "0.1.0"

__all__ = ["Crystal", "Species", "System", "FDTYPE", "EDTYPE",
           "resolve_device", "__version__"]
