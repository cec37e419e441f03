"""SCPN Fusion on PyTorch/CUDA — the port of ``scpn_fusion_tpu`` to an NVIDIA H100.

The package mirrors the JAX package's module paths: each module here is the
PyTorch counterpart of the module at the same path under ``scpn_fusion_tpu``.
It imports ``torch`` and numpy and never ``jax`` or the JAX package, so it
runs on a GPU host that has no jax installed.

Plain tensor code is PyTorch.  The Pallas TPU kernels on the fixed-boundary
equilibrium path are hand-written CUDA C++ kernels for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_cuda_build.py``).  Every kernel wrapper keeps a plain PyTorch version
beside it; a wrapper runs that version only for a tensor on the CPU.
"""

__version__ = "0.1.0"

from scpn_fusion_tpu_torch.core.config import (  # noqa: F401
    Coil,
    Dimensions,
    PhysicsParams,
    ProfileParams,
    ReactorConfig,
    SolverParams,
    load_config,
)
from scpn_fusion_tpu_torch.core.grid import Grid  # noqa: F401
