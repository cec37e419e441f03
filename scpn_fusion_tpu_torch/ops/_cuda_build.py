"""Build and load the hand-written CUDA kernels in ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with a
plain C interface, cached under ``scpn_fusion_tpu_torch/_build/`` by a hash of
the sources and flags, and loaded with ``ctypes``.  Every entry point takes
pointers and the CUDA stream as ``c_void_p`` and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0.  A missing
``nvcc`` or a failed build raises: nothing here falls back to another path.

Launch counts: :data:`LAUNCHES` holds, per C entry, the ``__global__``
launches it made (raised in :func:`launch`; the source entry makes three a
call), and :data:`CALLS` holds, per public kernel wrapper, the calls of that
wrapper that launched on the device (raised by the wrapper itself).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "scpn_rb_half_sweep": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P],
    "scpn_rb_sweeps_smem": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P],
    "scpn_defect_restrict": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "scpn_prolong_correct": [_P, _P, _I, _I, _I, _I, _P, _P],
    "scpn_fused_source": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _I,
                          _P, _P, _P, _P, _P, _P, _P],
}
LAUNCHES: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    CALLS.clear()


def kernel_launches() -> int:
    """``__global__`` launches made through :func:`launch` since the last reset."""
    return sum(LAUNCHES.values())


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256()
        for f in _sources():
            digest.update(f.name.encode())
            digest.update(f.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"libscpn_gs_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(f) for f in sorted(CSRC.glob("*.cu"))]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.scpn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.scpn_cuda_error_string.restype = ctypes.c_char_p
        lib.scpn_source_blocks.argtypes = [ctypes.c_int]
        lib.scpn_source_blocks.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(name: str, *args, kernels: int = 1) -> None:
    """Call C entry ``name`` (``kernels`` ``__global__`` launches) on
    PyTorch's current stream; raise on a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.scpn_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    LAUNCHES[name] += kernels


def source_blocks(n_points: int) -> int:
    return library().scpn_source_blocks(n_points)


def check_f32_cuda(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor."""
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
