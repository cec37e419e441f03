"""Helpers for holding the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; results
come back as numpy and are compared span-relatively.  JAX stays on the CPU
with x64 on (``tests/conftest.py``).  PyTorch runs one thread per process,
because the suite runs under several xdist workers.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from scpn_fusion_tpu_torch.bench_config import (  # noqa: F401
    BENCH_SOLVER,
    FREE_BOUNDARY_SOLVER,
    config_dict,
)

torch.set_num_threads(1)


def iter_like_cfg(n: int, **solver):
    """The JAX package's ReactorConfig for the ITER-like bench machine
    (``scpn_fusion_tpu_torch.bench_config.ITER_LIKE``) at n x n."""
    from scpn_fusion_tpu.core.config import config_from_dict
    return config_from_dict(config_dict(n, **solver))


def free_boundary_cfgs(n: int, **solver):
    """(JAX config, port config) of the free-boundary forward's machine and
    solver (``bench_config.free_boundary_config``) at n x n."""
    import dataclasses

    from scpn_fusion_tpu_torch import interop
    ref_cfg = iter_like_cfg(n, **{**FREE_BOUNDARY_SOLVER, **solver})
    return ref_cfg, interop.config_from_asdict(dataclasses.asdict(ref_cfg))


def rel(ours, ref) -> float:
    """max |ours - ref| over max |ref| (over 1e-300 where ``ref`` is all zero)."""
    a, b = as_np(ours), as_np(ref)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def crel(ours, ref) -> float:
    """:func:`rel` of complex (or real) values: max |ours - ref| over
    max |ref|, the imaginary parts included."""
    a, b = (np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                       dtype=np.complex128) for x in (ours, ref))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def as_np(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def to_torch(x, dtype=np.float64) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of ``dtype``."""
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True))


def span_rel(ours, ref) -> float:
    """max |ours - ref| over the span of ``ref``."""
    a, b = as_np(ours), as_np(ref)
    span = float(b.max() - b.min()) or 1.0
    return float(np.max(np.abs(a - b))) / span


def ring_equal(a, b) -> bool:
    """The boundary rings of two fields are bit-identical."""
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b)
    return all(np.array_equal(a[s], b[s]) for s in
               (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]))


def fields(seed: int, shape, n: int = 2, dtype=np.float64) -> list[np.ndarray]:
    """``n`` standard-normal fields from one seed."""
    g = rng(seed)
    return [g.standard_normal(shape).astype(dtype) for _ in range(n)]


def c_struct_fields(source: str, struct: str) -> list[tuple[str, str]]:
    """The fields of C struct ``struct`` in a kernel source, in order, as
    (name, "ptr" | "int" | "double"): what a ctypes argument block must list."""
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", source, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"^\s*(const void\*|void\*|const long long\*|const int\*"
                                   r"|int\*|unsigned char\*|int|double)"
                                   r"\s+([\w, ]+);", body, re.M):
        fields += [(n.strip(), "ptr" if "*" in ctype else ctype) for n in names.split(",")]
    return fields


def ctypes_fields(args_type) -> list[tuple[str, str]]:
    """A ctypes ``Structure``'s fields as :func:`c_struct_fields` lists them."""
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_double": "double"}
    return [(name, kinds[t.__name__]) for name, t in args_type._fields_]
