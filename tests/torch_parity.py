"""Helpers for holding the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; results
come back as numpy and are compared span-relatively.  JAX stays on the CPU
with x64 on (``tests/conftest.py``).  PyTorch runs one thread per process,
because the suite runs under several xdist workers.
"""

from __future__ import annotations

import numpy as np
import torch

from scpn_fusion_tpu_torch.bench_config import BENCH_SOLVER, config_dict  # noqa: F401

torch.set_num_threads(1)


def iter_like_cfg(n: int, **solver):
    """The JAX package's ReactorConfig for the ITER-like bench machine
    (``scpn_fusion_tpu_torch.bench_config.ITER_LIKE``) at n x n."""
    from scpn_fusion_tpu.core.config import config_from_dict
    return config_from_dict(config_dict(n, **solver))


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
