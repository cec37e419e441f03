"""Computational (R, Z) grid (port of ``scpn_fusion_tpu/core/grid.py``).

The coordinates must be bit-identical to the JAX package's
``jnp.linspace``: the divertor mask ``ZZ < Z_min/2`` selects the X-point
search rows, and one ulp of difference can move a row.  ``torch.linspace``
rounds differently, so the coordinates are built on the host in exact
rational arithmetic, rounded the way XLA evaluates ``jnp.linspace``'s
formula: ``step = i * (1/div)`` and ``out = fma(stop, step,
start * (1 - step))`` in the working dtype, endpoint appended.  They are
then moved to the device.

Array orientation matches the JAX package: 2D fields are ``(Z, R)``.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.config import Dimensions, ReactorConfig

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _round_exact(x: Fraction, dt) -> np.floating:
    """Round an exact rational to the nearest ``dt`` value, ties to even."""
    r = dt(float(x))
    best = r
    for cand in (np.nextafter(r, dt(-np.inf)), np.nextafter(r, dt(np.inf))):
        d_c, d_b = abs(Fraction(float(cand)) - x), abs(Fraction(float(best)) - x)
        if d_c < d_b or (d_c == d_b and int(cand.view(f"u{cand.nbytes}")) % 2 == 0):
            best = cand
    return best


@functools.lru_cache(maxsize=64)
def linspace_like_jax(start: float, stop: float, num: int, dtype: torch.dtype,
                      endpoint: bool = True) -> np.ndarray:
    """``jnp.linspace(start, stop, num, endpoint=endpoint, dtype=dtype)``
    reproduced bit for bit."""
    dt = _NP_DTYPES[dtype]
    if num == 1:
        return np.asarray([start], dt)
    div = num - 1 if endpoint else num
    inv = dt(1) / dt(div)
    idx = np.arange(div, dtype=dt)
    head = dt(start) * (dt(1) - idx * inv)
    b_inv = Fraction(float(dt(stop) * inv))
    out = [_round_exact(Fraction(float(i)) * b_inv + Fraction(float(h)), dt)
           for i, h in zip(idx, head)]
    return np.asarray(out + ([dt(stop)] if endpoint else []), dt)


def linspace(start: float, stop: float, num: int, dtype: torch.dtype,
             device: torch.device | str, endpoint: bool = True) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, endpoint=endpoint, dtype=dtype)`` on
    ``device``."""
    return torch.from_numpy(linspace_like_jax(start, stop, num, dtype, endpoint).copy()).to(device)


def xla_mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean`` as XLA rounds it under ``jit``: the sum times the
    reciprocal of the count, rounded once in the dtype (``torch.mean`` on a
    CPU tensor divides; on a CUDA tensor it multiplies, as here)."""
    if dim is None:
        total, count = torch.sum(x), x.numel()
    else:
        total, count = torch.sum(x, dim=dim, keepdim=keepdim), x.shape[dim]
    return total * torch.reciprocal(x.new_full((), float(count)))


def as_tensors(*values, dtype=None, device="cuda"):
    """``values`` as tensors of one dtype on one device: a tensor among them
    sets the device, and its dtype unless ``dtype`` is given (float32 for an
    integer tensor); else ``dtype`` (float32 by default) on ``device``."""
    like = next((v for v in values if isinstance(v, torch.Tensor)), None)
    if like is not None:
        device = like.device
        dtype = dtype or (like.dtype if like.is_floating_point() else torch.float32)
    dtype = dtype or torch.float32
    return tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in values)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform rectangular (R, Z) mesh on one device in one dtype.

    ``R``/``Z`` are 1D tensors of length NR/NZ; ``RR``/``ZZ`` are (NZ, NR)
    views.  ``dR``/``dZ`` are Python floats, as in the JAX package.
    """

    NR: int
    NZ: int
    R_min: float
    R_max: float
    Z_min: float
    Z_max: float
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")

    @property
    def dR(self) -> float:
        return (self.R_max - self.R_min) / (self.NR - 1)

    @property
    def dZ(self) -> float:
        return (self.Z_max - self.Z_min) / (self.NZ - 1)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.NZ, self.NR)

    @property
    def R(self) -> torch.Tensor:
        return linspace(self.R_min, self.R_max, self.NR, self.dtype, self.device)

    @property
    def Z(self) -> torch.Tensor:
        return linspace(self.Z_min, self.Z_max, self.NZ, self.dtype, self.device)

    @property
    def RR(self) -> torch.Tensor:
        return self.R[None, :].expand(self.NZ, self.NR)

    @property
    def ZZ(self) -> torch.Tensor:
        return self.Z[:, None].expand(self.NZ, self.NR)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    @classmethod
    def from_config(cls, cfg: ReactorConfig, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> "Grid":
        d: Dimensions = cfg.dimensions
        return cls(NR=cfg.NR, NZ=cfg.NZ,
                   R_min=float(d.R_min), R_max=float(d.R_max),
                   Z_min=float(d.Z_min), Z_max=float(d.Z_max),
                   dtype=dtype, device=torch.device(device))

    @classmethod
    def from_bounds(cls, nr: int, nz: int, r_min: float, r_max: float,
                    z_min: float, z_max: float, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> "Grid":
        return cls(NR=int(nr), NZ=int(nz),
                   R_min=float(r_min), R_max=float(r_max),
                   Z_min=float(z_min), Z_max=float(z_max),
                   dtype=dtype, device=torch.device(device))
