"""Tomographic inversion of line-integrated chord signals (port of
``scpn_fusion_tpu/models/diagnostics/tomography.py``).

Reconstruct a 2D emissivity map on an ``res x res`` pixel grid from
bolometer chord brightness by solving the Tikhonov-regularised
non-negative inverse problem  min ||A x - b||^2 + lam ||x||^2, x >= 0.

Geometry assembly bins the whole (n_chords, n_samples) sample cloud at once
(``floor`` binning: out-of-grid samples are excluded, not aliased).  A
pixel's entry is the chord's sample length times the count of its samples in
the pixel: the counts come from a one-hot comparison summed over the samples
(integers, exact in any order), so the matrix is the same bits on every run
and device -- no atomic ``index_add``.  JAX's einsum sums the sample lengths
one by one, so the two agree to a few ulps.

Three solvers, as in the JAX package:

* ``nnls``  -- accelerated projected gradient (FISTA) on the augmented
  Tikhonov system (the port's ``ops/lstsq.bounded_lstsq``).
* ``sart``  -- simultaneous algebraic reconstruction with row/column
  weights, a Python loop of plain ops.
* ``ridge`` -- Phillips-Twomey: Laplacian-smoothness normal equations by
  direct solve.
"""

from __future__ import annotations

import math

import torch

from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.ops.lstsq import bounded_lstsq


def build_geometry_matrix(starts: torch.Tensor, ends: torch.Tensor, r_min: float, r_max: float,
                          z_min: float, z_max: float, *, res: int = 20,
                          n_samples: int = 100) -> torch.Tensor:
    """Path-length geometry matrix A (n_chords, res*res), vectorised.

    Column-major pixel layout ``pixel = iz * res + ir`` (reference parity).
    """
    kw = dict(dtype=starts.dtype, device=starts.device)
    r_grid = linspace(r_min, r_max, res, **kw)
    z_grid = linspace(z_min, z_max, res, **kw)
    dr = r_grid[1] - r_grid[0]
    dz = z_grid[1] - z_grid[0]

    t = linspace(0.0, 1.0, n_samples, **kw)[None, :, None]   # (1, S, 1)
    pts = starts[:, None, :] + t * (ends - starts)[:, None, :]
    dl = torch.linalg.vector_norm(ends - starts, dim=1) / n_samples   # (n_chords,)

    ir = torch.floor((pts[..., 0] - r_min) / dr).to(torch.int64)
    iz = torch.floor((pts[..., 1] - z_min) / dz).to(torch.int64)
    inside = (ir >= 0) & (ir < res) & (iz >= 0) & (iz < res)
    pixel = torch.where(inside, iz * res + ir, -1)            # -1 matches no pixel
    pixels = torch.arange(res * res, device=starts.device)
    counts = (pixel[..., None] == pixels).sum(dim=1)          # (n_chords, P) integers
    return dl[:, None] * counts.to(starts.dtype)


def _laplacian_operator(res: int, dtype: torch.dtype,
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """2D 5-point Laplacian as a dense (P, P) matrix (Phillips-Twomey)."""
    n = res * res
    idx = torch.arange(n, device=device)
    lap = 4.0 * torch.eye(n, dtype=dtype, device=device)
    col = idx % res
    for offset, has in ((-1, col > 0), (1, col < res - 1), (-res, idx >= res),
                        (res, idx < n - res)):
        lap[idx, torch.clamp(idx + offset, 0, n - 1)] += torch.where(has, -1.0, 0.0).to(dtype)
    return lap


def reconstruct(a_matrix: torch.Tensor, signals: torch.Tensor, *, res: int,
                lambda_reg: float = 0.1, method: str = "nnls",
                n_iters: int = 300) -> torch.Tensor:
    """Invert chord signals to a (res, res) non-negative emissivity map."""
    b = torch.nan_to_num(signals, nan=0.0, posinf=0.0, neginf=0.0)
    b = torch.clamp(b, min=0.0)
    n_pix = res * res
    kw = dict(dtype=a_matrix.dtype, device=a_matrix.device)

    if method == "nnls":
        # Augmented Tikhonov system solved with projected FISTA.
        a_aug = torch.cat([a_matrix, math.sqrt(lambda_reg) * torch.eye(n_pix, **kw)])
        b_aug = torch.cat([b, torch.zeros(n_pix, **kw)])
        x = bounded_lstsq(a_aug, b_aug, lb=torch.zeros(n_pix, **kw),
                          ub=torch.full((n_pix,), math.inf, **kw), n_iter=n_iters)
    elif method == "sart":
        col_w = torch.sum(a_matrix, dim=0)
        row_w = torch.sum(a_matrix, dim=1)
        # Support mask: the 1/coverage weight amplifies noise in pixels a
        # handful of chords barely graze; exclude pixels below 2% of the
        # best-covered pixel (standard SART support masking).
        covered = col_w > 0.02 * torch.max(col_w)
        col_w = torch.where(covered, 1.0 / torch.clamp(col_w, min=1e-30), 0.0)
        row_w = torch.where(row_w > 0, 1.0 / torch.clamp(row_w, min=1e-30), 0.0)
        x = torch.zeros(n_pix, **kw)
        for _ in range(n_iters):
            err = b - a_matrix @ x
            x = torch.clamp(x + 0.1 * col_w * (a_matrix.T @ (row_w * err)), min=0.0)
    elif method == "ridge":
        lap = _laplacian_operator(res, a_matrix.dtype, a_matrix.device)
        lhs = a_matrix.T @ a_matrix + lambda_reg * (lap.T @ lap)
        rhs = a_matrix.T @ b
        x = torch.clamp(torch.linalg.solve(lhs, rhs), min=0.0)
    else:
        raise ValueError(f"unknown method {method!r}")
    return x.reshape(res, res)


def fan_chords(r_pinhole: float, z_pinhole: float, *, n_chords: int, r_target: float,
               z_span: float, dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda"):
    """Fan-beam chord layout from one pinhole camera toward the plasma
    column (convenience mirroring the reference's bolometer geometry)."""
    z_hits = linspace(-z_span, z_span, n_chords, dtype, device)
    starts = torch.stack([torch.full((n_chords,), r_pinhole, dtype=dtype, device=device),
                          torch.full((n_chords,), z_pinhole, dtype=dtype, device=device)], dim=1)
    ends = torch.stack([torch.full((n_chords,), r_target, dtype=dtype, device=device), z_hits],
                       dim=1)
    return starts, ends
