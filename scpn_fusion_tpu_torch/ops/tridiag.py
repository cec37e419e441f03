"""Tridiagonal (Thomas) solver (port of ``scpn_fusion_tpu/ops/tridiag.py``).

Forward elimination and back substitution with the JAX solver's guards:
pivots that are non-finite or below 1e-30 in magnitude are set to 1e-30, and
every non-finite intermediate is set to 0 (``_safe``), in the same places.

On a CUDA tensor :func:`thomas_solve_batched` launches the hand-written
kernel once (``ops/cuda_tridiag.py``, ``csrc/tridiag.cu``), whatever the
batch; on a CPU tensor it runs :func:`thomas_solve_batched_plain`, a loop
over the rows on ``(B,)`` slices doing the kernel's arithmetic (each product
and difference rounded on its own), so the two are equal bit for bit.  The
JAX solver is two ``lax.scan`` passes compiled into one program; eager
PyTorch has no such program, hence the kernel.  Independent systems may go
through one batched call: every system's arithmetic is unchanged.
"""

from __future__ import annotations

import torch

_PIVOT_FLOOR = 1e-30


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _clamp_pivot(m: torch.Tensor) -> torch.Tensor:
    bad = ~torch.isfinite(m) | (m.abs() < _PIVOT_FLOOR)
    return torch.where(bad, _PIVOT_FLOOR, m)


def thomas_solve_batched_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                               d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`thomas_solve_batched`: a row loop on
    the batch's ``(B,)`` slices."""
    n = d.shape[-1]
    m = _clamp_pivot(b[:, 0])
    cp = [_safe(c[:, 0] / m)]
    dp = [_safe(d[:, 0] / m)]
    for i in range(1, n):
        ai = a[:, i - 1]
        m = _clamp_pivot(b[:, i] - ai * cp[-1])
        if i < n - 1:
            cp.append(_safe(c[:, i] / m))
        dp.append(_safe(_safe(d[:, i] - ai * dp[-1]) / m))
    x = [dp[-1]]
    for i in range(n - 2, -1, -1):
        x.append(_safe(dp[i] - cp[i] * x[-1]))
    return torch.stack(x[::-1], dim=1)


def thomas_solve_batched(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """Solve B independent tridiagonal systems: ``a`` (B, n-1) sub-diagonal,
    ``b`` (B, n) main diagonal, ``c`` (B, n-1) super-diagonal, ``d`` (B, n)
    right-hand side.  One kernel launch on CUDA, the plain loop on the CPU."""
    if d.is_cuda:
        from scpn_fusion_tpu_torch.ops import cuda_tridiag
        return cuda_tridiag.thomas_solve_batched(a, b, c, d)
    return thomas_solve_batched_plain(a, b, c, d)


def thomas_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 d: torch.Tensor) -> torch.Tensor:
    """Solve one tridiagonal system A x = d: ``a`` (n-1,) sub-diagonal,
    ``b`` (n,) main diagonal, ``c`` (n-1,) super-diagonal, ``d`` (n,)."""
    return thomas_solve_batched(a[None], b[None], c[None], d[None])[0]
