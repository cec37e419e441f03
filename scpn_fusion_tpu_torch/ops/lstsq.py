"""Bounded Tikhonov least squares (port of ``scpn_fusion_tpu/ops/lstsq.py``).

A projected FISTA (accelerated projected gradient) on

    min ||A x - b||^2   s.t.  lb <= x <= ub

with fixed iteration counts, so it is differentiable through torch autograd
like the JAX version is through ``jax.grad``.  The loops (31 power
iterations for the Lipschitz constant, ``n_iter`` FISTA steps) are Python
loops over tensors: a handful of tiny ops a step, no host read.

The unconstrained warm start is the SVD solve of ``jnp.linalg.lstsq``:
singular values below ``eps * max(m, n) * s_max`` are dropped.  It is
written out with ``torch.linalg.svd``; ``torch.linalg.lstsq`` is not used,
because on CUDA it only has the ``gels`` solver, which assumes full rank.
"""

from __future__ import annotations

import torch


def _svd_lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(a, b)[0]``: the minimum-norm SVD solve with the
    default cutoff ``eps * max(m, n)`` relative to the largest singular value."""
    m, n = a.shape
    rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    safe_s = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1.0 / safe_s, torch.zeros_like(s))
    return vt.T @ (s_inv * (u.T @ b))


def bounded_lstsq(
    a: torch.Tensor,
    b: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    n_iter: int = 300,
) -> torch.Tensor:
    """Solve min ||A x - b||^2 subject to box bounds via projected FISTA.

    With ``x0`` None the iteration starts from the box-projected
    unconstrained least-squares solution (zeros if that is not finite); a
    given ``x0`` is taken as it is and the SVD is skipped."""
    n = a.shape[1]
    if x0 is None:
        x_uncon = _svd_lstsq(a, b)
        x0 = torch.where(torch.isfinite(x_uncon).all(), x_uncon, torch.zeros_like(x_uncon))
    x0 = torch.clamp(x0, lb, ub)

    ata = a.T @ a
    atb = a.T @ b
    # Lipschitz constant of the gradient: the largest eigenvalue of A^T A
    v = torch.ones(n, dtype=a.dtype, device=a.device)
    for _ in range(31):
        w = ata @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    lip = torch.clamp(v @ (ata @ v), min=1e-30)
    step = 1.0 / lip

    x, y = x0, x0
    t = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(n_iter):
        grad = ata @ y - atb
        x_new = torch.clamp(y - step * grad, lb, ub)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = torch.clamp(x_new + ((t - 1.0) / t_new) * (x_new - x), lb, ub)
        x, t = x_new, t_new
    return x


def tikhonov_coil_lstsq(
    response_t: torch.Tensor,   # (n_pts, n_coils) = M^T
    target: torch.Tensor,       # (n_pts,)
    tikhonov_alpha: float,
    lb: torch.Tensor,
    ub: torch.Tensor,
    prior: torch.Tensor | None = None,
    *,
    n_iter: int = 300,
) -> torch.Tensor:
    """Bounded coil-current fit of the augmented system
    ``[M^T; sqrt(a) I] x = [target; sqrt(a) prior]``, started from the
    prior (zeros when None)."""
    n_coils = response_t.shape[1]
    dt, dev = response_t.dtype, response_t.device
    sq = torch.sqrt(torch.tensor(tikhonov_alpha, dtype=dt, device=dev))
    a = torch.cat([response_t, sq * torch.eye(n_coils, dtype=dt, device=dev)])
    prior_vec = torch.zeros(n_coils, dtype=dt, device=dev) if prior is None else prior
    b = torch.cat([target, sq * prior_vec])
    return bounded_lstsq(a, b, lb, ub, x0=prior_vec, n_iter=n_iter)
