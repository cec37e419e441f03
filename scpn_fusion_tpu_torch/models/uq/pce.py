"""Polynomial chaos expansion (Hermite, total order) + Sobol indices (port
of ``scpn_fusion_tpu/models/uq/pce.py``).

Multivariate probabilists'-Hermite chaos with a total-order multi-index
basis, least-squares coefficient fit via an SVD pseudo-inverse, prediction,
first-order Sobol indices from coefficient energies, and Latin-hypercube
sampling.  The basis is vectorised: a Hermite value table He_0..He_P is
built once by recurrence for every (sample, dim), each basis term a product
of a gather; the fit is one (n_samples, n_terms) ``torch.linalg.svd``.  The
pseudo-inverse does not depend on the signs the SVD gives its singular
vectors, so the coefficients agree with JAX's where ``u`` and ``v`` need not.

:func:`latin_hypercube` draws its jitter and permutations from a
``torch.Generator``; :func:`_latin_hypercube` takes them (the CPU tests feed
it JAX's draws).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def total_order_multi_index(n_dims: int, order: int) -> tuple:
    """All exponent tuples alpha with sum(alpha) <= order (host/static)."""
    out = []

    def rec(prefix, remaining, dims_left):
        if dims_left == 0:
            out.append(tuple(prefix))
            return
        for p in range(remaining + 1):
            rec(prefix + [p], remaining - p, dims_left - 1)

    rec([], order, n_dims)
    # Sort by total order then lexicographically for a stable layout with
    # the constant term first.
    out.sort(key=lambda a: (sum(a), a))
    return tuple(out)


def hermite_table(x: torch.Tensor, max_order: int) -> torch.Tensor:
    """Probabilists' Hermite He_0..He_max by recurrence: (..., P+1)."""
    he = [torch.ones_like(x), x]
    for n in range(1, max_order):
        he.append(x * he[n] - n * he[n - 1])
    return torch.stack(he[: max_order + 1], dim=-1)


def design_matrix(samples: torch.Tensor, multi_index: tuple) -> torch.Tensor:
    """(n_samples, n_terms) with Psi[s, t] = prod_d He_{alpha[t,d]}(x[s,d])."""
    alpha = torch.as_tensor(np.array(multi_index), dtype=torch.int64, device=samples.device)
    max_order = int(np.max(np.array(multi_index))) if multi_index else 0
    he = hermite_table(samples, max_order)                  # (S, D, P+1)
    dims = torch.arange(alpha.shape[1], device=samples.device)[None, :]
    gathered = he[:, dims, alpha]                           # (S, T, D)
    return torch.prod(gathered, dim=-1)


class PCEModel(NamedTuple):
    coefficients: torch.Tensor    # (n_terms, n_outputs)
    multi_index: tuple


def _atleast_2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(1, -1) if x.dim() < 2 else x


def fit_pce(samples: torch.Tensor, outputs: torch.Tensor, order: int,
            rcond: float = 1e-10) -> PCEModel:
    """Least-squares Hermite-chaos fit (reference ``PCEModel::fit``).

    samples (S, D) standard-normal inputs; outputs (S, K).
    Fail-closed on shape mismatch / non-finite data like the reference.
    """
    samples, outputs = _atleast_2d(samples), _atleast_2d(outputs)
    if samples.shape[0] != outputs.shape[0]:
        raise ValueError("PCE fit requires matching sample and output rows")
    if samples.shape[0] == 0 or samples.shape[1] == 0 or outputs.shape[1] == 0:
        raise ValueError("PCE fit requires non-empty samples and outputs")
    if not (bool(torch.isfinite(samples).all()) and bool(torch.isfinite(outputs).all())):
        raise ValueError("PCE fit received non-finite values")

    mi = total_order_multi_index(samples.shape[1], order)
    psi = design_matrix(samples, mi)
    # SVD pseudo-inverse with relative cutoff (reference pinv_svd).
    u, s, vt = torch.linalg.svd(psi, full_matrices=False)
    cutoff = rcond * torch.max(s)
    s_inv = torch.where(s > cutoff, 1.0 / torch.clamp(s, min=1e-300), 0.0)
    coeff = (vt.T * s_inv[None, :]) @ (u.T @ outputs)
    if not bool(torch.isfinite(coeff).all()):
        raise ValueError("PCE coefficients contain non-finite values")
    return PCEModel(coeff, mi)


def predict_pce(model: PCEModel, x: torch.Tensor) -> torch.Tensor:
    """Evaluate at one point (D,) or a batch (S, D) -> (K,) or (S, K)."""
    single = x.dim() == 1
    out = design_matrix(_atleast_2d(x), model.multi_index) @ model.coefficients
    return out[0] if single else out


def sobol_first_order(model: PCEModel) -> torch.Tensor:
    """First-order Sobol indices from coefficient energies
    (reference ``sobol_indices``)."""
    mi = model.multi_index
    coeff = model.coefficients
    if not mi:
        return coeff.new_zeros(0)
    n_dims = len(mi[0])
    norms = np.array([float(np.prod([math.factorial(a) for a in alpha])) for alpha in mi])
    energy = torch.sum(coeff**2, dim=1) * torch.as_tensor(norms, dtype=coeff.dtype,
                                                          device=coeff.device)
    first = np.zeros((len(mi), n_dims))
    total_mask = np.zeros(len(mi))
    for t, alpha in enumerate(mi):
        if sum(alpha) == 0:
            continue
        total_mask[t] = 1.0
        nz = [d for d, a in enumerate(alpha) if a > 0]
        if len(nz) == 1:
            first[t, nz[0]] = 1.0
    kw = dict(dtype=energy.dtype, device=energy.device)
    total_var = torch.sum(energy * torch.as_tensor(total_mask, **kw))
    first_var = torch.as_tensor(first, **kw).T @ energy
    return torch.clamp(first_var / torch.clamp(total_var, min=1e-16), 0.0, 1.0)


def _latin_hypercube(jitter: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """LHS in [0,1]^D from the stratum jitters ``jitter`` (D, S) in [0, 1)
    and each dimension's permutation ``perms`` (D, S): column d is
    ``((arange(S) + jitter[d]) / S)[perms[d]]``."""
    n_samples = jitter.shape[1]
    vals = (torch.arange(n_samples, dtype=jitter.dtype, device=jitter.device)
            + jitter) / n_samples
    return torch.gather(vals, 1, perms).T


def latin_hypercube(generator: torch.Generator, n_samples: int, n_dims: int, *,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """LHS in [0,1]^D: stratified jitter + per-dim permutation, the draws
    from ``generator`` (on the CPU) moved to ``device``."""
    jitter = torch.rand((n_dims, n_samples), generator=generator, dtype=dtype)
    perms = torch.stack([torch.randperm(n_samples, generator=generator)
                         for _ in range(n_dims)])
    return _latin_hypercube(jitter.to(device), perms.to(device))
