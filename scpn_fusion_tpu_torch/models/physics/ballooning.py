"""Ideal-MHD s-alpha ballooning eigenvalue solver with second-stability access
(port of ``scpn_fusion_tpu/models/physics/ballooning.py``).

The ballooning equation

    d/dtheta [ f(theta) d xi/dtheta ] + g(theta) xi = 0,
    f = 1 + (s theta - alpha sin theta)^2,
    g = alpha (cos theta + (s theta - alpha sin theta) sin theta),

is integrated from xi(0) = 1, xi'(0) = 0 by fixed-step RK4 on the
first-order system (u1, u2) = (xi, f xi'); a point is stable when u1 keeps
its sign (Newcomb), i.e. when min u1 > 0.  The JAX package runs the RK4 loop
as a ``lax.scan`` vmapped over the field lines, one XLA program.  The port
runs it, for every (s, alpha) line of a call, in ONE launch of a
hand-written CUDA kernel, one thread a line
(``ops/cuda_ballooning.newcomb_min_xi``, ``csrc/ballooning.cu``); on a CPU
tensor the same function is its plain version, the loop of :func:`rk4_step`
over the lines as a batch.

Two operators: the circular s-alpha one and the Miller-shaped one, whose
coefficient tables (``_miller_coefficients``) come from the port's
``gyrokinetics.geometry.miller_geometry``.  Theta enters a right-hand side
only through line-independent coefficients (:func:`circular_coefficients`,
:func:`miller_coefficients`), computed at the step's three theta values
(t, t + h/2, t + h; :func:`step_thetas`).

The JAX package picks its float from the global x64 flag; the port's
functions take ``dtype`` (float32, the JAX package's default float, unless a
floating tensor says otherwise).  Functions of Python numbers take
``device`` (default ``"cuda"``); functions of tensors follow their device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.control.scenario import interp
from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

TWO_PI = 2.0 * math.pi
THETA_MAX = 20.0 * math.pi
F_FLOOR = 1e-12         # the Miller bending coefficient's floor (jnp.maximum(f, 1e-12))


def _lines(s, alpha, dtype, device):
    """(s, alpha) broadcast to one shape: (flat s, flat alpha, shape)."""
    s_b, a_b = torch.broadcast_tensors(*as_tensors(s, alpha, dtype=dtype, device=device))
    return s_b.reshape(-1).contiguous(), a_b.reshape(-1).contiguous(), s_b.shape


# ── the step's theta values and the operators' coefficients ──

def step_thetas(theta_max: float, n_steps: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """(n_steps, 3): step i's t = i h rounded once to ``dtype`` from the
    double product (JAX's ``i * h``), t + h/2 and t + h in ``dtype``."""
    h = theta_max / n_steps
    t = torch.from_numpy(np.arange(n_steps, dtype=np.float64) * h).to(device=device,
                                                                         dtype=dtype)
    return torch.stack([t, t + 0.5 * h, t + h], dim=1)


def circular_coefficients(tables, theta: torch.Tensor):
    """(theta, sin theta, cos theta) of the circular operator."""
    del tables
    return theta, torch.sin(theta), torch.cos(theta)


def wrap_theta(theta: torch.Tensor) -> torch.Tensor:
    """theta folded into [-pi, pi] as the JAX tier folds it: ``jnp.round``
    (half to even, as ``torch.round``) of theta / 2 pi."""
    two_pi = torch.full((), TWO_PI, dtype=theta.dtype, device=theta.device)
    return theta - TWO_PI * torch.round(theta / two_pi)


def miller_coefficients(tables, theta: torch.Tensor):
    """(theta, sin theta, the six shaped coefficients at the wrapped theta):
    ``tables`` = (theta table (n,), coefficient table (n, 6)); one
    ``jnp.interp`` index serves the six columns."""
    theta_tab, coef_tab = tables
    return theta, torch.sin(theta), interp(wrap_theta(theta), theta_tab, coef_tab)


def circular_rhs(coef, s, alpha, u1, u2):
    """(du1, du2) of the circular s-alpha operator (``ballooning.py:71-76``)."""
    theta, sin_t, cos_t = coef
    w = s * theta - alpha * sin_t
    f = 1.0 + w * w
    g = alpha * (cos_t + w * sin_t)
    return u2 / f, -g * u1


def miller_rhs(coef, s, alpha, u1, u2):
    """(du1, du2) of the Miller-shaped operator (``ballooning.py:269-287``)."""
    theta, sin_t, c = coef
    bdgt, grr, binv2, weight, cos_hat, sin_hat = c.unbind(-1)
    lam = s * theta - alpha * sin_t
    f = bdgt * (1.0 + lam * lam * grr) * binv2
    g = alpha * weight * (cos_hat + lam * sin_hat)
    return u2 / torch.clamp(f, min=F_FLOOR), -g * u1


OPERATORS = {"circular": (circular_coefficients, circular_rhs),
             "miller": (miller_coefficients, miller_rhs)}


def rk4_step(rhs, coefs, s, alpha, u1, u2, h: float):
    """One RK4 step of ``_integrate_newcomb`` from the coefficients at
    (t, t + h/2, t + h), in the JAX expression's operation order."""
    half, sixth = 0.5 * h, h / 6.0
    k1 = rhs(coefs[0], s, alpha, u1, u2)
    k2 = rhs(coefs[1], s, alpha, u1 + half * k1[0], u2 + half * k1[1])
    k3 = rhs(coefs[1], s, alpha, u1 + half * k2[0], u2 + half * k2[1])
    k4 = rhs(coefs[2], s, alpha, u1 + h * k3[0], u2 + h * k3[1])
    return tuple(y + sixth * (a + 2.0 * b + 2.0 * c + d)
                 for y, a, b, c, d in zip((u1, u2), k1, k2, k3, k4))


def _min_xi(op: str, s, alpha, tables, theta_max: float, n_steps: int) -> torch.Tensor:
    from scpn_fusion_tpu_torch.ops.cuda_ballooning import newcomb_min_xi
    return newcomb_min_xi(op, s, alpha, tables, theta_max, n_steps)


def _ballooning_min_xi(s, alpha, theta_max: float = THETA_MAX,
                       n_steps: int = 4000) -> torch.Tensor:
    """min xi over [0, theta_max] of each circular (s, alpha) line (1-D)."""
    return _min_xi("circular", s, alpha, None, theta_max, n_steps)


def ballooning_stable(s, alpha, *, theta_max: float = THETA_MAX, n_steps: int = 4000,
                      dtype: torch.dtype | None = None,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """True where the (s, alpha) point is ideal-ballooning stable; broadcasts
    over its inputs (a whole stability diagram is one launch)."""
    s_f, a_f, shape = _lines(s, alpha, dtype, device)
    return (_ballooning_min_xi(s_f, a_f, theta_max, n_steps) > 0.0).reshape(shape)


class SecondStabilityResult(NamedTuple):
    """Per-shear ballooning band structure on an alpha grid (fields as the
    JAX package's)."""

    shear: torch.Tensor
    alpha: torch.Tensor
    stable_map: torch.Tensor         # (n_s, n_alpha) bool
    alpha_crit_first: torch.Tensor   # (n_s,)
    alpha_crit_second: torch.Tensor  # (n_s,)
    second_access: torch.Tensor      # (n_s,) bool

    def alpha_crit_at(self, shat) -> torch.Tensor:
        """Interpolated (clamped linear) first-stability critical alpha."""
        x = torch.as_tensor(shat, dtype=self.shear.dtype, device=self.shear.device)
        return interp(x, self.shear, self.alpha_crit_first)

    def has_second_stability_at(self, shat) -> torch.Tensor:
        """Nearest-neighbour second-stability classification."""
        x = torch.as_tensor(shat, dtype=self.shear.dtype, device=self.shear.device)
        return self.second_access[torch.argmin(torch.abs(self.shear - x))]


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argmax`` of a bool mask: the first True (0 where none);
    ``torch.argmax`` refuses bool, so the mask goes as uint8."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def second_stability_scan(s_vals, *, alpha_max: float = 5.0, n_alpha: int = 64,
                          theta_max: float = THETA_MAX, n_steps: int = 4000,
                          dtype: torch.dtype | None = None,
                          device: torch.device | str = "cuda") -> SecondStabilityResult:
    """Full s-alpha diagram with first/second boundaries and access flags:
    ``n_s * n_alpha`` field lines in one launch, then band edges by index
    arithmetic."""
    (s_vals,) = as_tensors(s_vals, dtype=dtype, device=device)
    dtype, device = s_vals.dtype, s_vals.device
    alphas = linspace(0.0, alpha_max, n_alpha, dtype, device)
    stable = ballooning_stable(s_vals[:, None], alphas[None, :], theta_max=theta_max,
                               n_steps=n_steps, dtype=dtype)
    unstable = ~stable
    any_unstable = torch.any(unstable, dim=1)
    alpha_first = torch.where(any_unstable, alphas[_first_true(unstable)],
                              torch.full_like(alphas[:1], alpha_max))

    idx = torch.arange(n_alpha, device=device)
    i_last_unstable = (n_alpha - 1) - _first_true(unstable.flip(1))
    beyond = idx[None, :] > i_last_unstable[:, None]
    reentry = stable & beyond
    any_reentry = torch.any(reentry, dim=1) & any_unstable
    alpha_second = torch.where(any_reentry, alphas[_first_true(reentry)],
                               torch.full_like(alphas[:1], float("nan")))
    return SecondStabilityResult(
        shear=s_vals, alpha=alphas, stable_map=stable, alpha_crit_first=alpha_first,
        alpha_crit_second=alpha_second, second_access=any_reentry | ~any_unstable)


def marginal_alpha(s: float, *, alpha_lo: float = 0.0, alpha_hi: float = 2.0,
                   n_bisect: int = 24, theta_max: float = THETA_MAX, n_steps: int = 4000,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """Bisected first-stability boundary at fixed shear: ``n_bisect`` steps
    on the host, each one integration of one line (one launch on the card)."""
    lo = torch.full((1,), alpha_lo, dtype=dtype, device=device)
    hi = torch.full((1,), alpha_hi, dtype=dtype, device=device)
    s_t = torch.full((1,), s, dtype=dtype, device=device)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        stab = _ballooning_min_xi(s_t, mid, theta_max, n_steps) > 0.0
        lo, hi = torch.where(stab, mid, lo), torch.where(stab, hi, mid)
    return (0.5 * (lo + hi))[0]


# ── Shaped (Miller) ballooning tier (see the JAX module's notes) ──

def _miller_coefficients(*, r0, a, rho, kappa, delta, q, n_theta: int,
                         dtype: torch.dtype, device):
    """(theta table (2 n_theta + 1,), coefficient table (2 n_theta + 1, 6)):
    bdgt_n, grr_n, binv2, drive weight, cos and sin of theta_hat."""
    from scpn_fusion_tpu_torch.models.gyrokinetics.geometry import miller_geometry

    geo = miller_geometry(r0=r0, a=a, rho=rho, kappa=kappa, delta=delta, q=q, s_hat=0.0,
                          alpha_mhd=0.0, n_theta=2 * n_theta + 1, n_period=1, dtype=dtype,
                          device=device)
    mid = n_theta  # theta = 0 sample
    bdgt_n = geo.b_dot_grad_theta / geo.b_dot_grad_theta[mid]
    grr_n = geo.g_rr / geo.g_rr[mid]
    binv2 = (geo.b_mag[mid] / geo.b_mag) ** 2
    drive_weight = (geo.r_s[mid] / geo.r_s) / bdgt_n
    delta_angle = torch.asin(torch.clamp(torch.tensor(delta, dtype=dtype, device=device),
                                         -0.99, 0.99))
    theta_hat = geo.theta + delta_angle * torch.sin(geo.theta)
    coef = torch.stack([bdgt_n, grr_n, binv2, drive_weight, torch.cos(theta_hat),
                        torch.sin(theta_hat)], dim=1)
    return geo.theta.contiguous(), coef.contiguous()


def _miller_min_xi(s, alpha, tables, theta_max: float, n_steps: int) -> torch.Tensor:
    """min xi of each shaped (s, alpha) line (1-D)."""
    return _min_xi("miller", s, alpha, tables, theta_max, n_steps)


def miller_ballooning_stable(s, alpha, *, r0: float = 3.0, a: float = 1.0, rho: float = 0.9,
                             kappa: float = 1.0, delta: float = 0.0, q: float = 3.0,
                             n_theta: int = 256, theta_max: float = THETA_MAX,
                             n_steps: int = 4000, dtype: torch.dtype | None = None,
                             device: torch.device | str = "cuda") -> torch.Tensor:
    """True where (s, alpha) is ballooning-stable in Miller geometry; the
    coefficient tables are built once a call and serve every line.  In the
    thin-tube limit (rho -> 0, kappa = 1, delta = 0) this is the circular
    operator."""
    s_f, a_f, shape = _lines(s, alpha, dtype, device)
    tables = _miller_coefficients(r0=r0, a=a, rho=rho, kappa=kappa, delta=delta, q=q,
                                  n_theta=n_theta, dtype=s_f.dtype, device=s_f.device)
    return (_miller_min_xi(s_f, a_f, tables, theta_max, n_steps) > 0.0).reshape(shape)


def miller_marginal_alpha(s: float, *, alpha_hi: float = 5.0, n_grid: int = 96,
                          dtype: torch.dtype = torch.float32,
                          device: torch.device | str = "cuda", **geometry) -> torch.Tensor:
    """First-stability critical alpha at fixed shear in Miller geometry (a
    grid scan: the shaped band can close)."""
    alphas = linspace(0.0, alpha_hi, n_grid, dtype, device)
    unstable = ~miller_ballooning_stable(torch.tensor(s, dtype=dtype, device=device), alphas,
                                         **geometry)
    return torch.where(torch.any(unstable), alphas[_first_true(unstable)],
                       torch.full_like(alphas[0], alpha_hi))


class BootstrapPathResult(NamedTuple):
    """Marginal alpha along the bootstrap-consistent (s_eff, alpha) path."""

    alpha_crit: torch.Tensor
    second_access: torch.Tensor


def bootstrap_path_alpha_crit(s0: float, c_bs: float, *, alpha_hi: float = 16.0,
                              n_grid: int = 65, dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cuda",
                              **geometry) -> BootstrapPathResult:
    """Ballooning-critical alpha with self-consistent bootstrap shear
    ``s_eff(alpha) = s0 - c_bs alpha``: the last stable point of the path
    through the shaped diagram, all ``n_grid`` points in one launch."""
    alphas = linspace(0.0, alpha_hi, n_grid, dtype, device)
    s_eff = (torch.tensor(s0, dtype=dtype, device=device)
             - torch.tensor(c_bs, dtype=dtype, device=device) * alphas)
    unstable = ~miller_ballooning_stable(s_eff, alphas, **geometry)
    any_u = torch.any(unstable)
    i_first = _first_true(unstable)
    alpha_crit = torch.where(any_u, alphas[torch.clamp(i_first - 1, min=0)],
                             torch.full_like(alphas[0], alpha_hi))
    return BootstrapPathResult(alpha_crit=alpha_crit, second_access=~any_u)
