"""H-infinity robust controller synthesis (port of
``scpn_fusion_tpu/control/hinf.py``).

The central two-Riccati solution

    A^T X + X A + X (gamma^-2 B1 B1^T - B2 B2^T) X + C1^T C1 = 0
    A Y + Y A^T + Y (gamma^-2 C1^T C1 - C2^T C2) Y + B1 B1^T = 0

with F = -B2^T X and L = Y C2^T, feasibility rho(XY) < gamma^2, and gamma
bisection.  As in the JAX package, each Riccati equation is solved by
integrating the differential Riccati equation to steady state with a
fixed-step RK4 (JAX's ``lax.scan`` is a Python loop over steps).  Every
function takes leading batch dimensions: a population of designs (a batch of
gammas or of weighted ``C1``) is one batch of matrices, and the two Riccati
equations of :func:`synthesize_hinf` are integrated together as a batch of
two.  Results are on the inputs' device in their dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for a matrix and a vector with leading batch dimensions."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def eigvals(m: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.eigvals`` with ``jnp.linalg.eigvals``' answer, all NaN,
    for a matrix with a non-finite entry (LAPACK is never handed one: MKL's
    balancing step aborts the process on it)."""
    ok = torch.isfinite(m).all(-1).all(-1)
    ev = torch.linalg.eigvals(torch.where(ok[..., None, None], m, torch.zeros_like(m)))
    return torch.where(ok[..., None], ev, torch.full_like(ev, complex(float("nan"), float("nan"))))


def solve_care_ode(a: torch.Tensor, s: torch.Tensor, q: torch.Tensor, *, dt: float = 0.01,
                   n_steps: int = 4000) -> torch.Tensor:
    """Steady state of dX/dt = A^T X + X A - X S X + Q (X0 = 0), via RK4;
    ``a``, ``s`` and ``q`` broadcast over leading batch dimensions."""
    a, s, q = torch.broadcast_tensors(a, s, q)
    a_t = _t(a)

    def rhs(x):
        return a_t @ x + x @ a - x @ s @ x + q

    x = torch.zeros_like(a)
    for _ in range(n_steps):
        k1 = rhs(x)
        k2 = rhs(x + 0.5 * dt * k1)
        k3 = rhs(x + 0.5 * dt * k2)
        k4 = rhs(x + dt * k3)
        x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        x = 0.5 * (x + _t(x))  # keep symmetric
    return x


class HInfGains(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    f: torch.Tensor          # state feedback  u = F x
    l: torch.Tensor          # observer gain
    gamma: torch.Tensor
    spectral_radius_xy: torch.Tensor
    robust_feasible: torch.Tensor


def synthesize_hinf(a: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor, c1: torch.Tensor,
                    c2: torch.Tensor, gamma, *, riccati_steps: int = 4000,
                    riccati_dt: float = 0.01) -> HInfGains:
    """Central H-inf solution at ``gamma`` (a number, or a tensor of leading
    batch dimensions matching the matrices')."""
    if isinstance(gamma, torch.Tensor):
        g2 = gamma * gamma
    else:   # a number: squared in Python, as in JAX
        g2 = torch.tensor(gamma * gamma, dtype=a.dtype, device=a.device)
    gamma = torch.as_tensor(gamma, dtype=a.dtype, device=a.device)
    g2m = g2[..., None, None]
    s_x = b2 @ _t(b2) - (b1 @ _t(b1)) / g2m
    s_y = _t(c2) @ c2 - (_t(c1) @ c1) / g2m
    # the X and the Y equation as one batch of two
    pairs = [torch.broadcast_tensors(*m) for m in ((a, _t(a)), (s_x, s_y),
                                                   (_t(c1) @ c1, b1 @ _t(b1)))]
    xy = solve_care_ode(*(torch.stack(p, dim=-3) for p in pairs), dt=riccati_dt,
                        n_steps=riccati_steps)
    x, y = xy[..., 0, :, :], xy[..., 1, :, :]
    f = -_t(b2) @ x
    l = y @ _t(c2)
    eig = eigvals(x @ y)
    rho = eig.abs().amax(-1)
    return HInfGains(x, y, f, l, gamma, rho, rho < g2 * (1.0 - 1e-6))


def find_optimal_gamma(a, b1, b2, c1, c2, *, gamma_lo: float = 0.5, gamma_hi: float = 100.0,
                       n_bisect: int = 20, riccati_steps: int = 2000) -> float:
    """Bisection on the feasibility boundary (a host loop, as in JAX)."""
    lo, hi = float(gamma_lo), float(gamma_hi)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        g = synthesize_hinf(a, b1, b2, c1, c2, mid, riccati_steps=riccati_steps)
        feasible = bool(g.robust_feasible) and bool(
            torch.isfinite(g.x).all() and torch.isfinite(g.y).all())
        if feasible:
            hi = mid
        else:
            lo = mid
    return hi


class HInfState(NamedTuple):
    x_hat: torch.Tensor   # observer state


def hinf_step(gains: HInfGains, a: torch.Tensor, b2: torch.Tensor, c2: torch.Tensor,
              state: HInfState, y_meas: torch.Tensor, dt, u_max: float = 1e8):
    """One output-feedback step: observer update + saturated state feedback
    (forward-Euler discretisation of the central controller)."""
    u = _mv(gains.f, state.x_hat)
    u = torch.clamp(u, -u_max, u_max)
    innov = y_meas - _mv(c2, state.x_hat)
    dx = _mv(a, state.x_hat) + _mv(b2, u) + _mv(gains.l, innov)
    return HInfState(state.x_hat + dt * dx), u
