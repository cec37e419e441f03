"""Runaway-electron Fokker-Planck kernel, 1D in momentum (port of
``scpn_fusion_tpu/models/physics/fokker_planck_re.py``).

Log-spaced momentum grid (p in units of m_e c), Hesslow-style advection
coefficient ``A = F_acc - F_drag - F_synch``, Connor-Hastie critical field,
minmod-limited MUSCL advection with upwind face fluxes, central-difference
diffusion, and the Rosenbluth-Putvinski avalanche / Dreicer / knock-on
sources.  The JAX package runs the ``n_steps`` trajectory as one
``lax.scan``; the port runs it as a Python loop of :func:`fp_step` on plain
PyTorch ops (~60 launches a step on the card).

The field, density, temperature and Z_eff may be Python numbers or 0-d
tensors.  A number stays a Python double through the scalar terms (the
critical field's e^3 product underflows float32), so a Python number's
terms are folded in double in JAX's order before they meet the grid's
tensors, as JAX folds them under x64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import linspace_like_jax

C = 2.998e8
ME = 9.109e-31
MC = ME * C
E_CHARGE = 1.602e-19
EPS0 = 8.854e-12
COULOMB_LOG = 15.0
B_TOROIDAL = 5.3
DIFFUSION_FLOOR = 1e-5
AVALANCHE_RATE = 100.0
DREICER_SOURCE = 1.0e15
KNOCK_ON_SCALE = 1.0e-25
KNOCK_ON_MAX_SOURCE = 1.0e24
RE_SEED_FLOOR = 1.0e6


def _max(x, lo):
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) else max(x, lo)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


@dataclasses.dataclass(frozen=True)
class FokkerPlanckGrid:
    """Static log-spaced momentum grid (p in units of m_e c)."""

    np_grid: int = 200
    p_max: float = 100.0

    def __post_init__(self) -> None:
        if self.np_grid < 16:
            raise ValueError("np_grid must be >= 16")
        if not np.isfinite(self.p_max) or self.p_max <= 1e-3:
            raise ValueError("p_max must be finite and > 1e-3")

    def p(self, dtype: torch.dtype = torch.float32,
          device: torch.device | str = "cuda") -> torch.Tensor:
        """``jnp.logspace(-2, log10(p_max), np_grid, dtype)``: 10 to the
        power of ``jnp.linspace`` between the end points in ``dtype``."""
        stop = torch.log10(torch.tensor(self.p_max, dtype=dtype))
        lin = linspace_like_jax(-2.0, float(stop), self.np_grid, dtype)
        return torch.pow(10.0, torch.from_numpy(lin.copy())).to(device)

    def dp(self, dtype: torch.dtype = torch.float32,
           device: torch.device | str = "cuda") -> torch.Tensor:
        """``np.gradient`` central-difference spacings of the log grid."""
        p = self.p(dtype, device)
        interior = 0.5 * (p[2:] - p[:-2])
        return torch.cat([(p[1] - p[0])[None], interior, (p[-1] - p[-2])[None]])


def _e_crit(n_e):
    """Connor-Hastie critical field of density ``n_e`` [V/m]."""
    return (n_e * E_CHARGE**3 * COULOMB_LOG) / (4 * math.pi * EPS0**2 * ME * C**2)


def fp_coefficients(p: torch.Tensor, e_field, n_e, z_eff, t_e_ev,
                    b_toroidal: float = B_TOROIDAL):
    """(A, D, Fc_norm): advection/diffusion coefficients + normalised
    Connor-Hastie critical force (reference ``compute_coefficients``)."""
    f_acc = (E_CHARGE * e_field) / MC
    fc_norm = (E_CHARGE * _e_crit(n_e)) / MC

    gamma = torch.sqrt(1.0 + p**2)
    p_th_sq = _max(t_e_ev / 511e3, 1e-6)
    z1 = z_eff + 1.0
    z1 = z1.to(p.dtype) if isinstance(z1, torch.Tensor) else p.new_full((), z1)
    f_drag = fc_norm * (1.0 + torch.div(z1, p**2 + p_th_sq))
    tau_rad = (6 * math.pi * EPS0 * MC**3) / (E_CHARGE**4 * b_toroidal**2)
    f_synch = (1.0 / tau_rad) * p * gamma * _sqrt(1.0 + z_eff)

    a = f_acc - f_drag - f_synch
    d = torch.full_like(p, DIFFUSION_FLOOR)
    return a, d, fc_norm


def _minmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(a * b > 0, torch.sign(a) * torch.minimum(torch.abs(a), torch.abs(b)),
                       torch.zeros_like(a))


def fp_step(f: torch.Tensor, p: torch.Tensor, dp: torch.Tensor, dt, e_field, n_e, t_e_ev,
            z_eff):
    """One MUSCL-Hancock advection + diffusion + sources step.

    Returns (f_new, n_re, j_re) -- reference ``step`` (``:517-616``).
    """
    n = f.shape[0]
    a, d, fc = fp_coefficients(p, e_field, n_e, z_eff, t_e_ev)
    zero = f.new_zeros(())

    # Avalanche source (Rosenbluth-Putvinski NF 37 (1997) Eq. 19).
    e_crit = fc * MC / E_CHARGE
    rate = ((e_field / _max(e_crit, 1e-300) - 1.0)
            * _sqrt(math.pi * (z_eff + 1.0) / 2.0) * AVALANCHE_RATE)
    above = e_field > e_crit
    gamma_av = (torch.where(above, rate, torch.zeros_like(rate)) if isinstance(above, torch.Tensor)
                else rate if above else 0.0)
    s_av = gamma_av * f

    # Dreicer injection into the 5 lowest-momentum cells above 5% of E_crit.
    idx = torch.arange(n, device=f.device)
    s_dr = torch.where((idx < 5) & (e_field > 0.05 * e_crit), f.new_full((), DREICER_SOURCE),
                       zero)

    # Knock-on (Moller 1/p^2) source, gated on a seed population.
    n_re_now = torch.sum(f * dp)
    s_ko = (1.0 / (p**2 + 1e-4)) * n_e * n_re_now * KNOCK_ON_SCALE
    s_ko = torch.clamp(torch.where(torch.isfinite(s_ko), s_ko, zero), 0.0, KNOCK_ON_MAX_SOURCE)
    s_ko = torch.where(n_re_now < RE_SEED_FLOOR, zero, s_ko)

    # MUSCL advection with minmod slopes.
    step = f[1:] - f[:-1]
    df_fwd = torch.cat([step, f.new_zeros(1)])
    df_bwd = torch.cat([f.new_zeros(1), step])
    slope = _minmod(df_fwd, df_bwd)
    f_l = f + 0.5 * slope
    f_r = torch.roll(f - 0.5 * slope, -1)
    flux = torch.where(a >= 0, a * f_l, a * f_r)

    interior = (idx >= 1) & (idx <= n - 2)
    flux_prev = torch.cat([f.new_zeros(1), flux[:-1]])
    adv = -(dt / dp) * (flux - flux_prev)
    f_n = torch.roll(f, -1)
    f_s = torch.roll(f, 1)
    diff = dt * d * (f_n - 2.0 * f + f_s) / dp**2
    update = adv + diff + dt * (s_av + s_dr + s_ko)
    f_new = torch.clamp(f + torch.where(interior, update, zero), min=0.0)

    n_re = torch.sum(f_new * dp)
    gamma = torch.sqrt(1.0 + p**2)
    v = C * p / gamma
    j_re = E_CHARGE * torch.sum(f_new * v * dp)
    return f_new, n_re, j_re


class FPTrace(NamedTuple):
    n_re: torch.Tensor
    j_re: torch.Tensor


def run_fokker_planck(grid: FokkerPlanckGrid, f0: torch.Tensor, dt, e_field, n_e, t_e_ev,
                      z_eff, *, n_steps: int):
    """Run ``n_steps`` kinetic steps; returns (f_final, FPTrace with per-step
    n_re / j_re).  Follows ``f0``'s device and dtype."""
    p = grid.p(f0.dtype, f0.device)
    dp = grid.dp(f0.dtype, f0.device)
    f, n_re, j_re = f0, [], []
    for _ in range(n_steps):
        f, n, j = fp_step(f, p, dp, dt, e_field, n_e, t_e_ev, z_eff)
        n_re.append(n)
        j_re.append(j)
    if not n_re:
        empty = f0.new_zeros(0)
        return f, FPTrace(empty, empty.clone())
    return f, FPTrace(torch.stack(n_re), torch.stack(j_re))
