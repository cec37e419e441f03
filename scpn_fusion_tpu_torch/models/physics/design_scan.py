"""Global reactor design scan + compact-reactor optimisation (port of
``scpn_fusion_tpu/models/physics/design_scan.py``).

Every design point evaluates the same 0D physics chain --

    IPB98(y,2) confinement -> 0D burn equilibrium -> Q, P_fus
    Greenwald / beta / q* operational limits
    net-electric balance (models/engineering.plant_performance)

-- so a whole scan is one batch dimension (JAX's ``vmap``): the burn
relaxation of every design is one launch of row E on the card
(``ops/cuda_burn.py``), the rest batched plain ops.  The optimiser is the
scan plus a feasibility mask + argmax (the first maximum, as JAX's).
:func:`scan_designs` casts its inputs to float32, as JAX does; JAX's
float32 burn carry (the weakly typed initial temperature takes the loop's
float32) is the port's too.  :func:`compact_reactor_search` draws from a
``torch.Generator`` (on the CPU, so every device sees the same draws);
:func:`_compact_reactor_search` takes the draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.engineering.balance_of_plant import (
    PlantParams,
    plant_performance,
)
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors
from scpn_fusion_tpu_torch.models.physics.scaling_burn import burn_equilibrium_0d

MU0 = 4.0e-7 * math.pi


@dataclasses.dataclass(frozen=True)
class DesignLimits:
    greenwald_fraction_max: float = 0.9
    beta_n_max: float = 2.8
    q_star_min: float = 2.0
    b_max_coil_t: float = 23.0     # peak field at the HTS coil
    p_wall_max_mw_m2: float = 4.0  # neutron wall load


class DesignPoint(NamedTuple):
    """One evaluated reactor design (all tensors broadcast together)."""

    r_m: torch.Tensor
    a_m: torch.Tensor
    b0_t: torch.Tensor
    ip_ma: torch.Tensor
    ne19: torch.Tensor
    p_aux_mw: torch.Tensor
    kappa: torch.Tensor
    q_fusion: torch.Tensor
    p_fusion_mw: torch.Tensor
    p_net_mw: torch.Tensor
    t_kev: torch.Tensor
    greenwald_fraction: torch.Tensor
    beta_n: torch.Tensor
    q_star: torch.Tensor
    wall_load_mw_m2: torch.Tensor
    b_coil_t: torch.Tensor
    feasible: torch.Tensor


def evaluate_design(r_m, a_m, b0_t, ip_ma, ne19, p_aux_mw, kappa=1.8,
                    limits: DesignLimits = DesignLimits(),
                    plant: PlantParams = PlantParams(), *, dtype=None,
                    device="cuda") -> DesignPoint:
    """0D chain for one design point or a batch of them (the inputs
    broadcast together; differentiable on the CPU).  Python numbers become
    ``dtype`` (float32 by default) on ``device``; a tensor input sets both."""
    r_m, a_m, b0_t, ip_ma, ne19, p_aux_mw, kappa = as_tensors(
        r_m, a_m, b0_t, ip_ma, ne19, p_aux_mw, kappa, dtype=dtype, device=device)
    burn = burn_equilibrium_0d(ne19=ne19, p_aux_mw=p_aux_mw, ip_ma=ip_ma, bt_t=b0_t, r_m=r_m,
                               a_m=a_m, kappa=kappa, dtype=ne19.dtype, device=ne19.device)

    n_gw = ip_ma / (math.pi * a_m ** 2)                 # 1e20 m^-3
    f_gw = ne19 / (10.0 * torch.clamp(n_gw, min=1e-6))

    # Volume-average beta from the burn temperature
    pressure_pa = 2.0 * ne19 * 1e19 * burn.t_kev * 1.602e-16
    beta = 2.0 * MU0 * pressure_pa / (b0_t ** 2)
    beta_pct = 100.0 * beta
    beta_n = beta_pct * a_m * b0_t / torch.clamp(ip_ma, min=1e-6)

    q_star = (5.0 * a_m ** 2 * b0_t / (r_m * torch.clamp(ip_ma, min=1e-6))
              * 0.5 * (1.0 + kappa ** 2))

    wall_area = 4.0 * math.pi ** 2 * r_m * a_m * torch.sqrt(0.5 * (1.0 + kappa ** 2))
    wall_load = 0.8 * burn.p_fusion_mw / torch.clamp(wall_area, min=1e-6)

    # Peak coil field: B0 scaled to the inboard coil leg
    b_coil = b0_t * r_m / torch.clamp(r_m - a_m - 0.8, min=0.1)

    perf = plant_performance(burn.p_fusion_mw, p_aux_mw, plant)

    feasible = ((f_gw < limits.greenwald_fraction_max)
                & (beta_n < limits.beta_n_max)
                & (q_star > limits.q_star_min)
                & (b_coil < limits.b_max_coil_t)
                & (wall_load < limits.p_wall_max_mw_m2)
                & burn.converged)
    return DesignPoint(
        r_m=r_m, a_m=a_m, b0_t=b0_t, ip_ma=ip_ma, ne19=ne19, p_aux_mw=p_aux_mw, kappa=kappa,
        q_fusion=burn.q_fusion, p_fusion_mw=burn.p_fusion_mw,
        p_net_mw=perf.p_net_mw, t_kev=burn.t_kev,
        greenwald_fraction=f_gw, beta_n=beta_n, q_star=q_star,
        wall_load_mw_m2=wall_load, b_coil_t=b_coil, feasible=feasible)


class ScanResult(NamedTuple):
    points: DesignPoint
    best_index: torch.Tensor
    n_feasible: torch.Tensor


def _best(feasible: torch.Tensor, score: torch.Tensor):
    """(argmax of the score over the feasible set -- the first maximum, 0
    when none is feasible, as ``jnp.argmax`` -- and the feasible count)."""
    masked = torch.where(feasible, score, -math.inf)
    return torch.argmax(masked), torch.sum(feasible)


def scan_designs(*, r_m, a_m, b0_t, ip_ma, ne19, p_aux_mw, kappa=1.8,
                 objective: str = "q_fusion",
                 limits: DesignLimits = DesignLimits(), device="cuda") -> ScanResult:
    """The 0D chain over flat design arrays (float32, as JAX casts them);
    pick the feasible best.

    All inputs broadcast to a common 1D length (a tensor input sets the
    device); ``objective`` is a DesignPoint field name maximised over the
    feasible set.
    """
    args = torch.broadcast_tensors(*(torch.atleast_1d(x) for x in as_tensors(
        r_m, a_m, b0_t, ip_ma, ne19, p_aux_mw, kappa, dtype=torch.float32, device=device)))
    points = evaluate_design(*args, limits=limits)
    best, n_feasible = _best(points.feasible, getattr(points, objective))
    return ScanResult(points=points, best_index=best, n_feasible=n_feasible)


SEARCH_RANGES = ((1.5, 7.0), (0.25, 0.36), (4.0, 14.0), (0.3, 1.0))   # R0, a/R0, B0, Ip/Ip(q*)


def search_draws(n_samples: int, seed: int):
    """:func:`compact_reactor_search`'s uniforms in :data:`SEARCH_RANGES`
    (float64, as JAX's under x64) from a ``torch.Generator`` seeded with
    ``seed``, on the CPU: the major radius, the inverse aspect ratio, the
    field and the normalised current."""
    g = torch.Generator().manual_seed(seed)
    return [lo + (hi - lo) * torch.rand(n_samples, generator=g, dtype=torch.float64)
            for lo, hi in SEARCH_RANGES]


def search_designs(r, eps, b, ipn):
    """(R0, a, B0, Ip, ne19) of the compact search's draws: Ip from a safe q*
    target band, the density at 80% of Greenwald."""
    a = eps * r
    ip = ipn * 5.0 * a ** 2 * b / r
    ne = 0.8 * 10.0 * ip / (math.pi * a ** 2)
    return r, a, b, ip, ne


def _compact_reactor_search(r, eps, b, ipn, *, p_aux_mw: float = 50.0,
                            limits: DesignLimits = DesignLimits()) -> ScanResult:
    """:func:`compact_reactor_search` on given draws (n,): the major radius,
    the inverse aspect ratio, the field and the normalised current."""
    r, a, b, ip, ne = search_designs(r, eps, b, ipn)
    res = scan_designs(r_m=r, a_m=a, b0_t=b, ip_ma=ip, ne19=ne,
                       p_aux_mw=torch.full_like(r, p_aux_mw),
                       objective="q_fusion", limits=limits)
    # Re-rank: smallest R0 among feasible Q >= 10 designs
    pts = res.points
    ok = pts.feasible & (pts.q_fusion >= 10.0)
    best, n_ok = _best(ok, -pts.r_m)
    return ScanResult(points=pts, best_index=best, n_feasible=n_ok)


def compact_reactor_search(*, n_samples: int = 4096, seed: int = 0,
                           p_aux_mw: float = 50.0,
                           limits: DesignLimits = DesignLimits(),
                           device="cuda") -> ScanResult:
    """Random-search compact-device optimiser (reference
    ``compact_reactor_optimizer`` role): minimise R0 subject to Q >= 10 and
    all operational limits, via one scan of :func:`search_draws`."""
    return _compact_reactor_search(*(d.to(device) for d in search_draws(n_samples, seed)),
                                   p_aux_mw=p_aux_mw, limits=limits)
