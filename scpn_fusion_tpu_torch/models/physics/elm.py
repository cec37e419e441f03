"""ELM cycle model: peeling-ballooning trigger, crash, power-balance frequency
(port of ``scpn_fusion_tpu/models/physics/elm.py``).

The peeling limit j_edge < j_crit(n_mode, q95, shaping), the ballooning
limit alpha < alpha_crit(s), the type-I crash releasing a fraction of the
pedestal stored energy, and the power-balance ELM frequency
``f_ELM = P_SOL / (f_loss W_ped)``.  The limit cycle (:func:`run_elm_cycle`)
is a Python loop of a few 0-d ops a step on plain PyTorch ops.

The functions take numbers or tensors: a tensor among the inputs sets the
device (and dtype), else ``dtype`` (float32; JAX takes its float from the
x64 flag) and ``device`` (``"cuda"``) do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors


def ballooning_limit(s_edge, *, dtype=None, device="cuda"):
    """Connor-Hastie-Taylor alpha_crit(s) (shared with stability_mhd)."""
    (s_edge,) = as_tensors(s_edge, dtype=dtype, device=device)
    s = torch.clamp(s_edge, min=0.0)
    return torch.clamp(torch.where(s < 1.0, s * (1.0 - s / 2.0), 0.6 * s), min=0.0)


def peeling_limit(j_edge_norm, q95, kappa, delta, n_mode: int = 10, *, dtype=None,
                  device="cuda"):
    """Normalised peeling threshold: shaping raises it, high n lowers it."""
    q95, kappa, delta = as_tensors(q95, kappa, delta, dtype=dtype, device=device)
    f_shape = (1.0 + 0.5 * (kappa - 1.0)) * (1.0 + 0.8 * delta)
    return f_shape * (1.0 + 2.0 / max(n_mode, 1)) / torch.clamp(q95, min=1.0)


def pb_unstable(alpha_edge, j_edge_norm, s_edge, q95, kappa, delta, *, dtype=None,
                device="cuda"):
    """Elliptical coupled peeling-ballooning boundary crossing."""
    alpha_edge, j_edge_norm, s_edge, q95, kappa, delta = as_tensors(
        alpha_edge, j_edge_norm, s_edge, q95, kappa, delta, dtype=dtype, device=device)
    a_crit = torch.clamp(ballooning_limit(s_edge), min=1e-3)
    j_crit = torch.clamp(peeling_limit(j_edge_norm, q95, kappa, delta), min=1e-3)
    radius = torch.sqrt((alpha_edge / a_crit) ** 2 + (j_edge_norm / j_crit) ** 2)
    return radius > 1.0


class ELMCrash(NamedTuple):
    delta_w_mj: torch.Tensor
    t_ped_after_kev: torch.Tensor
    n_ped_after_1e19: torch.Tensor


def elm_crash(t_ped_kev, n_ped_1e19, w_ped_mj, *, loss_fraction=0.3, conductive_share=0.7,
              dtype=None, device="cuda") -> ELMCrash:
    """Type-I crash: lose ``loss_fraction`` of W_ped, split conductive
    (temperature) / convective (density) by ``conductive_share``."""
    t_ped_kev, n_ped_1e19, w_ped_mj = as_tensors(t_ped_kev, n_ped_1e19, w_ped_mj, dtype=dtype,
                                                 device=device)
    delta_w = loss_fraction * w_ped_mj
    t_after = t_ped_kev * (1.0 - loss_fraction * conductive_share)
    n_after = n_ped_1e19 * (1.0 - loss_fraction * (1.0 - conductive_share))
    return ELMCrash(delta_w, t_after, n_after)


def elm_power_balance_frequency(p_sol_mw, w_ped_mj, f_elm_fraction, *, dtype=None,
                                device="cuda"):
    """f_ELM = P_SOL / (f W_ped) [Hz] (zero on degenerate inputs)."""
    p_sol_mw, w_ped_mj, f_elm_fraction = as_tensors(p_sol_mw, w_ped_mj, f_elm_fraction,
                                                    dtype=dtype, device=device)
    ok = (w_ped_mj > 0) & (f_elm_fraction > 0)
    return torch.where(ok, p_sol_mw / torch.clamp(f_elm_fraction * w_ped_mj, min=1e-12),
                       torch.zeros_like(p_sol_mw))


class ELMCycleTrace(NamedTuple):
    t_ped: torch.Tensor       # (n_steps,)
    crashed: torch.Tensor     # (n_steps,) bool
    n_crashes: torch.Tensor


def run_elm_cycle(*, t_ped0_kev, n_ped_1e19, w_ped_mj, heat_rate_kev_s, alpha_per_kev, s_edge,
                  j_edge_norm, q95=3.5, kappa=1.7, delta=0.33, dt=1e-3, n_steps: int = 2000,
                  loss_fraction=0.3, dtype=None, device="cuda") -> ELMCycleTrace:
    """Pedestal build-up / crash limit cycle: heating raises T_ped (and alpha
    ~ alpha_per_kev T_ped) until the PB boundary trips, then the crash
    resets the pedestal."""
    t_ped, *consts = as_tensors(t_ped0_kev, j_edge_norm, s_edge, q95, kappa, delta, n_ped_1e19,
                                w_ped_mj, dtype=dtype, device=device)
    j_edge_norm, s_edge, q95, kappa, delta, n_ped_1e19, w_ped_mj = consts
    hist, fired = [], []
    for _ in range(n_steps):
        t_ped = t_ped + dt * heat_rate_kev_s
        alpha = alpha_per_kev * t_ped
        fire = pb_unstable(alpha, j_edge_norm, s_edge, q95, kappa, delta)
        crash = elm_crash(t_ped, n_ped_1e19, w_ped_mj, loss_fraction=loss_fraction)
        t_ped = torch.where(fire, crash.t_ped_after_kev, t_ped)
        hist.append(t_ped)
        fired.append(fire)
    crashed = torch.stack(fired)
    return ELMCycleTrace(torch.stack(hist), crashed, torch.sum(crashed))
