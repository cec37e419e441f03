"""Optimal shot-trajectory design: gradients THROUGH the integrated shot
(port of ``scpn_fusion_tpu/control/optimal_scenario.py``).

The whole integrated scenario
(:func:`~scpn_fusion_tpu_torch.models.physics.integrated_scenario.run_shot`:
schedule -> L-H -> dynamic burn -> flux budget) is a differentiable function
of the waveform knobs, so the shot design problem

    maximise  Q_flattop
    s.t.      flux budget not exhausted, Greenwald fraction < 0.9

is solved by Adam on the exact gradient (``torch.autograd.grad`` through the
shot's tick loop, where JAX takes ``jax.grad``) -- no finite differences, no
surrogate of the simulator.  Adam is optax's formula written out
(``control/mpc._adam_update``); the raw gradient is normalised before it.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple

import torch

from scpn_fusion_tpu_torch.control.mpc import _adam_update
from scpn_fusion_tpu_torch.control.scenario import FluxBudget, ScenarioSchedule, Waveform

if TYPE_CHECKING:  # pragma: no cover
    from scpn_fusion_tpu_torch.models.physics.integrated_scenario import ScenarioMachine

# integrated_scenario imports control.scenario (-> control/__init__ -> this
# module), so its symbols are imported lazily to break the cycle.


def _scenario_mod():
    from scpn_fusion_tpu_torch.models.physics import integrated_scenario
    return integrated_scenario


class ShotKnobs(NamedTuple):
    """Differentiable waveform parameters (raw, unconstrained)."""

    p_aux_flat_mw: torch.Tensor
    ne_flat_19: torch.Tensor
    ip_flat_ma: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    ramp_s: float = 60.0
    flattop_s: float = 300.0
    dt_s: float = 0.5
    greenwald_cap: float = 0.9
    flux_margin_vs: float = 5.0
    penalty: float = 50.0
    learning_rate: float = 0.05
    n_iters: int = 40
    # box bounds (projected)
    p_aux_bounds: tuple = (5.0, 120.0)
    ne_bounds: tuple = (2.0, 15.0)
    ip_bounds: tuple = (5.0, 17.0)


def _schedule_from_knobs(k: ShotKnobs, cfg: OptimizerConfig) -> ScenarioSchedule:
    """Build the staged schedule with tensor values (times are static)."""
    ramp, flat = cfg.ramp_s, cfg.flattop_s
    end = 2 * ramp + flat
    t_full_ne = ramp + 0.3 * flat
    return ScenarioSchedule(waveforms=(
        ("ip_ma", Waveform((0.0, ramp, ramp + flat, end),
                           (0.1, k.ip_flat_ma, k.ip_flat_ma, 0.1))),
        ("ne19", Waveform((0.0, ramp, t_full_ne, ramp + flat,
                           ramp + flat + 0.5 * ramp, end),
                          (0.5, 0.5 * k.ne_flat_19, k.ne_flat_19,
                           k.ne_flat_19, 0.3, 0.3))),
        ("p_aux_mw", Waveform((0.0, 0.5 * ramp, ramp, ramp + flat, end),
                              (0.0, 0.0, k.p_aux_flat_mw,
                               k.p_aux_flat_mw, 0.0))),
    ))


def shot_objective(k: ShotKnobs, budget: FluxBudget,
                   m: "ScenarioMachine", cfg: OptimizerConfig):
    """Negative soft-constrained Q (to MINIMISE); returns (loss, report).
    The shot runs on the knobs' device."""
    sched = _schedule_from_knobs(k, cfg)
    trace, report = _scenario_mod().run_shot(sched, budget, m, dt_s=cfg.dt_s,
                                             device=k.ip_flat_ma.device)
    # soft constraints from the trace (differentiable)
    flux_deficit = torch.clamp(cfg.flux_margin_vs - trace.flux_remaining_vs.min(), min=0.0)
    gw_excess = torch.clamp(
        torch.where(trace.ip_ma > 1.0, trace.greenwald_fraction,
                    torch.zeros_like(trace.greenwald_fraction)).max() - cfg.greenwald_cap,
        min=0.0)
    loss = (-report.q_flattop
            + cfg.penalty * (flux_deficit / cfg.flux_margin_vs) ** 2
            + cfg.penalty * gw_excess ** 2)
    return loss, report


class OptimalShotResult(NamedTuple):
    knobs: ShotKnobs
    q_flattop: torch.Tensor
    loss_history: torch.Tensor
    feasible: torch.Tensor


def optimize_shot(k0: ShotKnobs, budget: FluxBudget,
                  m: "ScenarioMachine | None" = None,
                  cfg: OptimizerConfig = OptimizerConfig()
                  ) -> OptimalShotResult:
    """Adam on the differentiable shot objective with box projection; runs
    in float64 on the device of ``k0``'s tensors."""
    if m is None:
        m = _scenario_mod().ScenarioMachine()
    dev = k0.ip_flat_ma.device
    lo = torch.tensor([cfg.p_aux_bounds[0], cfg.ne_bounds[0], cfg.ip_bounds[0]],
                      dtype=torch.float64, device=dev)
    hi = torch.tensor([cfg.p_aux_bounds[1], cfg.ne_bounds[1], cfg.ip_bounds[1]],
                      dtype=torch.float64, device=dev)

    def value_and_grad(vec):
        vec = vec.detach().requires_grad_(True)
        loss, _ = shot_objective(ShotKnobs(vec[0], vec[1], vec[2]), budget, m, cfg)
        (g,) = torch.autograd.grad(loss, vec)
        return loss.detach(), g

    vec = torch.stack([torch.as_tensor(x, dtype=torch.float64, device=dev)
                       for x in (k0.p_aux_flat_mw, k0.ne_flat_19, k0.ip_flat_ma)])
    mu, nu, count = torch.zeros_like(vec), torch.zeros_like(vec), 0
    losses = []
    for _ in range(cfg.n_iters):
        loss, g = value_and_grad(vec)
        # normalise the raw gradient so one lr fits all knob scales
        g = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
        update, mu, nu, count = _adam_update(g, mu, nu, count, cfg.learning_rate)
        vec = torch.minimum(torch.maximum(vec + update, lo), hi)
        losses.append(float(loss))

    k_final = ShotKnobs(vec[0], vec[1], vec[2])
    with torch.no_grad():
        _, report = shot_objective(k_final, budget, m, cfg)
    feasible = (~report.flux_exhausted) & (~report.greenwald_violated)
    return OptimalShotResult(knobs=k_final, q_flattop=report.q_flattop,
                             loss_history=torch.tensor(losses, dtype=torch.float64, device=dev),
                             feasible=feasible)
