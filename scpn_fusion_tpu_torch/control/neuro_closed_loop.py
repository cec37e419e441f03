"""Neuro-symbolic closed loop: SCPN controller + plant (port of
``scpn_fusion_tpu/control/neuro_closed_loop.py``).

The JAX package fuses the compiled Petri-net controller tick and the plant
update into one ``lax.scan``, so a multi-thousand-tick shot is one program
with no host round-trip.  The port's counterpart of that program is one
hand-written CUDA launch (``ops/cuda_closed_loop.closed_loop``,
``csrc/closed_loop.cu``).

Two plants, as in JAX:
* the reduced R/Z drift plant (flight_sim.rs semantics) for kHz-rate shots
  (:func:`run_neuro_closed_loop`);
* any plant function ``(plant_state, actions) -> (plant_state, obs_vec)``,
  e.g. the GS solver (:func:`run_closed_loop_custom_plant`), run tick by
  tick.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from scpn_fusion_tpu_torch.ops.cuda_closed_loop import closed_loop, closed_loop_plain
from scpn_fusion_tpu_torch.scpn.controller import (
    CompiledController,
    ControllerConfig,
    controller_step,
    initial_controller_state,
    needs_draws,
)


class ReducedPlantState(NamedTuple):
    r: torch.Tensor
    z: torch.Tensor


def reduced_plant_step(state: ReducedPlantState, actions: torch.Tensor, dt: float,
                       beta: float = 1.0):
    """Reduced R/Z plant: Shafranov drift + vertical instability + actuation.

    ``actions`` = (radial_cmd, vertical_cmd) moves the axis directly
    (flight_sim.rs:322-365 semantics, normalised gains)."""
    r = torch.clamp(state.r + (0.01 * beta + actions[0]) * dt, 2.0, 10.0)
    z = torch.clamp(state.z + (0.02 + actions[1]) * dt, -6.0, 6.0)
    return ReducedPlantState(r, z), torch.stack([r, z])


def run_neuro_closed_loop(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    plant0: ReducedPlantState,
    *,
    n_ticks: int,
    dt: float,
):
    """Run ``n_ticks`` of SCPN controller + reduced plant from the initial
    controller state.

    Returns (final_controller_state, final_plant_state, traces) where traces
    carries per-tick r, z, actions and (beyond JAX's trace) the firing
    vector.  The route is a rule: a configuration that draws no random
    numbers (firing not sampled, no bit flips) runs ``closed_loop``, which on
    a CUDA device is ONE kernel launch for the whole shot in float32 or
    float64 (on the CPU its plain version); one that draws runs the per-tick
    loop of ``controller_step`` (deterministic by tick), with no kernel.
    """
    route = closed_loop_plain if needs_draws(cfg) else closed_loop
    return route(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt)


def run_closed_loop_custom_plant(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    plant_step: Callable,
    plant0,
    obs0: torch.Tensor,
    *,
    n_ticks: int,
):
    """Same loop with an arbitrary plant function (e.g. GS solver), tick by
    tick on the controller's device."""
    cs, ps, obs = initial_controller_state(ctrl, cfg), plant0, obs0
    obs_tr, act_tr = [], []
    for k in range(n_ticks):
        cs, actions, _ = controller_step(ctrl, cfg, cs, obs, k)
        ps, obs = plant_step(ps, actions)
        obs_tr.append(obs)
        act_tr.append(actions)
    return cs, ps, {"obs": torch.stack(obs_tr), "actions": torch.stack(act_tr)}
