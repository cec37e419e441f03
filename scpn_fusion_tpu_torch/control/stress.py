"""1000-shot stress-test campaign (port of ``scpn_fusion_tpu/control/stress.py``).

The reference's ``validation/stress_test_campaign.py`` (PID across 1000
identical-scenario episodes with injected sensor noise, ELM events and ramp
transients; headline result: 0 % disruption rate, BASELINE.md) runs 1000
sequential Python episodes; the JAX package runs the whole campaign as one
``vmap`` of a ``lax.scan``.  Here the campaign is a leading shot dimension:
on the card ONE launch of ``csrc/reduced_shot.cu`` (its stress variant) runs
every tick of every shot; on the CPU its plain version, a Python loop over
ticks of ops over the shots.

The draws: JAX's threefry bits cannot be reproduced, so
:func:`run_stress_campaign` draws from a ``torch.Generator`` seeded with
``seed``, and :func:`_run_stress_campaign` takes the draws as a tensor, as
the tests hand it JAX's own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams
from scpn_fusion_tpu_torch.core.stats import percentile
from scpn_fusion_tpu_torch.ops.cuda_reduced_shot import reduced_shot


@dataclasses.dataclass(frozen=True)
class StressConfig:
    """Disturbance injection knobs (reference campaign scenario set)."""

    sensor_noise_m: float = 0.005       # measurement noise sigma [m]
    elm_rate_hz: float = 10.0           # ELM event frequency
    elm_kick_m: float = 0.02            # radial kick per ELM
    ramp_disturbance_m_s: float = 0.01  # slow drift transient
    disruption_limit_m: float = 0.5


class StressResult(NamedTuple):
    disruption_rate: torch.Tensor    # fraction of shots EVER disrupted
    r_err_p50: torch.Tensor
    r_err_p95: torch.Tensor
    r_err_p99: torch.Tensor
    z_err_p95: torch.Tensor
    mean_final_err: torch.Tensor
    per_shot_disrupted: torch.Tensor


def stress_draws(n_ticks: int, n_shots: int, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n_ticks, n_shots, 4) draws on the generator's device, in ``dtype``:
    a uniform ``u`` (an ELM fires where ``u < elm_rate_hz * dt``), the ELM
    amplitude and the two sensor-noise normals (R, Z)."""
    kw = dict(generator=generator, device=generator.device, dtype=dtype)
    return torch.cat([torch.rand((n_ticks, n_shots, 1), **kw),
                      torch.randn((n_ticks, n_shots, 3), **kw)], dim=-1)


def stress_inputs(params: FlightSimParams, cfg: StressConfig, dtype: torch.dtype,
                  device: torch.device | str):
    """What the tick loop takes besides the draws: the campaign's dt-scaled
    gains (1, 6), the heating request (n,) and the ramp drift (n,) of every
    tick."""
    dt = params.control_dt
    dt_ref = 0.01
    gains = torch.tensor([[params.pid_r_kp, params.pid_r_ki * dt / dt_ref,
                           params.pid_r_kd * dt_ref / dt, params.pid_z_kp,
                           params.pid_z_ki * dt / dt_ref, params.pid_z_kd * dt_ref / dt]],
                         dtype=dtype, device=device)
    phase = torch.clamp(torch.arange(params.n_steps, device=device).to(dtype) * dt
                        / params.shot_duration_s, 0.0, 1.0)
    drift = cfg.ramp_disturbance_m_s * torch.sin(2.0 * math.pi * phase)
    return gains, 20.0 + 60.0 * phase, drift


def _run_stress_campaign(params: FlightSimParams, cfg: StressConfig, draws: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> StressResult:
    """The campaign on given draws, (n, P, 4) as :func:`stress_draws` lays
    them out, on their device.  ``u`` is compared at the draws' own
    precision: JAX with x64 on draws it in float64 even for a float32
    campaign, so such draws come in float64 (the float32 normals widen
    exactly and are narrowed back to ``dtype``).  On the card the kernel
    takes draws in ``dtype`` only."""
    gains, heating_req, drift = stress_inputs(params, cfg, dtype, draws.device)
    traces = reduced_shot(params, gains, heating_req, drift=drift, draws=draws, stress=cfg)
    r_err = (traces.r - params.target_r).abs()
    z_err = (traces.z - params.target_z).abs()
    disrupted = ((r_err > cfg.disruption_limit_m) | (z_err > cfg.disruption_limit_m)).any(-1)
    p50, p95, p99 = percentile(r_err, (50.0, 95.0, 99.0))
    return StressResult(
        disruption_rate=disrupted.to(dtype).mean(),
        r_err_p50=p50, r_err_p95=p95, r_err_p99=p99,
        z_err_p95=percentile(z_err, 95.0),
        mean_final_err=(r_err[:, -1] + z_err[:, -1]).mean(),
        per_shot_disrupted=disrupted)


def run_stress_campaign(
    params: FlightSimParams = FlightSimParams(),
    cfg: StressConfig = StressConfig(),
    *,
    n_shots: int = 1000,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> StressResult:
    """All shots in one call: the draws (``u`` in ``dtype``) from a
    ``torch.Generator`` on ``device`` seeded with ``seed``; on the card one
    launch of the kernel."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = stress_draws(params.n_steps, n_shots, generator=gen, dtype=dtype)
    return _run_stress_campaign(params, cfg, draws, dtype)
