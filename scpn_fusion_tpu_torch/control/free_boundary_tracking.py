"""Closed-loop free-boundary shape tracking with the full GS plant in the loop
(port of ``scpn_fusion_tpu/control/free_boundary_tracking.py``).

* **local response identification** -- the coil-to-objective Jacobian from
  perturbed full free-boundary solves; JAX ``vmap``s them, the port runs one
  standalone solve a coil (JAX's batched while loop freezes each finished
  element, so each ends on its standalone count);
* **bounded least-squares corrections** with gain, per-step delta clamp,
  slew limits and Tikhonov regularisation;
* **objective-space disturbance observer**;
* **sensor bias/drift injection + fixed-step measurement latency** with a
  Smith-predictor compensation;
* **safety supervisor** -- alert ladder (nominal/warning/guarded/severe)
  with hysteresis hold, action filtering and a fallback-current ramp;
* **magnetics in the loop** -- every tick forward-models synthetic flux
  loops + B probes from the plant psi and re-reconstructs the coil currents
  from them (``shape_control.reconstruct_coil_currents``).

Kernels: the JAX lane runs its plant solves on plain ops
(``use_pallas=False`` in ``run_tracking_shot``), and so does the port: no
hand-written kernel launches on this path, whatever the device and dtype.

Random numbers: :func:`run_tracking_shot` draws the probe noise of every
tick from a ``torch.Generator`` seeded with ``seed`` and hands it to
:func:`_run_tracking_shot`, which takes the noise as a tensor; the parity
tests feed that function JAX's own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid, linspace
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import CoilSet, _run_free_boundary
from scpn_fusion_tpu_torch.models.equilibrium.shape_control import (
    probe_response_matrix,
    reconstruct_coil_currents,
    synthetic_magnetics,
)
from scpn_fusion_tpu_torch.models.equilibrium.topology import gradient
from scpn_fusion_tpu_torch.ops.lstsq import bounded_lstsq

N_OBJECTIVES = 4  # [axis_R, axis_Z, x_R, x_Z]


# ── Differentiable objective extraction ─────────────────────────────────


def soft_objectives(psi: torch.Tensor, grid: Grid, temperature: float = 60.0) -> torch.Tensor:
    """[axis_R, axis_Z, xpt_R, xpt_Z] via softmax/softmin position weights
    (smooth twin of the reference's ``evaluate_objectives`` axis/X-point
    metrics; differentiable so the same code serves gradient lanes)."""
    rr, zz = grid.RR, grid.ZZ
    ptp = psi.max() - psi.min()
    w_ax = torch.softmax((temperature * (psi - psi.max()) / (ptp + 1e-30)).reshape(-1), 0)
    axis_r = w_ax @ rr.reshape(-1)
    axis_z = w_ax @ zz.reshape(-1)

    dpsi_dz = gradient(psi, grid.dZ, 0)
    dpsi_dr = gradient(psi, grid.dR, 1)
    b_mag = torch.hypot(dpsi_dr, dpsi_dz)
    mask = zz < (grid.Z_min * 0.5)
    scale = torch.where(mask, b_mag, torch.zeros_like(b_mag)).max() + 1e-30
    logits = torch.where(mask, -temperature * b_mag / scale, torch.full_like(b_mag, -math.inf))
    w_x = torch.softmax(logits.reshape(-1), 0)
    x_r = w_x @ rr.reshape(-1)
    x_z = w_x @ zz.reshape(-1)
    return torch.stack([axis_r, axis_z, x_r, x_z])


# ── Safety supervisor ────────────────────────────────────────────────────

NOMINAL, WARNING, GUARDED, SEVERE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Constraint/alert thresholds (reference
    ``_free_boundary_safety_supervisor.py:31-108`` semantics, condensed)."""

    coil_current_limit: float = 40.0       # |I| absolute cap
    coil_delta_limit: float = 2.0          # per-coil per-tick |dI| cap
    total_action_l1_limit: float = 4.0     # sum |dI| cap
    warning_axis_error_m: float = 0.04
    guarded_axis_error_m: float = 0.07
    severe_axis_error_m: float = 0.10
    severe_xpoint_error_m: float = 0.12
    severe_bias_norm_m: float = 0.08
    alert_hold_steps: int = 6              # hysteresis: level decays slowly
    fallback_action_scale: float = 0.45    # action scale while GUARDED
    fallback_ramp_rate: float = 0.25       # SEVERE: fraction/tick toward safe


class SupervisorState(NamedTuple):
    level: torch.Tensor      # int32 alert level
    hold: torch.Tensor       # int32 ticks remaining at >= current level


def supervisor_init(device: torch.device | str = "cuda") -> SupervisorState:
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return SupervisorState(level=zero, hold=zero.clone())


def _classify_level(cfg: SupervisorConfig, axis_err: torch.Tensor,
                    x_err: torch.Tensor, bias_norm: torch.Tensor) -> torch.Tensor:
    sev = ((axis_err > cfg.severe_axis_error_m)
           | (x_err > cfg.severe_xpoint_error_m)
           | (bias_norm > cfg.severe_bias_norm_m))
    grd = axis_err > cfg.guarded_axis_error_m
    wrn = axis_err > cfg.warning_axis_error_m
    level = torch.where(wrn, WARNING, NOMINAL)
    level = torch.where(grd, GUARDED, level)
    return torch.where(sev, SEVERE, level).to(torch.int32)


def supervisor_step(
    cfg: SupervisorConfig,
    state: SupervisorState,
    delta: torch.Tensor,          # proposed coil correction
    currents: torch.Tensor,       # present coil currents
    fallback_currents: torch.Tensor,
    axis_err: torch.Tensor,
    x_err: torch.Tensor,
    bias_norm: torch.Tensor,
) -> tuple[SupervisorState, torch.Tensor]:
    """Advance the alert ladder and filter the proposed action.

    Returns (new_state, filtered_delta).  SEVERE overrides the correction
    with a bounded ramp toward the fallback currents (reference
    ``_recover_to_safe_state``); GUARDED scales the action down; all levels
    enforce delta, L1, and absolute-current limits.
    """
    req = _classify_level(cfg, axis_err, x_err, bias_norm)
    # Hysteresis: escalate immediately, de-escalate only when hold expires.
    escalate = req > state.level
    hold = torch.where(escalate, torch.full_like(state.hold, cfg.alert_hold_steps),
                       torch.clamp(state.hold - 1, min=0))
    level = torch.where(escalate, req,
                        torch.where(hold > 0, torch.maximum(state.level, req), req))

    one = torch.ones((), dtype=delta.dtype, device=delta.device)
    scale = torch.where(level == GUARDED, cfg.fallback_action_scale * one,
                        torch.where(level == SEVERE, 0.0 * one, one))
    d = delta * scale
    # SEVERE: ramp toward fallback currents instead of freezing.
    ramp = cfg.fallback_ramp_rate * (fallback_currents - currents)
    d = torch.where(level == SEVERE, ramp, d)

    # Hard action filters (all levels).
    d = torch.clamp(d, -cfg.coil_delta_limit, cfg.coil_delta_limit)
    l1 = d.abs().sum()
    d = d * torch.clamp(cfg.total_action_l1_limit / torch.clamp(l1, min=1e-30), max=1.0)
    d = torch.clamp(currents + d, -cfg.coil_current_limit, cfg.coil_current_limit) - currents
    return SupervisorState(level=level, hold=hold), d


# ── Tracking controller ──────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Controller knobs (reference ``FreeBoundaryTrackingController.__init__``
    :70-115 + runtime-mixin fault-injection parameters)."""

    gain: float = 0.8
    identification_perturbation: float = 0.25
    correction_limit: float = 2.0
    response_regularization: float = 1e-3
    latency_steps: int = 0                 # measurement delay in ticks
    # Latency compensation (reference ``latency_compensation_gain`` /
    # ``latency_rate_max_abs`` semantics): a Smith-predictor correction --
    # the identified response matrix maps the coil-current change applied
    # since the delayed measurement was taken into objective space; the
    # per-component correction is clamped.
    latency_compensation_gain: float = 1.0
    latency_rate_max_abs: float = 0.5
    observer_gain: float = 0.3             # disturbance-observer update rate
    sensor_bias: tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    # Known calibration subtracted from the measurement (reference
    # ``measurement_correction_bias``).
    measurement_correction_bias: tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    sensor_drift_per_tick: tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    probe_noise_sigma: float = 0.0         # synthetic-magnetics noise
    # Prior-anchored reconstruction: coil columns are anchored much harder
    # than the plasma-surrogate filament columns.
    reconstruction_alpha: float = 1e-2
    reconstruction_alpha_coils: float = 25.0
    # Plasma-surrogate filament offsets (dR, dZ) from the target axis.
    filament_offsets: tuple[tuple[float, float], ...] = (
        (0.0, 0.0), (-0.8, 0.0), (0.8, 0.0), (0.0, -0.8), (0.0, 0.8))
    supervisor: SupervisorConfig = SupervisorConfig()


class TrackingState(NamedTuple):
    currents: torch.Tensor          # commanded coil currents
    bias_estimate: torch.Tensor     # (N_OBJECTIVES,) disturbance observer
    obj_history: torch.Tensor       # (latency+2, N_OBJ) delayed measurements
    current_history: torch.Tensor   # (latency+1, n_coils) command history
    predicted_obj: torch.Tensor     # model prediction for the next estimate
    supervisor: SupervisorState
    tick: torch.Tensor


class TrackingTrace(NamedTuple):
    objectives: torch.Tensor        # true per-tick objectives
    currents: torch.Tensor
    reconstructed_currents: torch.Tensor
    reconstruction_rms: torch.Tensor
    alert_level: torch.Tensor
    axis_error: torch.Tensor


def _plant_solve(coils: CoilSet, cfg: ReactorConfig, grid: Grid, use_pallas: bool):
    res = _run_free_boundary(
        coils, cfg=cfg, grid=grid, max_outer_iter=5, tol=1e-4,
        optimize_shape=False, tikhonov_alpha=1e-4,
        mu0_green=float(cfg.physics.vacuum_permeability),
        use_pallas=use_pallas)
    return res.psi


def identify_response(
    coils: CoilSet,
    cfg: ReactorConfig,
    grid: Grid,
    base_obj: torch.Tensor,
    perturbation: float,
    use_pallas: bool,
) -> torch.Tensor:
    """Coil-to-objective Jacobian J[obj, coil] from perturbed free-boundary
    solves, one standalone solve a coil (reference
    ``identify_response_matrix``)."""
    n_coils = coils.currents.shape[0]
    eye = torch.eye(n_coils, dtype=coils.currents.dtype, device=coils.currents.device)
    objs = []
    for col in eye:
        c = coils._replace(currents=coils.currents + perturbation * col)
        objs.append(soft_objectives(_plant_solve(c, cfg, grid, use_pallas), grid))
    return (torch.stack(objs) - base_obj[None, :]).T / perturbation


def _run_tracking_shot(
    coils: CoilSet,
    targets: torch.Tensor,              # (N_OBJECTIVES,)
    fallback_currents: torch.Tensor,
    flux_points: torch.Tensor,
    b_probe_points: torch.Tensor,
    b_probe_dirs: torch.Tensor,
    noise: torch.Tensor,                # (n_steps, n_measurements) standard normals
    *,
    cfg: ReactorConfig,
    grid: Grid,
    tcfg: TrackingConfig,
    n_steps: int,
) -> TrackingTrace:
    """:func:`run_tracking_shot` with each tick's probe noise given."""
    dtype, dev = coils.currents.dtype, coils.currents.device
    sup_cfg = tcfg.supervisor
    mu0 = float(cfg.physics.vacuum_permeability)
    # Response matrix over n_coils + n_filaments columns: the extra columns
    # are a plasma-surrogate filament basis around the target axis, so the
    # inverse fit explains the TOTAL measurements (coil + plasma pickup).
    offs = torch.tensor(tcfg.filament_offsets, dtype=dtype, device=dev)   # (n_fil, 2)
    n_fil = offs.shape[0]
    fil_r = targets[0] + offs[:, 0]
    fil_z = targets[1] + offs[:, 1]
    plasma_filament = CoilSet(
        r=torch.cat([coils.r, fil_r]),
        z=torch.cat([coils.z, fil_z]),
        currents=torch.cat([coils.currents, torch.zeros((n_fil,), dtype=dtype, device=dev)]),
        turns=torch.cat([coils.turns, torch.ones((n_fil,), dtype=dtype, device=dev)]),
    )
    probe_resp = probe_response_matrix(
        plasma_filament, flux_points=flux_points,
        b_probe_points=b_probe_points, b_probe_dirs=b_probe_dirs, mu0=mu0)

    # One-time local response identification around the initial currents.
    psi0 = _plant_solve(coils, cfg, grid, False)
    obj0 = soft_objectives(psi0, grid)
    jac = identify_response(coils, cfg, grid, obj0, tcfg.identification_perturbation, False)

    hist_len = tcfg.latency_steps + 2
    state = TrackingState(
        currents=coils.currents, bias_estimate=torch.zeros((N_OBJECTIVES,), dtype=dtype,
                                                           device=dev),
        obj_history=obj0[None, :].repeat(hist_len, 1),
        current_history=coils.currents[None, :].repeat(tcfg.latency_steps + 1, 1),
        predicted_obj=obj0, supervisor=supervisor_init(dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev))

    def vec(values):
        return torch.tensor(values, dtype=dtype, device=dev)

    sensor_bias = vec(tcfg.sensor_bias)
    correction_bias = vec(tcfg.measurement_correction_bias)
    sensor_drift = vec(tcfg.sensor_drift_per_tick)
    ip_prior = vec(cfg.physics.plasma_current_target)
    n_jac = jac.shape[1]
    reg_rows = torch.sqrt(vec(tcfg.response_regularization)) * torch.eye(n_jac, dtype=dtype,
                                                                        device=dev)
    limit = torch.full((n_jac,), tcfg.correction_limit, dtype=dtype, device=dev)

    rows = []
    for k in range(n_steps):
        c = coils._replace(currents=state.currents)
        psi = _plant_solve(c, cfg, grid, False)
        obj_true = soft_objectives(psi, grid)

        # Synthetic magnetics -> coil-current reconstruction (estimator in
        # the loop: the controller never reads the oracle currents).
        meas = synthetic_magnetics(
            psi, grid, flux_points=flux_points,
            b_probe_points=b_probe_points, b_probe_dirs=b_probe_dirs)
        meas = meas + tcfg.probe_noise_sigma * noise[k]
        # Fit coil currents + a plasma filament current against the TOTAL
        # measurements; prior = previous command + Ip target for the
        # filament column.
        prior = torch.cat([state.currents, (ip_prior / n_fil).expand(n_fil)])
        limit_vec = torch.cat([torch.full_like(state.currents, sup_cfg.coil_current_limit),
                               (10.0 * ip_prior.abs() + 1.0).expand(n_fil)])
        alpha_vec = torch.cat([torch.full_like(state.currents, tcfg.reconstruction_alpha_coils),
                               torch.full((n_fil,), tcfg.reconstruction_alpha, dtype=dtype,
                                          device=dev)])
        recon_full = reconstruct_coil_currents(
            probe_resp, meas, prior, tikhonov_alpha=alpha_vec,
            current_limits=limit_vec, n_iter=120)

        # Sensor model: bias + drift, then fixed-step latency with a
        # Smith-predictor compensation of the delay.
        obj_meas = obj_true + sensor_bias + sensor_drift * state.tick - correction_bias
        hist = torch.cat([state.obj_history[1:], obj_meas[None, :]])
        delayed = hist[-(tcfg.latency_steps + 1)]
        comp = jac @ (state.currents - state.current_history[0])
        comp = torch.clamp(comp, -tcfg.latency_rate_max_abs, tcfg.latency_rate_max_abs)
        obj_est = delayed + tcfg.latency_compensation_gain * comp

        # Disturbance observer in objective space.
        innovation = obj_est - state.predicted_obj
        new_bias = (1.0 - tcfg.observer_gain) * state.bias_estimate \
            + tcfg.observer_gain * innovation
        err = targets - (obj_est + new_bias)
        delta = bounded_lstsq(
            torch.cat([jac, reg_rows]),
            torch.cat([err, torch.zeros((n_jac,), dtype=dtype, device=dev)]),
            -limit, limit, n_iter=120) * tcfg.gain

        axis_err = torch.hypot(obj_true[0] - targets[0], obj_true[1] - targets[1])
        x_err = torch.hypot(obj_true[2] - targets[2], obj_true[3] - targets[3])
        bias_norm = torch.linalg.vector_norm(state.bias_estimate[:2])
        sup_state, delta_f = supervisor_step(
            sup_cfg, state.supervisor, delta, state.currents,
            fallback_currents, axis_err, x_err, bias_norm)

        new_currents = state.currents + delta_f
        rows.append((obj_true, state.currents, recon_full.coil_currents[:-n_fil],
                     recon_full.residual_rms, sup_state.level, axis_err))
        state = TrackingState(
            currents=new_currents,
            bias_estimate=new_bias,
            obj_history=hist,
            current_history=torch.cat([state.current_history[1:], new_currents[None, :]]),
            predicted_obj=obj_est + jac @ delta_f,
            supervisor=sup_state,
            tick=state.tick + 1)
    return TrackingTrace(*(torch.stack(col) for col in zip(*rows)))


def default_flux_loops(grid: Grid) -> torch.Tensor:
    """The default diagnostic set: 16 flux loops on an ellipse that ENCLOSES
    the plasma but excludes the coils -- the virtual-casing condition for
    interior (plasma) / exterior (coil) source separation in the filament
    fit; (16, 2) (R, Z) in the grid's dtype and on its device."""
    th = linspace(0.0, 2.0 * math.pi, 17, grid.dtype, grid.device)[:-1]
    r_mid = 0.5 * (grid.R_min + grid.R_max)
    r_amp = 0.47 * (grid.R_max - grid.R_min)
    z_amp = 0.42 * (grid.Z_max - grid.Z_min)
    return torch.stack([r_mid + r_amp * torch.cos(th), z_amp * torch.sin(th)], dim=1)


def run_tracking_shot(
    cfg: ReactorConfig,
    coils: CoilSet,
    targets,
    *,
    grid: Grid | None = None,
    tcfg: TrackingConfig = TrackingConfig(),
    n_steps: int = 10,
    flux_points: torch.Tensor | None = None,
    b_probe_points: torch.Tensor | None = None,
    b_probe_dirs: torch.Tensor | None = None,
    fallback_currents: torch.Tensor | None = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
) -> TrackingTrace:
    """Closed-loop shape-tracking shot on the coils' device.

    Each tick: full free-boundary plant solve -> synthetic magnetics ->
    coil-current reconstruction -> latency/bias-compensated objective
    estimate -> bounded LSQ correction -> safety-supervisor filter.  The
    probe noise of tick k is row k of one (n_steps, n_measurements) draw of
    standard normals from a generator seeded with ``seed``.
    """
    dev = coils.currents.device
    if grid is None:
        grid = Grid.from_config(cfg, dtype=dtype, device=dev)
    if flux_points is None:
        flux_points = default_flux_loops(grid)
    if b_probe_points is None:
        b_probe_points = flux_points
        b_probe_dirs = torch.tensor([0, 1], dtype=torch.int32, device=dev).repeat(
            flux_points.shape[0] // 2)
    if fallback_currents is None:
        fallback_currents = coils.currents
    n_meas = flux_points.shape[0] + b_probe_points.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    noise = torch.randn((int(n_steps), n_meas), generator=gen, dtype=dtype, device=dev)
    return _run_tracking_shot(
        coils, torch.as_tensor(targets, dtype=dtype, device=dev), fallback_currents,
        flux_points, b_probe_points, b_probe_dirs, noise,
        cfg=cfg, grid=grid, tcfg=tcfg, n_steps=int(n_steps))
