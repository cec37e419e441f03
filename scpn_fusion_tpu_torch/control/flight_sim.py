"""Tokamak flight simulator: closed-loop shots (port of
``scpn_fusion_tpu/control/flight_sim.py``).

Two lanes, as in the JAX package:

* ``run_shot_reduced`` -- the >10 kHz lane: reduced-order R/Z/Ip/beta plant
  with PID control, safety-envelope slew enforcement, actuator delay line
  and disruption metrics.  ``run_shot_reduced_gains`` takes gains of shape
  ``(..., 6)``: a leading batch of gain sets is a population of shots
  (JAX's ``jax.vmap`` of the shot, ``control/tuning.py:61``), and the traces
  and metrics come out ``(..., n)`` and ``(...)``.  The tick-only quantities
  (phase, Ip ramp, heating request) are computed for all ticks at once, with
  the same operations in the same order; the tick loop itself is
  ``ops/cuda_reduced_shot.reduced_shot``: on the card ONE launch of
  ``csrc/reduced_shot.cu`` for the whole population, on the CPU its plain
  version, a Python loop over ticks of ops over the population.  Its
  percentiles are :func:`core.stats.percentile`, ``jnp.percentile``'s linear
  interpolation without ``torch.quantile``'s size limit.
* ``run_shot_full`` -- physics-in-the-loop lane: the Grad-Shafranov solve is
  the plant.  Each control tick: Ip ramp, sub-grid parabolic magnetic-axis
  estimate, R/Z PID, coil-current deltas through first-order actuators,
  vacuum flux refresh through the coil response table (one einsum), and a
  full fixed-boundary solve (``solve_fixed_boundary_impl``), called as the
  JAX lane calls it: no ``mg_pre_smooth`` / ``mg_post_smooth``, so the
  V-cycle is the solver's default (3, 3) whatever the configuration says.
  The hand-written kernels run iff ``cfg.solver.use_pallas`` is set, the
  shot is on a CUDA device and the dtype is float32 (JAX's rule with "tpu"
  read as "cuda"); at 513^2 that is kernels 2-5 on every Picard iteration.
  Each solve is a standalone call with one host read an iteration, so a
  30-tick shot is 31 separate solves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.actuator import ActuatorParams, actuator_init, actuator_step
from scpn_fusion_tpu_torch.control.pid import PIDGains, pid_init, pid_step
from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.core.stats import percentile
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
    _as_dtype,
    solve_fixed_boundary_impl,
)
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import (
    coilset_from_config,
    external_flux_table,
)
from scpn_fusion_tpu_torch.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu_torch.ops.cuda_reduced_shot import reduced_shot

DEFAULT_TARGET_R = 6.2
DEFAULT_TARGET_Z = 0.0


@dataclasses.dataclass(frozen=True)
class FlightSimParams:
    """Static reduced-lane configuration (reference flight_sim.rs defaults)."""

    target_r: float = DEFAULT_TARGET_R
    target_z: float = DEFAULT_TARGET_Z
    control_hz: float = 10_000.0
    shot_duration_s: float = 1.0
    # PID gains at the 100 Hz reference period (scaled by dt at runtime).
    pid_r_kp: float = 2.0
    pid_r_ki: float = 0.1
    pid_r_kd: float = 0.5
    pid_z_kp: float = 5.0
    pid_z_ki: float = 0.2
    pid_z_kd: float = 2.0
    pf_rate_limit: float = 1.0e3     # command units / s
    pf_abs_max: float = 50.0
    heating_rate_limit: float = 200.0  # MW/s
    heating_abs_max: float = 100.0
    delay_steps: int = 2
    disruption_limit_m: float = 0.5

    @property
    def control_dt(self) -> float:
        return 1.0 / self.control_hz

    @property
    def n_steps(self) -> int:
        return int(self.shot_duration_s / self.control_dt)


class ReducedShotTrace(NamedTuple):
    r: torch.Tensor
    z: torch.Tensor
    ip_ma: torch.Tensor
    beta: torch.Tensor
    heating_mw: torch.Tensor
    r_err: torch.Tensor
    z_err: torch.Tensor
    disrupted: torch.Tensor


def run_shot_reduced(params: FlightSimParams, *, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda"):
    """Run the reduced-order closed-loop shot; returns the full telemetry
    trace plus aggregate metrics (disruption fraction, final errors)."""
    gains = torch.tensor(
        [params.pid_r_kp, params.pid_r_ki, params.pid_r_kd,
         params.pid_z_kp, params.pid_z_ki, params.pid_z_kd], dtype=dtype, device=device)
    return run_shot_reduced_gains(params, gains, dtype=dtype)


def reduced_inputs(params: FlightSimParams, gains: torch.Tensor, dtype: torch.dtype):
    """What the tick loop takes for gain sets ``gains`` (P, 6): the dt-scaled
    gains (P, 6) and the heating request of every tick (n,), with the Ip
    ramp (n,) beside them, all on the gains' device."""
    dt = params.control_dt
    g = gains.to(dtype)
    # Gain scaling from the 100 Hz baseline (flight_sim.rs:199-206).
    dt_ref = 0.01
    scaled = torch.stack([g[:, 0], g[:, 1] * dt / dt_ref, g[:, 2] * dt_ref / dt,
                          g[:, 3], g[:, 4] * dt / dt_ref, g[:, 5] * dt_ref / dt], dim=-1)
    # the plant's schedule, every tick at once (reference step_once :305-330)
    phase = torch.clamp(torch.arange(params.n_steps, device=gains.device).to(dtype) * dt
                        / params.shot_duration_s, 0.0, 1.0)
    return scaled, 20.0 + 60.0 * phase, 5.0 + 10.0 * phase


def run_shot_reduced_gains(params: FlightSimParams, gains: torch.Tensor, *,
                           dtype: torch.dtype = torch.float32):
    """Reduced-lane shots with the six PID gains as a ``(..., 6)`` tensor
    ``[r_kp, r_ki, r_kd, z_kp, z_ki, z_kd]`` (100 Hz-baseline values, scaled
    by dt internally): one shot for each gain set, all in one call.  The
    trace fields are ``(..., n)`` and the metrics ``(...)``; the shots run on
    the gains' device (on the card: one launch of ``csrc/reduced_shot.cu``)."""
    n = params.n_steps
    batch = gains.shape[:-1]
    scaled, heating_req_all, ip_all = reduced_inputs(params, gains.reshape(-1, 6), dtype)
    traces = reduced_shot(params, scaled, heating_req_all)
    r_tr, z_tr, beta_tr, heat_tr = (t.reshape(*batch, n) for t in traces)
    r_err = (r_tr - params.target_r).abs()
    z_err = (z_tr - params.target_z).abs()
    disrupted = (r_err > params.disruption_limit_m) | (z_err > params.disruption_limit_m)
    trace = ReducedShotTrace(r_tr, z_tr, ip_all.expand(*batch, n), beta_tr, heat_tr, r_err,
                             z_err, disrupted)
    metrics = {
        "disruption_fraction": disrupted.to(dtype).mean(-1),
        "r_err_final": r_err[..., -1],
        "z_err_final": z_err[..., -1],
        "r_err_p95": percentile(r_err, 95.0, dim=-1),
        "z_err_p95": percentile(z_err, 95.0, dim=-1),
    }
    return trace, metrics


# ── full-physics lane ────────────────────────────────────────────────────


def subgrid_axis(psi: torch.Tensor, r_1d: torch.Tensor, z_1d: torch.Tensor,
                 d_r: float, d_z: float):
    """Magnetic-axis position with parabolic sub-grid interpolation
    (reference ``run_shot`` :295-318).  ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does; no host read."""
    nz, nr = psi.shape
    idx = torch.argmax(psi)
    iz, ir = idx // nr, idx % nr
    curr_r = r_1d[ir]
    curr_z = z_1d[iz]
    zero = torch.zeros((), dtype=psi.dtype, device=psi.device)

    irc = torch.clamp(ir, 1, nr - 2)
    a = psi[iz, irc - 1]
    b = psi[iz, irc]
    c = psi[iz, irc + 1]
    denom = 2.0 * (a - 2.0 * b + c)
    dr_frac = torch.where(denom.abs() > 1e-30, torch.clamp(-(c - a) / denom, -0.5, 0.5), zero)
    curr_r = curr_r + torch.where((ir >= 1) & (ir <= nr - 2), dr_frac * d_r, zero)

    izc = torch.clamp(iz, 1, nz - 2)
    a2 = psi[izc - 1, ir]
    b2 = psi[izc, ir]
    c2 = psi[izc + 1, ir]
    denom2 = 2.0 * (a2 - 2.0 * b2 + c2)
    dz_frac = torch.where(denom2.abs() > 1e-30, torch.clamp(-(c2 - a2) / denom2, -0.5, 0.5),
                          zero)
    curr_z = curr_z + torch.where((iz >= 1) & (iz <= nz - 2), dz_frac * d_z, zero)
    return curr_r, curr_z


class FullShotTrace(NamedTuple):
    t_s: torch.Tensor
    r_axis: torch.Tensor
    z_axis: torch.Tensor
    ctrl_r_cmd: torch.Tensor
    ctrl_r_applied: torch.Tensor
    ctrl_z_cmd: torch.Tensor
    ctrl_z_applied: torch.Tensor
    converged: torch.Tensor


def run_shot_full(
    cfg: ReactorConfig,
    *,
    shot_steps: int = 30,
    control_dt_s: float = 0.05,
    actuator_tau_s: float = 0.06,
    actuator_delta_limit: float = 5.0e4,
    radial_coil_ids: tuple = (1, 2, 3),
    top_coil_id: int = 0,
    bottom_coil_id: int = 5,
    target_r: float | None = None,
    target_z: float | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
):
    """Closed-loop shot with the GS solver as the plant; returns (final psi,
    final coil currents, per-tick trace).

    Coil-current deltas act through the precomputed per-coil response table,
    so each tick's vacuum-flux refresh is one einsum.
    """
    grid = Grid.from_config(cfg, dtype=dtype, device=device)
    coils = coilset_from_config(cfg, dtype, device)
    mu0 = float(cfg.physics.vacuum_permeability)
    g_table = external_flux_table(grid, coils, mu0)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype, device)
    sol = cfg.solver
    use_pallas = sol.use_pallas and grid.device.type == "cuda" and dtype == torch.float32
    tr = float(cfg.physics.plasma_current_target)

    t_r = DEFAULT_TARGET_R if target_r is None else float(target_r)
    t_z = DEFAULT_TARGET_Z if target_z is None else float(target_z)

    act_params = ActuatorParams(
        tau_s=actuator_tau_s, dt_s=control_dt_s,
        u_min=-actuator_delta_limit, u_max=actuator_delta_limit)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=grid.device)

    g_r = PIDGains(*[scalar(v) for v in (2.0, 0.1, 0.5)])
    g_z = PIDGains(*[scalar(v) for v in (5.0, 0.2, 2.0)])

    def gs_solve(psi0, psi_bc, i_target):
        return solve_fixed_boundary_impl(
            grid, psi0, psi_bc, i_target, p_c, ff_c,
            _as_dtype(sol.convergence_threshold, dtype), math.inf,
            _as_dtype(sol.relaxation_factor, dtype), _as_dtype(sol.sor_omega, dtype),
            solver_method=sol.solver_method, max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps, anderson_m=sol.anderson_depth,
            mu0=mu0, use_gs_criterion=False, use_pallas=use_pallas)

    n_radial = len(radial_coil_ids)
    r_1d, z_1d = grid.R, grid.Z
    ks = torch.arange(shot_steps, device=grid.device).to(dtype)
    t_all = ks * control_dt_s
    i_target_all = tr * (0.98 + 0.02 * ks / shot_steps)

    currents = coils.currents
    psi_bc0 = torch.einsum("c,czr->zr", currents, g_table)
    psi = gs_solve(psi_bc0, psi_bc0, scalar(tr)).psi
    pid_r, pid_z = pid_init(dtype, grid.device), pid_init(dtype, grid.device)
    act_r, act_t, act_b = (actuator_init(act_params, dtype, grid.device) for _ in range(3))
    rows, converged = [], []
    for k in range(shot_steps):
        r_axis, z_axis = subgrid_axis(psi, r_1d, z_1d, grid.dR, grid.dZ)
        pid_r, cmd_r = pid_step(g_r, pid_r, t_r - r_axis)
        pid_z, cmd_z = pid_step(g_z, pid_z, t_z - z_axis)

        act_r, applied_r = actuator_step(act_params, act_r, cmd_r)
        act_t, applied_t = actuator_step(act_params, act_t, cmd_z)
        act_b, applied_b = actuator_step(act_params, act_b, -cmd_z)

        currents = currents.clone()
        for cid in radial_coil_ids:
            currents[cid] += applied_r / n_radial
        currents[top_coil_id] += applied_t
        currents[bottom_coil_id] += applied_b

        psi_bc = torch.einsum("c,czr->zr", currents, g_table)
        eq = gs_solve(psi, psi_bc, i_target_all[k])
        psi = eq.psi
        rows.append((t_all[k], r_axis, z_axis, cmd_r, applied_r, cmd_z, applied_t))
        converged.append(eq.converged)

    cols = [torch.stack(col) for col in zip(*rows)]
    trace = FullShotTrace(*cols, converged=torch.tensor(converged, device=grid.device))
    return psi, currents, trace

