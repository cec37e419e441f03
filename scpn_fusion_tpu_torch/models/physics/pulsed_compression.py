"""FRC pulsed magnetic compression: coil circuit + adiabatic piston + flux
(port of ``scpn_fusion_tpu/models/physics/pulsed_compression.py``).

A voltage-driven R-L coil bank produces the external solenoid field
``B_ext = mu0 N I / L``; the magnetic piston ``(p_int - B^2/2mu0) * 2 pi R L
/ m`` drives the separatrix radius; compression is adiabatic (``T
V^(gamma-1)`` invariant) with an optional radial loss time; and energy
bookkeeping tracks thermal / compression-work / radiated channels with a
normalised balance residual.  The circuit step is the exact constant-voltage
R-L interval ``I(t+dt) = V/R + (I - V/R) exp(-R dt / L)``.

The JAX package runs the trajectory as one ``lax.scan`` and differentiates
it end to end with ``jax.grad``.  The port runs the whole trajectory in ONE
launch of a hand-written CUDA kernel, and its gradient in one launch of a
second, the adjoint sweep (``ops/cuda_compression.compression_run``,
``csrc/compression.cu``; row P).  On a CPU tensor the same call is its
plain version, the loop of :func:`compression_step` over the drive table,
differentiated by autograd.

The drive: a kernel cannot call the Python waveform, so
:func:`drive_table` tabulates it at each step's start time, the times
accumulated ``t_{k+1} = t_k + dt`` in the working dtype as the scan adds
them, and calls it once on the whole vector.  The drive must therefore be
elementwise, as every waveform of the JAX callers is; a Python number or a
0-d result is broadcast over the steps.  Autograd carries the table's
gradient back to whatever the drive closed over (the bank voltage).  The
start time takes no gradient: a ``state0.t_s`` that requires one raises.

:func:`compression_step` divides by 0-d tensors (:func:`step_constants`): on
a CUDA tensor PyTorch multiplies by the reciprocal of a Python divisor, and
the kernel divides.  ``jnp.clip`` is ``minimum(maximum(x, lo), hi)`` and
``torch.clamp`` is not (its gradient is 1 at a bound where JAX's is 0.5), so
the step spells the clip out.  :func:`initial_state` takes ``dtype``
(float32 by default; JAX takes its float from the x64 flag) and ``device``
(``"cuda"`` by default); the trajectory follows ``state0``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

MU_0 = 4.0e-7 * math.pi
E_CHARGE = 1.602176634e-19

# the names of :func:`step_constants`, in the order of ``csrc/compression.cu``'s
# ``Const`` (the kernel reads them as one (len,) tensor)
CONSTANTS = ("v_lo", "v_hi", "resistance", "decay", "half_resistance", "dt", "mu0_turns",
             "l_coil", "two_mu0", "pi", "length", "e_charge", "two_pi", "mass", "min_radius",
             "gm1", "loss", "tiny")


@dataclasses.dataclass(frozen=True)
class CoilGeometry:
    """Uniform-solenoid pulsed coil (reference ``CoilGeometry:44-53``)."""

    n_turns: int = 40
    l_coil_m: float = 1.0
    r_coil_m: float = 0.35
    inductance_h: float = 2.0e-6
    resistance_ohm: float = 5.0e-3
    bank_voltage_max_v: float = 5.0e3


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static parameters of the compression run."""

    coil: CoilGeometry = CoilGeometry()
    plasma_mass_kg: float = 2.0e-7
    plasma_length_m: float = 1.0
    gamma: float = 5.0 / 3.0
    radial_loss_time_s: float = math.inf
    min_radius_m: float = 1.0e-4


class CompressionState(NamedTuple):
    t_s: torch.Tensor
    radius_m: torch.Tensor
    velocity_m_s: torch.Tensor
    t_i_ev: torch.Tensor
    t_e_ev: torch.Tensor
    density_m3: torch.Tensor
    coil_current_a: torch.Tensor
    thermal_energy_j: torch.Tensor
    compression_work_j: torch.Tensor
    radiated_loss_j: torch.Tensor
    ohmic_loss_j: torch.Tensor
    source_work_j: torch.Tensor


class CompressionTrace(NamedTuple):
    state: CompressionState            # stacked over time
    b_ext_t: torch.Tensor
    beta: torch.Tensor
    balance_residual: torch.Tensor


class CompressionDiagnostics(NamedTuple):
    """Aggregate trajectory diagnostics (reference
    ``pulsed_compression_trajectory_diagnostics:507-545``)."""

    min_radius_m: torch.Tensor
    compression_ratio: torch.Tensor
    max_abs_acceleration: torch.Tensor
    radial_turning_points: torch.Tensor
    floor_contact_count: torch.Tensor
    max_balance_residual: torch.Tensor


def coil_field_t(coil: CoilGeometry, current_a) -> torch.Tensor:
    """``B_ext = mu0 N I / L`` (reference ``coil_field_t:139-143``)."""
    return MU_0 * coil.n_turns * current_a / coil.l_coil_m


def magnetic_pressure_pa(b_t) -> torch.Tensor:
    return b_t * b_t / (2.0 * MU_0)


def thermal_pressure_pa(density_m3, t_i_ev, t_e_ev) -> torch.Tensor:
    return density_m3 * (t_i_ev + t_e_ev) * E_CHARGE


def plasma_volume_m3(radius_m, length_m) -> torch.Tensor:
    return math.pi * radius_m**2 * length_m


def adiabatic_temperature_ev(t_ev, v_old, v_new, gamma) -> torch.Tensor:
    """``T V^(gamma-1)`` invariant (reference ``:299-312``)."""
    return t_ev * (v_old / v_new) ** (gamma - 1.0)


def _thermal_energy_j(density, volume, t_i, t_e) -> torch.Tensor:
    return 1.5 * density * volume * (t_i + t_e) * E_CHARGE


def initial_state(cfg: CompressionConfig, *, radius_m=0.25, t_i_ev=100.0, t_e_ev=100.0,
                  density_m3=5.0e20, dtype: torch.dtype | None = None,
                  device: torch.device | str = "cuda") -> CompressionState:
    """The state at rest with no coil current (``:118-137``): every field a
    0-d tensor of ``dtype`` (float32 by default) on ``device``."""
    dtype = dtype or torch.float32
    r, ti, te, n = (torch.as_tensor(x, dtype=dtype, device=device)
                    for x in (radius_m, t_i_ev, t_e_ev, density_m3))
    z = torch.zeros((), dtype=dtype, device=device)
    vol = plasma_volume_m3(r, cfg.plasma_length_m)
    return CompressionState(
        t_s=z, radius_m=r, velocity_m_s=z.clone(), t_i_ev=ti, t_e_ev=te, density_m3=n,
        coil_current_a=z.clone(), thermal_energy_j=_thermal_energy_j(n, vol, ti, te),
        compression_work_j=z.clone(), radiated_loss_j=z.clone(), ohmic_loss_j=z.clone(),
        source_work_j=z.clone())


def circuit_constants(coil: CoilGeometry, dt_s: float, dtype, device) -> dict:
    """The coil circuit's constants as 0-d tensors of ``dtype``: the clip
    bounds, R, ``exp(-dt / tau)`` (formed in ``dtype``, as the scan forms it
    from the traced ``dt``), ``0.5 R`` (a Python-double fold) and dt."""
    t = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in (
        ("v_lo", -coil.bank_voltage_max_v), ("v_hi", coil.bank_voltage_max_v),
        ("resistance", coil.resistance_ohm), ("half_resistance", 0.5 * coil.resistance_ohm),
        ("dt", dt_s), ("tau", coil.inductance_h / coil.resistance_ohm),
        ("inductance", coil.inductance_h))}
    t["decay"] = torch.exp(torch.div(-t["dt"], t.pop("tau")))
    return t


def _circuit(c: dict, i_a, v_drive):
    """Exact constant-voltage R-L interval (reference ``:164-209``): (the
    clipped voltage, I', the trapezoid ohmic and source work) with the
    constants of :func:`circuit_constants`."""
    v = torch.minimum(c["v_hi"], torch.maximum(c["v_lo"], v_drive))
    i_inf = torch.div(v, c["resistance"])
    i_new = i_inf + (i_a - i_inf) * c["decay"]
    ohmic = c["half_resistance"] * (i_a * i_a + i_new * i_new) * c["dt"]
    source = 0.5 * v * (i_a + i_new) * c["dt"]
    return v, i_new, ohmic, source


def _circuit_step(coil: CoilGeometry, i_a, v_drive, dt):
    """``I -> V/R + (I - V/R) e^(-R dt/L)`` with trapezoid energy ledgers:
    (I', dI/dt, ohmic work, source work); ``i_a`` sets dtype and device."""
    i_a = torch.as_tensor(i_a)
    c = circuit_constants(coil, dt, i_a.dtype, i_a.device)
    v, i_new, ohmic, source = _circuit(c, i_a, torch.as_tensor(v_drive, dtype=i_a.dtype,
                                                               device=i_a.device))
    di_dt = torch.div(v - c["resistance"] * i_new, c["inductance"])
    return i_new, di_dt, ohmic, source


def step_constants(cfg: CompressionConfig, dt_s: float, dtype, device) -> dict:
    """The constants of :func:`compression_step` as 0-d tensors of
    ``dtype``, named and ordered as :data:`CONSTANTS`: the circuit's, the
    Python-double folds of the JAX expressions (``mu0 N``, ``2 mu0``, ``2
    pi``, ``gamma - 1``), rounded once, and the loss factor ``exp(-dt /
    tau_loss)`` (1 with the default infinite loss time)."""
    c = circuit_constants(cfg.coil, dt_s, dtype, device)
    c.update({k: torch.tensor(v, dtype=dtype, device=device) for k, v in (
        ("mu0_turns", MU_0 * cfg.coil.n_turns), ("l_coil", cfg.coil.l_coil_m),
        ("two_mu0", 2.0 * MU_0), ("pi", math.pi), ("length", cfg.plasma_length_m),
        ("e_charge", E_CHARGE), ("two_pi", 2.0 * math.pi), ("mass", cfg.plasma_mass_kg),
        ("min_radius", cfg.min_radius_m), ("gm1", cfg.gamma - 1.0), ("tiny", 1e-30),
        ("tau_loss", cfg.radial_loss_time_s))})
    c["loss"] = torch.exp(torch.div(-c["dt"], c.pop("tau_loss")))
    return {k: c[k] for k in CONSTANTS}


def compression_step(c: dict, s, v_drive):
    """One step of ``run_voltage_driven_compression``'s scan (``:169-211``):
    ``s`` the twelve state fields, ``v_drive`` the bank voltage at the
    step's start; returns (s', (B_ext, beta, balance residual))."""
    t, r, u, ti, te, n, i_a, e_th0, work0, rad0, ohm0, src0 = s
    # 1) coil circuit over [t, t+dt]
    _, i_new, d_ohm, d_src = _circuit(c, i_a, v_drive)
    field = torch.div(c["mu0_turns"] * i_new, c["l_coil"])
    p_ext = torch.div(field * field, c["two_mu0"])
    # 2) radial Newton piston
    vol_old = c["pi"] * (r * r) * c["length"]
    p_int = n * (ti + te) * c["e_charge"]
    area = c["two_pi"] * r * c["length"]
    accel = torch.div((p_int - p_ext) * area, c["mass"])
    vel = u + accel * c["dt"]
    radius = torch.maximum(c["min_radius"], r + vel * c["dt"])
    # 3) adiabatic compression + radial loss channel
    vol_new = c["pi"] * (radius * radius) * c["length"]
    density = torch.div(n * vol_old, vol_new)
    pw = torch.pow(torch.div(vol_old, vol_new), c["gm1"])
    t_i_ad, t_e_ad = ti * pw, te * pw
    e_ad = 1.5 * density * vol_new * (t_i_ad + t_e_ad) * c["e_charge"]
    t_i, t_e = t_i_ad * c["loss"], t_e_ad * c["loss"]
    e_th = 1.5 * density * vol_new * (t_i + t_e) * c["e_charge"]
    work = work0 + (e_ad - e_th0)
    rad = rad0 + (e_ad - e_th)
    residual = e_th - e_th0 - (work - work0) + (rad - rad0)
    scale = torch.maximum(torch.maximum(e_th.abs(), e_th0.abs()),
                          torch.maximum(work.abs(), c["tiny"]))
    s_new = (t + c["dt"], radius, vel, t_i, t_e, density, i_new, e_th, work, rad,
             ohm0 + d_ohm, src0 + d_src)
    p_now = density * (t_i + t_e) * c["e_charge"]
    beta = torch.div(p_now, torch.maximum(p_ext, c["tiny"]))
    return s_new, (field, beta, torch.div(residual, scale))


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def drive_table(drive_voltage_t: Callable, t0, dt_s: float, n_steps: int, dtype, device):
    """(t_0 ... t_n, the drive at t_0 ... t_{n-1}): the step start times
    accumulated in ``dtype`` from ``t0`` as the scan adds them (``t + dt``,
    one addition a step), moved to ``device``, and the elementwise drive
    evaluated once on them and broadcast to (n_steps,)."""
    npdt = _NP[dtype]
    steps = np.full(n_steps + 1, npdt(dt_s), npdt)
    steps[0] = npdt(float(t0))
    times = torch.from_numpy(np.add.accumulate(steps, dtype=npdt)).to(device)
    v = torch.as_tensor(drive_voltage_t(times[:-1]), dtype=dtype, device=device)
    if v.dim() == 0:
        v = v.expand(n_steps)
    if tuple(v.shape) != (n_steps,):
        raise ValueError(f"the drive gave shape {tuple(v.shape)} on {n_steps} times: it must be "
                         f"elementwise (or constant)")
    return times, v.contiguous()


def run_voltage_driven_compression(cfg: CompressionConfig, state0: CompressionState,
                                   drive_voltage_t: Callable, *, dt_s: float = 2.0e-8,
                                   n_steps: int = 2000) -> CompressionTrace:
    """Coupled coil-circuit + pressure-driven compression (reference
    ``run_voltage_driven_pulsed_compression:467-504``): one launch of row P
    on the card, differentiable through the drive and ``state0`` (one
    launch of row P's adjoint a backward pass)."""
    from scpn_fusion_tpu_torch.ops.cuda_compression import compression_run

    if isinstance(state0.t_s, torch.Tensor) and state0.t_s.requires_grad:
        raise ValueError("run_voltage_driven_compression: state0.t_s takes no gradient (the "
                         "drive is tabulated on a fixed time grid)")
    dtype, device = state0.radius_m.dtype, state0.radius_m.device
    c = step_constants(cfg, dt_s, dtype, device)
    _, table = drive_table(drive_voltage_t, state0.t_s, dt_s, n_steps, dtype, device)
    s0 = torch.stack([torch.as_tensor(x, dtype=dtype, device=device) for x in state0])
    trace = compression_run(c, s0, table)
    return CompressionTrace(CompressionState(*trace[:12]), trace[12], trace[13], trace[14])


def trajectory_diagnostics(trace: CompressionTrace, cfg: CompressionConfig,
                           r_initial) -> CompressionDiagnostics:
    """Validated aggregates (reference ``:507-545``): minimum radius,
    compression ratio, turning points (velocity sign changes), floor
    contacts, worst energy-balance residual."""
    r = trace.state.radius_m
    v = trace.state.velocity_m_s
    sign_change = torch.signbit(v[1:]) != torch.signbit(v[:-1])
    accel_max = (v[1:] - v[:-1]).abs().max() / (trace.state.t_s[1] - trace.state.t_s[0])
    r_min = r.min()
    return CompressionDiagnostics(
        min_radius_m=r_min,
        compression_ratio=torch.as_tensor(r_initial, dtype=r.dtype, device=r.device)
        / torch.clamp(r_min, min=1e-30),
        max_abs_acceleration=accel_max,
        radial_turning_points=sign_change.sum(),
        floor_contact_count=(r <= cfg.min_radius_m * (1.0 + 1e-9)).sum(),
        max_balance_residual=trace.balance_residual.abs().max())
