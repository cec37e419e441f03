"""A population of reduced flight-sim shots as a hand-written CUDA kernel
(``csrc/reduced_shot.cu``).

:func:`reduced_shot` runs every tick of ``P`` reduced shots -- the R/Z/beta
plant, the two PID loops and the safety envelope of
``control/flight_sim.py`` -- in ONE launch (one thread a shot, the tick loop
inside the kernel), in float32 or float64, and adds one to
``cb.CALLS["reduced_shot"]``.  Two variants: the *reduced* tick of
``run_shot_reduced_gains`` (an actuator delay line of at most
:data:`MAX_DELAY` ticks) and the *stress* tick of ``control/stress.py`` (no
delay line; ELM kicks, a ramp drift and sensor noise from four draws a
shot-tick).  The JAX package has no Pallas kernel here: its shot is one
``lax.scan``, vmapped over the population or the campaign, inside one
compiled program, and this launch takes that program's place.

Everything before and after the tick loop is the callers' PyTorch code,
shared by the kernel and its plain version: the schedule vectors (heating
request and ramp drift, a value a tick), the scaled gains, the errors, the
disruption flags and the percentiles.

On a CPU tensor the wrapper runs the kernel's plain version, the batched tick
loop :func:`reduced_shot_plain` (a Python loop over ticks of ops over the
population).  On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_reduced_shot_f32", torch.float64: "scpn_reduced_shot_f64"}
MAX_DELAY = 8       # csrc/reduced_shot.cu:MAX_DELAY
_POINTERS = ("gains", "heating_req", "drift", "draws", "trace_r", "trace_z", "trace_beta",
             "trace_heating")
_INTS = ("n_shots", "n_ticks", "gain_stride", "n_delay", "stress")
_DOUBLES = ("dt", "target_r", "target_z", "r0", "z0", "beta0", "heating0", "heat_slew",
            "heat_max", "pf_slew", "pf_max", "z_step", "p_elm", "elm_kick", "sensor_noise")


class _Args(ctypes.Structure):
    """``ReducedShotArgs`` of ``csrc/reduced_shot.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [(name, ctypes.c_int) for name in _INTS]
                + [(name, ctypes.c_double) for name in _DOUBLES])


class ShotTraces(NamedTuple):
    """Each shot's state after every tick, (P, n); ``beta`` and ``heating``
    are None in the stress variant."""

    r: torch.Tensor
    z: torch.Tensor
    beta: torch.Tensor | None
    heating: torch.Tensor | None


def _envelope(requested, prev, rate_limit, abs_max, dt):
    """Safety-envelope enforcement: slew then absolute clamp
    (reference ``SafetyEnvelope::enforce``)."""
    out = torch.clamp(requested, prev - rate_limit * dt, prev + rate_limit * dt)
    return torch.clamp(out, -abs_max, abs_max)


def _n_shots(gains: torch.Tensor, draws: torch.Tensor | None) -> int:
    return int(draws.shape[1]) if draws is not None else int(gains.shape[0])


def reduced_shot_plain(params, gains: torch.Tensor, heating_req: torch.Tensor, *,
                       drift: torch.Tensor | None = None, draws: torch.Tensor | None = None,
                       stress=None) -> ShotTraces:
    """The batched tick loop the kernel replaces.

    ``params`` is a ``FlightSimParams``; ``gains`` (P, 6) or (1, 6) the
    dt-scaled ``[kp, ki, kd]`` of R then of Z; ``heating_req`` (n,) the
    heating request of each tick.  With ``stress`` (a ``StressConfig``) the
    tick is ``control/stress.py``'s, with ``drift`` (n,) and ``draws``
    (n, P, 4): ``u`` (compared with ``elm_rate_hz * dt`` at the draws'
    precision), the ELM amplitude and the two sensor-noise normals."""
    from scpn_fusion_tpu_torch.control.pid import PIDGains, pid_init, pid_step

    dt = params.control_dt
    dtype, dev = gains.dtype, gains.device
    n = heating_req.shape[0]
    p = _n_shots(gains, draws)
    g_r = PIDGains(gains[:, 0], gains[:, 1], gains[:, 2])
    g_z = PIDGains(gains[:, 3], gains[:, 4], gains[:, 5])

    def full(v):
        return torch.full((p,), v, dtype=dtype, device=dev)

    r, z = full(params.target_r + 0.1), full(params.target_z + 0.05)
    beta, heating = full(0.6), full(20.0)
    pid_r, pid_z = pid_init(dtype, dev), pid_init(dtype, dev)
    pf_r, pf_z = full(0.0), full(0.0)
    if stress is not None:
        # the draws' functions of no state, for every tick at once
        p_elm = torch.tensor(stress.elm_rate_hz * dt, dtype=dtype, device=dev)
        normals = draws[..., 1:].to(dtype)
        elm_all = (draws[..., 0] < p_elm).to(dtype) * stress.elm_kick_m * normals[..., 0]
        noise_all = stress.sensor_noise_m * normals[..., 1:]
    else:
        delay_buf = torch.zeros((p, params.delay_steps + 1, 2), dtype=dtype, device=dev)
        nbuf, cursor = delay_buf.shape[1], 0
    rows = []
    for k in range(n):
        heating = _envelope(heating_req[k], heating, params.heating_rate_limit,
                            params.heating_abs_max, dt)
        heating = torch.clamp(heating, 0.0, params.heating_abs_max)
        beta_target = 0.6 + 0.03 * heating
        beta = torch.clamp(beta + 0.5 * (beta_target - beta) * dt, 0.2, 10.0)
        if stress is not None:
            elm = elm_all[k]
            r = torch.clamp(r + (0.01 * beta + drift[k]) * dt + elm, 2.0, 10.0)
            z = torch.clamp(z + 0.02 * dt + 0.5 * elm, -6.0, 6.0)
            # control on noisy measurements
            pid_r, cmd_r = pid_step(g_r, pid_r, params.target_r - (r + noise_all[k, :, 0]))
            pid_z, cmd_z = pid_step(g_z, pid_z, params.target_z - (z + noise_all[k, :, 1]))
            pf_r = _envelope(cmd_r, pf_r, params.pf_rate_limit, params.pf_abs_max, dt)
            pf_z = _envelope(cmd_z, pf_z, params.pf_rate_limit, params.pf_abs_max, dt)
            r = torch.clamp(r + pf_r * dt, 2.0, 10.0)
            z = torch.clamp(z + pf_z * dt, -6.0, 6.0)
            rows.append((r, z))
            continue
        r = torch.clamp(r + 0.01 * beta * dt, 2.0, 10.0)
        z = torch.clamp(z + 0.02 * dt, -6.0, 6.0)
        # 2. Control, 2b. safety enforcement
        pid_r, cmd_r = pid_step(g_r, pid_r, params.target_r - r)
        pid_z, cmd_z = pid_step(g_z, pid_z, params.target_z - z)
        pf_r = _envelope(cmd_r, pf_r, params.pf_rate_limit, params.pf_abs_max, dt)
        pf_z = _envelope(cmd_z, pf_z, params.pf_rate_limit, params.pf_abs_max, dt)
        # 3. Actuator delay line: write this tick's slot, apply the oldest
        delay_buf[:, cursor] = torch.stack([pf_r, pf_z], dim=-1)
        cursor = (cursor + 1) % nbuf
        applied = delay_buf[:, cursor].clone()
        # 4. Apply control
        r = torch.clamp(r + applied[:, 0] * dt, 2.0, 10.0)
        z = torch.clamp(z + applied[:, 1] * dt, -6.0, 6.0)
        rows.append((r, z, beta, heating))
    cols = [torch.stack(col, dim=-1) for col in zip(*rows)]
    return ShotTraces(*cols) if stress is None else ShotTraces(*cols, None, None)


def check_reduced_shot(params, gains, heating_req, drift, draws, stress) -> None:
    """Raise unless the kernel takes these inputs."""
    dtype = gains.dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"reduced_shot: float32 or float64, got {dtype}")
    tensors = {"gains": gains, "heating_req": heating_req}
    if stress is not None:
        if drift is None or draws is None:
            raise ValueError("reduced_shot: the stress variant takes drift and draws")
        tensors.update(drift=drift, draws=draws)
    elif params.delay_steps > MAX_DELAY or params.delay_steps < 0:
        raise ValueError(f"reduced_shot: the kernel holds a delay of 0..{MAX_DELAY} ticks, "
                         f"not {params.delay_steps}")
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"reduced_shot: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"reduced_shot: {name} is {t.dtype}, the gains are {dtype} (the "
                            "kernel takes the draws in the shot's dtype)")
        if not t.is_contiguous():
            raise ValueError(f"reduced_shot: {name} must be contiguous")
    n, p = heating_req.shape[0], _n_shots(gains, draws)
    if gains.dim() != 2 or gains.shape[1] != 6 or (stress is not None and gains.shape[0] != 1):
        raise ValueError(f"reduced_shot: gains must be (P, 6), or (1, 6) in the stress "
                         f"variant; got {tuple(gains.shape)}")
    if stress is not None and (tuple(draws.shape) != (n, p, 4) or tuple(drift.shape) != (n,)):
        raise ValueError(f"reduced_shot: draws {tuple(draws.shape)} and drift "
                         f"{tuple(drift.shape)} do not match {n} ticks of {p} shots")
    if n < 1 or p < 1:
        raise ValueError("reduced_shot: at least one tick and one shot")


def launch_args(params, gains: torch.Tensor, heating_req: torch.Tensor, drift, draws, stress):
    """The kernel's argument block and its output traces, (n, P) each (beta
    and heating None in the stress variant); the traces are allocated on the
    gains' device (only the pointers go to the kernel)."""
    dtype, dev = gains.dtype, gains.device
    n, p = heating_req.shape[0], _n_shots(gains, draws)

    def trace():
        return torch.empty((n, p), dtype=dtype, device=dev)

    out = [trace(), trace()] + ([trace(), trace()] if stress is None else [None, None])
    dt = params.control_dt
    args = _Args(
        *(t.data_ptr() if t is not None else None
          for t in (gains, heating_req, drift, draws, *out)),
        n_shots=p, n_ticks=n, gain_stride=0 if stress is not None else 6,
        n_delay=0 if stress is not None else params.delay_steps,
        stress=int(stress is not None), dt=dt, target_r=params.target_r,
        target_z=params.target_z, r0=params.target_r + 0.1, z0=params.target_z + 0.05,
        beta0=0.6, heating0=20.0, heat_slew=params.heating_rate_limit * dt,
        heat_max=params.heating_abs_max, pf_slew=params.pf_rate_limit * dt,
        pf_max=params.pf_abs_max, z_step=0.02 * dt,
        p_elm=stress.elm_rate_hz * dt if stress is not None else 0.0,
        elm_kick=stress.elm_kick_m if stress is not None else 0.0,
        sensor_noise=stress.sensor_noise_m if stress is not None else 0.0)
    return args, out


def reduced_shot(params, gains: torch.Tensor, heating_req: torch.Tensor, *,
                 drift: torch.Tensor | None = None, draws: torch.Tensor | None = None,
                 stress=None) -> ShotTraces:
    """Every tick of ``P`` shots (:func:`reduced_shot_plain`'s arguments):
    the traces of r, z (and beta, heating in the reduced variant), (P, n)."""
    if not gains.is_cuda:
        return reduced_shot_plain(params, gains, heating_req, drift=drift, draws=draws,
                                  stress=stress)
    check_reduced_shot(params, gains, heating_req, drift, draws, stress)
    args, out = launch_args(params, gains, heating_req, drift, draws, stress)
    cb.launch(_ENTRIES[gains.dtype], ctypes.addressof(args))
    cb.CALLS["reduced_shot"] += 1
    return ShotTraces(*(t.t() if t is not None else None for t in out))
