"""Rotating-magnetic-field (RMF) current drive + phase-lock control (port of
``scpn_fusion_tpu/control/rmf.py``).

A reduced RMF-FRC coupling model -- the electron fluid spun up by the
rotating field's torque against ion-electron friction -- and a PI
phase-locked loop that keeps the antenna phase locked to the (measured)
rotation angle.  The JAX package runs each as one ``lax.scan``; the port runs
each as a plain loop of 0-d ops (20,000 and 5,000 ticks at the defaults), on
``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class RMFParams:
    b_rmf_mt: float = 2.0          # RMF amplitude
    omega_rmf_hz: float = 100e3    # drive frequency
    spin_up_rate: float = 3e4      # torque coefficient [1/(s mT)]
    friction_rate: float = 2e4     # e-i friction relaxation [1/s]
    dt_s: float = 1e-7
    n_steps: int = 20000


class RMFTrace(NamedTuple):
    omega_e_hz: torch.Tensor        # electron rotation frequency history
    sync_fraction: torch.Tensor     # omega_e / omega_rmf at end
    drive_efficiency: torch.Tensor  # average torque duty
    synchronised: torch.Tensor


def run_rmf_spinup(p: RMFParams, *, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> RMFTrace:
    """Electron spin-up under RMF torque vs friction: the normalised rotation
    x = omega_e / omega_rmf relaxes as ``dx/dt = nu_d (1 - x) - nu_f x`` with
    ``nu_d = spin_up_rate * B_rmf`` (steady state nu_d / (nu_d + nu_f))."""
    nu_d = p.spin_up_rate * p.b_rmf_mt
    x = torch.zeros((), dtype=dtype, device=device)
    omega, torque = [], []
    for _ in range(p.n_steps):
        tq = nu_d * (1.0 - x)
        x = torch.clamp(x + p.dt_s * (tq - p.friction_rate * x), 0.0, 1.0)
        omega.append(x * p.omega_rmf_hz)
        torque.append(tq)
    omega_hz, torque = torch.stack(omega), torch.stack(torque)
    sync = omega_hz[-1] / torch.tensor(p.omega_rmf_hz, dtype=dtype, device=device)
    duty = torch.mean(torque) / torch.tensor(max(nu_d, 1e-30), dtype=dtype, device=device)
    return RMFTrace(omega_e_hz=omega_hz, sync_fraction=sync, drive_efficiency=duty,
                    synchronised=sync > 0.85)


@dataclasses.dataclass(frozen=True)
class PLLParams:
    kp_hz_per_rad: float = 2e3
    ki_hz_per_rad_s: float = 2e6
    dt_s: float = 1e-5
    n_steps: int = 5000


class PLLTrace(NamedTuple):
    phase_error: torch.Tensor
    antenna_freq_hz: torch.Tensor
    locked: torch.Tensor            # sustained |error| < 0.15 rad over the last 5%
    lock_time_s: torch.Tensor


def run_phase_lock(pll: PLLParams, *, rotation_hz: float = 95e3, antenna_hz0: float = 100e3,
                   freq_drift_hz_s: float = 0.0, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> PLLTrace:
    """PI phase-locked loop steering the antenna onto the rotation angle
    (incl. a drifting target); the lock time is the first tick after which
    the loop stays locked (``inf`` when it never does)."""
    # the drifting target's phase advance of every tick, elementwise as JAX's tick computes it
    f_rot = rotation_hz + freq_drift_hz_s * torch.arange(pll.n_steps, dtype=dtype,
                                                         device=device) * pll.dt_s
    d_rot = 2.0 * math.pi * f_rot * pll.dt_s
    theta_rot = torch.zeros((), dtype=dtype, device=device)
    theta_ant = torch.zeros((), dtype=dtype, device=device)
    f_base = torch.tensor(antenna_hz0, dtype=dtype, device=device)
    errs, cmds = [], []
    for k in range(pll.n_steps):
        theta_rot = theta_rot + d_rot[k]
        slip = theta_rot - theta_ant
        err = torch.atan2(torch.sin(slip), torch.cos(slip))
        # PI in frequency: the integral lives in the base frequency itself
        f_base = f_base + pll.ki_hz_per_rad_s * err * pll.dt_s
        f_cmd = f_base + pll.kp_hz_per_rad * err
        theta_ant = theta_ant + 2.0 * math.pi * f_cmd * pll.dt_s
        errs.append(err)
        cmds.append(f_cmd)
    err, f_cmd = torch.stack(errs), torch.stack(cmds)
    locked_mask = torch.abs(err) < 0.15
    # first index after which the loop STAYS locked
    ever_unlocked_after = torch.cumsum((~locked_mask).flip(0).to(torch.int32), 0).flip(0)
    stays = ever_unlocked_after == 0
    t_first = torch.argmax(stays.to(torch.uint8)).to(dtype) * pll.dt_s
    t_lock = torch.where(torch.any(stays), t_first,
                         torch.full((), math.inf, dtype=dtype, device=device))
    tail = max(pll.n_steps // 20, 1)
    locked = torch.all(locked_mask[-tail:])
    return PLLTrace(phase_error=err, antenna_freq_hz=f_cmd, locked=locked, lock_time_s=t_lock)
