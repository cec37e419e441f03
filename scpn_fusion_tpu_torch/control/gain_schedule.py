"""Gain-scheduled PID bank with hysteretic regime detection (port of
``scpn_fusion_tpu/control/gain_schedule.py``).

Six discharge regimes (ramp-up, L-mode, L-H transition, H-mode, ramp-down,
disruption mitigation), a hysteresis detector over a rolling history buffer,
and a PID bank with bumpless linear gain interpolation during regime
switches.  The regime bank is a stacked (n_regimes, n_ch) tensor bundle and
the detector/controller state an explicit ``ScheduleState``, so a step is
branch-free tensor arithmetic, as in the JAX package.  Scalar inputs (``t``,
``dt``, ``dip_dt``, ``tau_e``, ``p_disrupt``) may be numbers: they take the
state's float type, as JAX's weakly typed scalars do.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.scenario import interp

# Regime codes (the regime is an int32 tensor).
RAMP_UP = 0
L_MODE_FLAT = 1
LH_TRANSITION = 2
H_MODE_FLAT = 3
RAMP_DOWN = 4
DISRUPTION_MITIGATION = 5
N_REGIMES = 6


@dataclasses.dataclass(frozen=True)
class DetectorThresholds:
    ramp_rate: float = 0.1          # |dIp/dt| above which we are ramping
    tau_e_l_mode: float = 1.0       # L-mode confinement reference [s]
    tau_e_jump: float = 1.5        # H-mode threshold multiplier
    disruption_prob: float = 0.8
    history_len: int = 5


class GainBank(NamedTuple):
    """Stacked per-regime PID gains and setpoints, shape (N_REGIMES, n_ch)."""

    kp: torch.Tensor
    ki: torch.Tensor
    kd: torch.Tensor
    x_ref: torch.Tensor


class ScheduleState(NamedTuple):
    regime: torch.Tensor         # int32 current regime
    prev_regime: torch.Tensor    # int32
    switch_time: torch.Tensor    # float (-1 = never switched)
    history: torch.Tensor        # (history_len,) int32 raw detections
    integral: torch.Tensor       # (n_ch,)
    prev_error: torch.Tensor     # (n_ch,)


def init_schedule_state(n_ch: int, history_len: int = 5, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda") -> ScheduleState:
    i32 = dict(dtype=torch.int32, device=device)
    return ScheduleState(
        torch.tensor(RAMP_UP, **i32), torch.tensor(RAMP_UP, **i32),
        torch.tensor(-1.0, dtype=dtype, device=device),
        torch.full((history_len,), RAMP_UP, **i32),
        torch.zeros((n_ch,), dtype=dtype, device=device),
        torch.zeros((n_ch,), dtype=dtype, device=device))


def detect_regime(th: DetectorThresholds, history: torch.Tensor, dip_dt, tau_e, p_disrupt):
    """Hysteretic classification (reference ``RegimeDetector.detect``): the
    raw detection enters a rolling buffer; the committed regime only changes
    when the buffer is unanimous."""
    def code(c):
        return torch.tensor(c, dtype=torch.int32, device=history.device)

    raw = torch.where(
        p_disrupt > th.disruption_prob, code(DISRUPTION_MITIGATION),
        torch.where(dip_dt > th.ramp_rate, code(RAMP_UP),
                    torch.where(dip_dt < -th.ramp_rate, code(RAMP_DOWN),
                                torch.where(tau_e > th.tau_e_jump * th.tau_e_l_mode,
                                            code(H_MODE_FLAT), code(L_MODE_FLAT)))))
    history = torch.cat([history[1:], raw[None]])
    unanimous = (history == raw).all()
    committed = torch.where(unanimous, raw, history[0])
    return committed, history


def schedule_step(th: DetectorThresholds, bank: GainBank, state: ScheduleState,
                  x: torch.Tensor, t, dt, *, dip_dt, tau_e, p_disrupt,
                  tau_switch: float = 0.5):
    """One detector + bumpless-PID step; returns (u, new_state)."""
    ftype, dev = state.switch_time.dtype, state.switch_time.device
    t, dip_dt, tau_e, p_disrupt = (torch.as_tensor(v, dtype=ftype, device=dev)
                                   for v in (t, dip_dt, tau_e, p_disrupt))
    detected, history = detect_regime(th, state.history, dip_dt, tau_e, p_disrupt)
    switched = detected != state.regime
    prev_regime = torch.where(switched, state.regime, state.prev_regime)
    regime = detected
    switch_time = torch.where(switched, t, state.switch_time)
    # Disruption mitigation entry resets the integrator (anti-windup).
    integral = torch.where(switched & (detected == DISRUPTION_MITIGATION),
                           torch.zeros_like(state.integral), state.integral)

    # Bumpless interpolation old -> new over tau_switch.
    in_blend = (switch_time >= 0) & (t - switch_time < tau_switch)
    alpha = torch.where(in_blend, (t - switch_time) / tau_switch, torch.ones_like(t))

    def blend(table):
        old = table[prev_regime]
        new = table[regime]
        return (1.0 - alpha) * old + alpha * new

    kp, ki, kd, x_ref = (blend(bank.kp), blend(bank.ki), blend(bank.kd), blend(bank.x_ref))

    error = x_ref - x
    integral = integral + error * dt
    derror = (error - state.prev_error) / max(dt, 1e-6)
    u = kp * error + ki * integral + kd * derror

    return u, ScheduleState(regime, prev_regime, switch_time, history, integral, error)


class Waveform(NamedTuple):
    """Piecewise-linear scenario waveform: value(t) by interp over knots."""

    times: torch.Tensor
    values: torch.Tensor

    def __call__(self, t):
        """The waveform at ``t``; a number takes the knots' float type, as a
        weakly typed JAX scalar does."""
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(t, dtype=self.times.dtype, device=self.times.device)
        dtype = torch.promote_types(t.dtype, self.times.dtype)
        return interp(t.to(dtype), self.times.to(dtype), self.values)


def iter_baseline_waveforms(dtype: torch.dtype = torch.float32,
                            device: torch.device | str = "cuda") -> dict:
    """ITER-like baseline scenario (reference ``iter_baseline_schedule``):
    Ip ramp to 15 MA, density ramp, heating staircase (float32, as JAX's)."""
    def w(times, values):
        return Waveform(torch.tensor(times, dtype=dtype, device=device),
                        torch.tensor(values, dtype=dtype, device=device))

    return {
        "ip_ma": w([0., 80., 100., 500., 560., 600.], [0.5, 15., 15., 15., 2., 0.]),
        "n_e_19": w([0., 100., 150., 500., 600.], [1., 8., 10., 10., 2.]),
        "p_aux_mw": w([0., 90., 110., 500., 520.], [0., 20., 50., 50., 0.]),
    }
