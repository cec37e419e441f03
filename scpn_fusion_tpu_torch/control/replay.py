"""Shot replay pipeline: sensor preprocessing + actuator lag + predictor
(port of ``scpn_fusion_tpu/control/replay.py``).

Archived-shot signals are resampled onto the control grid, median-filtered
and robustly clipped, scored by the disruption predictor and alarmed, and a
mitigation command is passed through the first-order actuator lag from the
first alarm tick.  The lag is a Python loop over ticks of every command
column at once, where JAX ``vmap``s a ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.disruption import AlarmConfig, DisruptionPredictor, run_alarm


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    control_dt_s: float = 1e-3
    median_window: int = 5          # odd; median prefilter length
    # Outlier clip in robust-sigma (MAD) units: wide, so that it catches
    # hardware spikes and not physics excursions.
    clip_sigma: float = 30.0
    actuator_tau_s: float = 20e-3   # first-order actuator lag
    alarm: AlarmConfig = AlarmConfig()

    def __post_init__(self):
        if self.median_window % 2 == 0 or self.median_window < 1:
            raise ValueError("median_window must be odd and >= 1")


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp``: piecewise-linear, clamped to the end values."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    df, dx = f1 - f0, x1 - x0
    delta = x - x0
    eps = torch.finfo(xp.dtype).eps ** 2     # np.spacing(eps), as jnp.interp
    flat = dx.abs() <= eps
    f = torch.where(flat, f0, f0 + (delta / torch.where(flat, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def resample_to_control_grid(t_s: torch.Tensor, signal: torch.Tensor, dt_s: float,
                             n_out: int) -> torch.Tensor:
    """Linear resample onto the uniform control grid."""
    t_out = torch.arange(n_out, device=t_s.device).to(t_s.dtype) * dt_s + t_s[0]
    return interp(t_out, t_s, signal)


def median_prefilter(x: torch.Tensor, window: int) -> torch.Tensor:
    """Running-median despike (edge-padded, static, odd window); a window
    holding a NaN gives NaN, as ``jnp.median``."""
    if window <= 1:
        return x
    half = window // 2
    padded = torch.cat([x[:1].expand(half), x, x[-1:].expand(half)])
    win = padded.unfold(0, window, 1)
    med = win.sort(dim=-1).values[:, half]
    return torch.where(torch.isnan(win).any(-1), torch.full_like(med, float("nan")), med)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a vector: the median of the finite-or-inf
    entries, the mean of the two middle ones for an even count."""
    v = x[~torch.isnan(x)].sort().values
    n = v.shape[0]
    return v[(n - 1) // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def robust_clip(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Clip at median +- sigma * (1.4826 MAD); NaNs -> median."""
    med = _nanmedian(x)
    mad = _nanmedian((x - med).abs()) * 1.4826
    lo, hi = med - sigma * mad, med + sigma * mad
    x = torch.where(torch.isfinite(x), x, med)
    return torch.clamp(x, lo, hi)


def preprocess_channel(t_s: torch.Tensor, raw: torch.Tensor, cfg: ReplayConfig,
                       n_out: int) -> torch.Tensor:
    x = resample_to_control_grid(t_s, raw, cfg.control_dt_s, n_out)
    x = median_prefilter(x, cfg.median_window)
    return robust_clip(x, cfg.clip_sigma)


def actuator_lag(command: torch.Tensor, dt_s: float, tau_s: float) -> torch.Tensor:
    """First-order lag y' = (u - y)/tau over the command trace, along the
    first axis (every further axis a column of its own)."""
    alpha = dt_s / (tau_s + dt_s)
    y = command[0]
    out = []
    for u in command:
        y = y + alpha * (u - y)
        out.append(y)
    return torch.stack(out)


class ReplayResult(NamedTuple):
    risk: torch.Tensor            # (n,) per-tick disruption risk
    alarm_latched: torch.Tensor   # (n,) bool
    warning_time_s: torch.Tensor  # time between first alarm and shot end
    actuated: torch.Tensor        # (n, n_act) lagged mitigation commands
    tripped: torch.Tensor         # scalar bool


def replay_shot(predictor: DisruptionPredictor, cfg: ReplayConfig, t_s: torch.Tensor,
                signals: torch.Tensor,
                mitigation_command: torch.Tensor | None = None) -> ReplayResult:
    """Replay one archived shot: signals (n_channels, n_raw) on the archive
    time base are preprocessed per channel, scored, alarmed, and (optionally)
    a mitigation command is passed through the actuator lag from the first
    alarm tick."""
    duration = float(t_s[-1] - t_s[0])
    n_out = max(int(duration / cfg.control_dt_s), cfg.median_window + predictor.window + 1)
    clean = torch.stack([preprocess_channel(t_s, signals[i], cfg, n_out)
                         for i in range(signals.shape[0])])
    risk = predictor.risk(clean.T)          # (n_out - window + 1,)
    alarm = run_alarm(risk, cfg.alarm)
    latched = alarm.alarm
    tripped = latched.any()
    first = torch.argmax(latched.to(torch.int8)).to(risk.dtype) * cfg.control_dt_s
    t_first = torch.where(tripped, first, torch.full_like(first, float("inf")))
    warning = torch.clamp(duration - t_first, min=0.0)
    if mitigation_command is None:
        mitigation_command = torch.ones((risk.shape[0], 1), dtype=risk.dtype, device=risk.device)
    cmd = mitigation_command * latched[:, None]
    actuated = actuator_lag(cmd, cfg.control_dt_s, cfg.actuator_tau_s)
    return ReplayResult(risk=risk, alarm_latched=latched, warning_time_s=warning,
                        actuated=actuated, tripped=tripped)
