"""Disruption prediction: windowed features -> MLP risk -> alarm runtime
(port of ``scpn_fusion_tpu/control/disruption.py``).

Sliding-window features are one gather, the classifier is the shared MLP
(``models/surrogates/mlp``) trained with its Adam loop, and whole-shot risk
traces are one batched forward pass.  The alarm runtime (threshold +
consecutive-tick confirmation + latching) is a Python loop over ticks of ops
over every shot and threshold at once, where JAX ``vmap``s a ``lax.scan``.

The draws rule: :func:`train_disruption_predictor` draws the initial
weights and the minibatches from a ``torch.Generator``;
:func:`_train_disruption_predictor` takes the initial parameters and the
minibatch indices.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.surrogates.mlp import (
    MLPParams,
    _train_mlp,
    batch_indices,
    init_mlp,
    mlp_apply,
)


def extract_window_features(signals: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window features, (..., T, C) -> (..., T - window + 1, 3C):
    per-channel mean, std and linear trend over the trailing window."""
    t_len = signals.shape[-2]
    n_win = t_len - window + 1
    dev = signals.device
    idx = torch.arange(n_win, device=dev)[:, None] + torch.arange(window, device=dev)[None, :]
    win = signals[..., idx, :]                         # (..., n_win, window, C)
    mean = win.mean(dim=-2)
    std = win.std(dim=-2, unbiased=False)
    x = torch.arange(window, dtype=signals.dtype, device=dev) - (window - 1) / 2.0
    denom = (x * x).sum()
    trend = torch.einsum("w,...nwc->...nc", x, win) / denom
    return torch.cat([mean, std, trend], dim=-1)


class DisruptionPredictor(NamedTuple):
    mlp: MLPParams
    x_mean: torch.Tensor
    x_std: torch.Tensor
    window: int

    def risk(self, signals: torch.Tensor) -> torch.Tensor:
        """Per-tick disruption risk in [0, 1], (..., T, C) -> (..., n_win)."""
        feats = extract_window_features(signals, self.window)
        xn = (feats - self.x_mean) / self.x_std
        lead = xn.shape[:-1]
        logits = mlp_apply(self.mlp, xn.reshape(-1, xn.shape[-1]))[:, 0]
        return torch.sigmoid(logits.reshape(lead))


def window_dataset(shots: torch.Tensor, labels: torch.Tensor, window: int,
                   pre_disruption_ticks: int):
    """(normalised features (N * n_win, 3C), scaled targets (N * n_win, 1),
    x_mean, x_std) of :func:`train_disruption_predictor`."""
    feats = extract_window_features(shots, window)
    n_win = feats.shape[1]
    tick_label = torch.arange(n_win, device=shots.device) >= n_win - pre_disruption_ticks
    y = (labels[:, None] * tick_label[None, :]).to(feats.dtype)
    x = feats.reshape(-1, feats.shape[-1])
    y = y.reshape(-1, 1)
    x_mean = x.mean(0)
    x_std = torch.clamp(x.std(0, unbiased=False), min=1e-9)
    return (x - x_mean) / x_std, 6.0 * (y - 0.5), x_mean, x_std


def train_disruption_predictor(shots: torch.Tensor, labels: torch.Tensor,
                               generator: torch.Generator, *, window: int = 16,
                               pre_disruption_ticks: int = 32, hidden: tuple = (64, 64),
                               n_steps: int = 3000, lr: float = 1e-3) -> DisruptionPredictor:
    """Train on per-tick windows; in disruptive shots the last
    ``pre_disruption_ticks`` windows are positive, everything else negative.
    The MSE trainer fits logits to the {0, 1} targets scaled to {-3, +3}."""
    c = shots.shape[-1]
    params0 = init_mlp(generator, (3 * c,) + tuple(hidden) + (1,), dtype=shots.dtype,
                       device=shots.device)
    n_rows = shots.shape[0] * (shots.shape[1] - window + 1)
    idx = batch_indices(generator, n_steps, min(512, n_rows), n_rows, shots.device)
    return _train_disruption_predictor(shots, labels, params0, idx, window=window,
                                       pre_disruption_ticks=pre_disruption_ticks, lr=lr)


def _train_disruption_predictor(shots: torch.Tensor, labels: torch.Tensor, params0: MLPParams,
                                batch_idx: torch.Tensor, *, window: int = 16,
                                pre_disruption_ticks: int = 32,
                                lr: float = 1e-3) -> DisruptionPredictor:
    """:func:`train_disruption_predictor` from ``params0`` with the
    (n_steps, batch) indices given."""
    xn, yt, x_mean, x_std = window_dataset(shots, labels, window, pre_disruption_ticks)
    res = _train_mlp(params0, xn, yt, batch_idx, lr=lr)
    return DisruptionPredictor(res.params, x_mean, x_std, window)


@dataclasses.dataclass(frozen=True)
class AlarmConfig:
    threshold: float = 0.7
    confirm_ticks: int = 3


class AlarmTrace(NamedTuple):
    alarm: torch.Tensor             # (T,) bool, latched
    first_alarm_tick: torch.Tensor  # int32, -1 if never


def _latched(risk: torch.Tensor, threshold, confirm_ticks: int) -> torch.Tensor:
    """The latched alarm of every trace, (..., T) -> (..., T) bool: a streak
    of ticks above ``threshold`` (broadcast against ``risk[..., 0]``) of
    ``confirm_ticks`` latches it."""
    above = risk > threshold
    streak = torch.zeros(above.shape[:-1], dtype=torch.int32, device=risk.device)
    latched = torch.zeros(above.shape[:-1], dtype=torch.bool, device=risk.device)
    out = []
    for k in range(above.shape[-1]):
        streak = torch.where(above[..., k], streak + 1, torch.zeros_like(streak))
        latched = latched | (streak >= confirm_ticks)
        out.append(latched)
    return torch.stack(out, dim=-1)


def _first(alarm: torch.Tensor) -> torch.Tensor:
    """First latched tick along the last axis, -1 where none (int32)."""
    fired = alarm.any(-1)
    first = torch.argmax(alarm.to(torch.int8), dim=-1)
    return torch.where(fired, first, torch.full_like(first, -1)).to(torch.int32)


def run_alarm(risk: torch.Tensor, cfg: AlarmConfig) -> AlarmTrace:
    """Threshold + consecutive-confirmation + latching alarm runtime."""
    alarm = _latched(risk, cfg.threshold, cfg.confirm_ticks)
    return AlarmTrace(alarm, _first(alarm))


def alarm_threshold_sweep(risks: torch.Tensor, thresholds: torch.Tensor,
                          confirm_ticks: int = 3):
    """The alarm runtime over a (K,) threshold grid and (N, T) risk traces:
    ``fired (K, N) bool`` and ``first_tick (K, N) int32`` (-1 when the
    alarm never fires), with :func:`run_alarm`'s semantics."""
    alarm = _latched(risks[None, :, :], thresholds[:, None, None], confirm_ticks)
    return alarm.any(-1), _first(alarm)


def evaluate_predictor(predictor: DisruptionPredictor, shots: torch.Tensor,
                       labels: torch.Tensor, cfg: AlarmConfig = AlarmConfig()):
    """Shot-level recall / false-positive-rate (the reference's metric)."""
    fired = _first(_latched(predictor.risk(shots), cfg.threshold, cfg.confirm_ticks)) >= 0
    pos = labels > 0.5
    recall = (fired & pos).sum() / torch.clamp(pos.sum(), min=1)
    fpr = (fired & ~pos).sum() / torch.clamp((~pos).sum(), min=1)
    return {"recall": recall, "fpr": fpr, "fired": fired}
