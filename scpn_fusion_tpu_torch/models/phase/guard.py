"""Sliding-window Lyapunov stability guard (port of
``scpn_fusion_tpu/models/phase/guard.py``).

Feed V(t) samples into a fixed-size ring buffer, estimate the finite-window
Lyapunov exponent lambda = ln(V_last/V_first)/T, count consecutive threshold
violations, and refuse after ``max_violations`` in a row.  The verdict also
exposes the sigmoid stability score 1/(1 + e^{10 lambda}).  The state is an
explicit NamedTuple of tensors; an update reads nothing back to the host.
Row U (``csrc/phase.cu``) runs the same update on the monitor's every tick.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.phase.kuramoto import lyapunov_v


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    window: int = 50
    dt: float = 1e-3
    lambda_threshold: float = 0.0
    max_violations: int = 3


class GuardState(NamedTuple):
    v_buffer: torch.Tensor     # (window,) ring of V samples, oldest first
    n_seen: torch.Tensor       # int32 total samples fed
    consecutive: torch.Tensor  # int32 consecutive violations


class GuardVerdict(NamedTuple):
    v: torch.Tensor
    lambda_exp: torch.Tensor
    approved: torch.Tensor
    consecutive_violations: torch.Tensor

    @property
    def score(self) -> torch.Tensor:
        """Stability score in [0, 1]; 1 = strongly contracting."""
        return torch.clamp(1.0 / (1.0 + torch.exp(
            torch.clamp(10.0 * self.lambda_exp, -80.0, 80.0))), 0.0, 1.0)


def init_guard(cfg: GuardConfig, dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda") -> GuardState:
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return GuardState(torch.zeros(cfg.window, dtype=dtype, device=device), zero, zero.clone())


def guard_update(cfg: GuardConfig, state: GuardState, v: torch.Tensor):
    """Feed the sample ``v`` (0-d, the buffer's dtype); returns (verdict,
    new_state)."""
    buf = torch.cat([state.v_buffer[1:], v.reshape(1)])
    n_seen = state.n_seen + 1
    n_valid = torch.clamp(n_seen, max=cfg.window)

    # lambda over the valid window: oldest valid sample vs newest.
    back = torch.clamp(cfg.window - n_valid, max=buf.shape[0] - 1)   # a gather clamps
    oldest = buf.index_select(0, back.reshape(1).long())[0]
    lam = torch.where(
        n_valid < 2, torch.zeros_like(v),
        torch.log(torch.clamp(v, min=1e-15) / torch.clamp(oldest, min=1e-15))
        / (n_valid.to(buf.dtype) * cfg.dt))

    violated = (n_valid >= 2) & (lam > cfg.lambda_threshold)
    consecutive = torch.where(violated, state.consecutive + 1, torch.zeros_like(n_seen))
    approved = consecutive < cfg.max_violations
    return GuardVerdict(v, lam, approved, consecutive), GuardState(buf, n_seen, consecutive)


def guard_check(cfg: GuardConfig, state: GuardState, theta: torch.Tensor, psi):
    """Feed one sample, V of ``theta`` against ``psi``; returns (verdict,
    new_state)."""
    return guard_update(cfg, state, lyapunov_v(theta, psi).to(state.v_buffer.dtype))


def guard_check_trajectory(cfg: GuardConfig, v_hist) -> GuardVerdict:
    """Batch verdict from a whole V(t) trajectory (reference
    ``check_trajectory``)."""
    if not isinstance(v_hist, torch.Tensor):
        v_hist = torch.as_tensor(v_hist, dtype=torch.float64)
    n = v_hist.shape[0]
    if n < 2:
        lam = torch.zeros((), dtype=v_hist.dtype, device=v_hist.device)
    else:
        lam = torch.log(torch.clamp(v_hist[-1], min=1e-15)
                        / torch.clamp(v_hist[0], min=1e-15)) / (n * cfg.dt)
    approved = lam <= cfg.lambda_threshold
    return GuardVerdict(v_hist[-1], lam, approved,
                        torch.where(approved, 0, 1).to(torch.int32))
