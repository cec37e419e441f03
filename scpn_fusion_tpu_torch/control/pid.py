"""PID controller as a pure function with explicit state (port of
``scpn_fusion_tpu/control/pid.py``).

Fail-safe on a non-finite error: the integrator is not accumulated and a
zero command is returned, so one NaN can never latch the error sum.  The
state is two 0-d tensors on one device; an error that is a Python number or
a tensor elsewhere is moved to the state's device first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PIDGains(NamedTuple):
    kp: torch.Tensor
    ki: torch.Tensor
    kd: torch.Tensor


class PIDState(NamedTuple):
    err_sum: torch.Tensor
    last_err: torch.Tensor


def pid_init(dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda") -> PIDState:
    zero = torch.zeros((), dtype=dtype, device=device)
    return PIDState(zero, zero.clone())


def pid_step(gains: PIDGains, state: PIDState, error):
    """One PID update; returns (new_state, command)."""
    dev = state.err_sum.device
    error = torch.as_tensor(error, dtype=None if isinstance(error, torch.Tensor)
                            else state.err_sum.dtype, device=dev)
    ok = torch.isfinite(error)
    err = torch.where(ok, error, 0.0)
    err_sum = state.err_sum + err          # err is 0 where the error is not finite
    d_err = err - state.last_err
    cmd = gains.kp * err + gains.ki * err_sum + gains.kd * d_err
    cmd = torch.where(ok, cmd, 0.0)
    new_state = PIDState(
        err_sum=torch.where(ok, err_sum, state.err_sum),
        last_err=torch.where(ok, err, state.last_err),
    )
    return new_state, cmd
