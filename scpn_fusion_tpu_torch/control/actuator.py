"""First-order actuator model: lag + slew + saturation + delay + fail-safe
(port of ``scpn_fusion_tpu/control/actuator.py``).

First-order lag ``u += dt/(tau+dt) (cmd - u)``, coil-current rate limit,
absolute saturation, pure transport delay via a fixed ring buffer, and the
fail-safe hold: a non-finite command never poisons the actuator state (the
last valid state is held and the fault is counted).  The ring buffer is
written out of place, as JAX's ``.at[].set`` is.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ActuatorParams:
    tau_s: float
    dt_s: float
    u_min: float = -5.0e4
    u_max: float = 5.0e4
    rate_limit: float = 1.0e6
    delay_steps: int = 0

    def __post_init__(self) -> None:
        if not self.tau_s > 0:
            raise ValueError("tau_s must be > 0")
        if not self.dt_s > 0:
            raise ValueError("dt_s must be > 0")
        if self.delay_steps < 0:
            raise ValueError("delay_steps must be >= 0")


class ActuatorState(NamedTuple):
    u: torch.Tensor           # applied state
    delay_buf: torch.Tensor   # (delay_steps+1,) ring buffer
    cursor: torch.Tensor      # int32
    faults: torch.Tensor      # int32


def actuator_init(params: ActuatorParams, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> ActuatorState:
    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)
    return ActuatorState(
        u=torch.zeros((), dtype=dtype, device=device),
        delay_buf=torch.zeros((params.delay_steps + 1,), dtype=dtype, device=device),
        cursor=i32(),
        faults=i32(),
    )


def actuator_step(params: ActuatorParams, state: ActuatorState, command):
    """Apply one command; returns (new_state, applied_output).

    The output is the delayed applied state (pure transport delay of
    ``delay_steps`` ticks); with zero delay it is the new state itself.
    """
    dev = state.u.device
    command = torch.as_tensor(command, dtype=None if isinstance(command, torch.Tensor)
                              else state.u.dtype, device=dev)
    ok = torch.isfinite(command)
    cmd = torch.clamp(torch.where(ok, command, state.u), params.u_min, params.u_max)
    alpha = params.dt_s / (params.tau_s + params.dt_s)
    u_new = state.u + alpha * (cmd - state.u)
    du = torch.clamp(u_new - state.u,
                     -params.rate_limit * params.dt_s,
                     params.rate_limit * params.dt_s)
    u_new = torch.where(ok, state.u + du, state.u)

    buf = state.delay_buf.clone()
    buf[state.cursor.long()] = u_new.to(buf.dtype)
    n = buf.shape[0]
    cursor = (state.cursor + 1) % n
    # oldest entry = delayed output, in the promoted type, as ``jnp.where`` gives it
    out = (buf[cursor.long()] if params.delay_steps > 0 else u_new).to(
        torch.promote_types(buf.dtype, u_new.dtype))
    return ActuatorState(
        u=u_new,
        delay_buf=buf,
        cursor=cursor,
        faults=state.faults + (~ok).to(torch.int32),
    ), out
