"""Fault-tolerant control: FDI + reconfigurable allocation (port of
``scpn_fusion_tpu/control/fault_tolerant.py``).

Covers the reference's ``control/fault_tolerant_control.py`` (``FDIMonitor``,
``ReconfigurableController``, ``FaultInjector``): Tikhonov weighted-least-
squares control allocation whose gain is rebuilt when actuators or sensors
fault -- zeroed Jacobian columns for lost coils, down-weighted rows for
degraded sensors, stuck-actuator offset compensation, a minimum-rank
controllability check, and a graceful shutdown command.

The fault condition is the state -- a :class:`FaultState` of tensors (coil
mask, sensor weights, stuck values) -- and every operation is a pure
function of it, free of host reads.  :func:`run_fault_tolerant_shot` is
JAX's one ``lax.scan`` as a Python loop over steps, with the fault schedule
(an inner ``lax.scan`` in JAX) a loop over faults; fault events are data.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Fault type codes (tensor-encodable; reference FaultType enum :22-30).
SENSOR_DROPOUT = 0
SENSOR_DRIFT = 1
SENSOR_NOISE = 2
ACTUATOR_LOSS = 3
ACTUATOR_STUCK = 4

# Sensor down-weights per fault class (reference handle_sensor_fault
# :151-184: dropout -> 0, noise -> 0.2, drift -> 0.5).
_SENSOR_WEIGHTS = (0.0, 0.5, 0.2)


class FaultState(NamedTuple):
    """Pure-tensor fault condition (reference's faulted_coils /
    faulted_sensors / stuck_values / W)."""

    coil_ok: torch.Tensor          # (n_c,) 1.0 healthy, 0.0 lost
    sensor_weight: torch.Tensor    # (n_s,) diagonal of W
    stuck_value: torch.Tensor      # (n_c,) commanded-stuck offsets


def init_fault_state(n_coils: int, n_sensors: int, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda") -> FaultState:
    kw = dict(dtype=dtype, device=device)
    return FaultState(torch.ones((n_coils,), **kw), torch.ones((n_sensors,), **kw),
                      torch.zeros((n_coils,), **kw))


def reconfig_gain(jacobian: torch.Tensor, state: FaultState,
                  lambda_reg: float = 1e-6) -> torch.Tensor:
    """Tikhonov weighted pseudo-inverse K = (J^T W J + lambda I)^-1 J^T W
    with faulted coil columns masked (reference ``_compute_gain:119-134``)."""
    j_m = jacobian * state.coil_ok[None, :]
    jtw = j_m.T * state.sensor_weight[None, :]
    n_c = jacobian.shape[1]
    h = jtw @ j_m + lambda_reg * torch.eye(n_c, dtype=jacobian.dtype, device=jacobian.device)
    k = torch.linalg.solve(h, jtw)
    return k * state.coil_ok[:, None]


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def apply_actuator_fault(state: FaultState, coil_index, kind, stuck_val=0.0) -> FaultState:
    """Mark a coil lost/stuck (reference ``handle_actuator_fault:136``).
    Index/kind may be tensors; a no-op is encoded as index < 0."""
    dev = state.coil_ok.device
    idx = _index(coil_index, dev)
    active = idx >= 0
    one_hot = (torch.arange(state.coil_ok.shape[0], device=dev) == idx) & active
    coil_ok = torch.where(one_hot, torch.zeros_like(state.coil_ok), state.coil_ok)
    stuck_val = torch.as_tensor(stuck_val, dtype=state.stuck_value.dtype, device=dev)
    stuck = torch.where(one_hot & (_index(kind, dev) == ACTUATOR_STUCK), stuck_val,
                        state.stuck_value)
    return state._replace(coil_ok=coil_ok, stuck_value=stuck)


def apply_sensor_fault(state: FaultState, sensor_index, kind) -> FaultState:
    """Down-weight a sensor row (reference ``handle_sensor_fault:151``)."""
    w0 = state.sensor_weight
    idx = _index(sensor_index, w0.device)
    active = idx >= 0
    one_hot = (torch.arange(w0.shape[0], device=w0.device) == idx) & active
    table = torch.tensor(_SENSOR_WEIGHTS, dtype=w0.dtype, device=w0.device)
    w = table[torch.clamp(_index(kind, w0.device), 0, 2)]
    return state._replace(sensor_weight=torch.where(one_hot, w, w0))


def ft_step(jacobian: torch.Tensor, state: FaultState, error: torch.Tensor,
            lambda_reg: float = 1e-6) -> torch.Tensor:
    """Coil-current correction with stuck-offset compensation
    (reference ``step:186-197``)."""
    adjusted = error - jacobian @ (state.stuck_value * (1.0 - state.coil_ok))
    du = reconfig_gain(jacobian, state, lambda_reg) @ adjusted
    return du * state.coil_ok


def controllability_ok(jacobian: torch.Tensor, state: FaultState, min_rank: int = 2,
                       rel_tol: float = 1e-6) -> torch.Tensor:
    """Minimum-rank controllability with a >half-coils-lost veto (reference
    ``controllability_check:199-208``); the rank from the singular values."""
    n_c = jacobian.shape[1]
    enough_coils = state.coil_ok.sum() >= (n_c - n_c // 2)
    s = torch.linalg.svdvals(jacobian * state.coil_ok[None, :])
    rank = (s > rel_tol * torch.clamp(s[0], min=1e-30)).sum()
    return enough_coils & (rank >= min_rank)


def graceful_shutdown(n_coils: int, dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """Zero-current safe ramp-down command (reference ``:210-212``)."""
    return torch.zeros((n_coils,), dtype=dtype, device=device)


def inject_sensor_fault(t, signals: torch.Tensor, fault_time, index, kind,
                        severity=1.0) -> torch.Tensor:
    """Corrupt a measurement vector after ``fault_time`` (reference
    ``FaultInjector.inject:226-242``): dropout zeroes the channel, drift
    adds ``severity * (t - fault_time)``."""
    dev = signals.device
    t = torch.as_tensor(t, dtype=signals.dtype, device=dev)
    active = t >= fault_time
    one_hot = (torch.arange(signals.shape[0], device=dev) == _index(index, dev)) & active
    k = _index(kind, dev)
    dropped = torch.where(one_hot & (k == SENSOR_DROPOUT), torch.zeros_like(signals), signals)
    drift = severity * torch.clamp(t - fault_time, min=0.0)
    return torch.where(one_hot & (k == SENSOR_DRIFT), signals + drift, dropped)


class FTShotTrace(NamedTuple):
    error_norm: torch.Tensor       # (T,)
    controllable: torch.Tensor     # (T,) bool
    coil_commands: torch.Tensor    # (T, n_c)


def run_fault_tolerant_shot(
    jacobian: torch.Tensor,        # (n_s, n_c) plant response
    target: torch.Tensor,          # (n_s,) setpoint
    fault_times: torch.Tensor,     # (n_f,) step indices (< 0 disables)
    fault_kinds: torch.Tensor,     # (n_f,) codes above
    fault_indices: torch.Tensor,   # (n_f,) coil or sensor index
    fault_values: torch.Tensor | None = None,  # (n_f,) stuck commands
    *,
    n_steps: int = 200,
    gain: float = 0.5,
    lambda_reg: float = 1e-6,
) -> FTShotTrace:
    """A whole faulted closed-loop shot: a linear plant y = J u_phys driven to
    ``target`` while the fault schedule fires and the allocation
    reconfigures in-loop -- lost coils go open-circuit, stuck coils hold
    their ``fault_values`` command physically."""
    n_s, n_c = jacobian.shape
    dtype, dev = jacobian.dtype, jacobian.device
    fstate = init_fault_state(n_c, n_s, dtype, dev)
    fault_times, fault_kinds, fault_indices = (_index(f, dev) for f in (
        fault_times, fault_kinds, fault_indices))
    if fault_values is None:
        fault_values = torch.zeros(fault_times.shape, dtype=dtype, device=dev)
    fault_values = torch.as_tensor(fault_values, dtype=dtype, device=dev)

    def u_phys(u, fs):
        """Physical coil vector: healthy coils follow the command, a lost
        coil is open-circuit (0), a stuck coil holds its frozen command."""
        return u * fs.coil_ok + fs.stuck_value * (1.0 - fs.coil_ok)

    u = torch.zeros((n_c,), dtype=dtype, device=dev)
    rows = []
    for t in range(n_steps):
        # Fire any scheduled fault whose time matches this step.
        for f_t, f_kind, f_idx, f_val in zip(fault_times, fault_kinds, fault_indices,
                                             fault_values):
            hit = (f_t == t) & (f_t >= 0)
            idx = torch.where(hit, f_idx, -1)
            is_act = (f_kind == ACTUATOR_LOSS) | (f_kind == ACTUATOR_STUCK)
            fstate = apply_actuator_fault(fstate, torch.where(is_act, idx, -1), f_kind,
                                          stuck_val=f_val)
            fstate = apply_sensor_fault(fstate, torch.where(is_act, -1, idx), f_kind)
        # The measured error carries the stuck coil's physical contribution
        # through u_phys, so plain reconfigured feedback is the in-loop law
        # (ft_step's offset compensation is the one-shot allocation form).
        err = target - jacobian @ u_phys(u, fstate)
        du = gain * (reconfig_gain(jacobian, fstate, lambda_reg) @ err)
        u = u + du * fstate.coil_ok
        err2 = target - jacobian @ u_phys(u, fstate)
        ok = controllability_ok(jacobian, fstate)
        rows.append((torch.linalg.vector_norm(err2), ok, du))
    errs, oks, dus = (torch.stack(col) for col in zip(*rows))
    return FTShotTrace(errs, oks, dus)
