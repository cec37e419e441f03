"""Push-pull spiking-population axis control (port of
``scpn_fusion_tpu/control/neuro_cybernetic.py``).

Each population is a vector of membrane potentials, the spike-count window
a rolling buffer, and the shot -- both R/Z push-pull brains (4 populations),
the reduced R/Z plant and the vertical-rate interlock -- a Python loop of
ticks where JAX runs one ``lax.scan``.  JAX runs the shot in float32
(``pool_init``'s default and ``jnp.float32`` initial positions); the port
takes the dtype, float32 by default.

The draws rule: :func:`run_neuro_cybernetic_shot` draws each tick's
membrane noise, (n_ticks, 4, n_neurons) standard normals for the R-push,
R-pull, Z-push and Z-pull populations, from a ``torch.Generator``;
:func:`_run_neuro_cybernetic_shot` takes them, so a test can feed it JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class LIFPoolParams:
    """Push-pull population configuration."""

    n_neurons: int = 50
    gain: float = 10.0
    tau_window: int = 20
    dt_s: float = 1.0e-3
    tau_mem_s: float = 15.0e-3
    noise_std: float = 0.02
    i_scale: float = 5.0
    i_bias: float = 0.1
    v_threshold: float = 0.35
    v_reset: float = 0.0

    def __post_init__(self) -> None:
        if self.n_neurons < 1:
            raise ValueError("n_neurons must be >= 1")
        if self.tau_window < 1:
            raise ValueError("tau_window must be >= 1")
        if self.dt_s <= 0.0 or self.tau_mem_s <= 0.0:
            raise ValueError("dt_s and tau_mem_s must be > 0")

    @property
    def alpha(self) -> float:
        return self.dt_s / self.tau_mem_s


class PoolState(NamedTuple):
    v_pos: torch.Tensor     # (n,) membrane potentials
    v_neg: torch.Tensor
    hist_pos: torch.Tensor  # (window,) spike counts
    hist_neg: torch.Tensor
    cursor: int


def pool_init(p: LIFPoolParams, dtype=torch.float32,
              device: torch.device | str = "cuda") -> PoolState:
    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return PoolState(zeros(p.n_neurons), zeros(p.n_neurons), zeros(p.tau_window),
                     zeros(p.tau_window), 0)


def _population_step(p: LIFPoolParams, v, i_in, normals):
    """Leaky integrate-and-fire sweep of one population with its noise given."""
    noise = p.noise_std * normals
    v = v + p.alpha * (-v + i_in + noise)
    fired = v >= p.v_threshold
    v = torch.where(fired, torch.full_like(v, p.v_reset), v)
    return v, fired.to(v.dtype).sum()


def pool_step(p: LIFPoolParams, state: PoolState, error, normals_pos, normals_neg):
    """One push-pull tick: rectified error drives the two populations;
    returns ``(state, command, (rate_pos, rate_neg))``."""
    i_pos = p.i_bias + torch.clamp(error, min=0.0) * p.i_scale
    i_neg = p.i_bias + torch.clamp(-error, min=0.0) * p.i_scale
    v_pos, n_pos = _population_step(p, state.v_pos, i_pos, normals_pos)
    v_neg, n_neg = _population_step(p, state.v_neg, i_neg, normals_neg)
    hist_pos, hist_neg = state.hist_pos.clone(), state.hist_neg.clone()
    hist_pos[state.cursor] = n_pos
    hist_neg[state.cursor] = n_neg
    cursor = (state.cursor + 1) % p.tau_window
    denom = float(p.tau_window * p.n_neurons)
    rate_pos = hist_pos.sum() / denom
    rate_neg = hist_neg.sum() / denom
    command = (rate_pos - rate_neg) * p.gain
    return PoolState(v_pos, v_neg, hist_pos, hist_neg, cursor), command, (rate_pos, rate_neg)


class NeuroShotTrace(NamedTuple):
    r: torch.Tensor
    z: torch.Tensor
    err_r: torch.Tensor
    err_z: torch.Tensor
    ctrl_r: torch.Tensor
    ctrl_z: torch.Tensor
    spike_rate: torch.Tensor
    position_allowed: torch.Tensor


def run_neuro_cybernetic_shot(generator: torch.Generator, *, n_ticks: int = 200,
                              brain_r: LIFPoolParams = LIFPoolParams(gain=10.0),
                              brain_z: LIFPoolParams = LIFPoolParams(gain=20.0),
                              dtype=torch.float32, device: torch.device | str = "cuda",
                              **kwargs):
    """The spiking-control shot (keywords as :func:`_run_neuro_cybernetic_shot`),
    its membrane noise drawn from ``generator``."""
    if brain_r.n_neurons != brain_z.n_neurons:
        raise ValueError("the R and Z brains draw one noise block: equal n_neurons")
    normals = torch.randn((n_ticks, 4, brain_r.n_neurons), generator=generator,
                          dtype=dtype).to(device)
    return _run_neuro_cybernetic_shot(normals, brain_r=brain_r, brain_z=brain_z, **kwargs)


def _run_neuro_cybernetic_shot(normals: torch.Tensor, *,
                               brain_r: LIFPoolParams = LIFPoolParams(gain=10.0),
                               brain_z: LIFPoolParams = LIFPoolParams(gain=20.0),
                               target_r: float = 6.2, target_z: float = 0.0, r0: float = 6.0,
                               z0: float = 0.3, dt: float = 0.05, beta: float = 1.0,
                               vertical_limit_m_s: float = 1.0, actuation_gain: float = 0.04):
    """Whole spiking-control shot with the (n_ticks, 4, n) membrane noise
    given, in its dtype on its device.  The vertical channel passes through
    a position interlock: when |dZ/dt| exceeds ``vertical_limit_m_s`` the
    position move is inhibited and the tick is recorded as disallowed.
    Returns ``(trace, metrics)``.  (JAX's ``stochastic`` flag only picks
    which draws are made; the draws are the caller's here.)"""
    dtype, dev = normals.dtype, normals.device
    br, bz = pool_init(brain_r, dtype, dev), pool_init(brain_z, dtype, dev)
    r, z, z_prev = (torch.tensor(v, dtype=dtype, device=dev) for v in (r0, z0, z0))
    rows = []
    for k in range(normals.shape[0]):
        err_r = target_r - r
        err_z = target_z - z
        br, ctrl_r, (rp_r, rn_r) = pool_step(brain_r, br, err_r, normals[k, 0], normals[k, 1])
        bz, ctrl_z, (rp_z, rn_z) = pool_step(brain_z, bz, err_z, normals[k, 2], normals[k, 3])
        dz_dt = (z - z_prev) / dt
        allowed = dz_dt.abs() <= vertical_limit_m_s
        ctrl_z_eff = torch.where(allowed, ctrl_z, torch.zeros_like(ctrl_z))
        r_new = torch.clamp(r + (0.01 * beta + actuation_gain * ctrl_r) * dt, 2.0, 10.0)
        z_new = torch.clamp(z + (0.02 + actuation_gain * ctrl_z_eff) * dt, -6.0, 6.0)
        rate = 0.25 * (rp_r + rn_r + rp_z + rn_z)
        rows.append((r_new, z_new, err_r, err_z, ctrl_r, ctrl_z_eff, rate, allowed))
        r, z, z_prev = r_new, z_new, z
    trace = NeuroShotTrace(*(torch.stack(col) for col in zip(*rows)))
    metrics = {
        "final_r": trace.r[-1],
        "final_z": trace.z[-1],
        "mean_abs_err_r": trace.err_r.abs().mean(),
        "mean_abs_err_z": trace.err_z.abs().mean(),
        "final_abs_err_r": trace.err_r[-1].abs(),
        "final_abs_err_z": trace.err_z[-1].abs(),
        "mean_spike_rate": trace.spike_rate.mean(),
        "safety_position_allow_rate": trace.position_allowed.to(torch.float32).mean(),
        "safety_interlock_trips": (~trace.position_allowed).sum(),
    }
    return trace, metrics
