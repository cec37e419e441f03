"""NEF-style spiking control channel (port of
``scpn_fusion_tpu/control/nef_snn.py``; nengo-wrapper parity, nengo-free).

LIF membrane dynamics with exact per-step integration
``V(t+dt) = J + (V - J) exp(-dt/tau_rc)`` and refractory clamping, analytic
steady-state rates with Tikhonov NEF decoders (``torch.linalg.solve``), and
a control channel (error population -> gain decoder -> control population
-> identity decoder, low-pass synapses between stages) whose trajectory is
a Python loop of ticks where JAX runs one ``lax.scan``.  The populations
are built from a numpy ``Generator`` exactly as in the JAX package, so both
packages hold the same neurons.

``nengo_available()`` reports the optional upstream package honestly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch


def nengo_available() -> bool:
    try:
        import nengo  # noqa: F401
        return True
    except ImportError:
        return False


@dataclasses.dataclass(frozen=True)
class NefConfig:
    """Channel knobs (reference ``NengoSNNConfig`` :46-61)."""

    n_neurons: int = 64
    dt: float = 1e-3
    tau_mem: float = 0.02          # tau_rc
    tau_ref: float = 0.002
    tau_synapse: float = 0.01
    max_rate_hz: float = 200.0
    intercept_lo: float = -0.9
    intercept_hi: float = 0.9
    gain: float = 1.0
    seed: int = 0


class LIFParams(NamedTuple):
    alpha: torch.Tensor       # (n,) NEF gain
    j_bias: torch.Tensor      # (n,)
    encoders: torch.Tensor    # (n,) +-1


class LIFState(NamedTuple):
    voltage: torch.Tensor
    ref_time: torch.Tensor


def make_lif_population(cfg: NefConfig, rng: np.random.Generator, dtype=torch.float32,
                        device: torch.device | str = "cuda") -> LIFParams:
    """NEF gain/bias from per-neuron (max_rate, intercept)."""
    n = cfg.n_neurons
    max_rates = rng.uniform(cfg.max_rate_hz * 0.5, cfg.max_rate_hz, n)
    intercepts = rng.uniform(cfg.intercept_lo, cfg.intercept_hi, n)
    encoders = rng.choice([-1.0, 1.0], n)
    j_max = 1.0 / (1.0 - np.exp((cfg.tau_ref - 1.0 / max_rates)
                                / cfg.tau_mem))
    alpha = (j_max - 1.0) / (1.0 - intercepts)
    j_bias = 1.0 - alpha * intercepts

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return LIFParams(alpha=t(alpha), j_bias=t(j_bias), encoders=t(encoders))


def lif_init(cfg: NefConfig, dtype=torch.float32,
             device: torch.device | str = "cuda") -> LIFState:
    z = torch.zeros((cfg.n_neurons,), dtype=dtype, device=device)
    return LIFState(voltage=z, ref_time=z)


def lif_step(cfg: NefConfig, pop: LIFParams, state: LIFState, x):
    """One exact-integration LIF step; returns (state, spike rates)."""
    j = pop.alpha * pop.encoders * x + pop.j_bias
    delta = torch.clamp(cfg.dt - state.ref_time, 0.0, cfg.dt)
    v = j + (state.voltage - j) * torch.exp(-delta / cfg.tau_mem)
    spiked = v >= 1.0
    v = torch.where(spiked, torch.zeros_like(v), v)
    ref = torch.where(spiked, torch.full_like(v, cfg.tau_ref), state.ref_time)
    ref = torch.clamp(ref - cfg.dt, min=0.0)
    rates = spiked.to(v.dtype) / cfg.dt
    return LIFState(voltage=v, ref_time=ref), rates


def steady_rates(cfg: NefConfig, pop: LIFParams, x_eval: torch.Tensor) -> torch.Tensor:
    """Analytic steady-state firing rates, shape (n, len(x_eval))."""
    j = (pop.alpha[:, None] * pop.encoders[:, None] * x_eval[None, :]
         + pop.j_bias[:, None])
    ok = j > 1.0
    safe_j = torch.where(ok, j, torch.full_like(j, 2.0))
    inv = torch.div(torch.ones_like(safe_j), safe_j)
    period = cfg.tau_ref - cfg.tau_mem * torch.log1p(-inv)
    rates = torch.div(torch.ones_like(period), period)
    return torch.where(ok, rates, torch.zeros_like(rates))


def nef_decoder(cfg: NefConfig, pop: LIFParams, fn, *, n_eval: int = 200,
                reg: float = 0.1) -> torch.Tensor:
    """Tikhonov least-squares decoder for fn(x) (LstsqL2 parity)."""
    x = torch.linspace(-1.0, 1.0, n_eval, dtype=pop.alpha.dtype, device=pop.alpha.device)
    a = steady_rates(cfg, pop, x)
    y = fn(x)
    aat = a @ a.T
    gamma = n_eval * reg * torch.clamp(a.max(), min=1e-10) ** 2
    eye = torch.eye(pop.alpha.shape[0], dtype=a.dtype, device=a.device)
    return torch.linalg.solve(aat + gamma * eye, a @ y)


class NefChannel(NamedTuple):
    """One control channel: error pop -> gain -> control pop -> output."""

    error_pop: LIFParams
    control_pop: LIFParams
    d_gain: torch.Tensor
    d_id: torch.Tensor


def make_channel(cfg: NefConfig, dtype=torch.float32,
                 device: torch.device | str = "cuda") -> NefChannel:
    rng = np.random.default_rng(cfg.seed)
    err_pop = make_lif_population(cfg, rng, dtype, device)
    ctl_pop = make_lif_population(cfg, rng, dtype, device)
    d_gain = nef_decoder(cfg, err_pop, lambda x: cfg.gain * x)
    d_id = nef_decoder(cfg, ctl_pop, lambda x: x)
    return NefChannel(error_pop=err_pop, control_pop=ctl_pop, d_gain=d_gain, d_id=d_id)


class ChannelState(NamedTuple):
    err_lif: LIFState
    ctl_lif: LIFState
    syn_in: torch.Tensor
    syn_mid: torch.Tensor
    syn_out: torch.Tensor


def channel_init(cfg: NefConfig, dtype=torch.float32,
                 device: torch.device | str = "cuda") -> ChannelState:
    z = torch.zeros((), dtype=dtype, device=device)
    return ChannelState(err_lif=lif_init(cfg, dtype, device), ctl_lif=lif_init(cfg, dtype, device),
                        syn_in=z, syn_mid=z, syn_out=z)


def _lowpass(y, x, tau, dt):
    a = math.exp(-dt / tau)
    return a * y + (1.0 - a) * x


def channel_step(cfg: NefConfig, ch: NefChannel, state: ChannelState, x):
    """One channel tick: synapse -> spikes -> decode -> synapse -> ..."""
    syn_in = _lowpass(state.syn_in, x, cfg.tau_synapse, cfg.dt)
    err_lif, err_spikes = lif_step(cfg, ch.error_pop, state.err_lif, syn_in)
    decoded = ch.d_gain @ err_spikes
    syn_mid = _lowpass(state.syn_mid, decoded, cfg.tau_synapse, cfg.dt)
    ctl_lif, ctl_spikes = lif_step(cfg, ch.control_pop, state.ctl_lif, syn_mid)
    out_raw = ch.d_id @ ctl_spikes
    syn_out = _lowpass(state.syn_out, out_raw, cfg.tau_synapse, cfg.dt)
    new_state = ChannelState(err_lif=err_lif, ctl_lif=ctl_lif, syn_in=syn_in, syn_mid=syn_mid,
                             syn_out=syn_out)
    return new_state, syn_out


def run_channel(cfg: NefConfig, ch: NefChannel, x_trace: torch.Tensor, *,
                n_steps: int | None = None) -> torch.Tensor:
    """Whole channel trajectory, a tick of ``x_trace`` at a time; returns the
    output trace."""
    state = channel_init(cfg, x_trace.dtype, x_trace.device)
    out = []
    for x in x_trace:
        state, y = channel_step(cfg, ch, state, x)
        out.append(y)
    return torch.stack(out)
