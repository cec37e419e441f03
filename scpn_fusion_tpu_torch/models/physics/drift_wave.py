"""2D Hasegawa-Wakatani drift-wave turbulence for edge-chaos forecasting
(port of ``scpn_fusion_tpu/models/physics/drift_wave.py``).

The two-field Hasegawa-Wakatani system for electrostatic potential ``phi``
and density fluctuation ``n`` on a doubly periodic box,

    dw/dt = -[phi, w] + alpha (phi - n) - nu k^4 w        (w = -k^2 phi)
    dn/dt = -[phi, n] + alpha (phi - n) - kappa d_y phi - nu k^4 n,

with pseudo-spectral Poisson brackets (2/3-rule de-aliased), 4th-order
hyperviscosity, RK4 time stepping, and the amplitude clamp (rescale when
max|phi_k| > 100).

The JAX package runs a trajectory as one ``lax.scan`` over ``jnp.fft``; the
port runs it as a Python loop of steps on ``torch.fft`` (cuFFT on the card;
~160 launches a step, 10 FFTs a right-hand side), the probe rows harvested
each step.  As in JAX, :func:`step` and :func:`simulate_probes` work in
float32 and complex64 whatever the state.  :func:`initial_state` draws from
a ``torch.Generator`` (its device; the state goes to ``device``); JAX's
threefry bits cannot be reproduced, so :func:`_initial_state` takes the
noise fields, and the parity tests feed it JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import linspace_like_jax

GRID = 64
BOX_L = 10.0

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


@dataclasses.dataclass(frozen=True)
class DriftWaveConfig:
    """Hasegawa-Wakatani parameters (reference module constants :20-26)."""

    n: int = GRID
    box_l: float = BOX_L
    alpha: float = 0.1      # adiabaticity
    kappa: float = 0.5      # density-gradient drive
    nu: float = 0.01        # hyperviscosity coefficient
    dt: float = 0.01        # RK4 step (reference ``local_dt`` :90)
    clamp_amp: float = 100.0
    init_noise: float = 0.01


class DriftWaveState(NamedTuple):
    phi_k: torch.Tensor   # complex spectrum (N, N)
    n_k: torch.Tensor     # complex spectrum (N, N)


class _Operators(NamedTuple):
    kx: torch.Tensor
    ky: torch.Tensor
    k2: torch.Tensor
    k2_safe: torch.Tensor
    mask: torch.Tensor
    dissip: torch.Tensor


def _fftfreq(n: int, d: float) -> np.ndarray:
    """``jnp.fft.fftfreq(n, d)`` in float64: the integer frequencies over
    ``d * n``."""
    i = np.arange(n, dtype=np.float64)
    k = (i + n // 2) % n - n // 2
    return k / np.float64(d * n)


def _operators(cfg: DriftWaveConfig, dtype=torch.float32, device="cuda") -> _Operators:
    """Spectral grids, 2/3 de-aliasing mask, and the nu*k^4 multiplier
    (reference ``__init__`` :36-49 + ``spectral_dissipation_multiplier``)."""
    k = torch.from_numpy(_fftfreq(cfg.n, cfg.box_l / (2.0 * np.pi * cfg.n))).to(dtype).to(device)
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    k2 = kx**2 + ky**2
    k2_safe = k2.clone()
    k2_safe[0, 0] = 1.0
    k_max = torch.max(torch.abs(k))
    mask = torch.where(k2 < (2.0 / 3.0 * k_max) ** 2, 1.0, 0.0).to(dtype)
    dissip = cfg.nu * k2**2   # 4th-order hyperviscosity (order // 2 = 2)
    return _Operators(kx, ky, k2, k2_safe, mask, dissip)


def _initial_state(phi_noise: torch.Tensor, n_noise: torch.Tensor,
                   cfg: DriftWaveConfig = DriftWaveConfig()) -> DriftWaveState:
    """:func:`initial_state` on given standard-normal fields (N, N)."""
    dtype = phi_noise.dtype
    ops = _operators(cfg, dtype, phi_noise.device)
    phi = cfg.init_noise * phi_noise
    n = cfg.init_noise * n_noise
    cplx = _COMPLEX[dtype]
    return DriftWaveState(
        phi_k=(torch.fft.fft2(phi) * ops.mask).to(cplx),
        n_k=(torch.fft.fft2(n) * ops.mask).to(cplx),
    )


def initial_state(generator: torch.Generator, cfg: DriftWaveConfig = DriftWaveConfig(),
                  dtype=torch.float32, device="cuda") -> DriftWaveState:
    """Random small-amplitude noise, masked (reference :50-58), drawn from
    ``generator``."""
    draw = [torch.randn((cfg.n, cfg.n), generator=generator, dtype=dtype,
                        device=generator.device) for _ in range(2)]
    return _initial_state(draw[0].to(device), draw[1].to(device), cfg)


def _bracket(a_k, b_k, ops: _Operators):
    """Poisson bracket [A, B] = dxA dyB - dyA dxB, de-aliased (reference
    ``bracket`` :60-74)."""
    dxa = torch.fft.ifft2(1j * ops.kx * a_k).real
    dya = torch.fft.ifft2(1j * ops.ky * a_k).real
    dxb = torch.fft.ifft2(1j * ops.kx * b_k).real
    dyb = torch.fft.ifft2(1j * ops.ky * b_k).real
    return torch.fft.fft2(dxa * dyb - dya * dxb) * ops.mask


def _rhs(state: DriftWaveState, cfg: DriftWaveConfig, ops: _Operators):
    """Hasegawa-Wakatani RHS in spectral space (reference ``rhs`` :92-125)."""
    p = state.phi_k * ops.mask
    n = state.n_k * ops.mask
    w = -ops.k2 * p
    coupling = cfg.alpha * (p - n)
    dw_dt = -_bracket(p, w, ops) + coupling - ops.dissip * w
    dp_dt = -dw_dt / ops.k2_safe
    origin = torch.zeros(1, dtype=torch.long, device=dp_dt.device)
    dp_dt = dp_dt.index_put((origin, origin), dp_dt.new_zeros(1))     # zero-mean potential
    dn_dt = (-_bracket(p, n, ops) + coupling
             - cfg.kappa * (1j * ops.ky * p) - ops.dissip * n)
    return DriftWaveState(dp_dt, dn_dt)


def step(state: DriftWaveState, cfg: DriftWaveConfig,
         ops: _Operators | None = None) -> DriftWaveState:
    """One RK4 step + branchless amplitude clamp (reference :127-143)."""
    if ops is None:
        ops = _operators(cfg, torch.float32, state.phi_k.device)
    dt = cfg.dt

    def add(s, k, c):
        return DriftWaveState(s.phi_k + c * k.phi_k, s.n_k + c * k.n_k)

    k1 = _rhs(state, cfg, ops)
    k2 = _rhs(add(state, k1, 0.5 * dt), cfg, ops)
    k3 = _rhs(add(state, k2, 0.5 * dt), cfg, ops)
    k4 = _rhs(add(state, k3, dt), cfg, ops)
    phi_k = state.phi_k + (dt / 6.0) * (k1.phi_k + 2 * k2.phi_k
                                        + 2 * k3.phi_k + k4.phi_k)
    n_k = state.n_k + (dt / 6.0) * (k1.n_k + 2 * k2.n_k
                                    + 2 * k3.n_k + k4.n_k)
    # Stability clamp: rescale only when max|phi_k| exceeds the cap.
    max_amp = torch.max(torch.abs(phi_k))
    scale = torch.where(max_amp > cfg.clamp_amp,
                        torch.div(torch.full_like(max_amp, cfg.clamp_amp),
                                  torch.clamp(max_amp, min=1e-30)),
                        torch.ones_like(max_amp))
    return DriftWaveState(phi_k * scale, n_k * scale)


def real_fields(state: DriftWaveState):
    """(phi, n) in real space."""
    return torch.fft.ifft2(state.phi_k).real, torch.fft.ifft2(state.n_k).real


def default_probe_indices(n: int = GRID, n_probes: int = 16, device="cuda") -> torch.Tensor:
    """Sparse-sensing probe locations (reference ``run_turbulence_oracle``
    :244 — 16 equispaced points of the flattened field): JAX's
    ``linspace(0, n*n - 1, n_probes)`` (jitted, in float64 as under x64),
    truncated to int32."""
    pts = linspace_like_jax(0.0, float(n * n - 1), n_probes, torch.float64)
    return torch.from_numpy(pts.astype(np.int32)).to(device)


def simulate_probes(state: DriftWaveState, cfg: DriftWaveConfig, probe_idx: torch.Tensor,
                    warmup: int, steps: int) -> tuple[DriftWaveState, torch.Tensor]:
    """Warm up ``warmup`` steps, then record ``steps`` probe rows (steps,
    n_probes), in float32 / complex64."""
    ops = _operators(cfg, torch.float32, state.phi_k.device)
    for _ in range(warmup):
        state = step(state, cfg, ops)
    idx = probe_idx.long()
    rows = []
    for _ in range(steps):
        state = step(state, cfg, ops)
        rows.append(torch.fft.ifft2(state.phi_k).real.reshape(-1)[idx])
    return state, torch.stack(rows)
