"""Reduced 2D Hall-MHD discovery sandbox: tearing drive, sweeps, threshold
(port of ``scpn_fusion_tpu/models/physics/hall_mhd_discovery.py``).

Doubly-periodic pseudo-spectral reduced Hall-MHD for (phi, psi) with
magnetic flutter, the Hall term (rho_s^2 [J, psi]), hyper-viscosity,
2/3-rule dealiasing, an optional static current sheet ``psi_0 = A cos(x)`` as
the tearing-mode drive, RK2 stepping, zonal-flow diagnostics, an (eta, nu)
growth-rate sweep and the bisection for the marginal resistivity of the
driven sheet.

The JAX package runs each trajectory as a ``lax.scan`` of ``jnp.fft`` calls
(its own calls, outside any Pallas kernel); the port runs it as a Python
loop of ``torch.fft`` calls (cuFFT on the card) and plain ops, ~210 launches
a step.  The sweep's ``vmap`` is a batch dimension: every (eta, nu) pair of
the grid steps together, ``fft2`` over the last two axes.  The bisection
keeps its bounds on the device (``torch.where``), one simulation a round.

Dtypes: float64 runs in complex128, float32 in complex64.  The draws rule:
:func:`init_hall_mhd`, :func:`parameter_sweep` and
:func:`find_tearing_threshold` draw the two (n, n) normals from a
``torch.Generator``; :func:`_init_hall_mhd`, :func:`_parameter_sweep` and
:func:`_find_tearing_threshold` take them as a tensor (the CPU tests feed
them JAX's).  The functions of numbers take ``dtype`` (float32 by default)
and ``device`` (``"cuda"`` by default); the others follow their state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace

GRID = 64
L_BOX = 2.0 * math.pi
DT = 5.0e-3
RHO_S = 0.1      # Hall scale (Larmor radius)
BETA = 0.01      # plasma beta

class HallMHDState(NamedTuple):
    phi_k: torch.Tensor     # complex (..., N, N)
    psi_k: torch.Tensor     # complex (..., N, N)


class HallMHDTrace(NamedTuple):
    total_energy: torch.Tensor    # (n_steps,) (then the sweep's batch)
    zonal_energy: torch.Tensor    # (n_steps,)
    final: HallMHDState


def _spectral_setup(n: int, dtype, device):
    """(kx, ky, k^2 with k^2[0, 0] = 1, the 2/3-rule mask) of ``dtype``,
    ``jnp.fft.fftfreq``'s wavenumbers: the integer index over ``d n``."""
    d = float(L_BOX) / (2.0 * math.pi * n)
    i = torch.arange(n, dtype=dtype, device=device)
    k = ((i + n // 2) % n - n // 2) / torch.tensor(d * n, dtype=dtype, device=device)
    kx, ky = torch.meshgrid(k, k, indexing="xy")
    k2 = kx**2 + ky**2
    k2[0, 0] = 1.0
    mask = torch.where(k2 < (2.0 / 3.0 * k.max()) ** 2, 1.0, 0.0).to(dtype)
    return kx, ky, k2, mask


def _init_hall_mhd(normals: torch.Tensor, *, noise: float = 1e-3) -> HallMHDState:
    """The initial perturbation (reference ``__init__:118-152``) from the two
    (n, n) standard normals ``normals`` (2, n, n)."""
    _, _, _, mask = _spectral_setup(normals.shape[-1], normals.dtype, normals.device)
    return HallMHDState(torch.fft.fft2(noise * normals[0]) * mask,
                        torch.fft.fft2(noise * normals[1]) * mask)


def init_hall_mhd(generator: torch.Generator, n: int = GRID, *, background_amplitude=0.0,
                  noise: float = 1e-3, dtype: torch.dtype | None = None,
                  device: torch.device | str = "cuda") -> HallMHDState:
    """Seeded random initial perturbation: two (n, n) normals drawn from
    ``generator`` (on the CPU) and moved to ``device``.  ``background_amplitude``
    is accepted and unused, as in the JAX package."""
    dtype = dtype or torch.float32
    normals = torch.randn((2, n, n), generator=generator, dtype=dtype)
    return _init_hall_mhd(normals.to(device), noise=noise)


def background_flux_k(n: int, amplitude, *, dtype: torch.dtype | None = None,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """Static current sheet ``psi_0 = A cos(x)`` (tearing drive), in Fourier
    space; x is ``jnp.linspace(0, L, n, endpoint=False)``."""
    dtype = dtype or torch.float32
    _, _, _, mask = _spectral_setup(n, dtype, device)
    x = linspace(0.0, float(L_BOX), n + 1, dtype, device)[:-1]
    xx, _ = torch.meshgrid(x, x, indexing="xy")
    return torch.fft.fft2(amplitude * torch.cos(xx)) * mask


def _bracket(a_k, b_k, kx, ky, mask):
    """Dealiased spectral Poisson bracket [A, B] (reference ``:167-190``)."""
    dxa = torch.fft.ifft2(1j * kx * a_k)
    dya = torch.fft.ifft2(1j * ky * a_k)
    dxb = torch.fft.ifft2(1j * kx * b_k)
    dyb = torch.fft.ifft2(1j * ky * b_k)
    return torch.fft.fft2(dxa * dyb - dya * dxb) * mask


def _rhs(state: HallMHDState, psi0_k, eta, nu, kx, ky, k2, mask) -> HallMHDState:
    """dU/dt = -[phi,U] + beta [J_tot, psi_tot] - nu k^4 U;
    dpsi/dt = -[phi, psi_tot] + rho_s^2 [J_tot, psi_tot] - eta k^2 psi
    (only the perturbation is resistively dissipated; reference
    ``dynamics:192-236``)."""
    phi, psi = state
    psi_tot = psi + psi0_k
    u = -k2 * phi
    j_tot = -k2 * psi_tot

    c_phi_u = _bracket(phi, u, kx, ky, mask)
    c_j_psi = _bracket(j_tot, psi_tot, kx, ky, mask)
    c_phi_psi = _bracket(phi, psi_tot, kx, ky, mask)

    du = -c_phi_u + BETA * c_j_psi - nu * k2**2 * u
    dpsi = -c_phi_psi + RHO_S**2 * c_j_psi - eta * k2 * psi
    dphi = -du / k2
    dphi[..., 0, 0] = 0.0
    return HallMHDState(dphi, dpsi)


def run_hall_mhd(state0: HallMHDState, *, eta=1e-4, nu=1e-4, background_amplitude=0.0,
                 n_steps: int = 200, n: int = GRID, dt: float = DT) -> HallMHDTrace:
    """RK2 trajectory (reference ``step:238-263``) on the device and in the
    dtype of ``state0``; ``eta`` and ``nu`` may carry a batch shape (..., 1,
    1) that the state takes on (the sweep's grid)."""
    real = state0.phi_k.real.dtype
    dev = state0.phi_k.device
    kx, ky, k2, mask = _spectral_setup(n, real, dev)
    psi0_k = background_flux_k(n, background_amplitude, dtype=real, device=dev)
    zonal_mask = (ky.abs() < 1e-9) & (kx.abs() > 1e-9)
    s, tot, zon = state0, [], []
    for _ in range(n_steps):
        d1 = _rhs(s, psi0_k, eta, nu, kx, ky, k2, mask)
        mid = HallMHDState(s.phi_k + 0.5 * dt * d1.phi_k, s.psi_k + 0.5 * dt * d1.psi_k)
        d2 = _rhs(mid, psi0_k, eta, nu, kx, ky, k2, mask)
        s = HallMHDState(s.phi_k + dt * d2.phi_k, s.psi_k + dt * d2.psi_k)
        e = s.phi_k.abs() ** 2
        tot.append(e.sum(dim=(-2, -1)))
        zon.append(torch.where(zonal_mask, e, 0.0).sum(dim=(-2, -1)))
    return HallMHDTrace(torch.stack(tot), torch.stack(zon), s)


def _late_growth(energy: torch.Tensor, tail: int) -> torch.Tensor:
    """Mean late-time log-slope over the first axis (reference ``:294-300``)."""
    e = torch.clamp(energy[-tail:], min=1e-30)
    return torch.diff(torch.log(e), dim=0).mean(dim=0)


def _parameter_sweep(normals: torch.Tensor, eta_range=(1e-5, 1e-3), nu_range=(1e-5, 1e-3), *,
                     n_points: int = 5, sim_steps: int = 200, background_amplitude=1.0,
                     n: int = GRID):
    """:func:`parameter_sweep` from the initial draws ``normals`` (2, n, n)."""
    dtype, dev = normals.dtype, normals.device
    etas = linspace(eta_range[0], eta_range[1], n_points, dtype, dev)
    nus = linspace(nu_range[0], nu_range[1], n_points, dtype, dev)
    ee, nn = torch.meshgrid(etas, nus, indexing="ij")
    ee, nn = ee.reshape(-1), nn.reshape(-1)
    state0 = _init_hall_mhd(normals)
    tr = run_hall_mhd(state0, eta=ee[:, None, None], nu=nn[:, None, None],
                      background_amplitude=background_amplitude, n_steps=sim_steps, n=n)
    return ee, nn, _late_growth(tr.total_energy, 10)


def parameter_sweep(generator: torch.Generator, eta_range=(1e-5, 1e-3), nu_range=(1e-5, 1e-3),
                    *, n_points: int = 5, sim_steps: int = 200, background_amplitude=1.0,
                    n: int = GRID, dtype: torch.dtype | None = None,
                    device: torch.device | str = "cuda"):
    """(eta, nu) growth-rate map (reference ``parameter_sweep:265-304``): every
    pair of the grid one batch of driven simulations.  Returns (etas, nus,
    growth) flattened over the n_points^2 grid."""
    normals = torch.randn((2, n, n), generator=generator, dtype=dtype or torch.float32)
    return _parameter_sweep(normals.to(device), eta_range, nu_range, n_points=n_points,
                            sim_steps=sim_steps, background_amplitude=background_amplitude, n=n)


def _find_tearing_threshold(normals: torch.Tensor, eta_range=(1e-6, 1e-2), *,
                            n_bisect: int = 10, sim_steps: int = 500,
                            background_amplitude=1.0, n: int = GRID) -> dict:
    """:func:`find_tearing_threshold` from the initial draws ``normals`` (2, n, n)."""
    state0 = _init_hall_mhd(normals)
    lo, hi = (torch.tensor(v, dtype=normals.dtype, device=normals.device) for v in eta_range)
    for _ in range(n_bisect):
        mid = torch.sqrt(lo * hi)
        tr = run_hall_mhd(state0, eta=mid, background_amplitude=background_amplitude,
                          n_steps=sim_steps, n=n)
        still_growing = _late_growth(tr.total_energy, 20) > 0.0
        lo, hi = torch.where(still_growing, mid, lo), torch.where(still_growing, hi, mid)
    return {"threshold_eta": torch.sqrt(lo * hi), "lo": lo, "hi": hi}


def find_tearing_threshold(generator: torch.Generator, eta_range=(1e-6, 1e-2), *,
                           n_bisect: int = 10, sim_steps: int = 500, background_amplitude=1.0,
                           n: int = GRID, dtype: torch.dtype | None = None,
                           device: torch.device | str = "cuda") -> dict:
    """Geometric-mean bisection for the marginal resistivity of the driven
    current sheet (reference ``find_tearing_threshold:306-345``): growth
    above the marginal eta is suppressed by resistive dissipation of the
    perturbation.  An empirical sandbox threshold, not a literature-parity
    tearing-rate claim.  One full simulation a round, the bounds on the
    device."""
    normals = torch.randn((2, n, n), generator=generator, dtype=dtype or torch.float32)
    return _find_tearing_threshold(normals.to(device), eta_range, n_bisect=n_bisect,
                                   sim_steps=sim_steps,
                                   background_amplitude=background_amplitude, n=n)
