"""Local electromagnetic Maxwell evolution evidence for nonlinear GK
(port of ``scpn_fusion_tpu/models/gyrokinetics/maxwell_evolution.py``).

Covers the reference's ``core/gk_maxwell_evolution.py``: a source-free
perpendicular spectral Maxwell system for ``A_parallel`` plus a
compressional ``B_parallel`` component, audited against Faraday induction,
the Ampere-Maxwell displacement current, the inductive parallel electric
field relation ``E_par = -dA/dt`` and the perpendicular magnetic divergence
constraint -- with the same claim boundary: it is *not* a Vlasov-Maxwell
parity claim (``self_consistent_kinetic_current_supported=False``).

Each spectral mode evolves as a closed-form harmonic oscillator
(``omega = c k_perp``), so the whole history is one broadcast evaluation
over a ``(n_steps, n_kx, n_ky)`` tensor.  The initial modes are numpy draws
from ``config.seed``, the JAX module's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

C_LIGHT = 299_792_458.0
EPSILON_0 = 8.854_187_8128e-12
MU_0_SI = 1.256_637_06212e-6
_TINY = 1.0e-300


@dataclass(frozen=True)
class MaxwellEvolutionConfig:
    """Source-free local spectral Maxwell evolution configuration
    (reference ``MaxwellEvolutionConfig:33-50``)."""

    n_kx: int = 8
    n_ky: int = 8
    n_steps: int = 16
    dt: float = 1.0e-12
    lx_m: float = 1.0
    ly_m: float = 1.0
    seed: int = 23
    amplitude_a_parallel: float = 1.0e-9
    amplitude_e_parallel: float = 1.0e-2
    amplitude_b_parallel: float = 1.0e-8
    amplitude_e_perpendicular: float = 1.0e-2
    courant_limit: float = 0.2
    relative_energy_tolerance: float = 1.0e-11
    residual_tolerance: float = 1.0e-12


class MaxwellEvolutionResult(NamedTuple):
    """Per-step diagnostics (tensors; host decoration in
    :func:`to_evidence`)."""

    time_s: torch.Tensor
    phi_energy_t: torch.Tensor
    a_parallel_energy_t: torch.Tensor
    b_parallel_energy_t: torch.Tensor
    electric_parallel_energy_t: torch.Tensor
    electric_perpendicular_energy_t: torch.Tensor
    total_field_energy_t: torch.Tensor
    faraday_linf_residual_t: torch.Tensor
    ampere_maxwell_linf_residual_t: torch.Tensor
    inductive_e_parallel_linf_residual_t: torch.Tensor
    magnetic_divergence_linf_residual_t: torch.Tensor
    relative_total_field_energy_drift: torch.Tensor


def _spectral_grid(config: MaxwellEvolutionConfig, device: torch.device | str):
    if config.n_kx < 2 or config.n_ky < 2:
        raise ValueError("Maxwell evolution requires at least two kx and ky modes")
    if config.n_steps < 2:
        raise ValueError("Maxwell evolution requires at least two saved steps")
    if config.dt <= 0.0 or config.lx_m <= 0.0 or config.ly_m <= 0.0:
        raise ValueError("Maxwell evolution requires positive dt and domain lengths")
    kx = 2.0 * np.pi * np.fft.fftfreq(config.n_kx, d=config.lx_m / config.n_kx)
    ky = 2.0 * np.pi * np.fft.fftfreq(config.n_ky, d=config.ly_m / config.n_ky)
    kxg, kyg = np.meshgrid(kx, ky, indexing="ij")
    k_perp = np.hypot(kxg, kyg)
    max_omega_dt = float(C_LIGHT * k_perp.max() * config.dt)
    if max_omega_dt > config.courant_limit:
        raise ValueError(
            "Courant limit violated for local Maxwell evolution: "
            f"max(c k_perp dt)={max_omega_dt:.6e}, "
            f"limit={config.courant_limit:.6e}")
    return tuple(torch.as_tensor(a, device=device) for a in (kxg, kyg, k_perp))


def _random_complex_modes(rng, shape, amplitude, device: torch.device | str = "cuda"):
    modes = amplitude * (rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape)) / np.sqrt(2.0)
    modes[0, 0] = 0.0
    return torch.as_tensor(modes, device=device)


def _linf(num, scale):
    return torch.amax(num / torch.clamp(scale, min=_TINY), dim=(1, 2))


def _evolve(kx, ky, k_perp, a0, e0, b0, c0, *, n_steps: int, dt: float
            ) -> MaxwellEvolutionResult:
    """All timesteps in one broadcast evaluation: leading axis is time."""
    omega = C_LIGHT * k_perp
    pos = k_perp > 0.0
    inv_omega = torch.where(pos, 1.0 / torch.where(pos, omega, torch.ones_like(omega)),
                            torch.zeros_like(omega))
    t = torch.arange(n_steps, dtype=k_perp.dtype, device=k_perp.device) * dt
    phase = t[:, None, None] * omega[None, :, :]
    cos_p, sin_p = torch.cos(phase), torch.sin(phase)

    a = a0 * cos_p - e0 * inv_omega * sin_p
    e_par = e0 * cos_p + omega * a0 * sin_p
    da_dt = -e_par
    d2a_dt2 = -(omega**2) * a
    b_par = b0 * cos_p - c0 / C_LIGHT * sin_p
    e_perp = c0 * cos_p + C_LIGHT * b0 * sin_p

    bx = 1j * ky * a
    by = -1j * kx * a
    dbx_dt = 1j * ky * da_dt
    dby_dt = -1j * kx * da_dt

    faraday_x = dbx_dt + 1j * ky * e_par
    faraday_y = dby_dt - 1j * kx * e_par
    ampere = d2a_dt2 + omega**2 * a
    inductive = e_par + da_dt
    div_b = 1j * kx * bx + 1j * ky * by

    faraday_scale = torch.maximum(
        torch.maximum(torch.abs(dbx_dt), torch.abs(dby_dt)),
        torch.maximum(torch.abs(kx * e_par), torch.abs(ky * e_par)))
    faraday_res = _linf(torch.maximum(torch.abs(faraday_x), torch.abs(faraday_y)),
                        faraday_scale)
    ampere_res = _linf(torch.abs(ampere),
                       torch.maximum(torch.abs(d2a_dt2), torch.abs(omega**2 * a)))
    inductive_res = _linf(torch.abs(inductive),
                          torch.maximum(torch.abs(e_par), torch.abs(da_dt)))
    div_res = _linf(torch.abs(div_b),
                    torch.maximum(torch.abs(kx * bx), torch.abs(ky * by)))

    e_par_energy = 0.5 * EPSILON_0 * torch.sum(torch.abs(e_par)**2, dim=(1, 2))
    a_energy = 0.5 / MU_0_SI * torch.sum(torch.abs(bx)**2 + torch.abs(by)**2,
                                         dim=(1, 2))
    b_energy = 0.5 / MU_0_SI * torch.sum(torch.abs(b_par)**2, dim=(1, 2))
    e_perp_energy = 0.5 * EPSILON_0 * torch.sum(torch.abs(e_perp)**2, dim=(1, 2))
    total = e_par_energy + a_energy + b_energy + e_perp_energy
    drift = torch.max(torch.abs(total - total[0])) / torch.clamp(
        torch.abs(total[0]), min=_TINY)

    return MaxwellEvolutionResult(
        time_s=t,
        phi_energy_t=torch.zeros_like(t),
        a_parallel_energy_t=a_energy,
        b_parallel_energy_t=b_energy,
        electric_parallel_energy_t=e_par_energy,
        electric_perpendicular_energy_t=e_perp_energy,
        total_field_energy_t=total,
        faraday_linf_residual_t=faraday_res,
        ampere_maxwell_linf_residual_t=ampere_res,
        inductive_e_parallel_linf_residual_t=inductive_res,
        magnetic_divergence_linf_residual_t=div_res,
        relative_total_field_energy_drift=drift)


def run_local_maxwell_evolution(
    config: MaxwellEvolutionConfig = MaxwellEvolutionConfig(),
    device: torch.device | str = "cuda",
) -> MaxwellEvolutionResult:
    """Run the source-free local spectral Maxwell evolution
    (reference ``run_local_maxwell_evolution:158``) on ``device``."""
    kx, ky, k_perp = _spectral_grid(config, device)
    rng = np.random.default_rng(config.seed)
    shape = (config.n_kx, config.n_ky)
    a0 = _random_complex_modes(rng, shape, config.amplitude_a_parallel, device)
    e0 = _random_complex_modes(rng, shape, config.amplitude_e_parallel, device)
    b0 = _random_complex_modes(rng, shape, config.amplitude_b_parallel, device)
    c0 = _random_complex_modes(rng, shape, config.amplitude_e_perpendicular, device)
    return _evolve(kx, ky, k_perp, a0, e0, b0, c0,
                   n_steps=config.n_steps, dt=config.dt)


def to_evidence(result: MaxwellEvolutionResult,
                config: MaxwellEvolutionConfig) -> dict[str, object]:
    """JSON-serialisable fail-closed evidence record
    (reference ``MaxwellEvolutionResult.to_evidence:82-116``)."""
    max_faraday = float(torch.max(result.faraday_linf_residual_t))
    max_ampere = float(torch.max(result.ampere_maxwell_linf_residual_t))
    max_inductive = float(torch.max(result.inductive_e_parallel_linf_residual_t))
    max_div = float(torch.max(result.magnetic_divergence_linf_residual_t))
    drift = float(result.relative_total_field_energy_drift)
    accepted = (drift <= config.relative_energy_tolerance
                and max_faraday <= config.residual_tolerance
                and max_ampere <= config.residual_tolerance
                and max_inductive <= config.residual_tolerance
                and max_div <= config.residual_tolerance)
    return {
        "schema": "gk-maxwell-evolution.v1",
        "saved_steps": int(result.time_s.shape[0]),
        "max_faraday_linf_residual": max_faraday,
        "max_ampere_maxwell_linf_residual": max_ampere,
        "max_inductive_e_parallel_linf_residual": max_inductive,
        "max_magnetic_divergence_linf_residual": max_div,
        "max_relative_total_field_energy_drift": drift,
        "relative_energy_tolerance": config.relative_energy_tolerance,
        "residual_tolerance": config.residual_tolerance,
        "faraday_induction_supported": True,
        "ampere_maxwell_displacement_current_supported": True,
        "inductive_parallel_electric_field_supported": True,
        "magnetic_divergence_constraint_supported": True,
        "self_consistent_kinetic_current_supported": False,
        "status": ("accepted_local_source_free_maxwell_evolution" if accepted
                   else "blocked_local_maxwell_evolution_residuals_failed"),
    }
