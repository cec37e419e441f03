"""Quasi-3D physics contracts: cross-subsystem validation-grade coupling
(port of ``scpn_fusion_tpu/models/physics/quasi3d.py``).

Synthetic SOLPS-like toroidal heat-flux references derived from JET
G-EQDSK data, axisymmetric-vs-stellarator force-balance observables,
Hall-MHD zonal-ratio estimation, a toroidal-poloidal force-residual
relaxation, electron-ion two-fluid evolution coupled to TEMHD surface
cooling, divertor heat-load profile construction, and TBR calibration
against erosion trend curves.

As in the JAX package, each profile point carries its own TEMHD column; the
port steps all of them as one batch a step (one launch of row T on the
card, as ``nuclear.temhd.temhd_flux_scan``), the two-fluid relaxation and
the force-residual relaxation as Python loops of plain ops.  The asymmetry
observables come from ``torch.fft.rfft`` over the toroidal angle of the
flux-surface geometry.  The SOLPS surrogate and the G-EQDSK statistics are
NumPy, as in the JAX package.

Draws: :func:`quasi_3d_force_balance` draws its sample angles, and
:func:`hall_mhd_zonal_ratio` its initial perturbation, from a
``torch.Generator``; :func:`_quasi_3d_force_balance` takes ``theta`` and
``phi`` and :func:`_hall_mhd_zonal_ratio` the two normals (the CPU tests
feed them JAX's).  Entry points take ``dtype`` (float32 by default; JAX
takes its float from the x64 flag) and ``device``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import as_tensors, linspace, xla_mean
from scpn_fusion_tpu_torch.core.stats import percentile
from scpn_fusion_tpu_torch.models.nuclear.blanket import BlanketConfig, volumetric_tbr
from scpn_fusion_tpu_torch.models.nuclear.pwi import SputteringMaterial, erosion_rate
from scpn_fusion_tpu_torch.models.nuclear.temhd import TEMHDParams, TEMHDState, temhd_step
from scpn_fusion_tpu_torch.models.physics.divertor_lab import temhd_liquid_metal_state
from scpn_fusion_tpu_torch.models.physics.hall_mhd_discovery import (
    _init_hall_mhd,
    run_hall_mhd,
)
from scpn_fusion_tpu_torch.models.physics.stellarator import StellaratorConfig

# ── SOLPS-like JET reference profile ─────────────────────────────────────


def jet_solps_reference_profile(geqdsk_stats: list[dict[str, float]],
                                toroidal_points: int = 48) -> tuple[np.ndarray, dict[str, Any]]:
    """Deterministic SOLPS-surrogate toroidal heat-flux profile from JET
    equilibrium statistics (amplitude from edge psi gradient and q95,
    low-order toroidal harmonics with per-file phases).

    ``geqdsk_stats``: one dict per equilibrium with keys ``q95``,
    ``edge_gradient``, ``bcentr`` — extract with
    :func:`geqdsk_profile_stats` from a parsed G-EQDSK.
    """
    if toroidal_points < 16:
        raise ValueError("toroidal_points must be >= 16.")
    if not geqdsk_stats:
        raise ValueError("geqdsk_stats must be non-empty.")
    angles = np.linspace(0.0, 2.0 * np.pi, toroidal_points, endpoint=False)
    profiles = []
    for i, st in enumerate(geqdsk_stats):
        q95 = float(st["q95"])
        eg = float(st["edge_gradient"])
        bc = abs(float(st["bcentr"]))
        amp = 8.0e5 * (1.0 + 3.2 * eg) * (1.0 + 0.03 * (q95 - 4.0))
        phase = 0.17 * i
        prof = amp * (1.0
                      + 0.14 * np.cos(angles - phase)
                      + 0.05 * np.cos(2.0 * angles + 0.6 * phase)
                      + 0.03 * np.sin(angles + 0.2 * bc))
        profiles.append(np.clip(prof, 5.0e4, None))
    ref = np.mean(np.stack(profiles), axis=0)
    meta = {
        "jet_file_count": len(profiles),
        "mean_q95": float(np.mean([s["q95"] for s in geqdsk_stats])),
        "mean_edge_gradient": float(np.mean([s["edge_gradient"] for s in geqdsk_stats])),
    }
    return ref, meta


def geqdsk_profile_stats(eq) -> dict[str, float]:
    """Extract the (q95, edge_gradient, bcentr) statistics the SOLPS
    surrogate needs from a parsed G-EQDSK."""
    psi_mid = np.asarray(eq.psirz[eq.nh // 2, :], float)
    denom = float(eq.sibry - eq.simag)
    if not np.isfinite(denom) or abs(denom) < 1e-12:
        raise ValueError("degenerate psi span")
    psi_norm = np.clip((psi_mid - float(eq.simag)) / denom, 0.0, 1.2)
    edge_grad = float(np.mean(np.abs(np.gradient(psi_norm)[-8:])))
    q = np.asarray(eq.qpsi, float)
    if q.size > 0 and np.all(np.isfinite(q)):
        q95 = float(abs(q[min(q.size - 1, int(0.95 * (q.size - 1)))]))
    else:
        q95 = 4.2
    return {"q95": q95, "edge_gradient": edge_grad, "bcentr": float(eq.bcentr)}


# ── Quasi-3D force balance observables ───────────────────────────────────


def _surface_points(cfg: StellaratorConfig, s: torch.Tensor, theta: torch.Tensor,
                    phi: torch.Tensor):
    """Cartesian points of the parametric flux surface at (s, theta, phi)
    (same map as ``stellarator.stellarator_flux_surface``, point-wise)."""
    r_min = cfg.a * torch.sqrt(torch.clamp(s, 1e-6, 1.0))
    delta_r = cfg.helical_excursion * torch.cos(cfg.n_fp * phi)
    r_maj = cfg.r0 + r_min * torch.cos(theta) + delta_r
    z = r_min * torch.sin(theta) + cfg.helical_excursion * torch.sin(cfg.n_fp * phi)
    x = r_maj * torch.cos(phi)
    y = r_maj * torch.sin(phi)
    return x, y, z, r_maj


class ForceBalanceObservables(NamedTuple):
    force_balance_rmse_pct: torch.Tensor
    asymmetry_index: torch.Tensor
    radial_spread_m: torch.Tensor
    n1_amp: torch.Tensor
    n2_amp: torch.Tensor
    z_n1_amp: torch.Tensor


def _quasi_3d_force_balance(theta: torch.Tensor, phi: torch.Tensor, *,
                            base: StellaratorConfig, stellar: StellaratorConfig,
                            rho: float = 0.92, n_phi: int = 96) -> ForceBalanceObservables:
    """:func:`quasi_3d_force_balance` at the sample angles ``theta`` and
    ``phi`` (samples,) in [0, 2 pi)."""
    s = torch.tensor(rho * rho, dtype=theta.dtype, device=theta.device)
    xb, yb, zb, _ = _surface_points(base, s, theta, phi)
    xs, ys, zs, _ = _surface_points(stellar, s, theta, phi)
    dist = torch.sqrt((xs - xb) ** 2 + (ys - yb) ** 2 + (zs - zb) ** 2)
    rmse_pct = 100.0 * torch.sqrt(xla_mean(dist**2)) / stellar.a

    # Toroidal-harmonic observables from the outboard-midplane ring: a
    # stellarator-symmetric surface has zero amplitude at n=1..n_fp-1, so
    # (n1, n2, n3) are the per-field-period family (bins n_fp, 2 n_fp, 3 n_fp).
    phi_ring = linspace(0.0, 2.0 * math.pi, n_phi, theta.dtype, theta.device, endpoint=False)
    _, _, z_ring, r_ring = _surface_points(stellar, s, torch.zeros_like(phi_ring), phi_ring)
    r_hat = torch.fft.rfft(r_ring - xla_mean(r_ring)) / n_phi
    z_hat = torch.fft.rfft(z_ring - xla_mean(z_ring)) / n_phi
    nb = r_hat.shape[0] - 1
    b1, b2, b3 = (min(stellar.n_fp, nb), min(2 * stellar.n_fp, nb), min(3 * stellar.n_fp, nb))
    n1 = 2.0 * torch.abs(r_hat[b1])
    n2 = 2.0 * torch.abs(r_hat[b2])
    n3 = 2.0 * torch.abs(r_hat[b3])
    z_n1 = 2.0 * torch.abs(z_hat[b1])
    asym = torch.sqrt(n1**2 + n2**2 + n3**2) / stellar.a
    spread = torch.std(r_ring, correction=0)
    return ForceBalanceObservables(rmse_pct, asym, spread, n1, n2, z_n1)


def quasi_3d_force_balance(generator: torch.Generator, *, base: StellaratorConfig,
                           stellar: StellaratorConfig, samples: int = 720, rho: float = 0.92,
                           n_phi: int = 96, dtype: torch.dtype = torch.float32,
                           device: torch.device | str = "cuda") -> ForceBalanceObservables:
    """Distance RMSE between paired axisymmetric/stellarator surfaces at
    random (theta, phi) samples plus toroidal-harmonic asymmetry
    observables; the two uniform draws from ``generator`` (on the CPU)."""
    u_theta = torch.rand((samples,), generator=generator, dtype=dtype)
    u_phi = torch.rand((samples,), generator=generator, dtype=dtype)
    return _quasi_3d_force_balance((u_theta * 2.0 * math.pi).to(device),
                                   (u_phi * 2.0 * math.pi).to(device), base=base,
                                   stellar=stellar, rho=rho, n_phi=n_phi)


# ── Hall-MHD zonal ratio ─────────────────────────────────────────────────


def _hall_mhd_zonal_ratio(normals: torch.Tensor, *, steps: int = 36) -> dict:
    """:func:`hall_mhd_zonal_ratio` from the two (grid, grid) normals
    ``normals`` (2, grid, grid)."""
    trace = run_hall_mhd(_init_hall_mhd(normals), n_steps=steps, n=normals.shape[-1])
    ratios = trace.zonal_energy / torch.clamp(trace.total_energy, min=1e-12)
    ratio = float(xla_mean(ratios))
    if not np.isfinite(ratio) or ratio <= 0.0:
        return {"backend": "proxy", "zonal_ratio": 0.06}
    return {"backend": "hall_mhd", "zonal_ratio": ratio}


def hall_mhd_zonal_ratio(generator: torch.Generator, *, grid: int = 18, steps: int = 36,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> dict:
    """Mean zonal-to-total energy ratio from the spectral Hall-MHD sandbox
    (the reference's ``HallMHD`` backend lane; the proxy fallback only for a
    non-finite or non-positive ratio)."""
    normals = torch.randn((2, grid, grid), generator=generator, dtype=dtype)
    return _hall_mhd_zonal_ratio(normals.to(device), steps=steps)


# ── Force-residual relaxation ────────────────────────────────────────────


def solve_quasi_3d_force_residual(asymmetry_index, n1_amp, n2_amp, *, poloidal_points: int = 56,
                                  toroidal_points: int = 48, iterations: int = 14,
                                  dtype: torch.dtype | None = None,
                                  device: torch.device | str = "cuda"):
    """Fixed-point pressure/J x B residual relaxation over a (theta, phi)
    grid, the iterations a Python loop.  Returns ``(mean_pct, p95_pct)``;
    the percentile is linear, as ``jnp.percentile``."""
    asym, n1, n2 = as_tensors(asymmetry_index, n1_amp, n2_amp, dtype=dtype, device=device)
    kw = dict(dtype=asym.dtype, device=asym.device)
    theta = linspace(0.0, 2.0 * math.pi, poloidal_points, endpoint=False, **kw)
    phi = linspace(0.0, 2.0 * math.pi, toroidal_points, endpoint=False, **kw)
    th, ph = torch.meshgrid(theta, phi, indexing="ij")
    pressure = 1.0 * (1.0
                      + 0.05 * asym * torch.cos(th - 0.25 * ph)
                      + 0.03 * n1 * torch.cos(ph)
                      + 0.02 * n2 * torch.cos(2.0 * ph))
    baseline_grad = torch.gradient(pressure, dim=0)[0]
    jxb_target = baseline_grad * (1.0
                                  + 0.10 * asym * torch.cos(ph)
                                  + 0.06 * n1 * torch.cos(th - ph)
                                  + 0.04 * n2 * torch.cos(th - 2.0 * ph))
    p, residual = pressure, None
    for _ in range(iterations):
        residual = torch.gradient(p, dim=0)[0] - jxb_target
        p = torch.clamp(p - 0.45 * residual, 0.30, 4.50)
    if residual is None:
        raise ValueError("solve_quasi_3d_force_residual: iterations must be >= 1")
    denom = torch.clamp(xla_mean(torch.abs(jxb_target)), min=1e-9)
    abs_r = torch.abs(residual)
    return 100.0 * xla_mean(abs_r) / denom, 100.0 * percentile(abs_r, 95.0) / denom


# ── Two-fluid + TEMHD coupling ───────────────────────────────────────────

TWO_FLUID_TEMHD = TEMHDParams(layer_thickness_mm=7.0, b_field_t=11.5, n_cells=24)


def two_fluid_temhd_coupled_profile(raw_heat_flux_w_m2, zonal_ratio, *, n_steps: int = 120,
                                    dtype: torch.dtype | None = None,
                                    device: torch.device | str = "cuda"):
    """Electron-ion two-fluid relaxation with per-point TEMHD surface
    cooling: each profile point carries its own TEMHD column, all of them
    one batch a step.  Returns ``(coupled_profile, diagnostics dict)``."""
    raw, zr = as_tensors(raw_heat_flux_w_m2, zonal_ratio, dtype=dtype, device=device)
    te = 8.0 + 1.5e-5 * raw
    ti = 11.0 + 1.8e-5 * raw
    p = TWO_FLUID_TEMHD
    states = TEMHDState(t_k=torch.full((*raw.shape, p.n_cells), p.t_wall_k, dtype=raw.dtype,
                                       device=raw.device))
    zr = torch.clamp(zr, 0.0, 1.0)
    q_mw = raw / 1e6
    coupled = raw
    for _ in range(n_steps):
        delta = te - ti
        nu_ei = 0.18 + 0.52 * zr
        q_ei = nu_ei * delta
        te = torch.clamp(te + 0.008 * (6.0e-5 * raw - q_ei - 0.22 * te), 2.0, 45.0)
        ti = torch.clamp(ti + 0.008 * (8.0e-5 * raw + q_ei - 0.17 * ti), 2.0, 65.0)
        states, t_surf_k, _ = temhd_step(p, states, q_mw, 0.05)
        cooling = torch.sigmoid((t_surf_k - 273.15 - 720.0) / 180.0)
        relax = 0.060 * cooling + 0.022 * torch.clamp(delta / 18.0, -1.0, 1.0)
        coupled = raw * torch.clamp(1.0 - relax, 0.70, 0.989)
    diag = {
        "two_fluid_temp_split_index": xla_mean(torch.abs(te - ti))
        / torch.clamp(xla_mean(te), min=1e-9),
        "electron_temp_mean_kev": xla_mean(te),
        "ion_temp_mean_kev": xla_mean(ti),
    }
    return coupled, diag


# ── Divertor profile construction ────────────────────────────────────────


def build_divertor_profiles(*, n1_amp, n2_amp, z_n1_amp, zonal_ratio,
                            reference_profile_w_m2: np.ndarray,
                            dtype: torch.dtype = torch.float32,
                            device: torch.device | str = "cuda") -> dict[str, Any]:
    """Divertor heat-load toroidal profile: TEMHD liquid-metal base state,
    harmonic asymmetry structure, reference-mean normalisation, two-fluid
    TEMHD cooling."""
    ref = torch.as_tensor(np.asarray(reference_profile_w_m2), dtype=dtype, device=device)
    n1, n2, zn1, zr = as_tensors(n1_amp, n2_amp, z_n1_amp, zonal_ratio, dtype=dtype,
                                 device=device)
    n = ref.shape[0]
    state = temhd_liquid_metal_state(5.0, 42.0, 2.95, 1.3, expansion_factor=22.0, dtype=dtype,
                                     device=device)
    q_base = state.q_surface
    angles = linspace(0.0, 2.0 * math.pi, n, dtype, device, endpoint=False)
    raw = q_base * (1.0
                    + 0.08 * n1 * torch.cos(angles)
                    + 0.05 * n2 * torch.cos(2.0 * angles)
                    - 0.03 * zn1 * torch.sin(angles)
                    + 0.03 * zr * torch.sin(3.0 * angles))
    raw = raw * (xla_mean(ref) / torch.clamp(xla_mean(raw), min=1e-9))
    cool, diag = two_fluid_temhd_coupled_profile(raw, zr)
    gain_pct = 100.0 * (xla_mean(raw) - xla_mean(cool)) / torch.clamp(xla_mean(raw), min=1e-12)
    return {
        "reference_profile_w_m2": ref.cpu().numpy(),
        "predicted_profile_w_m2": cool.cpu().numpy(),
        "cooling_gain_pct": float(gain_pct),
        "two_fluid_diag": {k: float(v) for k, v in diag.items()},
        "divertor_state": {
            "hartmann_number": float(state.hartmann),
            "stability_index": float(state.stability_index),
            "surface_temperature_c": float(state.t_surface_c),
            "surface_heat_flux_w_m2": float(state.q_surface),
        },
    }


# ── TBR calibration against erosion curves ───────────────────────────────

ASDEX_EROSION_ANGLES_DEG = np.asarray([15.0, 30.0, 45.0, 60.0, 75.0])
ASDEX_EROSION_SHAPE = np.asarray([0.70, 0.90, 1.00, 1.22, 1.44])


def calibrate_tbr_with_erosion(*, mean_heat_flux_w_m2: float, thickness_cm: float,
                               asdex_erosion_ref_mm_year: float,
                               dtype: torch.dtype = torch.float32,
                               device: torch.device | str = "cuda") -> dict[str, Any]:
    """TBR calibrated by tungsten-erosion trend parity against the ASDEX
    shape curve: erosion angle-curve from the PWI model (the five angles one
    batch), shape RMSE penalty, blanket TBR scaled by the erosion-headroom
    factor."""
    mat = SputteringMaterial.from_name("Tungsten", redeposition_factor=0.97)
    flux = max(1.0e21, (float(mean_heat_flux_w_m2) / 1.2e6) * 2.0e21)
    angles = torch.as_tensor(ASDEX_EROSION_ANGLES_DEG, dtype=dtype, device=device)
    curve = erosion_rate(mat, flux, 65.0, angles, dtype=dtype,
                         device=device)["Erosion_mm_year"].cpu().numpy().astype(np.float64)
    erosion = float(np.mean(curve))
    ref_curve = ASDEX_EROSION_SHAPE * float(asdex_erosion_ref_mm_year)
    ref_shape = ref_curve / max(float(np.mean(ref_curve)), 1e-12)
    pred_shape = curve / max(erosion, 1e-12)
    rmse_pct = float(100.0 * np.sqrt(np.mean((ref_shape - pred_shape) ** 2))
                     / max(float(np.mean(np.abs(ref_shape))), 1e-12))

    blanket = volumetric_tbr(BlanketConfig(thickness_cm=float(thickness_cm), li6_enrichment=1.0),
                             major_radius_m=6.2, minor_radius_m=2.0, elongation=1.7,
                             dtype=dtype, device=device)
    raw_tbr = float(blanket.tbr)
    base = min(1.0, float(asdex_erosion_ref_mm_year) / max(erosion, 1e-12))
    penalty = float(np.clip(1.0 - 0.004 * rmse_pct, 0.60, 1.00))
    factor = base * penalty
    return {
        "particle_flux_m2_s": flux,
        "estimated_erosion_mm_year": erosion,
        "asdex_reference_erosion_mm_year": float(asdex_erosion_ref_mm_year),
        "raw_tbr": raw_tbr,
        "calibration_factor": factor,
        "calibrated_tbr": raw_tbr * factor,
        "erosion_curve_rmse_pct": rmse_pct,
        "calibration_triggered": bool(raw_tbr > 1.1),
    }
