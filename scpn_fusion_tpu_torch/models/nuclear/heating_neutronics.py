"""Heating + neutronics candidate contracts (port of
``scpn_fusion_tpu/models/nuclear/heating_neutronics.py``).

The reference's GENRAY-like RF/NBI absorption proxy, ARIES-AT fusion-gain
proxy, MCNP-lite TBR projection, a lightweight stochastic
neutron-transport TBR estimate, and the candidate sample/score/refine
pipeline:

* the heating proxy evaluates ALL rays at once as an ``(n_rays, n_steps)``
  tensor (survival ``cumprod`` along the path axis: PyTorch multiplies in
  order where XLA may scan associatively, an ulp-level difference);
* the transport estimate is a non-analog weight-based Monte Carlo: a fixed
  particle array advances through a bounded number of interaction rounds
  (a Python loop of batched ops with no host read; the tallies stay on the
  device), the reference's branching at multiplication events replaced by
  weight combination (one particle of weight 1.60 w whose direction samples
  the weighted mixture of the two branch distributions);
* candidate scoring rides the port's 0D design chain
  (``models/physics/design_scan.evaluate_design``: row E on the card) and
  the volumetric blanket surrogate (``models/nuclear/blanket``).

The draws rule: the public functions draw from a ``torch.Generator`` (on the
CPU, so every device sees the same draws); the private ones
(:func:`_genray_heating_proxy`, :func:`_mcnp_lite_transport_tbr`,
:func:`_quick_candidate`, :func:`_refine_candidate_tbr`) take the draws.
The entry points take ``dtype`` (JAX reads its x64 flag; float32 by default
here) and ``device``; the thickness of the transport estimate is rounded to
float32 and the candidate's uniforms are float32, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import linspace, xla_mean
from scpn_fusion_tpu_torch.models.nuclear.blanket import BlanketConfig, volumetric_tbr
from scpn_fusion_tpu_torch.models.physics.design_scan import evaluate_design
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors
from scpn_fusion_tpu_torch.models.physics.frc_stability import gradient

TBR_EQUIVALENCE_SCALE = 1.45
# (lo, hi) of quick_candidate's ten design uniforms and of the blanket thickness
CANDIDATE_RANGES = ((4.0, 7.4), (5.0, 8.2), (8.0, 18.5), (1.5, 2.0), (0.20, 0.42),
                    (18.0, 42.0), (14.0, 38.0), (0.78, 1.0), (0.35, 0.95), (0.20, 0.85),
                    (220.0, 340.0))
PITCH_RANGE = (-0.22, 0.22)


def require_fraction(name: str, value) -> float:
    out = float(value)
    if not np.isfinite(out) or out < 0.0 or out > 1.0:
        raise ValueError(f"{name} must be finite and in [0, 1].")
    return out


def _uniform(g: torch.Generator, shape, lo: float, hi: float, dtype: torch.dtype):
    """``shape`` uniforms in [lo, hi) of ``dtype`` from ``g``, on the CPU."""
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=dtype)


def _select(mask: torch.Tensor, yes: float, no: float, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.where(mask, yes, no)`` of two Python numbers, in ``dtype``
    (``torch.where`` of two numbers is the default dtype)."""
    return torch.full(mask.shape, no, dtype=dtype, device=mask.device).masked_fill(mask, yes)


def _genray_heating_proxy(pitch: torch.Tensor, *, major_radius_m, elongation, b_t,
                          rf_power_mw, nbi_power_mw, n_steps: int = 120) -> dict:
    """:func:`genray_heating_proxy` on the rays' pitches ``pitch`` (n_rays, 1)."""
    dtype, device, n_rays = pitch.dtype, pitch.device, pitch.shape[0]
    major_radius_m, elongation, b_t = as_tensors(major_radius_m, elongation, b_t, dtype=dtype,
                                                 device=device)
    t = linspace(0.0, 1.0, n_steps, dtype, device)[None, :]       # (1, S)
    i = torch.arange(n_rays, dtype=dtype, device=device)[:, None]  # (R, 1)
    launch_phase = 2.0 * math.pi * (i + 0.5) / n_rays

    rf_sigma = 0.12 + 0.02 * torch.clamp(elongation - 1.6, min=0.0)
    nbi_sigma = 0.16 + 0.03 * torch.clamp(2.0 - elongation, min=0.0)
    rf_res = 0.34 + 0.03 * torch.tanh((b_t - 5.8) / 2.0)
    nbi_res = 0.56 + 0.04 * torch.tanh((major_radius_m - 6.0) / 1.8)

    radius = torch.clamp(1.0 - 0.92 * t + 0.03 * torch.sin(3.0 * t + launch_phase), 0.02, 1.2)
    tor_phase = launch_phase + (1.6 + 0.2 * pitch) * t
    shear_mod = 1.0 + 0.08 * torch.cos(2.0 * tor_phase)
    density = 0.35 + 0.65 * torch.clamp(1.0 - radius**2, 0.0, 1.0)

    rf_cut = 0.90 + 0.03 * torch.sin(launch_phase)
    nbi_cut = 0.95 + 0.02 * torch.cos(launch_phase)
    rf_mask = density > rf_cut
    nbi_mask = density > nbi_cut
    rf_survival = torch.cumprod(_select(rf_mask, 0.92, 0.996, dtype), dim=1)
    nbi_survival = torch.cumprod(_select(nbi_mask, 0.95, 0.997, dtype), dim=1)

    rf_kernel = (torch.exp(-(((radius - rf_res) / rf_sigma) ** 2))
                 * shear_mod * rf_survival)
    nbi_kernel = (torch.exp(-(((radius - nbi_res) / nbi_sigma) ** 2))
                  * (1.0 + 0.05 * torch.sin(1.5 * tor_phase + pitch))
                  * nbi_survival)

    rf_eff = torch.clamp(0.56 + 0.34 * xla_mean(rf_kernel), 0.35, 0.95)
    nbi_eff = torch.clamp(0.50 + 0.34 * xla_mean(nbi_kernel), 0.28, 0.93)
    dr = gradient(radius, 1.0)
    mean_path = xla_mean(torch.sum(0.98 + 0.08 * torch.abs(dr), dim=1) / n_steps)
    return {
        "rf_absorption_eff": rf_eff,
        "nbi_absorption_eff": nbi_eff,
        "absorbed_heating_mw": rf_power_mw * rf_eff + nbi_power_mw * nbi_eff,
        "mean_path_length_norm": mean_path,
        "rf_reflection_rate": xla_mean(rf_mask.to(dtype)),
        "nbi_reflection_rate": xla_mean(nbi_mask.to(dtype)),
    }


def genray_heating_proxy(generator: torch.Generator, *, major_radius_m, elongation, b_t,
                         rf_power_mw, nbi_power_mw, n_rays: int = 96, n_steps: int = 120,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> dict:
    """Deterministic ray-path RF/NBI absorption proxy, all rays at once
    (reference ``genray_like_heating_proxy:52-123``); the rays' pitches
    drawn from ``generator``."""
    pitch = _uniform(generator, (n_rays, 1), *PITCH_RANGE, dtype).to(device)
    return _genray_heating_proxy(pitch, major_radius_m=major_radius_m, elongation=elongation,
                                 b_t=b_t, rf_power_mw=rf_power_mw, nbi_power_mw=nbi_power_mw,
                                 n_steps=n_steps)


def aries_at_q_proxy(*, major_radius_m, b_t, ip_ma, absorbed_heating_mw, dtype=None,
                     device="cuda") -> torch.Tensor:
    """ARIES-AT-like fusion-gain scaling (reference ``:124-140``)."""
    major_radius_m, b_t, ip_ma, absorbed_heating_mw = as_tensors(
        major_radius_m, b_t, ip_ma, absorbed_heating_mw, dtype=dtype, device=device)
    return (5.8 * (major_radius_m / 6.2) ** 0.62
            * (b_t / 5.5) ** 1.20
            * (ip_ma / 12.0) ** 0.92
            * (torch.clamp(absorbed_heating_mw, min=1.0) / 55.0) ** 0.25)


def mcnp_lite_tbr(*, raw_tbr, li6_enrichment, be_multiplier_fraction, reflector_albedo,
                  dtype=None, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Project a raw breeding ratio into the engineering-equivalent TBR
    space used by the campaign gates (reference ``:141-158``)."""
    factor = (1.11
              + 0.22 * require_fraction("be_multiplier_fraction",
                                        be_multiplier_fraction)
              + 0.08 * require_fraction("li6_enrichment", li6_enrichment)
              + 0.05 * require_fraction("reflector_albedo", reflector_albedo))
    (raw,) = as_tensors(raw_tbr, dtype=dtype, device=device)
    return raw * factor * TBR_EQUIVALENCE_SCALE, torch.tensor(factor, dtype=raw.dtype,
                                                              device=raw.device)


def _mcnp_lite_transport_tbr(u_step: torch.Tensor, u_albedo: torch.Tensor,
                             u_event: torch.Tensor, *, thickness_cm, li6_enrichment,
                             be_multiplier_fraction, reflector_albedo) -> dict:
    """:func:`mcnp_lite_transport_tbr` on the rounds' draws: ``u_step`` and
    ``u_albedo`` (rounds, histories), ``u_event`` (rounds, histories, 2)."""
    dtype, device = u_step.dtype, u_step.device
    sigma_cap = 0.055 + 0.11 * min(max(li6_enrichment, 0.0), 1.0)
    sigma_scat = 0.18
    sigma_par = 0.02
    sigma_mult = 0.02 + 0.08 * min(max(be_multiplier_fraction, 0.0), 1.0)
    sigma_tot = sigma_cap + sigma_scat + sigma_par + sigma_mult
    p_cap = sigma_cap / sigma_tot
    p_scat = (sigma_cap + sigma_scat) / sigma_tot
    p_mult = (sigma_cap + sigma_scat + sigma_mult) / sigma_tot
    albedo = min(max(reflector_albedo, 0.0), 1.0)
    thick = float(np.float32(thickness_cm))       # JAX rounds the thickness to float32
    # Branch-direction mixture for the combined multiplication particle:
    # weights 0.90 (60% forward) and 0.70 (72% forward).
    p_fwd_mult = (0.90 * 0.60 + 0.70 * 0.72) / 1.60
    mfp = 1.0 / max(sigma_tot, 1e-9)

    n = u_step.shape[1]
    w = torch.ones(n, dtype=dtype, device=device)
    x = torch.zeros(n, dtype=dtype, device=device)
    d = torch.ones(n, dtype=dtype, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    cap, leak, mult = (torch.zeros((), dtype=dtype, device=device) for _ in range(3))
    for u1, u_alb, u in zip(u_step, u_albedo, u_event):
        alive = alive & (w > 1e-3)
        s = -mfp * torch.log(torch.clamp(1.0 - u1, min=1e-12))
        x_new = x + d * s
        # Reflect at the plasma-facing surface.
        d = torch.where(x_new < 0.0, 1.0, d)
        x_new = torch.clamp(x_new, min=0.0)

        escaped = alive & (x_new > thick)
        back_reflected = escaped & (u_alb < albedo)
        leaked = escaped & ~back_reflected
        leak = leak + torch.sum(torch.where(leaked, w, 0.0))

        inside = alive & ~escaped
        ev = u[:, 0]
        captured = inside & (ev < p_cap)
        scattered = inside & (ev >= p_cap) & (ev < p_scat)
        multiplied = inside & (ev >= p_scat) & (ev < p_mult)
        cap = cap + torch.sum(torch.where(captured, w, 0.0))
        mult = mult + torch.sum(torch.where(multiplied, w, 0.0))

        new_dir = _select(u[:, 1] < _select(multiplied, p_fwd_mult, 0.68, dtype), 1.0, -1.0,
                          dtype)
        w = torch.where(back_reflected, 0.92 * w,
                        torch.where(scattered, 0.98 * w,
                                    torch.where(multiplied, 1.60 * w, w)))
        x = torch.where(back_reflected, thick, x_new)
        d = torch.where(back_reflected, -1.0,
                        torch.where(scattered | multiplied, new_dir, d))
        # Survivors: albedo-reflected, scattered, or multiplied particles.
        # Leak, capture, and parasitic absorption all terminate the history
        # (the reference pushes nothing onto the stack for those, :203-225).
        alive = back_reflected | scattered | multiplied
    inv = 1.0 / max(float(n), 1e-9)
    return {"tbr_mc": cap * inv, "leakage_rate": leak * inv,
            "multiplication_gain": 1.0 + mult * inv}


def mcnp_lite_transport_draws(generator: torch.Generator, histories: int,
                              max_interactions: int, dtype: torch.dtype):
    """The rounds' draws of :func:`mcnp_lite_transport_tbr` from ``generator``
    (three a round, on the CPU)."""
    return tuple(torch.rand(shape, generator=generator, dtype=dtype) for shape in (
        (max_interactions, histories), (max_interactions, histories),
        (max_interactions, histories, 2)))


def mcnp_lite_transport_tbr(generator: torch.Generator, *, histories: int, thickness_cm,
                            li6_enrichment, be_multiplier_fraction, reflector_albedo,
                            max_interactions: int = 48, dtype: torch.dtype = torch.float32,
                            device: torch.device | str = "cuda") -> dict:
    """1D weight-based neutron-transport TBR estimate, fully vectorised
    (reference ``mcnp_lite_transport_tbr:160-229``; non-analog
    multiplication redesign documented in the module docstring)."""
    draws = mcnp_lite_transport_draws(generator, histories, max_interactions, dtype)
    return _mcnp_lite_transport_tbr(
        *(u.to(device) for u in draws), thickness_cm=float(thickness_cm),
        li6_enrichment=float(li6_enrichment), be_multiplier_fraction=float(be_multiplier_fraction),
        reflector_albedo=float(reflector_albedo))


def _quick_candidate(uniforms, pitch: torch.Tensor, idx: int, *, base_tbr: float = 1.1409,
                     aspect_ratio: float = 3.1, greenwald_fraction: float = 0.85) -> dict:
    """:func:`quick_candidate` on its eleven float32 uniforms (Python
    numbers, in :data:`CANDIDATE_RANGES`) and its rays' pitches (n_rays, 1):
    the dtype and device of ``pitch`` are the candidate's."""
    u = [float(v) for v in uniforms]
    (major_radius_m, b_t, ip_ma, elongation, triangularity, rf_power_mw,
     nbi_power_mw, li6_enrichment, be_multiplier_fraction,
     reflector_albedo, blanket_thickness_cm) = u
    kw = dict(dtype=pitch.dtype, device=pitch.device)

    heating = _genray_heating_proxy(
        pitch, major_radius_m=major_radius_m, elongation=elongation,
        b_t=b_t, rf_power_mw=rf_power_mw, nbi_power_mw=nbi_power_mw)
    a_m = major_radius_m / aspect_ratio
    n_gw19 = 10.0 * ip_ma / (np.pi * a_m**2)
    design = evaluate_design(
        major_radius_m, a_m, b_t, ip_ma,
        greenwald_fraction * n_gw19, rf_power_mw + nbi_power_mw,
        kappa=elongation, **kw)

    heating_weight = (0.56 * float(heating["rf_absorption_eff"])
                      + 0.44 * float(heating["nbi_absorption_eff"]))
    q_aries = float(aries_at_q_proxy(
        major_radius_m=major_radius_m, b_t=b_t, ip_ma=ip_ma,
        absorbed_heating_mw=heating["absorbed_heating_mw"]))
    surrogate_q = 4.8 + 0.085 * np.sqrt(max(float(design.q_fusion), 0.0)) \
        * heating_weight * np.sqrt(b_t / 5.5)
    q_proxy = 0.90 * q_aries + 0.10 * surrogate_q + 2.8

    raw_tbr_est = (base_tbr * (blanket_thickness_cm / 260.0) ** 0.11
                   * (1.0 + 0.07 * (elongation - 1.7)))
    tbr_est, tbr_factor = mcnp_lite_tbr(
        raw_tbr=raw_tbr_est, li6_enrichment=li6_enrichment,
        be_multiplier_fraction=be_multiplier_fraction,
        reflector_albedo=reflector_albedo, **kw)
    objective = (q_proxy + 18.0 * (float(tbr_est) - 1.05)
                 - 0.45 * abs(q_proxy - q_aries))
    return {
        "candidate_id": float(idx),
        "major_radius_m": major_radius_m, "b_t": b_t, "ip_ma": ip_ma,
        "elongation": elongation, "triangularity": triangularity,
        "rf_power_mw": rf_power_mw, "nbi_power_mw": nbi_power_mw,
        "li6_enrichment": li6_enrichment,
        "be_multiplier_fraction": be_multiplier_fraction,
        "reflector_albedo": reflector_albedo,
        "blanket_thickness_cm": blanket_thickness_cm,
        "rf_absorption_eff": float(heating["rf_absorption_eff"]),
        "nbi_absorption_eff": float(heating["nbi_absorption_eff"]),
        "rf_reflection_rate": float(heating["rf_reflection_rate"]),
        "nbi_reflection_rate": float(heating["nbi_reflection_rate"]),
        "mean_path_length_norm": float(heating["mean_path_length_norm"]),
        "absorbed_heating_mw": float(heating["absorbed_heating_mw"]),
        "q_proxy": float(q_proxy), "q_aries_at_proxy": q_aries,
        "tbr_est": float(tbr_est), "tbr_factor": float(tbr_factor),
        "objective": float(objective),
    }


def quick_candidate(generator: torch.Generator, idx: int, *, base_tbr: float = 1.1409,
                    aspect_ratio: float = 3.1, greenwald_fraction: float = 0.85,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> dict:
    """Sample and score one heating/neutronics reactor candidate (reference
    ``quick_candidate:231-309``): eleven float32 uniforms and the heating
    proxy's pitches from ``generator``.  The design-chain Q comes from the
    port's 0D chain (``evaluate_design``)."""
    uniforms = [float(_uniform(generator, (), lo, hi, torch.float32))
                for lo, hi in CANDIDATE_RANGES]
    pitch = _uniform(generator, (96, 1), *PITCH_RANGE, dtype).to(device)
    return _quick_candidate(uniforms, pitch, idx, base_tbr=base_tbr, aspect_ratio=aspect_ratio,
                            greenwald_fraction=greenwald_fraction)


def _refine_candidate_tbr(candidate: dict, draws, *, dtype: torch.dtype = torch.float32,
                          device: torch.device | str = "cuda") -> dict:
    """:func:`refine_candidate_tbr` on the transport estimate's draws
    (:func:`mcnp_lite_transport_draws` of 700 histories)."""
    cfg = BlanketConfig(thickness_cm=float(candidate["blanket_thickness_cm"]),
                        li6_enrichment=float(candidate["li6_enrichment"]))
    vol = volumetric_tbr(
        cfg,
        major_radius_m=float(candidate["major_radius_m"]),
        minor_radius_m=max(1.4, float(candidate["major_radius_m"]) * 0.31),
        elongation=float(candidate["elongation"]),
        radial_cells=8, poloidal_cells=16, toroidal_cells=12,
        incident_flux=1e14, dtype=dtype, device=device)
    raw_tbr = float(vol.tbr)
    tbr_est, tbr_factor = mcnp_lite_tbr(
        raw_tbr=raw_tbr,
        li6_enrichment=float(candidate["li6_enrichment"]),
        be_multiplier_fraction=float(candidate["be_multiplier_fraction"]),
        reflector_albedo=float(candidate["reflector_albedo"]), dtype=dtype, device=device)
    mc = _mcnp_lite_transport_tbr(
        *(u.to(device=device, dtype=dtype) for u in draws),
        thickness_cm=float(candidate["blanket_thickness_cm"]),
        li6_enrichment=float(candidate["li6_enrichment"]),
        be_multiplier_fraction=float(candidate["be_multiplier_fraction"]),
        reflector_albedo=float(candidate["reflector_albedo"]))
    tbr_final = 0.60 * float(tbr_est) + 0.40 * float(mc["tbr_mc"])
    out = dict(candidate)
    out["raw_tbr"] = raw_tbr
    out["tbr_final"] = tbr_final
    out["tbr_factor"] = float(tbr_factor)
    out["tbr_mc"] = float(mc["tbr_mc"])
    out["neutron_leakage_rate"] = float(mc["leakage_rate"])
    out["neutron_multiplication_gain"] = float(mc["multiplication_gain"])
    out["objective"] = (float(candidate["q_proxy"])
                        + 18.0 * (tbr_final - 1.05)
                        - 0.45 * abs(float(candidate["q_proxy"])
                                     - float(candidate["q_aries_at_proxy"])))
    return out


def refine_candidate_tbr(candidate: dict, generator: torch.Generator, *,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> dict:
    """Refine a sampled candidate with the volumetric blanket solve and the
    stochastic transport estimate (reference ``refine_candidate_tbr:311-355``);
    the transport's draws from ``generator``."""
    return _refine_candidate_tbr(candidate, mcnp_lite_transport_draws(generator, 700, 48, dtype),
                                 dtype=dtype, device=device)
