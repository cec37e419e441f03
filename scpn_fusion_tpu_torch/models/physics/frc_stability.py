"""FRC n=1 tilt-mode diagnostics + rigid-rotor validation contracts (port of
``scpn_fusion_tpu/models/physics/frc_stability.py``).

* the Steinhauer Eq. 27 kinetic parameter ``s = (1/R_s) int_0^{R_s} r /
  rho_i(r) dr`` over a static-shape separatrix mask, the sliver up to R_s
  added analytically;
* the Belova-normalised MHD tilt growth rate ``gamma = C * V_A / (E * R_s)``;
* the tilt diagnostic over a pulsed-compression trajectory in one vectorised
  pass (the cumulative growth exponent a trapezoidal ``cumsum``);
* the rigid-body FLR regime ladder as an int32 code (0-3);
* the rigid-rotor audit against its own closure identities.

Like the reference, the tilt stability claim is fail-closed:
``tilt_mode_stable`` always returns ``stable=False``.  Plain PyTorch ops on
the tensors of the state; where JAX takes the float of a scalar input from
the x64 flag (the elongation, ``jnp.gradient``'s spacing) the port takes the
state's dtype.  ``jnp.gradient`` is written out (:func:`gradient`): its
rounding is not ``torch.gradient``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.scenario import interp
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors
from scpn_fusion_tpu_torch.models.physics.frc import MU0, FRCEquilibriumState

ATOMIC_MASS_KG = 1.66053906892e-27
ELEMENTARY_CHARGE_C = 1.602176634e-19
DEUTERIUM_MASS_AMU = 2.014102

# Belova-normalised n=1 MHD tilt growth coefficient and the rigid-body
# FLR s/E thresholds (reference ``tilt_mode_frc.py:33-36``).
BELOVA_MHD_GROWTH_COEFFICIENT = 1.2
DIAMAGNETIC_S_OVER_E = 1.7
GYROVISCOUS_S_OVER_E = 2.2
COMBINED_FLR_S_OVER_E = 2.8

REGIME_NAMES = (
    "diamagnetic_flr_threshold_passed",
    "gyroviscous_flr_threshold_passed",
    "combined_flr_threshold_passed",
    "mhd_tilt_susceptible",
)


class TiltModeReport(NamedTuple):
    """n=1 tilt diagnostic (reference ``FRCTiltModeReport``)."""

    growth_rate_s_inv: torch.Tensor
    alfven_speed_m_s: torch.Tensor
    alfven_transit_time_s: torch.Tensor
    s_parameter: torch.Tensor
    elongation: torch.Tensor
    s_over_elongation: torch.Tensor
    regime_code: torch.Tensor        # int32 index into REGIME_NAMES
    threshold_passed: torch.Tensor   # bool: any FLR threshold satisfied


class TiltTrajectory(NamedTuple):
    """Tilt diagnostic projected over a compression trajectory."""

    t_s: torch.Tensor
    growth_rate_s_inv: torch.Tensor
    s_parameter: torch.Tensor
    s_over_elongation: torch.Tensor
    regime_code: torch.Tensor
    cumulative_growth_integral: torch.Tensor
    perturbation_amplification: torch.Tensor
    amplification_overflow_limited: torch.Tensor


class FRCValidationReport(NamedTuple):
    """Fail-closed rigid-rotor equilibrium audit (reference
    ``frc_rigid_rotor_validation.py:27``)."""

    finite: torch.Tensor
    force_balance_ok: torch.Tensor
    ampere_ok: torch.Tensor
    flux_derivative_ok: torch.Tensor
    pressure_balance_ok: torch.Tensor
    field_reversal_ok: torch.Tensor
    psi_monotonic_ok: torch.Tensor
    null_radius_ok: torch.Tensor
    all_passed: torch.Tensor
    force_balance_residual: torch.Tensor
    ampere_residual: torch.Tensor
    flux_derivative_residual: torch.Tensor
    pressure_balance_residual: torch.Tensor


def alfven_speed_m_s(b_reference_t, density_peak_m3, ion_mass_amu: float = DEUTERIUM_MASS_AMU,
                     *, dtype: torch.dtype | None = None,
                     device: torch.device | str = "cuda") -> torch.Tensor:
    """``V_A = |B| / sqrt(mu0 * n_m * m_i)`` (reference ``tilt_mode_frc.py:91``);
    a tensor among the inputs sets dtype and device."""
    b, n = as_tensors(b_reference_t, density_peak_m3, dtype=dtype, device=device)
    rho_m = n * ion_mass_amu * ATOMIC_MASS_KG
    return b.abs() / torch.sqrt(MU0 * rho_m)


def s_parameter(eq: FRCEquilibriumState, t_i_ev,
                ion_mass_amu: float = DEUTERIUM_MASS_AMU) -> torch.Tensor:
    """Steinhauer Eq. 27: ``s = (1/R_s) int_0^{R_s} r / rho_i dr``, the
    integrand masked to ``rho <= R_s`` over the whole grid and the sliver
    between the last node inside and R_s added analytically."""
    like = eq.rho
    thermal_momentum = torch.sqrt(torch.as_tensor(
        2.0 * ion_mass_amu * ATOMIC_MASS_KG * t_i_ev * ELEMENTARY_CHARGE_C,
        dtype=like.dtype, device=like.device))
    inv_gyro = ELEMENTARY_CHARGE_C * eq.b_z.abs() / thermal_momentum
    integrand = eq.rho * inv_gyro

    inside = eq.rho <= eq.r_s
    pair_in = inside[:-1] & inside[1:]
    dr = torch.diff(eq.rho)
    zero, ninf = like.new_zeros(()), like.new_tensor(-torch.inf)
    core = torch.where(pair_in, 0.5 * (integrand[:-1] + integrand[1:]) * dr, zero).sum()

    # Analytic sliver [r_last, R_s]: linear interpolation of the integrand.
    r_last = torch.where(inside, eq.rho, ninf).max()
    f_last = torch.where(inside, torch.where(eq.rho == r_last, integrand, ninf), ninf).max()
    f_sep = interp(eq.r_s.reshape(1), eq.rho, integrand)[0]
    sliver = torch.clamp(eq.r_s - r_last, min=0.0) * 0.5 * (f_last + f_sep)
    return (core + sliver) / eq.r_s


def s_over_elongation(eq: FRCEquilibriumState, t_i_ev, elongation) -> torch.Tensor:
    """Dimensionless ``s / E`` rigid-body stability diagnostic."""
    s = s_parameter(eq, t_i_ev)
    return s / torch.as_tensor(elongation, dtype=s.dtype, device=s.device)


def rigid_body_flr_regime_code(ratio, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """Map ``s/E`` onto the 4-regime FLR ladder as an int32 code; a tensor
    keeps its device, numbers go to ``device``."""
    (ratio,) = as_tensors(ratio, dtype=None, device=device)
    return ((ratio > DIAMAGNETIC_S_OVER_E).to(torch.int32)
            + (ratio > GYROVISCOUS_S_OVER_E).to(torch.int32)
            + (ratio > COMBINED_FLR_S_OVER_E).to(torch.int32))


def regime_name(code) -> str:
    """Host-side decoration of a regime code."""
    return REGIME_NAMES[int(code)]


def _report_from_values(*, s_value, b_reference_t, density_peak_m3, radius_m, elongation,
                        mhd_coefficient, ion_mass_amu) -> TiltModeReport:
    speed = alfven_speed_m_s(b_reference_t, density_peak_m3, ion_mass_amu)
    e = torch.as_tensor(elongation, dtype=speed.dtype, device=speed.device)
    half_length = radius_m * e
    ratio = s_value / e
    code = rigid_body_flr_regime_code(ratio)
    return TiltModeReport(
        growth_rate_s_inv=mhd_coefficient * speed / half_length,
        alfven_speed_m_s=speed,
        alfven_transit_time_s=half_length / speed,
        s_parameter=s_value,
        elongation=e,
        s_over_elongation=ratio,
        regime_code=code,
        threshold_passed=code < 3,
    )


def tilt_mode_report(eq: FRCEquilibriumState, t_i_ev, elongation, *,
                     mhd_coefficient: float = BELOVA_MHD_GROWTH_COEFFICIENT,
                     ion_mass_amu: float = DEUTERIUM_MASS_AMU) -> TiltModeReport:
    """n=1 tilt diagnostic for a rigid-rotor state (ref ``tilt_mode_frc.py:264``)."""
    return _report_from_values(
        s_value=s_parameter(eq, t_i_ev, ion_mass_amu),
        b_reference_t=eq.b_z.abs().max(),
        density_peak_m3=eq.density.max(),
        radius_m=eq.r_s,
        elongation=elongation,
        mhd_coefficient=mhd_coefficient,
        ion_mass_amu=ion_mass_amu,
    )


def tilt_mode_stable(eq: FRCEquilibriumState, t_i_ev, elongation) -> tuple[bool, torch.Tensor]:
    """Fail-closed stability claim: always ``(False, gamma)`` until a
    digitised Belova Table I reference exists (ref ``tilt_mode_frc.py:287``)."""
    report = tilt_mode_report(eq, t_i_ev, elongation)
    return False, report.growth_rate_s_inv


def belova_table1_acceptance_status() -> dict[str, str]:
    """Fail-closed external-parity status (ref ``tilt_mode_frc.py:304``)."""
    return {
        "case": "belova_2001_table1_tilt_stability",
        "status": "blocked_missing_public_digitised_reference",
        "required_artifact": (
            "digitised Belova Table I growth/stability data with provenance, "
            "checksum, and matching equilibrium-deck metadata"),
    }


def claim_boundary() -> dict[str, str]:
    return {
        "accepted": ("MHD Alfven-time tilt-growth diagnostic with conservative "
                     "fail-closed status"),
        "not_accepted": ("full Belova hybrid eigenvalue solver or Table I "
                         "same-case parity"),
    }


def tilt_trajectory_from_compression(
    eq: FRCEquilibriumState,
    t_i_ev_ref,
    elongation,
    *,
    t_s: torch.Tensor,
    radius_m: torch.Tensor,
    t_i_ev: torch.Tensor,
    density_m3: torch.Tensor,
    b_ext_t: torch.Tensor,
    mhd_coefficient: float = BELOVA_MHD_GROWTH_COEFFICIENT,
    ion_mass_amu: float = DEUTERIUM_MASS_AMU,
) -> TiltTrajectory:
    """Project the tilt diagnostic over a pulsed-compression trajectory
    (reference ``tilt_mode_frc.py:152-247``): ``s(t) = s0 (R/R0) (B/B0)
    sqrt(T0/T)``, the per-sample growth rates in one pass, and the
    cumulative growth exponent the trapezoidal integral of the rates.  The
    amplification saturates at ``exp(log(finfo.max))`` of the working dtype."""
    s0 = s_parameter(eq, t_i_ev_ref, ion_mass_amu)
    r0, b0, temp0 = radius_m[0], b_ext_t[0].abs(), t_i_ev[0]
    s_t = s0 * (radius_m / r0) * (b_ext_t.abs() / b0) * torch.sqrt(temp0 / t_i_ev)

    speed = alfven_speed_m_s(b_ext_t, density_m3, ion_mass_amu)
    e = torch.as_tensor(elongation, dtype=speed.dtype, device=speed.device)
    gamma = mhd_coefficient * speed / (radius_m * e)
    ratio = s_t / e
    code = rigid_body_flr_regime_code(ratio)

    increments = 0.5 * (gamma[:-1] + gamma[1:]) * torch.diff(t_s)
    cumulative = torch.cat([gamma.new_zeros(1), torch.cumsum(increments, 0)])
    log_max = torch.log(gamma.new_tensor(torch.finfo(gamma.dtype).max))
    return TiltTrajectory(
        t_s=t_s, growth_rate_s_inv=gamma, s_parameter=s_t,
        s_over_elongation=ratio, regime_code=code,
        cumulative_growth_integral=cumulative,
        perturbation_amplification=torch.exp(torch.minimum(cumulative, log_max)),
        amplification_overflow_limited=cumulative > log_max)


def gradient(f: torch.Tensor, h) -> torch.Tensor:
    """``jnp.gradient(f, h, axis=-1)`` for a scalar spacing: ``(f[2:] -
    f[:-2]) * 0.5 / h`` inside, first-order one-sided differences at the
    ends, along the last axis."""
    inner = (f[..., 2:] - f[..., :-2]) * 0.5 / h
    return torch.cat([(f[..., 1:2] - f[..., :1]) / h, inner, (f[..., -1:] - f[..., -2:-1]) / h],
                     dim=-1)


def validate_rigid_rotor(eq: FRCEquilibriumState, *, tolerance: float = 2e-2
                         ) -> FRCValidationReport:
    """Audit a rigid-rotor state against its own closure identities
    (reference ``validate_equilibrium``, ``frc_rigid_rotor_validation.py:27``):
    radial force balance, Ampere's law, the flux derivative ``dpsi/dr = B_z
    r``, constant total pressure, field reversal inside the separatrix,
    monotone flux and the analytic null at ``R_s/sqrt(2)``.  All residuals
    are relative; the report holds 0-d tensors."""
    dr = eq.rho[1] - eq.rho[0]
    b_e = eq.b_z.abs().max()
    scale_p = b_e**2 / (2.0 * MU0)

    finite = (torch.isfinite(eq.b_z).all() & torch.isfinite(eq.pressure).all()
              & torch.isfinite(eq.psi).all() & torch.isfinite(eq.j_theta).all())

    total = eq.pressure + eq.b_z**2 / (2.0 * MU0)
    fb_res = torch.diff(total).abs().max() / (scale_p / eq.r_s * dr)

    dbz = gradient(eq.b_z, dr)
    amp_res = (eq.j_theta + dbz / MU0).abs().max() / (b_e / (MU0 * eq.r_s))

    dpsi = gradient(eq.psi, dr)
    flux_res = (dpsi - eq.b_z * eq.rho).abs().max() / (b_e * eq.r_s)

    # Constant total pressure, audited against the profile's own mean.
    total_ref = total.mean()
    pb_res = (total - total_ref).abs().max() / total_ref

    # Field reversal: B_z changes sign across the null inside [0, R_s].
    inside = eq.rho < eq.r_s
    inf = eq.b_z.new_tensor(torch.inf)
    reversal = (torch.where(inside, eq.b_z, inf).min() < 0.0) & (
        torch.where(inside, eq.b_z, -inf).max() > 0.0)

    # psi rises monotonically from the axis to the null, falls beyond it.
    null_ok = (eq.r_null - eq.r_s / math.sqrt(2.0)).abs() <= tolerance * eq.r_s
    pre_null = eq.rho[:-1] < eq.r_null
    dpsi_steps = torch.diff(eq.psi)
    span = eq.psi.abs().max() + 1e-300
    mono = torch.where(pre_null, dpsi_steps >= -tolerance * span,
                       dpsi_steps <= tolerance * span).all()

    checks = (fb_res <= tolerance, amp_res <= tolerance,
              flux_res <= tolerance, pb_res <= tolerance)
    all_passed = finite & reversal & mono & null_ok
    for ok in checks:
        all_passed = all_passed & ok
    return FRCValidationReport(
        finite=finite,
        force_balance_ok=checks[0], ampere_ok=checks[1],
        flux_derivative_ok=checks[2], pressure_balance_ok=checks[3],
        field_reversal_ok=reversal, psi_monotonic_ok=mono,
        null_radius_ok=null_ok, all_passed=all_passed,
        force_balance_residual=fb_res, ampere_residual=amp_res,
        flux_derivative_residual=flux_res, pressure_balance_residual=pb_res)
