"""FRC Faraday back-EMF and recovery-energy contract, MIF lane (port of
``scpn_fusion_tpu/models/physics/faraday_recovery.py``).

* the closed-form induction relation ``EMF = -N pi (R_s^2 dB/dt + 2 B R_s
  dR/dt)`` over a whole trajectory in one pass (:func:`faraday_recovery`);
* derivatives on a possibly non-uniform time grid by a second-order
  three-point stencil (:func:`central_derivative`);
* the recovered energy a trapezoid over ``EMF^2/R_load``;
* the flux-derivative closure audit: the finite-difference flux rate against
  ``-EMF/N`` with the reference's L-inf / L2 scaled norms;
* fail-closed energy-budget gates: without a compression-work value the gate
  reports ``blocked_missing_compression_work`` (host-side report).

:func:`recovery_from_compression` takes the port's
``pulsed_compression.CompressionTrace`` (on the card, one launch of row P
made it).  Plain PyTorch ops on the tensors given; they set the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.physics.pulsed_compression import CompressionTrace


class FaradayRecoveryResult(NamedTuple):
    """Per-sample arrays + integral scalars."""

    t_s: torch.Tensor
    magnetic_flux_wb: torch.Tensor
    flux_rate_field_term_wb_s: torch.Tensor
    flux_rate_radial_term_wb_s: torch.Tensor
    back_emf_v: torch.Tensor
    load_current_a: torch.Tensor
    load_power_w: torch.Tensor
    recovered_energy_j: torch.Tensor
    flux_derivative_residual_linf: torch.Tensor
    flux_derivative_residual_l2: torch.Tensor


class FaradayRecoveryReport(NamedTuple):
    """Host-side report with fail-closed claim statuses."""

    result: FaradayRecoveryResult
    n_turns: int
    coil_resistance_ohm: float
    flux_derivative_closure_passed: bool
    compression_work_j: float | None
    energy_budget_relative_error: float | None
    energy_budget_passed: bool | None
    budget_claim_status: str
    coil_source_work_j: float | None
    source_energy_budget_relative_error: float | None
    source_energy_budget_passed: bool | None
    source_budget_claim_status: str


def magnetic_flux_wb(separatrix_radius_m, b_ext_t):
    """Linked flux per turn ``B_ext pi R_s^2`` (reference ``:311``)."""
    return b_ext_t * math.pi * separatrix_radius_m**2


def faraday_back_emf(separatrix_radius_m, b_ext_t, d_radius_dt_m_s, d_b_ext_dt_t_s, n_turns):
    """Closed-form recovery-coil back-EMF in volts (reference ``:318``)."""
    return -n_turns * math.pi * (
        separatrix_radius_m**2 * d_b_ext_dt_t_s
        + 2.0 * b_ext_t * separatrix_radius_m * d_radius_dt_m_s)


def central_derivative(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Second-order derivative on a (possibly non-uniform) strictly
    increasing grid: 3-point interior stencil, one-sided 2nd-order ends."""
    h_l = t[1:-1] - t[:-2]
    h_r = t[2:] - t[1:-1]
    interior = (h_l**2 * y[2:] - h_r**2 * y[:-2]
                + (h_r**2 - h_l**2) * y[1:-1]) / (h_l * h_r * (h_l + h_r))
    h0, h1 = t[1] - t[0], t[2] - t[1]
    first = (-(2.0 * h0 + h1) * y[0] + (h0 + h1)**2 / h1 * y[1]
             - h0**2 / h1 * y[2]) / (h0 * (h0 + h1))
    hm, hn = t[-2] - t[-3], t[-1] - t[-2]
    last = (hn**2 / hm * y[-3] - (hm + hn)**2 / hm * y[-2]
            + (2.0 * hn + hm) * y[-1]) / (hn * (hm + hn))
    return torch.cat([first.reshape(1), interior, last.reshape(1)])


def faraday_recovery(t_s: torch.Tensor, separatrix_radius_m: torch.Tensor,
                     b_ext_t: torch.Tensor, *, n_turns: int, coil_resistance_ohm: float,
                     d_radius_dt_m_s: torch.Tensor | None = None,
                     d_b_ext_dt_t_s: torch.Tensor | None = None) -> FaradayRecoveryResult:
    """Vectorised recovery integral over a supplied trajectory; derivatives
    not supplied come from :func:`central_derivative` (reference ``:716-733``)."""
    drdt = (central_derivative(t_s, separatrix_radius_m)
            if d_radius_dt_m_s is None else d_radius_dt_m_s)
    dbdt = (central_derivative(t_s, b_ext_t)
            if d_b_ext_dt_t_s is None else d_b_ext_dt_t_s)

    flux = magnetic_flux_wb(separatrix_radius_m, b_ext_t)
    field_term = math.pi * separatrix_radius_m**2 * dbdt
    radial_term = 2.0 * math.pi * b_ext_t * separatrix_radius_m * drdt
    emf = faraday_back_emf(separatrix_radius_m, b_ext_t, drdt, dbdt, n_turns)
    current = emf / coil_resistance_ohm
    power = emf * emf / coil_resistance_ohm
    energy = (0.5 * (power[:-1] + power[1:]) * torch.diff(t_s)).sum()

    # Closure audit: d(flux)/dt computed by FD must equal -EMF/N.
    flux_rate_fd = central_derivative(t_s, flux)
    emf_per_turn = emf / n_turns
    residual = flux_rate_fd + emf_per_turn
    scale = torch.maximum(flux_rate_fd.abs().max(), torch.clamp(
        emf_per_turn.abs().max(), min=torch.finfo(flux.dtype).eps))
    scaled = residual / scale
    return FaradayRecoveryResult(
        t_s=t_s, magnetic_flux_wb=flux,
        flux_rate_field_term_wb_s=field_term,
        flux_rate_radial_term_wb_s=radial_term,
        back_emf_v=emf, load_current_a=current, load_power_w=power,
        recovered_energy_j=energy,
        flux_derivative_residual_linf=scaled.abs().max(),
        flux_derivative_residual_l2=torch.sqrt((scaled**2).mean()))


def _evaluate_budget(recovered_j: float, work_j: float | None, tolerance: float,
                     missing_status: str):
    """Fail-closed budget gate (reference ``_evaluate_budget:631``):
    symmetric relative error between recovered energy and supplied work,
    scaled by the larger magnitude."""
    if work_j is None:
        return None, None, None, missing_status
    if work_j <= 0.0 or not np.isfinite(work_j):
        raise ValueError("supplied work must be positive and finite")
    scale = max(abs(work_j), abs(recovered_j), float(np.finfo(np.float64).eps))
    rel = abs(recovered_j - work_j) / scale
    passed = bool(rel <= tolerance)
    return float(work_j), float(rel), passed, ("passed" if passed else "failed")


def integrated_recovery_energy(
    t_s,
    separatrix_radius_m,
    b_ext_t,
    *,
    n_turns: int,
    coil_resistance_ohm: float,
    d_radius_dt_m_s=None,
    d_b_ext_dt_t_s=None,
    compression_work_j: float | None = None,
    coil_source_work_j: float | None = None,
    budget_tolerance: float = 0.01,
    flux_derivative_tolerance: float = 2.0e-2,
) -> FaradayRecoveryReport:
    """Full fail-closed report (reference ``integrated_recovery_energy:362``)."""
    if int(n_turns) < 1:
        raise ValueError("n_turns must be a positive integer")
    if coil_resistance_ohm <= 0.0:
        raise ValueError("coil_resistance_ohm must be positive")
    t = torch.as_tensor(t_s)
    if t.shape[0] < 2:
        raise ValueError("trajectory must contain at least two samples")
    if not bool((torch.diff(t) > 0.0).all()):
        raise ValueError("trajectory time samples must be strictly increasing")
    r = torch.as_tensor(separatrix_radius_m)
    if bool((r <= 0.0).any()):
        raise ValueError("trajectory separatrix radii must be positive")

    result = faraday_recovery(
        t, r, torch.as_tensor(b_ext_t),
        n_turns=int(n_turns), coil_resistance_ohm=float(coil_resistance_ohm),
        d_radius_dt_m_s=d_radius_dt_m_s, d_b_ext_dt_t_s=d_b_ext_dt_t_s)

    recovered = float(result.recovered_energy_j)
    work, rel, passed, status = _evaluate_budget(
        recovered, compression_work_j, budget_tolerance,
        "blocked_missing_compression_work")
    s_work, s_rel, s_passed, s_status = _evaluate_budget(
        recovered, coil_source_work_j, budget_tolerance,
        "blocked_missing_coil_source_work")
    return FaradayRecoveryReport(
        result=result, n_turns=int(n_turns),
        coil_resistance_ohm=float(coil_resistance_ohm),
        flux_derivative_closure_passed=bool(
            float(result.flux_derivative_residual_linf) <= flux_derivative_tolerance),
        compression_work_j=work, energy_budget_relative_error=rel,
        energy_budget_passed=passed, budget_claim_status=status,
        coil_source_work_j=s_work, source_energy_budget_relative_error=s_rel,
        source_energy_budget_passed=s_passed, source_budget_claim_status=s_status)


def recovery_from_compression(trace: CompressionTrace, *, n_turns: int,
                              coil_resistance_ohm: float,
                              budget_tolerance: float = 0.01) -> FaradayRecoveryReport:
    """Adapter from the pulsed-compression trace (reference
    ``faraday_trajectory_from_pulsed_compression:124`` and the two work
    adapters ``:156``, ``:278``): the trace's ``velocity_m_s`` is ``dR/dt``
    exactly; ``dB/dt`` comes from the finite-difference path."""
    st = trace.state
    return integrated_recovery_energy(
        st.t_s, st.radius_m, trace.b_ext_t,
        n_turns=n_turns, coil_resistance_ohm=coil_resistance_ohm,
        d_radius_dt_m_s=st.velocity_m_s,
        compression_work_j=float(st.compression_work_j[-1]),
        coil_source_work_j=float(st.source_work_j[-1]),
        budget_tolerance=budget_tolerance)
