"""Synthetic diagnostics: forward models from plasma state to detectors
(port of ``scpn_fusion_tpu/models/diagnostics/forward.py``).

* interferometer:  dphi = r_e * lambda * integral(n_e dl)
* neutron rate:    counts = sum(S_n) dV * efficiency * solid-angle
* Thomson voltage: V = g * n_e (1 + s * T_e) + baseline at sample points
* ECE:             optically-thick T_e(R_ch, z_obs) * optical-depth factor
* soft X-ray:      eps = n_e^2 sqrt(T_e) Z_eff exp(-E_filter/T_e), chord-integrated
* bolometer:       P = n_e^2 C_rad Z_eff^2 sqrt(T_e)(1 + f_imp), chord-integrated
* CXRS:            Gaussian-beam-weighted chord averages of T_i and rotation
* magnetics:       psi and (B_R, B_Z) sampled at probe points, on the port's
                   ``topology.compute_b_field`` and
                   ``free_boundary.interp_psi_at_points``

Chords are (n_chords, 2, 2) tensors and every channel family is one batched
gather over (chord, sample) -- no per-chord loop.  The nearest grid point is
``torch.round`` of the offset over the step, half to even as ``jnp.round``;
the step is a tensor, so the offset is divided by it on every device (a
Python divisor becomes a reciprocal product on the card).  All models are
plain differentiable tensor ops on the fields' device and dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import Grid, linspace
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import interp_psi_at_points
from scpn_fusion_tpu_torch.models.equilibrium.topology import compute_b_field

ELECTRON_RADIUS_M = 2.8179403262e-15


def _nearest_indices(axis_min: float, step: float, n: int, values: torch.Tensor):
    step_t = torch.tensor(step, dtype=values.dtype, device=values.device)
    idx = torch.round((values - axis_min) / step_t).to(torch.int64)
    return torch.clamp(idx, 0, n - 1)


def _chord_samples(grid: Grid, chords: torch.Tensor, samples: int):
    """(r, z, ir, iz), each (n_chords, samples), along the chords."""
    t = linspace(0.0, 1.0, samples, chords.dtype, chords.device)
    start, end = chords[:, 0], chords[:, 1]
    r_vals = start[:, :1] + (end[:, :1] - start[:, :1]) * t
    z_vals = start[:, 1:] + (end[:, 1:] - start[:, 1:]) * t
    ir = _nearest_indices(grid.R_min, grid.dR, grid.NR, r_vals)
    iz = _nearest_indices(grid.Z_min, grid.dZ, grid.NZ, z_vals)
    return r_vals, z_vals, ir, iz


def line_integral_nearest(field: torch.Tensor, grid: Grid, chords: torch.Tensor,
                          samples: int = 96) -> torch.Tensor:
    """Chord integrals with nearest-grid-point sampling (reference
    ``_line_integral_nearest`` semantics), every chord one batch."""
    _, _, ir, iz = _chord_samples(grid, chords, samples)
    d = chords[:, 1] - chords[:, 0]
    dl = torch.hypot(d[:, 0], d[:, 1]) / samples
    return torch.sum(field[iz, ir], dim=-1) * dl


def interferometer_phase_shift(electron_density_m3: torch.Tensor, grid: Grid,
                               chords: torch.Tensor, *, laser_wavelength_m: float = 1.064e-6,
                               samples: int = 96) -> torch.Tensor:
    """Line-integrated interferometer phase shift [rad] per chord."""
    coeff = ELECTRON_RADIUS_M * laser_wavelength_m
    return coeff * line_integral_nearest(electron_density_m3, grid, chords, samples)


def neutron_count_rate(neutron_source_m3_s: torch.Tensor, *, volume_element_m3,
                       detector_efficiency: float = 0.12,
                       solid_angle_fraction: float = 1.0e-4) -> torch.Tensor:
    """Detector neutron count rate [Hz] from the volumetric source map."""
    emitted = torch.sum(torch.clamp(neutron_source_m3_s, min=0.0)) * volume_element_m3
    return emitted * detector_efficiency * solid_angle_fraction


def thomson_scattering_voltage(electron_density_m3: torch.Tensor,
                               electron_temp_kev: torch.Tensor, grid: Grid,
                               sample_points: torch.Tensor, *,
                               gain_v_per_m3: float = 2.5e-24,
                               temp_sensitivity_per_kev: float = 0.08,
                               baseline_voltage_v: float = 0.0) -> torch.Tensor:
    """Thomson-scattering detector voltages at sample points (n_pts, 2)."""
    ir = _nearest_indices(grid.R_min, grid.dR, grid.NR, sample_points[:, 0])
    iz = _nearest_indices(grid.Z_min, grid.dZ, grid.NZ, sample_points[:, 1])
    ne_local = torch.clamp(electron_density_m3[iz, ir], min=0.0)
    te_local = torch.clamp(electron_temp_kev[iz, ir], min=0.0)
    return (gain_v_per_m3 * ne_local
            * (1.0 + temp_sensitivity_per_kev * te_local) + baseline_voltage_v)


def ece_radiometer_temperature(electron_temp_kev: torch.Tensor, grid: Grid,
                               channel_r_positions: torch.Tensor, *,
                               z_observation: float = 0.0,
                               optical_depth_factor: float = 1.0) -> torch.Tensor:
    """Optically-thick ECE radiometer channels: T_e(R_ch, z_obs) * tau."""
    z_obs = torch.tensor(z_observation, dtype=channel_r_positions.dtype,
                         device=channel_r_positions.device)
    iz = _nearest_indices(grid.Z_min, grid.dZ, grid.NZ, z_obs)
    ir = _nearest_indices(grid.R_min, grid.dR, grid.NR, channel_r_positions)
    return torch.clamp(electron_temp_kev[iz, ir], min=0.0) * optical_depth_factor


def soft_xray_brightness(electron_density_m3: torch.Tensor, electron_temp_kev: torch.Tensor,
                         grid: Grid, chords: torch.Tensor, *, z_eff: float = 1.5,
                         filter_energy_kev: float = 1.0, samples: int = 96) -> torch.Tensor:
    """Soft X-ray chord brightness: eps = ne^2 sqrt(Te) Z exp(-E_f/Te)."""
    te_safe = torch.clamp(electron_temp_kev, min=0.01)
    emissivity = (electron_density_m3**2 * torch.sqrt(te_safe) * z_eff
                  * torch.exp(-filter_energy_kev / te_safe))
    return line_integral_nearest(emissivity, grid, chords, samples)


def bolometer_power_density(electron_density_m3: torch.Tensor, electron_temp_kev: torch.Tensor,
                            grid: Grid, chords: torch.Tensor, *, z_eff: float = 1.5,
                            impurity_fraction: float = 0.02, samples: int = 96) -> torch.Tensor:
    """Bolometer chords: P = ne^2 C_rad Z^2 sqrt(Te) (1 + f_imp)."""
    c_rad = 1.0e-31
    te_safe = torch.clamp(electron_temp_kev, min=0.01)
    p_rad = (electron_density_m3**2 * c_rad * z_eff**2
             * torch.sqrt(te_safe) * (1.0 + impurity_fraction))
    return line_integral_nearest(p_rad, grid, chords, samples)


def cxrs_ion_diagnostics(ion_temp_kev: torch.Tensor, rotation_km_s: torch.Tensor, grid: Grid,
                         chords: torch.Tensor, *, beam_r_center: float = 6.2,
                         beam_width: float = 0.1, samples: int = 96):
    """CXRS: Gaussian-beam-weighted chord averages of (T_i, v_tor)."""
    r_vals, _, ir, iz = _chord_samples(grid, chords, samples)
    w = torch.exp(-((r_vals - beam_r_center) / max(beam_width, 1e-6)) ** 2)
    w_sum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    ti = torch.sum(w * ion_temp_kev[iz, ir], dim=-1) / w_sum
    vrot = torch.sum(w * rotation_km_s[iz, ir], dim=-1) / w_sum
    return ti, vrot


def synthetic_magnetic_probes(psi: torch.Tensor, grid: Grid, probe_points: torch.Tensor):
    """Synthetic magnetics: (psi, B_R, B_Z) at probe points (n_probes, 2)
    (reference ``diagnostics/synthetic_sensors.py:48-116`` lane)."""
    b_r, b_z = compute_b_field(psi, grid.RR, grid.dR, grid.dZ)
    return (interp_psi_at_points(psi, grid, probe_points),
            interp_psi_at_points(b_r, grid, probe_points),
            interp_psi_at_points(b_z, grid, probe_points))


class ForwardChannels(NamedTuple):
    """Bundle of all synthetic channels (reference
    ``ForwardDiagnosticChannels`` / ``generate_forward_channels``)."""

    interferometer_rad: torch.Tensor
    neutron_rate_hz: torch.Tensor
    thomson_v: torch.Tensor
    ece_kev: torch.Tensor
    soft_xray: torch.Tensor
    bolometer: torch.Tensor


def generate_forward_channels(*, ne_m3: torch.Tensor, te_kev: torch.Tensor,
                              neutron_source: torch.Tensor, grid: Grid, chords: torch.Tensor,
                              thomson_points: torch.Tensor, ece_channels: torch.Tensor,
                              volume_element_m3) -> ForwardChannels:
    """All channel families in one pass."""
    return ForwardChannels(
        interferometer_rad=interferometer_phase_shift(ne_m3, grid, chords),
        neutron_rate_hz=neutron_count_rate(neutron_source, volume_element_m3=volume_element_m3),
        thomson_v=thomson_scattering_voltage(ne_m3, te_kev, grid, thomson_points),
        ece_kev=ece_radiometer_temperature(te_kev, grid, ece_channels),
        soft_xray=soft_xray_brightness(ne_m3, te_kev, grid, chords),
        bolometer=bolometer_power_density(ne_m3, te_kev, grid, chords),
    )
