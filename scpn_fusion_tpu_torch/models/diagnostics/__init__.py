"""Synthetic diagnostics and tomography (port of
``scpn_fusion_tpu/models/diagnostics/``, with its exports)."""

from scpn_fusion_tpu_torch.models.diagnostics.forward import (  # noqa: F401
    bolometer_power_density,
    cxrs_ion_diagnostics,
    ece_radiometer_temperature,
    generate_forward_channels,
    interferometer_phase_shift,
    line_integral_nearest,
    neutron_count_rate,
    soft_xray_brightness,
    synthetic_magnetic_probes,
    thomson_scattering_voltage,
)
