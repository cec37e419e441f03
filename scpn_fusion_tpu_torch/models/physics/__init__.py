"""Physics lanes (port of ``scpn_fusion_tpu/models/physics/``).

Ported so far: ``scaling_burn`` (the transport stepper's He pump takes its
IPB98(y,2) scaling), ``integrated_scenario`` (the whole-shot scenario of
``control/optimal_scenario.py``), ``ballooning`` (the Newcomb integration
through row B on the card), ``edge`` (the SOL model and the EPED tiers), and
the MHD, disruption and runaway lanes: ``disruption_sequence`` (row Q on the
card), ``fokker_planck_re``, ``runaway_fluid``, ``spi_ablation``,
``mhd_modes``, ``sawtooth``, ``stability_mhd``, ``elm``, ``edge_events`` and
``sandpile`` (row S on the card), and the FRC and pulsed physics: ``frc``,
``frc_stability``, ``frc_public``, ``pulsed_compression`` (row P and its
adjoint on the card), ``faraday_recovery``, ``hall_mhd_pulsed`` and
``hall_mhd_discovery``, and the heating, orbit, divertor and stellarator
physics: ``orbits``, ``fast_ions`` (row F on the card), ``current_drive``,
``rf_heating``, ``drift_wave``, ``divertor_lab`` and ``stellarator``, and
``design_scan`` (the design scan and the compact-reactor search, their burn
relaxations through row E on the card), and ``quasi3d`` (the quasi-3D
contracts, their TEMHD columns through row T on the card).  The
names the JAX package exports from those modules are exported here under the
same names; its other exports come with the modules that define them.
"""

from scpn_fusion_tpu_torch.models.physics.fokker_planck_re import (  # noqa: F401
    FokkerPlanckGrid,
    fp_step,
    run_fokker_planck,
)
from scpn_fusion_tpu_torch.models.physics.hall_mhd_pulsed import (  # noqa: F401
    HallMHDPulsedParams,
    run_hall_mhd_pulsed,
    spitzer_resistivity_ohm_m,
    step_hall_mhd_pulsed,
)
from scpn_fusion_tpu_torch.models.physics.disruption_sequence import (  # noqa: F401
    DisruptionParams,
    run_disruption_sequence,
    spi_mitigation_scan,
    structural_response_screen,
)
from scpn_fusion_tpu_torch.models.physics.edge_events import (  # noqa: F401
    blob_transport,
    marfe_onset,
    pellet_ablation,
)
from scpn_fusion_tpu_torch.models.physics.fast_ions import (  # noqa: F401
    EnsembleStats,
    coulomb_log_ei,
    critical_velocity,
    first_orbit_loss,
    follow_ensemble,
    heating_partition,
    sample_fast_ion_birth,
    slowing_down_time,
    tau_spitzer_electron,
    tokamak_field,
)
from scpn_fusion_tpu_torch.models.physics.mhd_modes import (  # noqa: F401
    delta_prime_cylindrical,
    locked_mode_evolution,
    mrti_growth_rate,
    rutherford_island_evolution,
    tae_stability,
)
from scpn_fusion_tpu_torch.models.physics.design_scan import (  # noqa: F401
    DesignLimits,
    compact_reactor_search,
    evaluate_design,
    scan_designs,
)
from scpn_fusion_tpu_torch.models.physics.sandpile import (  # noqa: F401
    SandpileConfig,
    avalanche_statistics,
    run_sandpile,
)
from scpn_fusion_tpu_torch.models.physics.drift_wave import (  # noqa: F401
    DriftWaveConfig,
    DriftWaveState,
    default_probe_indices,
    simulate_probes,
)
from scpn_fusion_tpu_torch.models.physics.frc_stability import (  # noqa: F401
    TiltModeReport,
    TiltTrajectory,
    s_parameter as frc_s_parameter,
    tilt_mode_report,
    tilt_mode_stable,
    tilt_trajectory_from_compression,
    validate_rigid_rotor,
)
from scpn_fusion_tpu_torch.models.physics.faraday_recovery import (  # noqa: F401
    FaradayRecoveryReport,
    faraday_back_emf,
    faraday_recovery,
    integrated_recovery_energy,
    recovery_from_compression,
)

# ``quasi3d`` imports ``models.nuclear``, whose modules import this package:
# its names are imported on first use, not with the package.
_QUASI3D = ("build_divertor_profiles", "calibrate_tbr_with_erosion", "hall_mhd_zonal_ratio",
            "jet_solps_reference_profile", "quasi_3d_force_balance",
            "solve_quasi_3d_force_residual", "two_fluid_temhd_coupled_profile")


def __getattr__(name: str):
    if name in _QUASI3D:
        from scpn_fusion_tpu_torch.models.physics import quasi3d
        return getattr(quasi3d, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
