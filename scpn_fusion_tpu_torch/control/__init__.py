"""Control layer (port of ``scpn_fusion_tpu/control/``): every module of the
JAX package's ``control/`` has its counterpart at the same path, and this
package exports every name of the JAX package's ``control/__init__.py``
under the same name.  ``realtime_bus`` and ``director`` are carried over
(framework-neutral copies); the rest are ports.
"""

from scpn_fusion_tpu_torch.control.actuator import (  # noqa: F401
    ActuatorParams,
    ActuatorState,
    actuator_init,
    actuator_step,
)
from scpn_fusion_tpu_torch.control.pid import PIDGains, PIDState, pid_init, pid_step  # noqa: F401
from scpn_fusion_tpu_torch.control.flight_sim import (  # noqa: F401
    FlightSimParams,
    run_shot_reduced,
    run_shot_reduced_gains,
)
from scpn_fusion_tpu_torch.control.control_room import (  # noqa: F401
    render_control_room_report,
    run_control_room_session,
)
from scpn_fusion_tpu_torch.control.realtime_efit import (  # noqa: F401
    EFITModel,
    MagneticsLayout,
    build_efit_model,
    reconstruct,
)
from scpn_fusion_tpu_torch.control.hil import (  # noqa: F401
    LatencyReport,
    control_rate_hz,
    measure_dispatch_latency,
    measure_fused_throughput,
)
from scpn_fusion_tpu_torch.control.plasma_controllers import (  # noqa: F401
    BurnControllerParams,
    DensityControllerParams,
    DetachmentControllerParams,
    burn_controller_step,
    density_controller_step,
    run_detachment_loop,
    sensor_vote,
)
from scpn_fusion_tpu_torch.control.rmf import (  # noqa: F401
    PLLParams,
    RMFParams,
    run_phase_lock,
    run_rmf_spinup,
)
from scpn_fusion_tpu_torch.control.scenario import (  # noqa: F401
    FluxBudget,
    ScenarioSchedule,
    Waveform,
    run_startup_sequence,
    standard_shot_schedule,
)
from scpn_fusion_tpu_torch.control.optimal_scenario import (  # noqa: F401
    OptimizerConfig,
    ShotKnobs,
    optimize_shot,
    shot_objective,
)
from scpn_fusion_tpu_torch.control.twin_ingest import (  # noqa: F401
    TelemetryStream,
    generate_emulated_stream,
    run_realtime_twin_session,
    scenario_plan,
)
from scpn_fusion_tpu_torch.control.tuning import (  # noqa: F401
    CEMResult,
    cem_minimize,
    tune_hinf,
    tune_pid,
)
from scpn_fusion_tpu_torch.control.robust import (  # noqa: F401
    MuSynthesisResult,
    RWMFeedbackResult,
    build_rwm_plant,
    mu_synthesis,
    rwm_feedback_design,
)
from scpn_fusion_tpu_torch.control.fault_tolerant import (  # noqa: F401
    FaultState,
    controllability_ok,
    ft_step,
    init_fault_state,
    reconfig_gain,
    run_fault_tolerant_shot,
)
from scpn_fusion_tpu_torch.control.neuro_cybernetic import (  # noqa: F401
    LIFPoolParams,
    run_neuro_cybernetic_shot,
)
from scpn_fusion_tpu_torch.control.soc_learning import (  # noqa: F401
    CoupledSandpileConfig,
    SoftQConfig,
    run_soc_learning,
)
from scpn_fusion_tpu_torch.control.federated import (  # noqa: F401
    FederatedConfig,
    predict_disruption_risk,
    train_federated,
)
from scpn_fusion_tpu_torch.control.disruption_seq import (  # noqa: F401
    SeqPredictorParams,
    generate_hard_cohort,
    init_seq_predictor,
    seq_logits,
    seq_risk,
    shot_scores,
    train_seq_predictor,
)
from scpn_fusion_tpu_torch.control.replay import (  # noqa: F401
    ReplayConfig,
    replay_shot,
)
from scpn_fusion_tpu_torch.control.surrogate_mpc import (  # noqa: F401
    DynamicsSurrogate,
    learn_dynamics,
    surrogate_mpc_closed_loop,
    surrogate_mpc_plan,
)
