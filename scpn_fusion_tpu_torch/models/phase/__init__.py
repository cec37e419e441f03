"""Phase dynamics: Kuramoto-Sakaguchi, multi-layer UPDE, Lyapunov guard,
the monitored UPDE run (row U on the card) (port of
``scpn_fusion_tpu/models/phase/``, with its exports)."""

from scpn_fusion_tpu_torch.models.phase.guard import (
    GuardConfig,
    GuardState,
    GuardVerdict,
    guard_check,
    guard_check_trajectory,
    init_guard,
)
from scpn_fusion_tpu_torch.models.phase.knm import (
    AdaptiveKnmConfig,
    AdaptiveKnmState,
    KnmSpec,
    adaptive_knm_update,
    build_knm_plasma,
    build_knm_plasma_from_config,
    init_adaptive_state,
    plasma_omega,
)
from scpn_fusion_tpu_torch.models.phase.kuramoto import (
    KuramotoTrace,
    kuramoto_step,
    lyapunov_exponent,
    lyapunov_v,
    order_parameter,
    resolve_psi,
    run_kuramoto,
    wrap_phase,
)
from scpn_fusion_tpu_torch.models.phase.upde import (
    UPDETrace,
    global_order_parameter,
    layer_order_parameters,
    run_upde,
    upde_tick,
)

__all__ = [
    "AdaptiveKnmConfig",
    "AdaptiveKnmState",
    "GuardConfig",
    "GuardState",
    "GuardVerdict",
    "KnmSpec",
    "KuramotoTrace",
    "UPDETrace",
    "adaptive_knm_update",
    "build_knm_plasma",
    "build_knm_plasma_from_config",
    "global_order_parameter",
    "guard_check",
    "guard_check_trajectory",
    "init_adaptive_state",
    "init_guard",
    "kuramoto_step",
    "layer_order_parameters",
    "lyapunov_exponent",
    "lyapunov_v",
    "order_parameter",
    "plasma_omega",
    "resolve_psi",
    "run_kuramoto",
    "run_upde",
    "upde_tick",
    "wrap_phase",
]
from scpn_fusion_tpu_torch.models.phase.monitor import (  # noqa: F401, E402
    MonitorConfig,
    MonitorTrace,
    PhaseStreamCodec,
    adaptive_knm_from_gk,
    gk_natural_frequencies,
    init_monitor,
    monitor_tick,
    run_monitor,
    stream_trace,
)
