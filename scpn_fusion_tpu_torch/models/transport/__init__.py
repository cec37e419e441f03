from scpn_fusion_tpu_torch.models.transport.solver import (  # noqa: F401
    TransportParams,
    TransportState,
    evolve_profiles,
    initial_state,
    run_transport,
)
from scpn_fusion_tpu_torch.models.transport.momentum_lh import (  # noqa: F401
    LHState,
    MomentumParams,
    evolve_rotation,
    lh_transition_step,
    martin_lh_threshold_mw,
)
