from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (  # noqa: F401
    EquilibriumResult,
    solve_equilibrium,
    solve_equilibrium_fmg,
)
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi  # noqa: F401
from scpn_fusion_tpu_torch.models.equilibrium.amr import (  # noqa: F401
    AMRPatchResult,
    refine_x_point,
)
from scpn_fusion_tpu_torch.models.equilibrium.differentiable import (  # noqa: F401
    PredictiveTheta,
    axis_sensitivity,
    build_predictive_model,
    fixed_point_ift,
    solve_predictive_diff,
)
from scpn_fusion_tpu_torch.models.equilibrium.compact_basis import (  # noqa: F401
    FixedBasis,
    chebyshev_psi_basis,
    continuation_history_reset,
    profile_bspline_basis,
)
from scpn_fusion_tpu_torch.models.equilibrium.rigid_body_stability import (  # noqa: F401
    RigidBodyReport,
    analyze_rigid_body,
    ring_forces,
    stability_landscape,
    vacuum_field_at,
)
