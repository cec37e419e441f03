from scpn_fusion_tpu_torch.models.gyrokinetics.geometry import (  # noqa: F401
    MillerGeometry,
    circular_geometry,
    miller_geometry,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.species import (  # noqa: F401
    GKSpecies,
    VelocityGrid,
    bessel_j0,
    collision_frequencies,
    deuterium_ion,
    electron,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.linear import (  # noqa: F401
    EigenMode,
    LinearGKResult,
    solve_eigenvalue_single_ky,
    solve_linear_gk,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.quasilinear import (  # noqa: F401
    mixing_length_saturation,
    quasilinear_fluxes_from_spectrum,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.interface import (  # noqa: F401
    GKLocalParams,
    GKSolverBase,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.registry import (  # noqa: F401
    available_gk_solvers,
    create_gk_solver,
    gk_solver_class,
    register_gk_solver,
    registered_gk_solvers,
    resolve_tglf_solver,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.tglf_native import (  # noqa: F401
    TGLFNativeConfig,
    TGLFNativeSolver,
    tglf_native_fluxes,
    tglf_native_fluxes_profile,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import (  # noqa: F401
    GKState,
    GKTrace,
    NonlinearGKConfig,
    build_grids,
    run_nonlinear_gk,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.hybrid import (  # noqa: F401
    SchedulerConfig,
    corrector_apply,
    corrector_update,
    fit_ood,
    init_corrector,
    init_learner,
    learner_add,
    learner_predict,
    learner_refit,
    ood_check,
    schedule_spot_checks,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.ql_closure import (  # noqa: F401
    QLLocalParams,
    QLTransportModel,
    compute_spectrum as ql_compute_spectrum,
    quasilinear_fluxes as ql_quasilinear_fluxes,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.maxwell_evolution import (  # noqa: F401
    MaxwellEvolutionConfig,
    MaxwellEvolutionResult,
    run_local_maxwell_evolution,
    to_evidence as maxwell_evidence,
)
