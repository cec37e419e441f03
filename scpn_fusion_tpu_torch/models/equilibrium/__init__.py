from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (  # noqa: F401
    EquilibriumResult,
    solve_equilibrium,
    solve_equilibrium_fmg,
)
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi  # noqa: F401
