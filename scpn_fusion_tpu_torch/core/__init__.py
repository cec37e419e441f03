from scpn_fusion_tpu_torch.core.config import (  # noqa: F401
    Coil,
    Dimensions,
    PhysicsParams,
    ProfileParams,
    ReactorConfig,
    SolverParams,
    load_config,
)
from scpn_fusion_tpu_torch.core.grid import Grid  # noqa: F401
