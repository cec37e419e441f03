"""Parallel equilibrium solves (port of ``scpn_fusion_tpu/parallel``): the
Z-slab and 2D-tile sharded solves on a single-controller device mesh
(``parallel/mesh.py``) and the batched ensembles."""

from scpn_fusion_tpu_torch.parallel.halo import (  # noqa: F401
    make_z_mesh,
    sharded_sor_solve,
)
from scpn_fusion_tpu_torch.parallel.sharded_fb import (  # noqa: F401
    solve_free_boundary_sharded,
)
from scpn_fusion_tpu_torch.parallel.sharded_solve import (  # noqa: F401
    solve_equilibrium_sharded,
    solve_equilibrium_sharded_fmg,
)
