"""Distributed free-boundary Grad-Shafranov forward (port of
``scpn_fusion_tpu/parallel/sharded_fb.py``).

The port's free-boundary outer loop (``models/equilibrium/free_boundary.
_run_free_boundary``: Green's tables, optional Tikhonov shape control, the
outer convergence on ``max|dpsi|``) with ``use_pallas=False`` and the inner
elliptic step replaced by the Z-slab ``parallel/sharded_mg.sharded_vcycle``,
as in JAX.  The coil algebra, topology, source and Anderson mixing run the
plain ops on the mesh's first device.
"""

from __future__ import annotations

import torch

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import (
    MU0_SI,
    CoilSet,
    FreeBoundaryResult,
    _run_free_boundary,
    coilset_from_config,
)
from scpn_fusion_tpu_torch.parallel.halo import make_z_mesh
from scpn_fusion_tpu_torch.parallel.mesh import Mesh
from scpn_fusion_tpu_torch.parallel.sharded_solve import _make_elliptic_fn


def solve_free_boundary_sharded(cfg: ReactorConfig, coils: CoilSet | None = None, *,
                                mesh: Mesh | None = None, n_devices: int | None = None,
                                axis: str = "z", grid: Grid | None = None,
                                max_outer_iter: int = 20, tol: float = 1e-4,
                                optimize_shape: bool = False, tikhonov_alpha: float = 1e-4,
                                mu0_green: float | None = None,
                                dtype: torch.dtype = torch.float32) -> FreeBoundaryResult:
    """Free-boundary equilibrium with the inner elliptic solve Z-slab
    sharded over a mesh: the contract of
    ``models.equilibrium.solve_free_boundary``.  Pass a ``mesh`` or
    ``n_devices`` (CUDA devices); the loop and the result live on the mesh's
    first device."""
    if mesh is None:
        mesh = make_z_mesh(n_devices, axis=axis)
    if grid is None:
        grid = Grid.from_config(cfg, dtype=dtype, device=mesh.first)
    if coils is None:
        coils = coilset_from_config(cfg, dtype, grid.device)
    if mu0_green is None:
        mu0_green = float(MU0_SI)
    if optimize_shape and coils.target_flux_points is None:
        raise ValueError("optimize_shape requires CoilSet.target_flux_points")
    return _run_free_boundary(
        coils, cfg=cfg, grid=grid, max_outer_iter=int(max_outer_iter), tol=float(tol),
        optimize_shape=bool(optimize_shape), tikhonov_alpha=float(tikhonov_alpha),
        mu0_green=float(mu0_green), use_pallas=False,
        elliptic_fn=_make_elliptic_fn(mesh, axis, grid))
