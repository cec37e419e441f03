"""Convergent 2D-tile distributed multigrid (port of
``scpn_fusion_tpu/parallel/sharded_mg2d.py``).

The Z-slab V-cycle of ``parallel/sharded_mg.py`` on the 2D Cartesian tile
decomposition: fine-level red-black smoothing and the defect run tile by
tile with four halo exchanges a half-sweep (``parallel/halo2d.Tiling``), the
fine defect is gathered once a V-cycle over both axes, and the coarse
hierarchy runs replicated (once on each distinct device) on the plain
``ops.multigrid._vcycle_impl``.  Global (row, column) parity keeps the
solve iteration-identical across tilings.  Grids that do not divide are
padded to tile multiples and sliced back on exit.  Plain PyTorch ops only.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.ops.multigrid import (
    _vcycle_impl,
    prolongate_bilinear,
    restrict_full_weight,
)
from scpn_fusion_tpu_torch.parallel.halo2d import Tiling, grid_of, make_2d_mesh, pad_to
from scpn_fusion_tpu_torch.parallel.mesh import Mesh, gather_tiles, shard_tiles
from scpn_fusion_tpu_torch.parallel.sharded_mg import _replicated_coarse, mg_solve_gated


def sharded_vcycle_2d(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                      omega: float | torch.Tensor, *, mesh: Mesh, d_r: float, d_z: float,
                      pre_smooth: int = 3, post_smooth: int = 3, min_grid: int = 5,
                      coarse_sweeps: int = 50) -> torch.Tensor:
    """One distributed V-cycle with the fine level 2D-tiled over the
    two-axis ``mesh``; returns the global field on the mesh's first
    device."""
    pz, pr = grid_of(mesh)
    nz, nr = psi.shape
    omega = float(omega)
    tiles = shard_tiles(pad_to(psi, pz, pr), pz, pr, mesh)
    srcs = shard_tiles(pad_to(source, pz, pr), pz, pr, mesh)
    tiling = Tiling(mesh, tiles, r_1d, d_r, d_z, nz, nr)

    tiles = tiling.smooth(tiles, srcs, omega, pre_smooth)
    d_local = tiling.defect(tiles, srcs)
    nz_c, nr_c = (nz + 1) // 2, (nr + 1) // 2

    def coarse(d_full):
        d_c = restrict_full_weight(d_full[:nz, :nr].contiguous())
        e_c = _vcycle_impl(torch.zeros((nz_c, nr_c), dtype=psi.dtype, device=d_full.device), d_c,
                           r_1d.to(d_full.device)[::2], d_r * 2.0, d_z * 2.0, 1.0, pre_smooth,
                           post_smooth, min_grid, coarse_sweeps)
        return pad_to(prolongate_bilinear(e_c, nz, nr), pz, pr)

    corr = _replicated_coarse(mesh, lambda d: gather_tiles(d_local, pz, pr, d), coarse)
    lz, lr = tiles[0].shape
    tiles = [t + corr[t.device][ro:ro + lz, co:co + lr]
             for t, (ro, co) in zip(tiles, tiling.offsets)]
    tiles = tiling.smooth(tiles, srcs, omega, post_smooth)
    return gather_tiles(tiles, pz, pr, mesh.first)[:nz, :nr]


def sharded_mg_solve_2d(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, *,
                        mesh: Mesh, d_r: float, d_z: float, tol: float = 1e-8,
                        max_cycles: int = 50):
    """Converged 2D-tile distributed linear solve (residual-gated
    V-cycles); returns ``(psi, res_rms, n_cycles)`` on the mesh's first
    device."""
    dev = mesh.first
    psi, source, r_1d = psi.to(dev), source.to(dev), r_1d.to(dev)
    return mg_solve_gated(
        lambda p: sharded_vcycle_2d(p, source, r_1d, 1.0, mesh=mesh, d_r=d_r, d_z=d_z),
        psi, source, r_1d, d_r, d_z, tol, max_cycles)


@functools.lru_cache(maxsize=16)
def _make_elliptic_fn_2d(mesh: Mesh, grid: Grid):
    """One elliptic step ``(psi, source) -> psi`` per (mesh, grid)."""
    d_r, d_z = float(grid.dR), float(grid.dZ)
    r_1d = grid.R

    def elliptic(psi, source):
        return sharded_vcycle_2d(psi, source, r_1d.to(psi.dtype), 1.0, mesh=mesh, d_r=d_r,
                                 d_z=d_z)

    return elliptic


def solve_equilibrium_sharded_2d(cfg, mesh: Mesh | None = None, *,
                                 n_devices: int | None = None, dtype=torch.float32,
                                 psi0: torch.Tensor | None = None, skip_seed: bool = False):
    """Full converged GS equilibrium with the elliptic inner solve 2D-tiled:
    the Picard/Anderson loop and result of ``solve_equilibrium_sharded``
    with another decomposition.  ``mesh`` defaults to the most-square
    process grid over the CUDA devices (``make_2d_mesh``); the outer loop
    runs on the mesh's first device."""
    from scpn_fusion_tpu_torch.parallel.sharded_solve import _solve_with_elliptic

    if mesh is None:
        mesh = make_2d_mesh(n_devices)
    grid = Grid.from_config(cfg, dtype=dtype, device=mesh.first)
    return _solve_with_elliptic(cfg, grid, _make_elliptic_fn_2d(mesh, grid), psi0, skip_seed)
