"""2D Cartesian tile decomposition with halo exchange over a device mesh
(port of ``scpn_fusion_tpu/parallel/halo2d.py``).

The psi grid is cut into a ``pz`` x ``pr`` grid of tiles over a two-axis
:class:`~.mesh.Mesh` ``("tz", "tr")``; each red-black half-sweep exchanges
one halo row with the Z neighbours and then one halo column of the
Z-padded tiles with the R neighbours (four exchanges a half-sweep, zeros
past the global boundary), and the update norm is a psum over both axes.
Checkerboard parity comes from global (row, column) offsets, so the tiled
sweep is the monolithic sweep's arithmetic.  Plain PyTorch ops only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from scpn_fusion_tpu_torch.ops.stencil import stencil_coeffs
from scpn_fusion_tpu_torch.parallel.mesh import (
    Mesh,
    devices_of,
    gather_tiles,
    make_mesh,
    psum,
    shard_tiles,
)


def optimal_process_grid(n_devices: int) -> tuple[int, int]:
    """Most-square factorisation pz x pr = n (reference
    ``optimal_process_grid``, ``mpi_domain.rs:1009``)."""
    best = (1, n_devices)
    for pz in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % pz == 0:
            best = (pz, n_devices // pz)
    return best


def make_2d_mesh(n_devices: int | None = None, axes: tuple[str, str] = ("tz", "tr"), *,
                 device: torch.device | str = "cuda") -> Mesh:
    """2D mesh of the most-square process grid over the first ``n_devices``
    CUDA devices (raising when the host has fewer), or ``n_devices`` CPU
    shards with ``device="cpu"``."""
    if n_devices is None:
        n_devices = len(devices_of(None, device))
    return make_mesh(n_devices, tuple(axes), optimal_process_grid(n_devices), device)


def grid_of(mesh: Mesh) -> tuple[int, int]:
    """``(pz, pr)`` of a two-axis mesh."""
    if len(mesh.axis_names) != 2:
        raise ValueError(f"a tiled solve needs a two-axis mesh; got axes {mesh.axis_names}")
    return mesh.axis_sizes


def _tile_halo_pad(tiles: list[torch.Tensor], pz: int, pr: int) -> list[torch.Tensor]:
    """Every tile padded with one exchanged halo row and column on each
    side: first the Z neighbours' edge rows, then the R neighbours' edge
    columns of their Z-padded tiles (zeros past the global boundary)."""
    def at(i, j):
        return i * pr + j

    p_z = []
    for i in range(pz):
        for j in range(pr):
            t = tiles[at(i, j)]
            top = tiles[at(i - 1, j)][-1].to(t.device) if i > 0 else torch.zeros_like(t[0])
            bot = tiles[at(i + 1, j)][0].to(t.device) if i + 1 < pz else torch.zeros_like(t[0])
            p_z.append(torch.cat([top[None], t, bot[None]], 0))
    out = []
    for i in range(pz):
        for j in range(pr):
            t = p_z[at(i, j)]
            lft = p_z[at(i, j - 1)][:, -1].to(t.device) if j > 0 else torch.zeros_like(t[:, 0])
            rgt = p_z[at(i, j + 1)][:, 0].to(t.device) if j + 1 < pr else torch.zeros_like(t[:, 0])
            out.append(torch.cat([lft[:, None], t, rgt[:, None]], 1))
    return out


@functools.lru_cache(maxsize=512)
def _tile_interior(lz: int, lr: int, row_off: int, col_off: int, nz_total: int, nr_total: int,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A tile's global interior mask and its global ``(row + column) % 2``."""
    iz = torch.arange(lz, device=device)[:, None] + row_off
    ir = torch.arange(lr, device=device)[None, :] + col_off
    interior = (iz >= 1) & (iz <= nz_total - 2) & (ir >= 1) & (ir <= nr_total - 2)
    return interior, (iz + ir) % 2


@functools.lru_cache(maxsize=512)
def _tile_mask(lz, lr, row_off, col_off, nz_total, nr_total, parity, device, dtype):
    interior, par = _tile_interior(lz, lr, row_off, col_off, nz_total, nr_total, device)
    return (interior & (par == parity)).to(dtype)


class Tiling:
    """Where each tile of a ``pz`` x ``pr`` tiling sits and its slice of the
    R coefficient rows (full width, zero on the ring and the padding)."""

    def __init__(self, mesh: Mesh, tiles: list[torch.Tensor], r_1d: torch.Tensor, d_r: float,
                 d_z: float, nz_total: int, nr_total: int):
        self.pz, self.pr = grid_of(mesh)
        lz, lr = tiles[0].shape
        self.offsets = [(i * lz, j * lr) for i in range(self.pz) for j in range(self.pr)]
        a_e, a_w, self.a_ns, self.a_c = stencil_coeffs(r_1d[1:nr_total - 1], d_r, d_z)
        width = self.pr * lr
        a_e_f = torch.zeros(width, dtype=r_1d.dtype, device=r_1d.device)
        a_w_f = torch.zeros_like(a_e_f)
        a_e_f[1:nr_total - 1] = a_e
        a_w_f[1:nr_total - 1] = a_w
        self.ae = [a_e_f[c:c + lr].to(t.device) for (_, c), t in zip(self.offsets, tiles)]
        self.aw = [a_w_f[c:c + lr].to(t.device) for (_, c), t in zip(self.offsets, tiles)]
        self.nz_total, self.nr_total = nz_total, nr_total

    def half_sweep(self, tiles, sources, omega: float, parity: int):
        """One red-black half-sweep on every tile (global parity)."""
        out = []
        for t, pp, src, ae, aw, (ro, co) in zip(tiles, _tile_halo_pad(tiles, self.pz, self.pr),
                                                 sources, self.ae, self.aw, self.offsets):
            gs = (ae[None, :] * pp[1:-1, 2:] + aw[None, :] * pp[1:-1, :-2]
                  + self.a_ns * (pp[:-2, 1:-1] + pp[2:, 1:-1]) - src) / self.a_c
            mask = _tile_mask(*t.shape, ro, co, self.nz_total, self.nr_total, parity, t.device,
                              t.dtype)
            out.append(t + mask * omega * (gs - t))
        return out

    def smooth(self, tiles, sources, omega: float, n_sweeps: int):
        for _ in range(n_sweeps):
            for parity in (0, 1):
                tiles = self.half_sweep(tiles, sources, omega, parity)
        return tiles

    def defect(self, tiles, sources):
        """Residual ``S - L[psi]`` on every tile, zero outside the global
        interior."""
        out = []
        for t, pp, src, ae, aw, (ro, co) in zip(tiles, _tile_halo_pad(tiles, self.pz, self.pr),
                                                 sources, self.ae, self.aw, self.offsets):
            lap = (ae[None, :] * pp[1:-1, 2:] + aw[None, :] * pp[1:-1, :-2]
                   + self.a_ns * (pp[:-2, 1:-1] + pp[2:, 1:-1]) - self.a_c * pp[1:-1, 1:-1])
            interior, _ = _tile_interior(*t.shape, ro, co, self.nz_total, self.nr_total,
                                         t.device)
            out.append(torch.where(interior, src - lap, torch.zeros_like(t)))
        return out


def pad_to(x: torch.Tensor, pz: int, pr: int) -> torch.Tensor:
    """``x`` padded with zero rows and columns to multiples of the grid."""
    return F.pad(x, (0, (-x.shape[1]) % pr, 0, (-x.shape[0]) % pz))


def sharded_sor_solve_2d(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                         omega: float | torch.Tensor, *, mesh: Mesh, d_r: float, d_z: float,
                         n_sweeps: int, nz_total: int, nr_total: int):
    """Red-black SOR on a 2D-tiled grid (rows and columns must divide into
    the tiles); returns ``(psi, last-sweep L2 delta)`` on the mesh's first
    device."""
    pz, pr = grid_of(mesh)
    tiles = shard_tiles(psi, pz, pr, mesh)
    srcs = shard_tiles(source, pz, pr, mesh)
    tiling = Tiling(mesh, tiles, r_1d, d_r, d_z, nz_total, nr_total)
    omega = float(omega)
    res = torch.zeros((), dtype=psi.dtype, device=mesh.first)
    for _ in range(n_sweeps):
        prev = tiles
        tiles = tiling.smooth(tiles, srcs, omega, 1)
        res = torch.sqrt(psum([((a - b) ** 2).sum() for a, b in zip(tiles, prev)])[0])
    return gather_tiles(tiles, pz, pr, mesh.first), res
