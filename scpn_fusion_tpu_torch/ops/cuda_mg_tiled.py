"""Tiled fine-level V-cycle legs as hand-written CUDA kernels (port of
``scpn_fusion_tpu/ops/pallas_mg_tiled.py``).

The legs of the square 2^k+1 levels from 1025^2 to 4097^2, each ONE launch
of ``csrc/tiled_legs.cu`` (the band kernels of ``csrc/tiled_band.cuh``
instantiated for grids of many waves; ``ops/cuda_mg`` launches the same code
on smaller tiles for the levels up to 513^2):

* ``tiled_presmooth_restrict`` = ``pre_smooth`` red-black SOR sweeps, the
  defect ``s - L[psi]`` and its 9-point full weighting, written compact with
  a zero ring;
* ``tiled_prolong_smooth`` = bilinear prolongation of the compact coarse
  error, the correction on the interior, ``post_smooth`` sweeps.

The Pallas kernels tile over full-width Z-chunks; here each CUDA block owns a
tile of ``t_rows`` x ``t_rows`` points (both directions: at 2049 wide one row
of psi and src is 16 KB, so full-width chunks do not fit in shared memory),
the last tile of each direction taking the grid's last line as well, and
sweeps a slab with a halo of ``2 * pre + 2`` (down leg) or ``2 * post`` (up
leg) points, with the halo contract of ``pallas_mg_tiled.py:21-36`` (global
red/black parity and interior mask, the Dirichlet ring never updated, only
the core written).  Each thread keeps a band of one slab column in registers;
each half-sweep updates only the ring of the halo that the later half-sweeps
still need.  :func:`launch_plan` makes the whole plan of a launch (tiles,
halo, bands, threads, shared memory) in Python (``ops/leg_plan``).

Each wrapper takes the JAX signature minus ``interpret``: on CUDA float32
tensors it launches its kernel and adds one to ``cb.CALLS[<its name>]``; on
CPU tensors it runs the ``*_plain`` version beside it, the untiled
arithmetic of ``cuda_mg.fine_*_plain`` (``t_rows`` only shapes the launch).

``_tiled_presmooth_restrict_slab`` / ``_tiled_prolong_smooth_slab`` launch the
first design of these kernels (``csrc/tiled_legs_slab.cu``: one thread
striding over a (64 + 2 * halo)^2 slab).  No solver path calls them; they are
the reference the kernels must equal bit for bit and the earlier time
measured beside them.
"""

from __future__ import annotations

import functools

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops import leg_plan
from scpn_fusion_tpu_torch.ops.cuda_mg import (
    fine_presmooth_restrict_plain,
    fine_prolong_smooth_plain,
)
from scpn_fusion_tpu_torch.ops.cuda_stencil import check_level, level_scalars
from scpn_fusion_tpu_torch.ops.leg_plan import (  # noqa: F401  (part of this module's interface)
    ALL_STAGES,
    LEGS,
    SMEM_LIMIT,
    leg_halo,
    tile_spans,
)
from scpn_fusion_tpu_torch.ops.leg_plan import LegLaunchPlan as TiledLaunchPlan

DEFAULT_TILE = 64


# The kernels' instantiations, in the order of csrc/tiled_legs.cu: (rows of a
# thread's band, pitch of a slab row in shared memory, most threads a block,
# blocks an SM the registers allow).
VARIANTS = ((20, 80, 320, 3), (36, 176, 1024, 1))


def _tile_edge(t_rows: int | None) -> int:
    return DEFAULT_TILE if t_rows is None else int(t_rows) + (int(t_rows) & 1)


def tile_plan(t_rows: int | None, sweeps: int, leg: str = "down") -> tuple[int, int]:
    """(tile edge, halo) of a launch: ``t_rows`` rounded up to even (the
    coarse points of a tile sit on its even rows), halo :func:`leg_halo`."""
    tile = _tile_edge(t_rows)
    if tile < 2 or sweeps < 0:
        raise ValueError(f"need t_rows >= 1 and sweeps >= 0, got {t_rows}, {sweeps}")
    halo = leg_halo(sweeps, leg)
    n = tile + 2 * halo
    if (2 * n * n + 2 * n) * 4 > SMEM_LIMIT:
        raise ValueError(f"a {tile}^2 tile with halo {halo} needs more than "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return tile, halo


@functools.lru_cache(maxsize=256)
def launch_plan(leg: str, nz: int, nr: int, sweeps: int, t_rows: int | None = None,
                t_cols: int | None = None) -> TiledLaunchPlan:
    """The launch of one leg on an ``nz`` x ``nr`` level: tile (``t_rows`` x
    ``t_cols``, rounded up to even; 64 x 64 by default), halo,
    the kernel variant that holds the slab in the least shared memory, bands,
    threads and shared-memory bytes.  Raises ``ValueError`` for a
    tile that does not fit a block."""
    if sweeps < 0 or (t_rows is not None and t_rows < 1) or (t_cols is not None and t_cols < 1):
        raise ValueError(f"need t_rows >= 1 and sweeps >= 0, got {t_rows}, {sweeps}")
    tile_rows = _tile_edge(t_rows)
    tile_cols = tile_rows if t_cols is None else _tile_edge(t_cols)
    return leg_plan.plan_launch(leg, nz, nr, sweeps, tile_rows, tile_cols, VARIANTS)


def launch_occupancy(plan: TiledLaunchPlan) -> dict:
    """Blocks of ``plan``'s kernel one SM holds, blocks resident on the card
    and the grid's size, asked of the CUDA occupancy API (needs the card)."""
    return leg_plan.launch_occupancy("scpn_tiled_ctas_per_sm", plan)


def tiled_presmooth_restrict_plain(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth=3,
                                   t_rows=None):
    """Plain version of :func:`tiled_presmooth_restrict` (untiled)."""
    return fine_presmooth_restrict_plain(psi, source, r_1d, d_r, d_z, omega,
                                         pre_smooth=pre_smooth)


def tiled_prolong_smooth_plain(psi_s, source, e_coarse, r_1d, d_r, d_z, omega, *,
                               post_smooth=3, t_rows=None):
    """Plain version of :func:`tiled_prolong_smooth` (untiled)."""
    return fine_prolong_smooth_plain(psi_s, source, e_coarse, r_1d, d_r, d_z, omega,
                                     post_smooth=post_smooth)


def _launch_down(plan: TiledLaunchPlan, psi, source, r_1d, d_r, d_z, omega):
    """One launch of the down-leg kernel as ``plan`` says (no call counted)."""
    return leg_plan.launch_down("scpn_tiled_pre", plan.as_ints(), psi, source, r_1d, d_r, d_z,
                                omega)


def _launch_up(plan: TiledLaunchPlan, psi_s, source, e_coarse, r_1d, d_r, d_z, omega):
    """One launch of the up-leg kernel as ``plan`` says (no call counted)."""
    return leg_plan.launch_up("scpn_tiled_post", plan.as_ints(), psi_s, source, e_coarse, r_1d,
                              d_r, d_z, omega)


def _check_up(psi_s, source, e_coarse, r_1d) -> None:
    leg_plan.check_up("tiled_prolong_smooth", psi_s, source, e_coarse, r_1d)


def tiled_presmooth_restrict(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                             d_r: float, d_z: float, omega: float, *, pre_smooth: int = 3,
                             t_rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled fine-level down leg in one launch: ``(psi_smoothed, d_coarse)``,
    the coarse defect compact with a zero ring."""
    if not psi.is_cuda:
        return tiled_presmooth_restrict_plain(psi, source, r_1d, d_r, d_z, omega,
                                              pre_smooth=pre_smooth)
    check_level("tiled_presmooth_restrict", psi, source, r_1d)
    plan = launch_plan("down", psi.shape[0], psi.shape[1], pre_smooth, t_rows)
    result = _launch_down(plan, psi, source, r_1d, d_r, d_z, omega)
    cb.CALLS["tiled_presmooth_restrict"] += 1
    return result


def tiled_prolong_smooth(psi_s: torch.Tensor, source: torch.Tensor, e_coarse: torch.Tensor,
                         r_1d: torch.Tensor, d_r: float, d_z: float, omega: float, *,
                         post_smooth: int = 3, t_rows: int | None = None) -> torch.Tensor:
    """Tiled fine-level up leg in one launch: bilinear prolongation of the
    compact coarse error, correction on the interior, ``post_smooth`` sweeps."""
    if not psi_s.is_cuda:
        return tiled_prolong_smooth_plain(psi_s, source, e_coarse, r_1d, d_r, d_z, omega,
                                          post_smooth=post_smooth)
    _check_up(psi_s, source, e_coarse, r_1d)
    plan = launch_plan("up", psi_s.shape[0], psi_s.shape[1], post_smooth, t_rows)
    out = _launch_up(plan, psi_s, source, e_coarse, r_1d, d_r, d_z, omega)
    cb.CALLS["tiled_prolong_smooth"] += 1
    return out


def _tiled_presmooth_restrict_slab(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth=3,
                                   t_rows=None):
    """The down leg through the first design of the kernel (a predecessor
    kept for comparison; CUDA tensors only)."""
    check_level("tiled_presmooth_restrict", psi, source, r_1d)
    tile, halo = tile_plan(t_rows, pre_smooth)
    nz, nr = psi.shape
    inv_dr2, a_ns, a_c, inv_ac = level_scalars(d_r, d_z)
    psi_s = torch.empty_like(psi)
    d_c = torch.empty(((nz + 1) // 2, (nr + 1) // 2), dtype=psi.dtype, device=psi.device)
    cb.launch("scpn_tiled_pre_slab", psi.data_ptr(), source.data_ptr(), r_1d.data_ptr(),
              r_1d.stride(0), nz, nr, tile, halo, pre_smooth, inv_dr2, d_r, a_ns, a_c, inv_ac,
              float(omega), psi_s.data_ptr(), d_c.data_ptr())
    return psi_s, d_c


def _tiled_prolong_smooth_slab(psi_s, source, e_coarse, r_1d, d_r, d_z, omega, *,
                               post_smooth=3, t_rows=None):
    """The up leg through the first design of the kernel (a predecessor kept
    for comparison; CUDA tensors only)."""
    _check_up(psi_s, source, e_coarse, r_1d)
    tile, halo = tile_plan(t_rows, post_smooth)
    nz, nr = psi_s.shape
    inv_dr2, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    out = torch.empty_like(psi_s)
    cb.launch("scpn_tiled_post_slab", psi_s.data_ptr(), source.data_ptr(), e_coarse.data_ptr(),
              r_1d.data_ptr(), r_1d.stride(0), nz, nr, tile, halo, post_smooth, inv_dr2, d_r,
              a_ns, inv_ac, float(omega), out.data_ptr())
    return out
