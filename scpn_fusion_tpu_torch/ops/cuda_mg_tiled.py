"""Tiled fine-level V-cycle legs as hand-written CUDA kernels (port of
``scpn_fusion_tpu/ops/pallas_mg_tiled.py``).

The legs of the square 2^k+1 levels from 1025^2 to 4097^2, each ONE launch
of ``csrc/tiled_legs.cu``:

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
halo, bands, threads, shared memory) here in Python.

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

import ctypes
import dataclasses
import functools

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops.cuda_mg import (
    fine_presmooth_restrict_plain,
    fine_prolong_smooth_plain,
)
from scpn_fusion_tpu_torch.ops.cuda_stencil import check_level, level_scalars

DEFAULT_TILE = 64
SMEM_LIMIT = 232_448   # dynamic shared memory a block may opt in to on Hopper


# The kernels' instantiations, in the order of csrc/tiled_legs.cu: (rows of a
# thread's band, pitch of a slab row in shared memory, most threads a block,
# blocks an SM the registers allow).
VARIANTS = ((20, 80, 320, 3), (36, 176, 1024, 1))
LEGS = ("down", "up")
ALL_STAGES = 5     # down: load, sweep, defect, store the core, full weighting; up has three


def leg_halo(sweeps: int, leg: str = "down") -> int:
    """Halo of a leg: ``2 * sweeps`` for the half-sweeps, on the down leg
    ``+ 2`` for the defect's and the full weighting's radius; at least 2, so
    that the slab of the last tile holds the grid's last line."""
    if leg not in LEGS:
        raise ValueError(f"leg must be one of {LEGS}, got {leg!r}")
    return max(2 * sweeps + (2 if leg == "down" else 0), 2)


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


def tile_spans(n: int, tile: int) -> list[tuple[int, int]]:
    """Core spans ``[start, stop)`` of the tiles along one direction of an
    ``n``-point level: origins ``k * tile``, the last tile ending at ``n``
    (it takes the last line, so no tile is a one-point sliver)."""
    count = max(1, -(-(n - 1) // tile))
    return [(k * tile, n if k == count - 1 else (k + 1) * tile) for k in range(count)]


@dataclasses.dataclass(frozen=True)
class TiledLaunchPlan:
    """One launch of a tiled leg, as ``csrc/tiled_legs.cu`` takes it."""

    leg: str
    nz: int
    nr: int
    tile_rows: int
    tile_cols: int
    halo: int
    sweeps: int
    n_seg: int        # row bands of a slab
    variant: int      # index into VARIANTS
    threads: int
    smem_bytes: int
    stages: int = ALL_STAGES   # fewer: the kernel stops after that many stages (timing only)

    @property
    def seg_len(self) -> int:
        return VARIANTS[self.variant][0]

    @property
    def slab(self) -> tuple[int, int]:
        return self.tile_rows + 2 * self.halo, self.tile_cols + 2 * self.halo

    @property
    def grid(self) -> tuple[int, int]:
        """Blocks along Z and along R."""
        return len(tile_spans(self.nz, self.tile_rows)), len(tile_spans(self.nr, self.tile_cols))

    def row_spans(self) -> list[tuple[int, int]]:
        return tile_spans(self.nz, self.tile_rows)

    def col_spans(self) -> list[tuple[int, int]]:
        return tile_spans(self.nr, self.tile_cols)

    def update_ring(self, half_sweep: int) -> int:
        """Points by which half-sweep ``half_sweep`` (0-based) grows the core
        it updates: one less with every half-sweep, down to 0 (2 on the down
        leg, for the defect and the full weighting)."""
        return 2 * self.sweeps - 1 - half_sweep + (2 if self.leg == "down" else 0)

    def as_ints(self) -> ctypes.Array:
        return (ctypes.c_int * 11)(self.nz, self.nr, self.tile_rows, self.tile_cols, self.halo,
                                   self.sweeps, self.n_seg, self.variant, self.threads,
                                   self.smem_bytes, self.stages)


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
    if nz < 3 or nr < 3:
        raise ValueError(f"a level needs an interior, got {nz} x {nr}")
    tile_rows = _tile_edge(t_rows)
    tile_cols = tile_rows if t_cols is None else _tile_edge(t_cols)
    halo = leg_halo(sweeps, leg)
    sh, sw = tile_rows + 2 * halo, tile_cols + 2 * halo
    best = None
    for index, (seg_len, pitch, max_threads, _) in enumerate(VARIANTS):
        n_seg = -(-(sh - 1) // seg_len)
        threads = -(-(n_seg * sw) // 32) * 32
        # a field holds its slab rows and three guard rows, at the variant's pitch
        words = 2 * (n_seg * seg_len + 3) * pitch
        if sw > pitch or threads > max_threads or words * 4 > SMEM_LIMIT:
            continue
        if best is None or words < best[0]:     # a tie goes to the earlier variant
            best = (words, index, n_seg, threads)
    if best is None:
        raise ValueError(f"a {tile_rows} x {tile_cols} tile with halo {halo} fits no kernel "
                         f"variant: too wide, or more than {SMEM_LIMIT} bytes of shared memory")
    words, variant, n_seg, threads = best
    return TiledLaunchPlan(leg, nz, nr, tile_rows, tile_cols, halo, sweeps, n_seg, variant,
                           threads, words * 4)


def launch_occupancy(plan: TiledLaunchPlan) -> dict:
    """Blocks of ``plan``'s kernel one SM holds, blocks resident on the card
    and the grid's size, asked of the CUDA occupancy API (needs the card)."""
    per_sm = ctypes.c_int(0)
    err = cb.library().scpn_tiled_ctas_per_sm(LEGS.index(plan.leg), plan.as_ints(),
                                              ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"scpn_tiled_ctas_per_sm: CUDA error {err}")
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    grid = plan.grid[0] * plan.grid[1]
    return {"ctas_per_sm": per_sm.value, "resident": per_sm.value * sms, "grid": grid,
            "waves": grid / max(per_sm.value * sms, 1)}


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
    nz, nr = psi.shape
    inv_dr2, a_ns, a_c, inv_ac = level_scalars(d_r, d_z)
    psi_s = torch.empty_like(psi)
    d_c = torch.empty(((nz + 1) // 2, (nr + 1) // 2), dtype=psi.dtype, device=psi.device)
    cb.launch("scpn_tiled_pre", psi.data_ptr(), source.data_ptr(), r_1d.data_ptr(),
              r_1d.stride(0), plan.as_ints(), inv_dr2, d_r, a_ns, a_c, inv_ac, float(omega),
              psi_s.data_ptr(), d_c.data_ptr())
    return psi_s, d_c


def _launch_up(plan: TiledLaunchPlan, psi_s, source, e_coarse, r_1d, d_r, d_z, omega):
    """One launch of the up-leg kernel as ``plan`` says (no call counted)."""
    inv_dr2, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    out = torch.empty_like(psi_s)
    cb.launch("scpn_tiled_post", psi_s.data_ptr(), source.data_ptr(), e_coarse.data_ptr(),
              r_1d.data_ptr(), r_1d.stride(0), plan.as_ints(), inv_dr2, d_r, a_ns, inv_ac,
              float(omega), out.data_ptr())
    return out


def _check_up(psi_s, source, e_coarse, r_1d) -> None:
    check_level("tiled_prolong_smooth", psi_s, source, r_1d)
    cb.check_f32_cuda("tiled_prolong_smooth", e_coarse=e_coarse)
    nz, nr = psi_s.shape
    if tuple(e_coarse.shape) != ((nz + 1) // 2, (nr + 1) // 2):
        raise ValueError(f"tiled_prolong_smooth: coarse shape {tuple(e_coarse.shape)} does "
                         f"not match fine {(nz, nr)}")


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
