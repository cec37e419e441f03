"""Multigrid V-cycle legs as hand-written CUDA kernels (port of
``scpn_fusion_tpu/ops/pallas_mg.py``).

The Pallas kernels keep whole levels in VMEM, embedded at stride 2^k in the
entry-level array.  Here every level is compacted (the ``x[::2, ::2]`` grid
of the level above, so level-local red/black parity is plain ``(i+j) % 2``).
Each fine leg is one launch, and so is the fused V-cycle:

* ``fine_presmooth_restrict`` = ``pre_smooth`` SOR sweeps, the defect
  ``s - L[psi]`` and its 9-point full weighting, written compact with a zero
  ring: one launch of ``csrc/fine_legs.cu`` (entry ``scpn_fine_pre``).
* ``fine_prolong_smooth`` = bilinear prolongation of the compact coarse error,
  added on the interior, and ``post_smooth`` sweeps: one launch of
  ``csrc/fine_legs.cu`` (entry ``scpn_fine_post``).
  Both kernels cut the level into small tiles, one block a tile, each block
  recomputing the halo its half-sweeps need, so that a 513^2 level fills the
  card once with many short-lived warps and no stage waits on another block;
  :func:`fine_launch_plan` chooses the tile and makes the launch's plan.
  ``_presmooth_restrict_launch`` / ``_prolong_smooth_launch`` are the staged
  route they replace (``csrc/rb_sweep.cu`` + ``csrc/transfer.cu``, one launch
  per dependent stage: three and five at (1, 2) smoothing): the reference the
  one-launch legs must equal bit for bit and the earlier time measured beside
  them.  No solver path calls them.
* ``fused_coarse_vcycle`` = one launch of ``csrc/vcycle_fused.cu``: every
  level from the entry (at most 257^2) down to ``min_grid`` stays in the
  shared memory of one 8-CTA thread-block cluster for the whole cycle, laid
  out by :func:`vcycle_launch_plan`.  ``_fused_coarse_vcycle_staged`` is the
  same cycle as a host loop over the two legs' launchers: the reference that
  the one-launch kernel must equal bit for bit, used by ``chip_smoke.py``
  alone.

Each wrapper takes the JAX signature minus ``interpret``: on CUDA float32
tensors it launches the kernels, on CPU tensors it runs the ``*_plain``
version beside it, which does the same arithmetic with PyTorch ops.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops import leg_plan
from scpn_fusion_tpu_torch.ops.cuda_stencil import (
    check_level,
    ew_rows,
    level_scalars,
    sor_sweeps_plain,
    sweeps_in_place,
)


def level_plan(n: int, min_grid: int) -> list[int]:
    """Grid sizes visited by the V-cycle, entry first, coarsest last."""
    ns = [n]
    while min_grid < ns[-1]:
        ns.append((ns[-1] + 1) // 2)
    return ns


def is_pow2_plus1_square(shape) -> bool:
    nz, nr = shape
    return nz == nr and nz >= 3 and ((nz - 1) & (nz - 2)) == 0


# ── plain versions ──


def _coarse_slices(nc: int, off: int) -> slice:
    """Fine indices 2*I + off for the coarse interior I = 1 .. nc-2."""
    return slice(2 + off, 2 * (nc - 2) + 1 + off, 2)


def defect_restrict_plain(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                          d_r: float, d_z: float) -> torch.Tensor:
    """Full-weighted defect ``s - L[psi]``, compact, zero coarse ring."""
    nz, nr = psi.shape
    nzc, nrc = (nz + 1) // 2, (nr + 1) // 2
    _, a_ns, a_c, _ = level_scalars(d_r, d_z)
    a_e, a_w = ew_rows(r_1d, d_r)
    lap = (a_e[None, 1:-1] * psi[1:-1, 2:] + a_w[None, 1:-1] * psi[1:-1, :-2]
           + a_ns * (psi[2:, 1:-1] + psi[:-2, 1:-1]) - a_c * psi[1:-1, 1:-1])
    d = torch.zeros_like(psi)
    d[1:-1, 1:-1] = source[1:-1, 1:-1] - lap

    def at(di: int, dj: int) -> torch.Tensor:
        return d[_coarse_slices(nzc, di), _coarse_slices(nrc, dj)]

    edge = at(0, 1) + at(0, -1) + at(1, 0) + at(-1, 0)
    diag = at(1, 1) + at(1, -1) + at(-1, 1) + at(-1, -1)
    d_c = torch.zeros((nzc, nrc), dtype=psi.dtype, device=psi.device)
    d_c[1:-1, 1:-1] = 0.25 * at(0, 0) + 0.125 * edge + 0.0625 * diag
    return d_c


def prolong_correct_plain(psi_s: torch.Tensor, e_coarse: torch.Tensor) -> torch.Tensor:
    """``psi_s`` plus the bilinear prolongation of ``e_coarse`` on the interior."""
    nz, nr = psi_s.shape
    e = e_coarse
    corr = torch.zeros((2 * e.shape[0], 2 * e.shape[1]), dtype=psi_s.dtype,
                       device=psi_s.device)
    corr[0::2, 0::2] = e
    corr[0::2, 1:-2:2] = 0.5 * (e[:, 1:] + e[:, :-1])
    corr[1:-2:2, 0::2] = 0.5 * (e[1:, :] + e[:-1, :])
    corr[1:-2:2, 1:-2:2] = 0.25 * (((e[1:, 1:] + e[1:, :-1]) + e[:-1, 1:]) + e[:-1, :-1])
    out = psi_s.clone()
    out[1:-1, 1:-1] = psi_s[1:-1, 1:-1] + corr[1:nz - 1, 1:nr - 1]
    return out


def fine_presmooth_restrict_plain(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth=3):
    """Plain version of :func:`fine_presmooth_restrict`."""
    psi_s = sor_sweeps_plain(psi, source, r_1d, d_r, d_z, omega, pre_smooth)
    return psi_s, defect_restrict_plain(psi_s, source, r_1d, d_r, d_z)


def fine_prolong_smooth_plain(psi_s, source, e_coarse, r_1d, d_r, d_z, omega, *,
                              post_smooth=3):
    """Plain version of :func:`fine_prolong_smooth`."""
    p = prolong_correct_plain(psi_s, e_coarse)
    return sor_sweeps_plain(p, source, r_1d, d_r, d_z, omega, post_smooth)


def _compact_vcycle(psi, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                    min_grid, coarse_sweeps, down, up, sweeps):
    nz, nr = psi.shape
    if not is_pow2_plus1_square((nz, nr)):
        raise ValueError(f"fused V-cycle needs a square 2^k+1 grid; got {tuple(psi.shape)}")
    saved = []
    p, s, r, dr, dz = psi, source, r_1d, d_r, d_z
    for _ in level_plan(nz, min_grid)[:-1]:
        p_s, d_c = down(p, s, r, dr, dz, omega, pre_smooth=pre_smooth)
        saved.append((p_s, s, r, dr, dz))
        p, s, r, dr, dz = torch.zeros_like(d_c), d_c, r[::2], dr * 2.0, dz * 2.0
    p = sweeps(p, s, r, dr, dz, omega, coarse_sweeps)
    for p_s, s_f, r_f, dr_f, dz_f in reversed(saved):
        p = up(p_s, s_f, p, r_f, dr_f, dz_f, omega, post_smooth=post_smooth)
    return p


def fused_coarse_vcycle_plain(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth=3,
                              post_smooth=3, min_grid=5, coarse_sweeps=50):
    """Plain version of :func:`fused_coarse_vcycle`."""
    return _compact_vcycle(psi, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                           min_grid, coarse_sweeps, fine_presmooth_restrict_plain,
                           fine_prolong_smooth_plain, sor_sweeps_plain)


# ── the one-launch V-cycle's plan ──
#
# ``csrc/vcycle_fused.cu`` keeps every level in shared memory.  The layout is
# made here, where the CPU tests can check it, and handed to the C entry as
# one struct together with the level constants.

CLUSTER_CTAS = 8            # CTAs of the cluster (the portable maximum)
BANDED_FROM = 129           # levels this wide and wider are cut into row bands
WARP_UP_TO = 17             # levels this wide and narrower are swept by one warp
MAX_ENTRY = 257             # widest entry level the kernel takes
MAX_LEVELS = 8
SMEM_LIMIT = 232448         # shared memory one CTA may opt into on an H100
SCOPE_WARP, SCOPE_BLOCK, SCOPE_CLUSTER = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class VcycleLaunchPlan:
    """Where each level of a V-cycle from ``n`` lives in the cluster's shared
    memory.  Per level, entry first: its width ``levels``, the threads that
    work on it ``scope``, the rows a CTA holds ``rows``, log2 of a band's rows
    ``band_shift`` (31 where CTA 0 holds the whole level) and the float offset
    ``offsets`` of its block (psi rows, source rows, a_E row, a_W row) in
    every CTA's shared memory."""

    levels: tuple[int, ...]
    n_cta: int
    scope: tuple[int, ...]
    rows: tuple[int, ...]
    band_shift: tuple[int, ...]
    offsets: tuple[int, ...]
    smem_bytes: int

    def band(self, level: int, rank: int) -> tuple[int, int]:
        """Rows ``[lo, hi)`` of ``level`` that CTA ``rank`` holds."""
        n = self.levels[level]
        if self.scope[level] != SCOPE_CLUSTER:
            return (0, n) if rank == 0 else (0, 0)
        rows = 1 << self.band_shift[level]
        return rank * rows, n if rank == self.n_cta - 1 else (rank + 1) * rows


@functools.lru_cache(maxsize=64)
def vcycle_launch_plan(n: int, min_grid: int) -> VcycleLaunchPlan:
    """The shared-memory layout of the one-launch V-cycle from an ``n`` x
    ``n`` entry level down to ``min_grid``; raises for a shape the kernel
    does not take."""
    if not is_pow2_plus1_square((n, n)):
        raise ValueError(f"fused V-cycle needs a square 2^k+1 grid; got {(n, n)}")
    if n > MAX_ENTRY:
        raise ValueError(f"the one-launch V-cycle takes entry levels up to {MAX_ENTRY}^2; "
                         f"got {n}^2")
    if min_grid < 3:
        raise ValueError(f"the one-launch V-cycle needs min_grid >= 3; got {min_grid}")
    levels = tuple(level_plan(n, min_grid))    # at most MAX_LEVELS: 257 down to 3
    n_cta = CLUSTER_CTAS if n >= BANDED_FROM else 1
    scope, rows, band_shift, offsets = [], [], [], []
    used = 0
    for m in levels:
        if m >= BANDED_FROM:
            band = (m - 1) // n_cta       # a power of two; the last CTA holds one row more
            scope.append(SCOPE_CLUSTER)
            rows.append(band + 1)
            band_shift.append(band.bit_length() - 1)
        else:
            scope.append(SCOPE_WARP if m <= WARP_UP_TO else SCOPE_BLOCK)
            rows.append(m)
            band_shift.append(31)
        offsets.append(used)
        used += 2 * rows[-1] * m + 2 * m
    if 4 * used > SMEM_LIMIT:
        raise ValueError(f"V-cycle from {n} needs {4 * used} bytes of shared memory a CTA")
    return VcycleLaunchPlan(levels, n_cta, tuple(scope), tuple(rows), tuple(band_shift),
                            tuple(offsets), 4 * used)


_INTS, _FLOATS = ctypes.c_int * MAX_LEVELS, ctypes.c_float * MAX_LEVELS


class _PlanStruct(ctypes.Structure):
    """``struct Plan`` of ``csrc/vcycle_fused.cu``, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("n_levels", "n_cta", "pre", "post", "coarse_sweeps", "smem_bytes")] \
        + [("omega", ctypes.c_float)] \
        + [(name, _INTS) for name in ("n", "log_half", "band_shift", "scope", "rows", "off")] \
        + [(name, _FLOATS) for name in ("inv_dr2", "dr", "a_ns", "a_c", "inv_ac")]


@functools.lru_cache(maxsize=64)
def vcycle_plan_struct(n: int, min_grid: int, d_r: float, d_z: float, omega: float,
                       pre_smooth: int, post_smooth: int, coarse_sweeps: int) -> _PlanStruct:
    """The launch plan with the level constants, as the C entry reads it.
    The constants are :func:`level_scalars` of ``d_r * 2^l``, rounded to float
    as the per-stage launchers round them."""
    plan = vcycle_launch_plan(n, min_grid)
    st = _PlanStruct(n_levels=len(plan.levels), n_cta=plan.n_cta, pre=pre_smooth,
                     post=post_smooth, coarse_sweeps=coarse_sweeps,
                     smem_bytes=plan.smem_bytes, omega=omega)
    dr, dz = d_r, d_z
    for lv, m in enumerate(plan.levels):
        st.n[lv], st.log_half[lv] = m, ((m - 1) // 2).bit_length() - 1
        st.band_shift[lv], st.scope[lv] = plan.band_shift[lv], plan.scope[lv]
        st.rows[lv], st.off[lv] = plan.rows[lv], plan.offsets[lv]
        st.inv_dr2[lv], st.a_ns[lv], st.a_c[lv], st.inv_ac[lv] = level_scalars(dr, dz)
        st.dr[lv] = dr
        dr, dz = dr * 2.0, dz * 2.0
    return st


# ── the one-launch fine legs' plan ──
#
# ``csrc/fine_legs.cu`` instantiates the band kernels of
# ``csrc/tiled_band.cuh`` for levels that fill the card about once.

SM_COUNT = leg_plan.SM_COUNT
# The kernels' instantiations, in the order of csrc/fine_legs.cu: (rows of a
# thread's band, pitch of a slab row in shared memory, most threads a block,
# blocks an SM the registers allow).  Of those that hold a slab in the same
# shared memory the first is taken: 4-row bands while the block stays within
# 512 threads, 8-row bands beyond, the wide pitch for large halos.
FINE_VARIANTS = ((4, 80, 512, 1), (8, 80, 512, 1), (8, 176, 1024, 1))
# Tiles (rows, columns), largest first: a level takes the first that gives
# every SM a block, or else the smallest.
FINE_TILES = leg_plan.SMALL_LEVEL_TILES


@functools.lru_cache(maxsize=256)
def fine_launch_plan(leg: str, nz: int, nr: int, sweeps: int,
                     tile: tuple[int, int] | None = None,
                     seg_len: int | None = None) -> leg_plan.LegLaunchPlan:
    """The launch of one fine leg (``"down"`` or ``"up"``) on an ``nz`` x
    ``nr`` level: tile, halo (``2 * sweeps + 2`` down, ``2 * sweeps`` up, at
    least 2), bands, kernel variant, threads, shared-memory bytes and grid.
    The tile is the largest of :data:`FINE_TILES` whose grid has a block for
    every SM, the smallest where none has; ``tile`` and ``seg_len`` override
    the choice (measurements).  Raises ``ValueError`` for a shape or a
    smoothing count no kernel variant serves."""
    return leg_plan.plan_on_tiles(leg, nz, nr, sweeps, FINE_TILES if tile is None else (tile,),
                                  FINE_VARIANTS, seg_len)


@functools.lru_cache(maxsize=256)
def _fine_plan_ints(leg: str, nz: int, nr: int, sweeps: int) -> ctypes.Array:
    """The plan as the C entries read it, made once a shape."""
    return fine_launch_plan(leg, nz, nr, sweeps).as_ints()


def fine_launch_occupancy(plan: leg_plan.LegLaunchPlan) -> dict:
    """Blocks of ``plan``'s kernel one SM holds, blocks resident on the card
    and the grid's size, asked of the CUDA occupancy API (needs the card)."""
    return leg_plan.launch_occupancy("scpn_fine_ctas_per_sm", plan)


# ── kernel wrappers ──
#
# Each public wrapper adds one to ``cb.CALLS[<its name>]`` per call in which
# it launched.  The fine-leg counts come only from the fine route of
# ``ops/multigrid._vcycle_impl``: the staged V-cycle below runs its per-level
# legs through the private staged launchers and counts nowhere.


def _presmooth_restrict_launch(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth):
    """The down leg as one launch per dependent stage (the predecessor of the
    one-launch kernel; no call counted)."""
    nz, nr = psi.shape
    nzc, nrc = (nz + 1) // 2, (nr + 1) // 2
    psi_s = psi.clone()
    sweeps_in_place(psi_s, source, r_1d, d_r, d_z, omega, pre_smooth)
    inv_dr2, a_ns, a_c, _ = level_scalars(d_r, d_z)
    d_c = torch.empty((nzc, nrc), dtype=psi.dtype, device=psi.device)
    cb.launch("scpn_defect_restrict", psi_s.data_ptr(), source.data_ptr(), r_1d.data_ptr(),
              r_1d.stride(0), nz, nr, nzc, nrc, inv_dr2, d_r, a_ns, a_c, d_c.data_ptr())
    return psi_s, d_c


def _prolong_smooth_launch(psi_s, source, e_coarse, r_1d, d_r, d_z, omega, *, post_smooth):
    """The up leg as one launch per dependent stage (the predecessor of the
    one-launch kernel; no call counted)."""
    cb.check_f32_cuda("fine_prolong_smooth", psi_s=psi_s, e_coarse=e_coarse)
    nz, nr = psi_s.shape
    nzc, nrc = e_coarse.shape
    if (nzc, nrc) != ((nz + 1) // 2, (nr + 1) // 2):
        raise ValueError(f"fine_prolong_smooth: coarse shape {(nzc, nrc)} does not match "
                         f"fine {(nz, nr)}")
    out = torch.empty_like(psi_s)
    cb.launch("scpn_prolong_correct", psi_s.data_ptr(), e_coarse.data_ptr(), nz, nr, nzc, nrc,
              out.data_ptr())
    sweeps_in_place(out, source, r_1d, d_r, d_z, omega, post_smooth)
    return out


def fine_presmooth_restrict(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                            d_r: float, d_z: float, omega: float, *,
                            pre_smooth: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine-level down leg: ``(psi_smoothed, d_coarse)``, the coarse defect
    compact with a zero ring.  On a CUDA tensor it is one kernel launch and
    two allocations, the outputs'."""
    if not psi.is_cuda:
        return fine_presmooth_restrict_plain(psi, source, r_1d, d_r, d_z, omega,
                                             pre_smooth=pre_smooth)
    check_level("fine_presmooth_restrict", psi, source, r_1d)
    ints = _fine_plan_ints("down", psi.shape[0], psi.shape[1], int(pre_smooth))
    out = leg_plan.launch_down("scpn_fine_pre", ints, psi, source, r_1d, d_r, d_z, omega)
    cb.CALLS["fine_presmooth_restrict"] += 1
    return out


def fine_prolong_smooth(psi_s: torch.Tensor, source: torch.Tensor, e_coarse: torch.Tensor,
                        r_1d: torch.Tensor, d_r: float, d_z: float, omega: float, *,
                        post_smooth: int = 3) -> torch.Tensor:
    """Fine-level up leg: bilinear prolongation of the compact coarse error,
    correction on the interior, then ``post_smooth`` sweeps.  On a CUDA
    tensor it is one kernel launch and one allocation, the output's."""
    if not psi_s.is_cuda:
        return fine_prolong_smooth_plain(psi_s, source, e_coarse, r_1d, d_r, d_z, omega,
                                         post_smooth=post_smooth)
    leg_plan.check_up("fine_prolong_smooth", psi_s, source, e_coarse, r_1d)
    ints = _fine_plan_ints("up", psi_s.shape[0], psi_s.shape[1], int(post_smooth))
    out = leg_plan.launch_up("scpn_fine_post", ints, psi_s, source, e_coarse, r_1d, d_r, d_z,
                             omega)
    cb.CALLS["fine_prolong_smooth"] += 1
    return out


def _fused_coarse_vcycle_staged(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth=3,
                                post_smooth=3, min_grid=5, coarse_sweeps=50):
    """The V-cycle as a host loop over the legs' launchers, one launch per
    dependent stage: what :func:`fused_coarse_vcycle` must equal bit for bit.
    Off every solver path; adds to no wrapper's count."""
    def coarsest(p, s, r, dr, dz, om, n_sweeps):
        out = p.clone()
        sweeps_in_place(out, s, r, dr, dz, om, n_sweeps)
        return out

    return _compact_vcycle(psi, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                           min_grid, coarse_sweeps, _presmooth_restrict_launch,
                           _prolong_smooth_launch, coarsest)


def fused_coarse_vcycle(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                        d_r: float, d_z: float, omega: float, *, pre_smooth: int = 3,
                        post_smooth: int = 3, min_grid: int = 5,
                        coarse_sweeps: int = 50) -> torch.Tensor:
    """One V-cycle on a square 2^k+1 grid down to ``min_grid`` and back.  On
    a CUDA tensor (up to 257^2, ``min_grid`` >= 3) it is one kernel launch
    and one allocation, the output's."""
    if not psi.is_cuda:
        return fused_coarse_vcycle_plain(psi, source, r_1d, d_r, d_z, omega,
                                         pre_smooth=pre_smooth, post_smooth=post_smooth,
                                         min_grid=min_grid, coarse_sweeps=coarse_sweeps)
    check_level("fused_coarse_vcycle", psi, source, r_1d)
    if psi.shape[0] != psi.shape[1]:
        raise ValueError(f"fused V-cycle needs a square 2^k+1 grid; got {tuple(psi.shape)}")
    plan = vcycle_plan_struct(psi.shape[0], int(min_grid), float(d_r), float(d_z), float(omega),
                              int(pre_smooth), int(post_smooth), int(coarse_sweeps))
    out = torch.empty_like(psi)
    cb.launch("scpn_fused_vcycle", psi.data_ptr(), source.data_ptr(), r_1d.data_ptr(),
              r_1d.stride(0), ctypes.addressof(plan), out.data_ptr())
    cb.CALLS["fused_coarse_vcycle"] += 1
    return out
