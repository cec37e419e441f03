"""The launch plan of the band kernels (``csrc/tiled_band.cuh``).

The band kernels of ``csrc/tiled_band.cuh`` are instantiated three times: by
``csrc/tiled_legs.cu`` for the V-cycle legs of the levels from 1025^2
(``ops/cuda_mg_tiled``), by ``csrc/fine_legs.cu`` for those up to 513^2
(``ops/cuda_mg``) and by ``csrc/sor_band.cu`` for red-black sweeps alone
(``ops/cuda_stencil.sor_sweeps``).  All take one plan, made here in Python
where the CPU tests reach it: the tile a block owns, the halo its half-sweeps
need, the row bands of its slab, the kernel instantiation ("variant"),
threads and shared memory.  The modules choose tiles and variants for their
levels and launch through :func:`launch_down` / :func:`launch_up` /
:func:`launch_sweeps`; :func:`sor_launch_plan` chooses the route of a
``sor_sweeps`` call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops.cuda_stencil import check_level, level_scalars

SMEM_LIMIT = 232_448   # dynamic shared memory a block may opt in to on Hopper
SM_COUNT = 132         # streaming multiprocessors of an H100
# Tiles (rows, columns), largest first, of a level that fills the card about
# once (the fine legs, ``sor_sweeps``' route B): :func:`plan_on_tiles` takes
# the first that gives every SM a block, or else the smallest.
SMALL_LEVEL_TILES = ((32, 64), (16, 64), (16, 32))
LEGS = ("down", "up", "sweeps")   # the C entries' leg numbers 0, 1, 2
ALL_STAGES = 5     # down: load, sweep, defect, store the core, full weighting; the others three


def leg_halo(sweeps: int, leg: str = "down") -> int:
    """Halo of a leg: ``2 * sweeps`` for the half-sweeps, on the down leg
    ``+ 2`` for the defect's and the full weighting's radius; at least 2, so
    that the slab of the last tile holds the grid's last line.  (The
    sweeps-only kernel's halo is the up leg's.)"""
    if leg not in LEGS:
        raise ValueError(f"leg must be one of {LEGS}, got {leg!r}")
    return max(2 * sweeps + (2 if leg == "down" else 0), 2)


def tile_spans(n: int, tile: int) -> list[tuple[int, int]]:
    """Core spans ``[start, stop)`` of the tiles along one direction of an
    ``n``-point level: origins ``k * tile``, the last tile ending at ``n``
    (it takes the last line, so no tile is a one-point sliver)."""
    count = max(1, -(-(n - 1) // tile))
    return [(k * tile, n if k == count - 1 else (k + 1) * tile) for k in range(count)]


@dataclasses.dataclass(frozen=True)
class LegLaunchPlan:
    """One launch of a leg, as the kernels of ``csrc/tiled_band.cuh`` take it."""

    leg: str
    nz: int
    nr: int
    tile_rows: int
    tile_cols: int
    halo: int
    sweeps: int
    n_seg: int        # row bands of a slab
    variant: int      # index into the launching module's list of instantiations
    seg_len: int      # rows of a band (the variant's)
    threads: int
    smem_bytes: int
    stages: int = ALL_STAGES   # fewer: the kernel stops after that many stages (timing only)

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
        leg, for the defect and the full weighting); clipped to the level's
        interior."""
        return 2 * self.sweeps - 1 - half_sweep + (2 if self.leg == "down" else 0)

    def as_ints(self) -> ctypes.Array:
        return (ctypes.c_int * 11)(self.nz, self.nr, self.tile_rows, self.tile_cols, self.halo,
                                   self.sweeps, self.n_seg, self.variant, self.threads,
                                   self.smem_bytes, self.stages)


def plan_launch(leg: str, nz: int, nr: int, sweeps: int, tile_rows: int, tile_cols: int,
                variants, seg_len: int | None = None,
                candidates: tuple[int, ...] | None = None,
                halo: int | None = None) -> LegLaunchPlan:
    """The launch of one leg on an ``nz`` x ``nr`` level with even
    ``tile_rows`` x ``tile_cols`` tiles: halo, the instantiation of
    ``variants`` (rows of a band, pitch of a slab row in shared memory, most
    threads a block, blocks an SM; only those of ``seg_len`` rows if given,
    only the indices in ``candidates`` if given) that holds the slab in the
    least shared memory, bands, threads and shared-memory bytes.  ``halo``
    below :func:`leg_halo` is taken only by a tile that covers the level.
    Raises ``ValueError`` for a level without an interior, a halo too small
    or a tile that fits no variant."""
    if sweeps < 0:
        raise ValueError(f"need sweeps >= 0, got {sweeps}")
    if nz < 3 or nr < 3:
        raise ValueError(f"a level needs an interior, got {nz} x {nr}")
    if tile_rows < 2 or tile_cols < 2 or tile_rows & 1 or tile_cols & 1:
        raise ValueError(f"tile edges must be even and >= 2, got {tile_rows} x {tile_cols}")
    need = leg_halo(sweeps, leg)
    halo = need if halo is None else halo
    whole = tile_rows >= nz - 1 and tile_cols >= nr - 1
    if halo < 2 or halo & 1 or (halo < need and not whole):
        raise ValueError(f"a halo of {halo} does not serve {sweeps} sweeps on a "
                         f"{tile_rows} x {tile_cols} tile of {nz} x {nr}")
    sh, sw = tile_rows + 2 * halo, tile_cols + 2 * halo
    best = None
    for index, (rows, pitch, max_threads, _) in enumerate(variants):
        if (seg_len is not None and rows != seg_len) or (candidates is not None
                                                         and index not in candidates):
            continue
        n_seg = -(-(sh - 1) // rows)
        threads = -(-(n_seg * sw) // 32) * 32
        # a field holds its slab rows and three guard rows, at the variant's pitch
        words = 2 * (n_seg * rows + 3) * pitch
        if sw > pitch or threads > max_threads or words * 4 > SMEM_LIMIT:
            continue
        if best is None or words < best[0]:     # a tie goes to the earlier variant
            best = (words, index, n_seg, threads)
    if best is None:
        raise ValueError(f"a {tile_rows} x {tile_cols} tile with halo {halo} fits no kernel "
                         f"variant: too wide, or more than {SMEM_LIMIT} bytes of shared memory")
    words, variant, n_seg, threads = best
    return LegLaunchPlan(leg, nz, nr, tile_rows, tile_cols, halo, sweeps, n_seg, variant,
                         variants[variant][0], threads, words * 4)


def plan_on_tiles(leg: str, nz: int, nr: int, sweeps: int, tiles, variants,
                  seg_len: int | None = None,
                  candidates: tuple[int, ...] | None = None) -> LegLaunchPlan:
    """:func:`plan_launch` with the largest of ``tiles`` (rows, columns;
    largest first) whose grid has a block for every SM, or else the smallest
    that fits a variant.  Raises ``ValueError`` where none fits."""
    plan, refusal = None, None
    for rows, cols in tiles:
        try:
            plan = plan_launch(leg, nz, nr, sweeps, rows, cols, variants, seg_len, candidates)
        except ValueError as exc:
            refusal = exc
            continue
        if plan.grid[0] * plan.grid[1] >= SM_COUNT:
            break
    if plan is None:
        raise refusal
    return plan


# ── the routes of a ``sor_sweeps`` call (``ops/cuda_stencil.sor_sweeps``) ──
#
# B: tiles over many CTAs, halo 2 * n, the ring shrinking by one point a
#    half-sweep: one launch, for up to 4 sweeps on a level of any size.
# A: one CTA holds the whole level (one tile, halo 2) and runs every sweep,
#    __syncthreads() apart: one launch whatever the count, for more sweeps on
#    a level whose bands fit one CTA.
# D: the staged half-sweeps of ``csrc/rb_sweep.cu`` without the copy before
#    them: 2 * n launches, for what A and B do not take.
# B is taken wherever it serves: on the card (H100 80GB HBM3, 700 W) it beat
# A at every level and count both take (129^2 n = 1: 2.2 against 7.8 us of
# device time; 17 x 9 n = 2: 2.3 against 3.0), because one CTA loads a level
# at a fraction of the card's rate (3.5 us for 129^2).
# A level's working set (psi, source, two coefficient rows) is never limited
# to 12 MB as the JAX package's VMEM-resident kernel is: B and D take any size.

# The sweeps-only kernel's instantiations, in the order of csrc/sor_band.cu:
# (rows of a band, pitch of a slab row, most threads a block, blocks an SM).
SOR_VARIANTS = ((4, 80, 512, 1), (8, 80, 512, 1),
                (8, 40, 1024, 1), (16, 72, 1024, 1), (20, 136, 1024, 1))
TILE_VARIANTS = (0, 1)          # route B's: the fine legs' bands and pitch
WHOLE_LEVEL_VARIANTS = (2, 3, 4)   # route A's, by the width of the level
TILED_SWEEPS_MAX = 4      # route B's largest count: a halo of 8 on 16 x 64 tiles
ROUTES = ("A", "B", "D")


@dataclasses.dataclass(frozen=True)
class SorLaunchPlan:
    """How one ``sor_sweeps`` call runs: its route and, on routes A and B,
    the band kernel's launch plan."""

    route: str
    nz: int
    nr: int
    sweeps: int
    launch: LegLaunchPlan | None

    @property
    def launches(self) -> int:
        """``__global__`` launches a call."""
        return 1 if self.launch is not None else 2 * self.sweeps


def whole_level_plan(nz: int, nr: int, sweeps: int) -> LegLaunchPlan:
    """Route A's plan: one tile (even edges covering ``nz - 1`` rows and
    ``nr - 1`` columns), halo 2.  Raises ``ValueError`` where the level's
    bands fit no variant of ``WHOLE_LEVEL_VARIANTS``."""
    return plan_launch("sweeps", nz, nr, sweeps, nz - 1 + (nz - 1) % 2, nr - 1 + (nr - 1) % 2,
                       SOR_VARIANTS, candidates=WHOLE_LEVEL_VARIANTS, halo=2)


@functools.lru_cache(maxsize=256)
def sor_launch_plan(nz: int, nr: int, sweeps: int, route: str | None = None) -> SorLaunchPlan:
    """The route of ``sweeps`` red-black sweeps on an ``nz`` x ``nr`` level:
    B for up to ``TILED_SWEEPS_MAX`` sweeps; A for more where one CTA holds
    the level; else D.  ``route`` forces one (measurements).  Raises
    ``ValueError`` for a level without an interior, fewer than one sweep, or
    a forced route that does not take the call."""
    if nz < 3 or nr < 3:
        raise ValueError(f"a level needs an interior, got {nz} x {nr}")
    if sweeps < 1:
        raise ValueError(f"sor_launch_plan needs sweeps >= 1, got {sweeps}")
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "B" or (route is None and sweeps <= TILED_SWEEPS_MAX):
        if sweeps > TILED_SWEEPS_MAX:
            raise ValueError(f"route B takes up to {TILED_SWEEPS_MAX} sweeps, got {sweeps}")
        return SorLaunchPlan("B", nz, nr, sweeps,
                             plan_on_tiles("sweeps", nz, nr, sweeps, SMALL_LEVEL_TILES,
                                           SOR_VARIANTS, candidates=TILE_VARIANTS))
    if route in (None, "A"):
        try:
            return SorLaunchPlan("A", nz, nr, sweeps, whole_level_plan(nz, nr, sweeps))
        except ValueError:
            if route == "A":
                raise
    return SorLaunchPlan("D", nz, nr, sweeps, None)


def launch_occupancy(entry: str, plan: LegLaunchPlan) -> dict:
    """Blocks of ``plan``'s kernel one SM holds, blocks resident on the card
    and the grid's size, asked of the CUDA occupancy API through the C entry
    ``entry`` of the source that instantiates the kernel (needs the card)."""
    per_sm = ctypes.c_int(0)
    err = getattr(cb.library(), entry)(LEGS.index(plan.leg), plan.as_ints(),
                                       ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    grid = plan.grid[0] * plan.grid[1]
    return {"ctas_per_sm": per_sm.value, "resident": per_sm.value * sms, "grid": grid,
            "waves": grid / max(per_sm.value * sms, 1)}


def launch_down(entry: str, plan_ints: ctypes.Array, psi, source, r_1d, d_r, d_z, omega):
    """One launch of the down-leg kernel behind C entry ``entry`` as the plan
    says (no call counted): ``(psi_smoothed, d_coarse)``, both allocated here."""
    nz, nr = psi.shape
    inv_dr2, a_ns, a_c, inv_ac = level_scalars(d_r, d_z)
    psi_s = torch.empty_like(psi)
    d_c = torch.empty(((nz + 1) // 2, (nr + 1) // 2), dtype=psi.dtype, device=psi.device)
    cb.launch(entry, psi.data_ptr(), source.data_ptr(), r_1d.data_ptr(), r_1d.stride(0),
              plan_ints, inv_dr2, d_r, a_ns, a_c, inv_ac, float(omega), psi_s.data_ptr(),
              d_c.data_ptr())
    return psi_s, d_c


def launch_sweeps(entry: str, plan_ints: ctypes.Array, psi, source, r_1d, d_r, d_z, omega):
    """One launch of the sweeps-only kernel behind C entry ``entry`` as the
    plan says (no call counted); the output is allocated here."""
    inv_dr2, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    out = torch.empty_like(psi)
    cb.launch(entry, psi.data_ptr(), source.data_ptr(), r_1d.data_ptr(), r_1d.stride(0),
              plan_ints, inv_dr2, d_r, a_ns, inv_ac, float(omega), out.data_ptr())
    return out


def launch_up(entry: str, plan_ints: ctypes.Array, psi_s, source, e_coarse, r_1d, d_r, d_z,
              omega):
    """One launch of the up-leg kernel behind C entry ``entry`` as the plan
    says (no call counted); the output is allocated here."""
    inv_dr2, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    out = torch.empty_like(psi_s)
    cb.launch(entry, psi_s.data_ptr(), source.data_ptr(), e_coarse.data_ptr(), r_1d.data_ptr(),
              r_1d.stride(0), plan_ints, inv_dr2, d_r, a_ns, inv_ac, float(omega),
              out.data_ptr())
    return out


def check_up(name: str, psi_s, source, e_coarse, r_1d) -> None:
    """Raise unless the up leg's fields are float32 CUDA fields of matching shapes."""
    check_level(name, psi_s, source, r_1d)
    cb.check_f32_cuda(name, e_coarse=e_coarse)
    nz, nr = psi_s.shape
    if tuple(e_coarse.shape) != ((nz + 1) // 2, (nr + 1) // 2):
        raise ValueError(f"{name}: coarse shape {tuple(e_coarse.shape)} does not match fine "
                         f"{(nz, nr)}")
