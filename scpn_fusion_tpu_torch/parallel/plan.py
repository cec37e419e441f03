"""Rank-tile decomposition planner for the 5D GK phase space.

TPU-native port of the reference's
``core/gk_domain_decomposition.py:25-260`` contract layer: explicit,
validated radial x toroidal rank-tile plans with halo extents, plus the
decomposition-invariant metrics (tile reductions == monolithic to
round-off; halo-view reconstruction exact) that certify a plan before
anything distributed runs on it.

Relationship to the execution lanes: ``parallel/gk_shard.py`` executes
the 5D state under GSPMD (shard_map) and ``tests/test_multiprocess_tiles``
executes across real OS processes.  THIS module is the planning/contract
surface both lanes share: given global extents and a rank grid it
produces the tile table the reference's ProcessPool executor and our
shard_map specs both describe implicitly, and its ``validate_plan`` /
``invariant_metrics`` are the acceptance tests.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


class PlanError(ValueError):
    """Fail-closed plan validation error."""


@dataclasses.dataclass(frozen=True)
class AxisBlock:
    """Half-open [start, stop) partition on one decomposed axis."""

    start: int
    stop: int

    @property
    def size(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class RankTile:
    """One radial x toroidal tile with halo-extended extents."""

    rank: int
    radial: AxisBlock
    toroidal: AxisBlock
    radial_with_halo: AxisBlock
    toroidal_with_halo: AxisBlock

    @property
    def owned_cells(self) -> int:
        return self.radial.size * self.toroidal.size

    @property
    def halo_cells(self) -> int:
        return (self.radial_with_halo.size
                * self.toroidal_with_halo.size)


class InvariantMetrics(NamedTuple):
    """Tile-vs-monolithic invariants (reference 1e-12 contract)."""

    reconstruction_linf_error: float
    inventory_relative_error: float
    free_energy_relative_error: float
    decomposition_invariant_pass: bool


@dataclasses.dataclass(frozen=True)
class DecompositionPlan:
    """Validated radial x toroidal plan over a 5D (r, zeta, th, v, mu)
    phase space."""

    n_radial: int
    n_toroidal: int
    halo: int
    tiles: tuple[RankTile, ...]

    @property
    def total_ranks(self) -> int:
        return len(self.tiles)

    @property
    def owned_cell_imbalance(self) -> float:
        sizes = [t.owned_cells for t in self.tiles]
        return max(sizes) / max(min(sizes), 1)

    @property
    def halo_overhead_ratio(self) -> float:
        owned = sum(t.owned_cells for t in self.tiles)
        halo = sum(t.halo_cells for t in self.tiles)
        return halo / max(owned, 1)


def _balanced_blocks(size: int, parts: int) -> tuple[AxisBlock, ...]:
    """Contiguous near-equal blocks (first ``size % parts`` get +1)."""
    if parts < 1 or size < parts:
        raise PlanError(f"cannot split extent {size} into {parts} parts")
    base, extra = divmod(size, parts)
    blocks = []
    start = 0
    for i in range(parts):
        stop = start + base + (1 if i < extra else 0)
        blocks.append(AxisBlock(start, stop))
        start = stop
    return tuple(blocks)


def _with_halo(block: AxisBlock, size: int, halo: int) -> AxisBlock:
    return AxisBlock(max(block.start - halo, 0),
                     min(block.stop + halo, size))


def build_decomposition(
    n_radial: int,
    n_toroidal: int,
    *,
    radial_ranks: int,
    toroidal_ranks: int,
    halo: int = 1,
) -> DecompositionPlan:
    """Build + validate the rank-tile plan (reference
    ``build_radial_toroidal_decomposition`` :263+)."""
    if halo < 0:
        raise PlanError("halo must be >= 0")
    r_blocks = _balanced_blocks(n_radial, radial_ranks)
    t_blocks = _balanced_blocks(n_toroidal, toroidal_ranks)
    tiles = []
    rank = 0
    for rb in r_blocks:
        for tb in t_blocks:
            tiles.append(RankTile(
                rank=rank, radial=rb, toroidal=tb,
                radial_with_halo=_with_halo(rb, n_radial, halo),
                toroidal_with_halo=_with_halo(tb, n_toroidal, halo)))
            rank += 1
    plan = DecompositionPlan(n_radial=n_radial, n_toroidal=n_toroidal,
                             halo=halo, tiles=tuple(tiles))
    validate_plan(plan)
    return plan


def validate_plan(plan: DecompositionPlan) -> None:
    """Fail-closed structural validation: the owned blocks partition the
    global extent exactly (no gap, no overlap) and halos never exceed
    the domain."""
    owned = np.zeros((plan.n_radial, plan.n_toroidal), dtype=np.int64)
    for tile in plan.tiles:
        if not (0 <= tile.radial_with_halo.start
                <= tile.radial.start < tile.radial.stop
                <= tile.radial_with_halo.stop <= plan.n_radial):
            raise PlanError(f"rank {tile.rank}: bad radial extents")
        if not (0 <= tile.toroidal_with_halo.start
                <= tile.toroidal.start < tile.toroidal.stop
                <= tile.toroidal_with_halo.stop <= plan.n_toroidal):
            raise PlanError(f"rank {tile.rank}: bad toroidal extents")
        owned[tile.radial.start:tile.radial.stop,
              tile.toroidal.start:tile.toroidal.stop] += 1
    if not np.all(owned == 1):
        missing = int(np.sum(owned == 0))
        multi = int(np.sum(owned > 1))
        raise PlanError(
            f"owned blocks must partition the domain exactly: "
            f"{missing} uncovered, {multi} multiply-owned cells")


def extract_tile(state: np.ndarray, tile: RankTile,
                 *, with_halo: bool = False) -> np.ndarray:
    """Local view of a 5D (r, zeta, theta, vpar, mu) state."""
    rb = tile.radial_with_halo if with_halo else tile.radial
    tb = tile.toroidal_with_halo if with_halo else tile.toroidal
    return state[rb.start:rb.stop, tb.start:tb.stop, ...]


def invariant_metrics(plan: DecompositionPlan,
                      state: np.ndarray,
                      *, tol: float = 1e-12) -> InvariantMetrics:
    """Tile-reductions == monolithic certification (reference
    ``DecompositionInvariantMetrics``; tolerance 1e-12).

    * reconstruction: stitching owned tiles reproduces the state exactly;
    * inventory: sum over tiles of sum|f| equals the global sum;
    * free energy: sum over tiles of sum f^2 equals the global sum.
    """
    state = np.asarray(state, dtype=np.float64)
    if state.ndim != 5:
        raise PlanError("state must be 5D (r, zeta, theta, vpar, mu)")
    if state.shape[0] != plan.n_radial or state.shape[1] != plan.n_toroidal:
        raise PlanError("state extents do not match the plan")

    recon = np.zeros_like(state)
    inv_local = 0.0
    fe_local = 0.0
    for tile in plan.tiles:
        owned = extract_tile(state, tile)
        recon[tile.radial.start:tile.radial.stop,
              tile.toroidal.start:tile.toroidal.stop, ...] = owned
        inv_local += float(np.sum(np.abs(owned)))
        fe_local += float(np.sum(owned**2))

    linf = float(np.max(np.abs(recon - state)))
    inv_global = float(np.sum(np.abs(state)))
    fe_global = float(np.sum(state**2))
    inv_err = abs(inv_local - inv_global) / max(abs(inv_global), 1e-300)
    fe_err = abs(fe_local - fe_global) / max(abs(fe_global), 1e-300)
    ok = (linf == 0.0) and (inv_err <= tol) and (fe_err <= tol)
    return InvariantMetrics(
        reconstruction_linf_error=linf,
        inventory_relative_error=inv_err,
        free_energy_relative_error=fe_err,
        decomposition_invariant_pass=bool(ok))
