"""The launch plan of the tiled legs (``ops/cuda_mg_tiled.launch_plan``) and
its halo arithmetic, checked without a card.

* The plan for every level 129^2 .. 4097^2 and both legs: the tiles partition
  the level, origins are even, the halo covers the leg's half-sweeps (and the
  down leg's defect and full weighting), the slab fits the kernel variant and
  a block's shared memory, no tile is a one-point sliver.
* A plain-torch emulation of ONE tile's slab, written here, with the update
  ring that shrinks by one point a half-sweep as ``csrc/tiled_legs.cu`` does
  it: the cores assembled over all tiles must equal the untiled ``*_plain``
  legs bit for bit in float32, for a square, a rectangular and a ragged
  tiling.  The CUDA kernels themselves are held against the plain versions
  and their first design on the card by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import fields, to_torch

from scpn_fusion_tpu_torch.ops import cuda_mg_tiled as mt
from scpn_fusion_tpu_torch.ops.cuda_mg import prolong_correct_plain
from scpn_fusion_tpu_torch.ops.cuda_stencil import ew_rows, level_scalars

PKG = Path(mt.__file__).resolve().parent.parent
LEG_CASES = [("down", 1), ("down", 3), ("up", 2), ("up", 3), ("up", 0)]


@pytest.mark.parametrize("leg,sweeps", LEG_CASES)
@pytest.mark.parametrize("n", [129, 257, 513, 1025, 2049, 4097])
def test_launch_plan_covers_level(n, leg, sweeps):
    plan = mt.launch_plan(leg, n, n, sweeps)
    seg_len, pitch, max_threads, _ = mt.VARIANTS[plan.variant]
    sh, sw = plan.slab
    for spans in (plan.row_spans(), plan.col_spans()):
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))     # each point once
        assert all(start % 2 == 0 for start, _ in spans)               # coarse points on even rows
        assert all(stop - start >= 2 for start, stop in spans)         # no sliver
        assert all(stop - start <= plan.tile_rows + 1 for start, stop in spans)
    assert plan.grid == (len(plan.row_spans()), len(plan.col_spans()))
    assert plan.halo % 2 == 0 and plan.halo >= 2
    assert plan.halo >= (2 * sweeps + 2 if leg == "down" else 2 * sweeps)
    # the first half-sweep's ring stays inside the slab, off its edge
    assert sweeps == 0 or plan.update_ring(0) <= plan.halo - 1
    assert plan.update_ring(2 * sweeps - 1) == (2 if leg == "down" else 0)
    assert sw <= pitch and sw % 2 == 0
    assert plan.n_seg * seg_len >= sh - 1                              # bands cover the slab
    assert plan.n_seg * sw <= plan.threads <= max_threads and plan.threads % 32 == 0
    assert plan.smem_bytes == 2 * (plan.n_seg * seg_len + 3) * pitch * 4
    assert plan.smem_bytes <= mt.SMEM_LIMIT == 232_448
    assert plan.stages == mt.ALL_STAGES


def test_2049_has_no_33rd_tile():
    """2049 = 32 * 64 + 1: the last tile is 65 wide; 1024 blocks, not 1089."""
    plan = mt.launch_plan("down", 2049, 2049, 3)
    assert plan.grid == (32, 32)
    assert plan.row_spans()[-1] == (1984, 2049)
    assert (plan.tile_rows, plan.halo, plan.threads) == (64, 8, 320)
    assert mt.launch_plan("up", 2049, 2049, 3).halo == 6


@pytest.mark.parametrize("t_rows,sweeps,leg,plan", [
    (None, 3, "down", (64, 8)), (None, 0, "down", (64, 2)), (48, 1, "down", (48, 4)),
    (33, 2, "down", (34, 6)), (1, 0, "down", (2, 2)),
    (None, 3, "up", (64, 6)), (None, 0, "up", (64, 2)), (48, 1, "up", (48, 2)),
    (33, 2, "up", (34, 4)), (24, 3, "up", (24, 6)),
])
def test_tile_plan_leg(t_rows, sweeps, leg, plan):
    """The up leg's halo has no defect and full-weighting radius; never
    below 2, so that the last tile's slab holds the grid's last line."""
    assert mt.tile_plan(t_rows, sweeps, leg) == plan
    assert mt.leg_halo(sweeps, leg) == plan[1]
    got = mt.launch_plan(leg, 129, 129, sweeps, t_rows)
    assert (got.tile_rows, got.tile_cols, got.halo) == (plan[0], plan[0], plan[1])


@pytest.mark.parametrize("kwargs,match", [
    (dict(leg="down", sweeps=3, t_rows=200), "fits no kernel variant"),
    (dict(leg="down", sweeps=-1, t_rows=32), "sweeps >= 0"),
    (dict(leg="up", sweeps=1, t_rows=0), "t_rows >= 1"),
    (dict(leg="side", sweeps=1, t_rows=32), "leg must be"),
])
def test_launch_plan_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        mt.launch_plan(kwargs["leg"], 129, 129, kwargs["sweeps"], kwargs["t_rows"])


def test_variants_match_the_cuda_source():
    """``VARIANTS`` lists the kernels' instantiations in the source's order."""
    text = (PKG / "csrc" / "tiled_legs.cu").read_text()
    found = re.findall(r"case (\d+): return RUN<(\d+), (\d+), (\d+), (\d+)>", text)
    assert [int(f[0]) for f in found] == list(range(len(mt.VARIANTS)))
    assert tuple(tuple(int(v) for v in f[1:]) for f in found) == mt.VARIANTS


def test_no_path_calls_the_first_design():
    """The first design of the tiled kernels is reached only through the
    private ``*_slab`` functions of ``cuda_mg_tiled`` (``_cuda_build`` holds
    the C entries' signatures)."""
    for path in PKG.rglob("*.py"):
        if path.name not in ("cuda_mg_tiled.py", "_cuda_build.py"):
            assert "_slab" not in path.read_text(), path


# ── one tile's slab in plain torch, with the shrinking update ring ──

def _cut(field, row0, col0, sh, sw):
    """The (sh, sw) slab of ``field`` from (row0, col0), zero outside the grid."""
    nz, nr = field.shape
    out = torch.zeros((sh, sw), dtype=field.dtype)
    lo_i, hi_i = max(row0, 0), min(row0 + sh, nz)
    lo_j, hi_j = max(col0, 0), min(col0 + sw, nr)
    out[lo_i - row0:hi_i - row0, lo_j - col0:hi_j - col0] = field[lo_i:hi_i, lo_j:hi_j]
    return out


def _slab_sweeps(plan, z, c, p, s, a_e, a_w, d_r, d_z, omega):
    """The leg's half-sweeps on slab ``p``: half-sweep t updates the points of
    its colour in the core grown by ``plan.update_ring(t)``, clipped to the
    global interior; colour and interior from GLOBAL indices."""
    _, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    sh, sw = plan.slab
    row0, col0 = z[0] - plan.halo, c[0] - plan.halo
    gi = torch.arange(row0, row0 + sh)[:, None]
    gj = torch.arange(col0, col0 + sw)[None, :]
    for t in range(2 * plan.sweeps):
        g = plan.update_ring(t)
        region = ((gi >= max(1, z[0] - g)) & (gi <= min(plan.nz - 2, z[1] - 1 + g))
                  & (gj >= max(1, c[0] - g)) & (gj <= min(plan.nr - 2, c[1] - 1 + g)))
        assert not region[0].any() and not region[-1].any()         # never the slab's edge
        assert not region[:, 0].any() and not region[:, -1].any()
        gs = (a_e[None, 1:-1] * p[1:-1, 2:] + a_w[None, 1:-1] * p[1:-1, :-2]
              + a_ns * (p[2:, 1:-1] + p[:-2, 1:-1]) - s[1:-1, 1:-1]) * inv_ac
        old = p[1:-1, 1:-1]
        mask = (region & ((gi + gj) % 2 == t % 2))[1:-1, 1:-1]
        p = p.clone()
        p[1:-1, 1:-1] = torch.where(mask, old + omega * (gs - old), old)
    return p


def _tiled_by_slabs(plan, psi, src, r, d_r, d_z, omega, e_c=None):
    """The leg assembled from the cores of every tile's slab."""
    nz, nr = psi.shape
    _, a_ns, a_c, _ = level_scalars(d_r, d_z)
    a_e_row, a_w_row = ew_rows(r, d_r)
    sh, sw = plan.slab
    start = psi if e_c is None else prolong_correct_plain(psi, e_c)
    out = torch.full_like(psi, float("nan"))
    d_c = torch.full(((nz + 1) // 2, (nr + 1) // 2), float("nan"), dtype=psi.dtype)
    owned = torch.zeros_like(psi)
    for z in plan.row_spans():
        for c in plan.col_spans():
            row0, col0 = z[0] - plan.halo, c[0] - plan.halo
            p = _cut(start, row0, col0, sh, sw)
            s = _cut(src, row0, col0, sh, sw)
            a_e = _cut(a_e_row[None, :], 0, col0, 1, sw)[0]
            a_w = _cut(a_w_row[None, :], 0, col0, 1, sw)[0]
            p = _slab_sweeps(plan, z, c, p, s, a_e, a_w, d_r, d_z, omega)
            out[z[0]:z[1], c[0]:c[1]] = p[z[0] - row0:z[1] - row0, c[0] - col0:c[1] - col0]
            owned[z[0]:z[1], c[0]:c[1]] += 1
            if plan.leg != "down":
                continue
            # defect on the slab (zero off the global interior), full weighting
            # at the coarse points of the core
            gi = torch.arange(row0, row0 + sh)[:, None]
            gj = torch.arange(col0, col0 + sw)[None, :]
            inner = ((gi >= 1) & (gi <= nz - 2) & (gj >= 1) & (gj <= nr - 2))[1:-1, 1:-1]
            lap = (a_e[None, 1:-1] * p[1:-1, 2:] + a_w[None, 1:-1] * p[1:-1, :-2]
                   + a_ns * (p[2:, 1:-1] + p[:-2, 1:-1]) - a_c * p[1:-1, 1:-1])
            d = torch.zeros_like(p)
            d[1:-1, 1:-1] = torch.where(inner, s[1:-1, 1:-1] - lap, torch.zeros_like(lap))
            for ic in range(z[0] // 2, (z[1] + 1) // 2):
                for jc in range(c[0] // 2, (c[1] + 1) // 2):
                    assert torch.isnan(d_c[ic, jc])                    # each coarse point once
                    if not (1 <= ic <= d_c.shape[0] - 2 and 1 <= jc <= d_c.shape[1] - 2):
                        d_c[ic, jc] = 0.0
                        continue
                    h, w = 2 * ic - row0, 2 * jc - col0
                    edge = d[h, w + 1] + d[h, w - 1] + d[h + 1, w] + d[h - 1, w]
                    diag = (d[h + 1, w + 1] + d[h + 1, w - 1] + d[h - 1, w + 1]
                            + d[h - 1, w - 1])
                    d_c[ic, jc] = 0.25 * d[h, w] + 0.125 * edge + 0.0625 * diag
    assert bool((owned == 1).all())
    return out, d_c


def _level(n, seed):
    r = torch.linspace(2.0, 10.0, n, dtype=torch.float32)
    d_r = float(r[1] - r[0])
    psi, src = (to_torch(f, np.float32) for f in fields(seed, (n, n), dtype=np.float32))
    nc = (n + 1) // 2
    e_c = to_torch(np.random.default_rng(seed + 1).standard_normal((nc, nc)), np.float32)
    e_c[0, :] = e_c[-1, :] = 0.0
    e_c[:, 0] = e_c[:, -1] = 0.0
    return psi, src, e_c, r, d_r, 8.0 / (n - 1)


TILINGS = [(32, None), (32, 16), (24, None)]      # square, rectangular, ragged


@pytest.mark.parametrize("t_rows,t_cols", TILINGS)
@pytest.mark.parametrize("n,pre,omega", [(65, 3, 1.0), (65, 1, 1.3), (129, 3, 1.0)])
def test_down_leg_by_slabs_equals_untiled(n, pre, omega, t_rows, t_cols):
    psi, src, _, r, d_r, d_z = _level(n, seed=31)
    plan = mt.launch_plan("down", n, n, pre, t_rows, t_cols)
    got_p, got_d = _tiled_by_slabs(plan, psi, src, r, d_r, d_z, omega)
    ref_p, ref_d = mt.tiled_presmooth_restrict_plain(psi, src, r, d_r, d_z, omega,
                                                     pre_smooth=pre)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_d, ref_d)


@pytest.mark.parametrize("t_rows,t_cols", TILINGS)
@pytest.mark.parametrize("n,post,omega", [(65, 3, 1.0), (65, 2, 1.3), (65, 0, 1.0),
                                          (129, 3, 1.0)])
def test_up_leg_by_slabs_equals_untiled(n, post, omega, t_rows, t_cols):
    psi, src, e_c, r, d_r, d_z = _level(n, seed=37)
    plan = mt.launch_plan("up", n, n, post, t_rows, t_cols)
    got, _ = _tiled_by_slabs(plan, psi, src, r, d_r, d_z, omega, e_c)
    ref = mt.tiled_prolong_smooth_plain(psi, src, e_c, r, d_r, d_z, omega, post_smooth=post)
    assert torch.equal(got, ref)


def test_a_ring_one_point_short_is_caught():
    """The emulation is sharp: with every ring one point smaller the
    assembled down leg differs from the untiled one."""
    import dataclasses
    psi, src, _, r, d_r, d_z = _level(65, seed=41)
    plan = mt.launch_plan("down", 65, 65, 3, 32)

    class Short(type(plan)):
        def update_ring(self, half_sweep):
            return super().update_ring(half_sweep) - 1

    short = Short(**dataclasses.asdict(plan))
    got_p, got_d = _tiled_by_slabs(short, psi, src, r, d_r, d_z, 1.0)
    ref_p, ref_d = mt.tiled_presmooth_restrict_plain(psi, src, r, d_r, d_z, 1.0, pre_smooth=3)
    assert torch.equal(got_p, ref_p)          # the core itself needs no extra ring ...
    assert not torch.equal(got_d, ref_d)      # ... the defect's and the weighting's radius do
