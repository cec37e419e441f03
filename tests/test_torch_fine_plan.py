"""The launch plan of the one-launch fine legs (``ops/cuda_mg.fine_launch_plan``)
and what surrounds the kernels of ``csrc/fine_legs.cu``, checked without a card.

* The plan at 513^2, the level the cascades give the fine legs: a block for
  every SM, enough warps an SM, the halo of each leg, shared memory.
* The plan for other levels (129^2 .. 1025^2, rectangular, not 2^k+1): the
  tiles partition the level, the bands cover the slab, the variant fits.
* A plain-torch emulation of one tile's slab with the update ring that
  shrinks by one point a half-sweep (``test_torch_tiled_plan._tiled_by_slabs``)
  under the fine plan: the cores of first, inner and last tiles assembled
  must equal the untiled ``*_plain`` legs bit for bit in float32.
* The C side's instantiations against ``FINE_VARIANTS``, the routing of
  ``_vcycle_impl``, and that no solver path reaches the staged launchers.

The CUDA kernels themselves are held against the plain versions and the
staged launchers on the card by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import pytest
import torch
from test_torch_tiled_plan import _level, _tiled_by_slabs

from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_mg_tiled, leg_plan
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl

PKG = Path(cuda_mg.__file__).resolve().parent.parent
LEG_CASES = [("down", 1), ("down", 3), ("up", 2), ("up", 3), ("up", 0)]
SHAPES = [(129, 129), (257, 257), (513, 513), (1025, 1025), (257, 385), (300, 700), (3, 3)]


@pytest.mark.parametrize("leg,sweeps", [("down", 1), ("down", 2), ("up", 1), ("up", 2)])
def test_513_fills_the_card_once(leg, sweeps):
    """513^2 with the cascades' smoothing counts: a block for each of the 132
    SMs, at least 16 warps an SM on average, one wave by shared memory."""
    plan = cuda_mg.fine_launch_plan(leg, 513, 513, sweeps)
    blocks = plan.grid[0] * plan.grid[1]
    assert blocks >= cuda_mg.SM_COUNT == 132
    assert blocks * (plan.threads // 32) / cuda_mg.SM_COUNT >= 16
    assert plan.smem_bytes < leg_plan.SMEM_LIMIT == 232_448
    assert plan.halo == max(2 * sweeps + (2 if leg == "down" else 0), 2)
    assert (plan.tile_rows, plan.tile_cols) in cuda_mg.FINE_TILES
    # short bands: a thread walks through a few rows, not twenty
    assert plan.seg_len <= 8 and plan.seg_len % 2 == 0


@pytest.mark.parametrize("leg,sweeps", LEG_CASES)
@pytest.mark.parametrize("nz,nr", SHAPES)
def test_fine_launch_plan_covers_level(nz, nr, leg, sweeps):
    plan = cuda_mg.fine_launch_plan(leg, nz, nr, sweeps)
    seg_len, pitch, max_threads, _ = cuda_mg.FINE_VARIANTS[plan.variant]
    sh, sw = plan.slab
    for n, tile, spans in ((nz, plan.tile_rows, plan.row_spans()),
                           (nr, plan.tile_cols, plan.col_spans())):
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))     # each point once
        assert all(start % 2 == 0 for start, _ in spans)               # coarse points on even rows
        assert all(stop - start >= 2 for start, stop in spans[:-1])    # no sliver
        assert all(stop - start <= tile + 1 for start, stop in spans)
    assert plan.halo % 2 == 0
    assert plan.halo == max(2 * sweeps + (2 if leg == "down" else 0), 2)
    assert sweeps == 0 or plan.update_ring(0) <= plan.halo - 1
    assert plan.update_ring(2 * sweeps - 1) == (2 if leg == "down" else 0)
    assert plan.seg_len == seg_len and seg_len % 2 == 0
    assert sw <= pitch and sw % 2 == 0
    assert plan.n_seg * seg_len >= sh - 1                              # bands cover the slab
    assert plan.n_seg * sw <= plan.threads <= max_threads and plan.threads % 32 == 0
    assert plan.smem_bytes == 2 * (plan.n_seg * seg_len + 3) * pitch * 4
    assert plan.smem_bytes <= leg_plan.SMEM_LIMIT
    assert plan.stages == leg_plan.ALL_STAGES
    # the largest tile that gives every SM a block, else the smallest
    blocks = plan.grid[0] * plan.grid[1]
    if blocks < cuda_mg.SM_COUNT:
        assert (plan.tile_rows, plan.tile_cols) == cuda_mg.FINE_TILES[-1]
    # what the wrappers hand to the C entries, made once a shape
    ints = cuda_mg._fine_plan_ints(leg, nz, nr, sweeps)
    assert list(ints) == list(plan.as_ints())
    assert cuda_mg._fine_plan_ints(leg, nz, nr, sweeps) is ints


def test_1025_takes_the_larger_tile():
    """Where even the largest tile gives every SM a block, it is taken: less
    of the slab is halo."""
    plan = cuda_mg.fine_launch_plan("down", 1025, 1025, 1)
    assert (plan.tile_rows, plan.tile_cols) == cuda_mg.FINE_TILES[0] == (32, 64)
    assert plan.grid == (32, 16)
    small = cuda_mg.fine_launch_plan("down", 129, 129, 1)
    assert (small.tile_rows, small.tile_cols) == cuda_mg.FINE_TILES[-1]


def test_large_halos_take_the_wide_pitch():
    """Four and more sweeps at 513^2: the slab is wider than the 80-word
    pitch, so the plan takes the instantiation with the wide one."""
    plan = cuda_mg.fine_launch_plan("down", 513, 513, 4)
    assert plan.slab == (36, 84) and cuda_mg.FINE_VARIANTS[plan.variant][1] == 176
    assert plan.grid == (32, 8) and plan.threads == 5 * 84 + 28


def test_overrides_for_measurements():
    plan = cuda_mg.fine_launch_plan("up", 513, 513, 2, (32, 64), 8)
    assert (plan.tile_rows, plan.tile_cols, plan.seg_len, plan.grid) == (32, 64, 8, (16, 8))
    assert plan.threads == 5 * 72 + 24 and plan.n_seg == 5


@pytest.mark.parametrize("args,match", [
    (("down", 513, 513, -1), "sweeps >= 0"),
    (("down", 2, 513, 1), "needs an interior"),
    (("up", 513, 1, 1), "needs an interior"),
    (("side", 513, 513, 1), "leg must be"),
    (("down", 513, 513, 40), "fits no kernel variant"),
    (("up", 513, 513, 2, (15, 64)), "must be even"),
    (("up", 513, 513, 2, (16, 64), 6), "fits no kernel variant"),
])
def test_fine_launch_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        cuda_mg.fine_launch_plan(*args)


def test_variants_match_the_cuda_source():
    """``FINE_VARIANTS`` lists the kernels' instantiations in the source's
    order: band rows, pitch, thread cap, blocks an SM.  The kernels are the
    band code that the tiled legs instantiate too."""
    text = (PKG / "csrc" / "fine_legs.cu").read_text()
    found = re.findall(r"case (\d+): return RUN<(\d+), (\d+), (\d+), (\d+)>", text)
    assert [int(f[0]) for f in found] == list(range(len(cuda_mg.FINE_VARIANTS)))
    assert tuple(tuple(int(v) for v in f[1:]) for f in found) == cuda_mg.FINE_VARIANTS
    assert all(rows % 2 == 0 and pitch % 2 == 0 and cap % 32 == 0 and cap <= 1024
               for rows, pitch, cap, _ in cuda_mg.FINE_VARIANTS)
    assert '#include "tiled_band.cuh"' in text
    assert '#include "tiled_band.cuh"' in (PKG / "csrc" / "tiled_legs.cu").read_text()
    for entry in ("scpn_fine_pre", "scpn_fine_post", "scpn_fine_ctas_per_sm"):
        assert f'extern "C" int {entry}(' in text
    band = (PKG / "csrc" / "tiled_band.cuh").read_text()
    # the C side refuses a plan whose halo is short of the leg's need
    assert "a.halo >= 2 * a.n_sweeps + (up ? 0 : 2)" in band


def test_no_path_calls_the_staged_fine_legs():
    """The staged launchers are reached only inside ``cuda_mg`` (the staged
    V-cycle); the solvers take the one-launch wrappers."""
    for path in PKG.rglob("*.py"):
        if path.name != "cuda_mg.py":
            text = path.read_text()
            assert "_presmooth_restrict_launch" not in text, path
            assert "_prolong_smooth_launch" not in text, path


# ── one tile's slab in plain torch, under the fine plan ──

@pytest.mark.parametrize("nz,pre,omega", [(65, 1, 1.0), (65, 3, 1.3), (97, 1, 1.0)])
def test_down_leg_by_slabs_equals_untiled(nz, pre, omega):
    """16 x 32 tiles of a 65^2 / 97^2 level: first, inner and last tiles."""
    psi, src, _, r, d_r, d_z = _level(nz, seed=43)
    plan = cuda_mg.fine_launch_plan("down", nz, nz, pre)
    assert plan.grid[0] >= 4 and plan.grid[1] >= 2
    got_p, got_d = _tiled_by_slabs(plan, psi, src, r, d_r, d_z, omega)
    ref_p, ref_d = cuda_mg.fine_presmooth_restrict_plain(psi, src, r, d_r, d_z, omega,
                                                         pre_smooth=pre)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_d, ref_d)


@pytest.mark.parametrize("nz,post,omega", [(65, 2, 1.0), (65, 3, 1.3), (65, 0, 1.0), (97, 2, 1.0)])
def test_up_leg_by_slabs_equals_untiled(nz, post, omega):
    psi, src, e_c, r, d_r, d_z = _level(nz, seed=47)
    plan = cuda_mg.fine_launch_plan("up", nz, nz, post)
    got, _ = _tiled_by_slabs(plan, psi, src, r, d_r, d_z, omega, e_c)
    ref = cuda_mg.fine_prolong_smooth_plain(psi, src, e_c, r, d_r, d_z, omega, post_smooth=post)
    assert torch.equal(got, ref)


def test_measured_tiles_by_slabs_equal_untiled():
    """The tile shapes the measurements try (``fine_launch_plan``'s overrides)."""
    psi, src, e_c, r, d_r, d_z = _level(65, seed=53)
    ref_p, ref_d = cuda_mg.fine_presmooth_restrict_plain(psi, src, r, d_r, d_z, 1.0, pre_smooth=1)
    ref_u = cuda_mg.fine_prolong_smooth_plain(psi, src, e_c, r, d_r, d_z, 1.0, post_smooth=2)
    for tile in ((32, 64), (16, 64), (32, 32)):
        down = cuda_mg.fine_launch_plan("down", 65, 65, 1, tile, 8)
        got_p, got_d = _tiled_by_slabs(down, psi, src, r, d_r, d_z, 1.0)
        assert torch.equal(got_p, ref_p) and torch.equal(got_d, ref_d)
        up = cuda_mg.fine_launch_plan("up", 65, 65, 2, tile, 8)
        assert torch.equal(_tiled_by_slabs(up, psi, src, r, d_r, d_z, 1.0, e_c)[0], ref_u)


# ── routing ──

@pytest.mark.parametrize("n,route", [(513, ["fine"]), (1025, ["tiled", "fine"])])
def test_vcycle_routes_levels_to_their_legs(monkeypatch, n, route):
    """With the kernels selected, a 513^2 level takes the fine wrappers, a
    1025^2 level the tiled ones (and the fine ones below it), 257^2 the fused
    V-cycle.  Recorders in place of the wrappers; CPU."""
    calls = []

    def down(name):
        def record(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth):
            calls.append((name, "down", psi.shape[0], pre_smooth))
            nc = (psi.shape[0] + 1) // 2
            return psi, torch.zeros((nc, nc), dtype=psi.dtype)
        return record

    def up(name):
        def record(psi_s, source, e_coarse, r_1d, d_r, d_z, omega, *, post_smooth):
            calls.append((name, "up", psi_s.shape[0], post_smooth))
            assert e_coarse.shape[0] == (psi_s.shape[0] + 1) // 2
            return psi_s
        return record

    def fused(psi, source, r_1d, d_r, d_z, omega, **kw):
        calls.append(("fused", "vcycle", psi.shape[0], kw["pre_smooth"]))
        return psi

    monkeypatch.setattr(cuda_mg, "fine_presmooth_restrict", down("fine"))
    monkeypatch.setattr(cuda_mg, "fine_prolong_smooth", up("fine"))
    monkeypatch.setattr(cuda_mg_tiled, "tiled_presmooth_restrict", down("tiled"))
    monkeypatch.setattr(cuda_mg_tiled, "tiled_prolong_smooth", up("tiled"))
    monkeypatch.setattr(cuda_mg, "fused_coarse_vcycle", fused)
    psi = torch.zeros((n, n), dtype=torch.float32)
    r = torch.linspace(2.0, 10.0, n, dtype=torch.float32)
    _vcycle_impl(psi, psi, r, 8.0 / (n - 1), 8.0 / (n - 1), 1.0, 1, 2, 5, 50, True)
    sizes = [n >> k | 1 for k in range(len(route))]
    want = [(name, "down", m, 1) for name, m in zip(route, sizes)]
    want.append(("fused", "vcycle", 257, 1))
    want += [(name, "up", m, 2) for name, m in reversed(list(zip(route, sizes)))]
    assert calls == want


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """A CPU tensor runs the plain version beside the wrapper and counts no
    launch."""
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    psi, src, e_c, r, d_r, d_z = _level(33, seed=59)
    before = dict(cb.CALLS)
    got_p, got_d = cuda_mg.fine_presmooth_restrict(psi, src, r, d_r, d_z, 1.0, pre_smooth=1)
    ref_p, ref_d = cuda_mg.fine_presmooth_restrict_plain(psi, src, r, d_r, d_z, 1.0, pre_smooth=1)
    got_u = cuda_mg.fine_prolong_smooth(psi, src, e_c, r, d_r, d_z, 1.0, post_smooth=2)
    ref_u = cuda_mg.fine_prolong_smooth_plain(psi, src, e_c, r, d_r, d_z, 1.0, post_smooth=2)
    assert torch.equal(got_p, ref_p) and torch.equal(got_d, ref_d) and torch.equal(got_u, ref_u)
    assert dict(cb.CALLS) == before
