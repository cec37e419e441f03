"""The routes of ``sor_sweeps`` (``ops/leg_plan.sor_launch_plan``), checked
without a card.

* The plan for square, rectangular, ragged and coarse levels and 1 to 50
  sweeps: route B (tiles, halo ``2 * n``) for up to 4 sweeps on any level;
  route A (one CTA holds the level) for more wherever its bands fit one
  CTA; route D (the staged half-sweeps, ``2 * n`` launches) otherwise.  Shared memory within a
  block's 232,448 bytes, threads within the variant's, one launch on A and B.
* A plain-torch emulation of the band kernel's slabs with the update ring
  that shrinks by one point a half-sweep (``tests/test_torch_tiled_plan.py``)
  assembled over route A's one tile and route B's tiles equals
  ``sor_sweeps_plain`` bit for bit in float32.  The CUDA kernel itself is
  held against the plain version and the staged route on the card by
  ``chip_smoke.py``.

No plan has a cluster: the cluster route of the design (an 8-CTA cluster for
many sweeps on levels above A up to 257^2) was dropped (``PERF.md`` §6).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_tiled_plan import _tiled_by_slabs
from torch_parity import fields, to_torch

from scpn_fusion_tpu_torch.ops import leg_plan as lp
from scpn_fusion_tpu_torch.ops.cuda_stencil import sor_sweeps_plain

PKG = Path(lp.__file__).resolve().parent.parent

# (nz, nr): square 2^k+1, the rectangular V-cycle's levels 257 x 129 down to
# 9 x 5, ragged (not 2^k+1, even sizes), the widest level route A holds
SHAPES = [(5, 5), (17, 17), (65, 65), (129, 129), (257, 257), (513, 513), (257, 129),
          (129, 65), (65, 33), (33, 17), (17, 9), (9, 5), (300, 700), (138, 100), (137, 133)]


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4, 5, 50])
@pytest.mark.parametrize("nz,nr", SHAPES)
def test_sor_plan_routes(nz, nr, sweeps):
    plan = lp.sor_launch_plan(nz, nr, sweeps)
    assert (plan.nz, plan.nr, plan.sweeps) == (nz, nr, sweeps)
    try:
        whole = lp.whole_level_plan(nz, nr, sweeps)
    except ValueError:
        whole = None
    if sweeps <= lp.TILED_SWEEPS_MAX:
        expected = "B"
    elif whole is not None:
        expected = "A"
    else:
        expected = "D"
    assert plan.route == expected
    if plan.route == "D":
        assert plan.launch is None and plan.launches == 2 * sweeps
        return
    launch = plan.launch
    assert plan.launches == 1 and launch.leg == "sweeps" and launch.sweeps == sweeps
    seg_len, pitch, max_threads, _ = lp.SOR_VARIANTS[launch.variant]
    sh, sw = launch.slab
    assert launch.seg_len == seg_len and sw <= pitch
    assert launch.n_seg * seg_len >= sh - 1                      # bands cover the slab
    assert launch.n_seg * sw <= launch.threads <= max_threads and launch.threads % 32 == 0
    assert launch.smem_bytes == 2 * (launch.n_seg * seg_len + 3) * pitch * 4
    assert launch.smem_bytes <= lp.SMEM_LIMIT == 232_448
    for spans in (launch.row_spans(), launch.col_spans()):
        assert spans[0][0] == 0 and spans[-1][1] in (nz, nr)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(start % 2 == 0 for start, _ in spans)
    if plan.route == "A":
        assert launch.grid == (1, 1) and launch.halo == 2
        assert launch.variant in lp.WHOLE_LEVEL_VARIANTS
    else:
        assert launch.halo == 2 * sweeps == lp.leg_halo(sweeps, "sweeps")
        assert launch.variant in lp.TILE_VARIANTS
        assert launch.update_ring(0) == launch.halo - 1 and launch.update_ring(2 * sweeps - 1) == 0


def test_sor_plan_of_the_paths():
    """The rectangular V-cycle (257 x 129 down to 17 x 9 at (1,2), 50 sweeps
    at 9 x 5) and the anderson path (129^2, 50 sweeps) take one launch a call."""
    for nz, nr in ((257, 129), (129, 65), (65, 33), (33, 17), (17, 9)):
        assert lp.sor_launch_plan(nz, nr, 1).route == lp.sor_launch_plan(nz, nr, 2).route == "B"
    assert lp.sor_launch_plan(9, 5, 50).route == "A"
    assert lp.sor_launch_plan(129, 129, 50).launch.threads <= 1024
    assert lp.sor_launch_plan(513, 513, 50).route == "D"


@pytest.mark.parametrize("args,match", [
    ((2, 9, 1), "interior"), ((9, 2, 1), "interior"), ((9, 9, 0), "sweeps >= 1"),
    ((9, 9, 1, "C"), "route must be"), ((257, 129, 1, "A"), "fits no kernel variant"),
    ((257, 129, 5, "B"), "up to 4 sweeps"),
])
def test_sor_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        lp.sor_launch_plan(*args)


def test_forced_routes():
    """Every route takes 129^2 for a few sweeps (the measurements force them)."""
    for route in lp.ROUTES:
        assert lp.sor_launch_plan(129, 129, 2, route).route == route
    assert lp.sor_launch_plan(129, 129, 2, "D").launches == 4


def test_sor_variants_match_the_cuda_source():
    """``SOR_VARIANTS`` lists the kernel's instantiations in the source's order."""
    text = (PKG / "csrc" / "sor_band.cu").read_text()
    found = re.findall(r"case (\d+): return RUN<(\d+), (\d+), (\d+), (\d+)>", text)
    assert [int(f[0]) for f in found] == list(range(len(lp.SOR_VARIANTS)))
    assert tuple(tuple(int(v) for v in f[1:]) for f in found) == lp.SOR_VARIANTS


def _level(nz, nr, seed):
    r = torch.linspace(0.9, 2.6, nr, dtype=torch.float32)
    d_r = float(r[1] - r[0])
    psi, src = (to_torch(f, np.float32) for f in fields(seed, (nz, nr), dtype=np.float32))
    return psi, src, r, d_r, 3.0 / (nz - 1)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("nz,nr,route", [(257, 129, "B"), (300, 700, "B"), (129, 129, "B"),
                                         (129, 129, "A"), (129, 65, "A")])
def test_sweeps_by_slabs_equal_plain(nz, nr, route, sweeps):
    psi, src, r, d_r, d_z = _level(nz, nr, seed=43)
    plan = lp.sor_launch_plan(nz, nr, sweeps, route).launch
    got, _ = _tiled_by_slabs(plan, psi, src, r, d_r, d_z, 1.9)
    assert torch.equal(got, sor_sweeps_plain(psi, src, r, d_r, d_z, 1.9, sweeps))


@pytest.mark.parametrize("nz,nr,sweeps", [(9, 5, 50), (17, 9, 7)])
def test_whole_level_by_slab_any_count(nz, nr, sweeps):
    """Route A's halo stays 2 however many sweeps: the clipped ring is the
    level's interior at every half-sweep."""
    psi, src, r, d_r, d_z = _level(nz, nr, seed=47)
    plan = lp.sor_launch_plan(nz, nr, sweeps).launch
    assert plan.halo == 2 < 2 * sweeps
    got, _ = _tiled_by_slabs(plan, psi, src, r, d_r, d_z, 1.0)
    assert torch.equal(got, sor_sweeps_plain(psi, src, r, d_r, d_z, 1.0, sweeps))
