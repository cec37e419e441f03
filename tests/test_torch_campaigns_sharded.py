"""The port's ``sharded_gs`` campaign and lanes 1-6 of
``sharded_convergence`` on the CPU against the JAX package's committed
reports (made on 8 virtual CPU devices in float64; the port's shards are 8
``parallel/mesh.Mesh`` shards of the CPU): the same lanes, statuses,
thresholds and notes, every metric within 1e-9 relative but the times and
where a rule below says why not.  Lane 7 has a file of its own
(``tests/test_torch_campaigns_sharded_gk.py``)."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from scpn_fusion_tpu_torch.validation import run_sharded_convergence as sc
from scpn_fusion_tpu_torch.validation import run_sharded_gs
from tests.torch_parity import flat_report, report_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports"
TIMING = ("timing", None)

GS_RULES = {("sharded_scaling_shape", f"ms_per_sweep_{k}shards"): TIMING for k in (1, 2, 4, 8)}
GS_RULES.update({("sharded_vs_plain_program", k): TIMING for k in (
    "ms_per_sweep_plain", "ms_per_sweep_shardmap_1shard", "shardmap_overhead_ratio")})

CONV_RULES = {
    # sharded against single: 0 in the port (one device's arithmetic in the
    # same order), 1e-14-1e-13 in JAX's (XLA partitions the reductions):
    # rounding either way, held below the lanes' gates
    ("sharded_headline_convergence", "max_span_rel_dev_vs_single"): ("below", 1e-8),
    ("tile2d_grid_invariant_convergence", "max_span_rel_dev_vs_single"): ("below", 1e-5),
    ("sharded_free_boundary_forward", "max_span_rel_dev_vs_single"): ("below", 1e-8),
    # the linear solve's residual after 7 V-cycles (3.4e-10) sums 513^2
    # differences of O(1) terms, rounding-bound: JAX's own two computations
    # of it (the reported and the independent one) differ by 2.7e-6
    # relative, so 1e-5 relative; its error against the manufactured
    # field is the discretisation's (2.57e-12), held within 1e-14
    ("sharded_linear_residual_gate", "residual_rms"): ("rel", 1e-5),
    ("sharded_linear_residual_gate", "independent_residual_rms"): ("rel", 1e-5),
    ("sharded_linear_residual_gate", "err_vs_manufactured_span_rel"): ("abs", 1e-14),
    # the FMG ladder's psi against the direct solve: 1.26e-6 in both, the
    # tolerance-level difference of two converged solves, to 1e-7 of it
    ("sharded_fmg_cascade", "span_rel_dev_vs_single_direct"): ("rel", 1e-7),
}
CONV_RULES.update({("sharded_scaling_shape_513", f"ms_per_solve_{k}shards"): TIMING
                   for k in (1, 2, 4, 8)})


def test_sharded_gs_matches_the_committed_report(tmp_path):
    assert run_sharded_gs.main(device="cpu", out_dir=tmp_path) == 0
    ours = json.loads((tmp_path / "sharded_gs.json").read_text())
    ref = json.loads((COMMITTED / "sharded_gs.json").read_text())
    assert [lane["notes"] for lane in ours["lanes"]] == [lane["notes"] for lane in ref["lanes"]]
    assert report_mismatches(ours, ref, GS_RULES) == {}


@pytest.fixture(scope="module")
def headline():
    return sc.headline(torch.device("cpu"))


LANES = {"sharded_headline_convergence": lambda h: sc.lane_headline(h),
         "sharded_linear_residual_gate": lambda h: sc.lane_linear(torch.device("cpu")),
         "sharded_scaling_shape_513": lambda h: sc.lane_scaling(h),
         "sharded_fmg_cascade": lambda h: sc.lane_fmg(torch.device("cpu"), h),
         "tile2d_grid_invariant_convergence": lambda h: sc.lane_tile2d(torch.device("cpu"), h),
         "sharded_free_boundary_forward": lambda h: sc.lane_free_boundary(torch.device("cpu"), h)}


@pytest.mark.parametrize("name", list(LANES))
def test_sharded_convergence_lane_matches_the_committed_report(name, headline):
    lane = json.loads(json.dumps(dataclasses.asdict(LANES[name](headline)), default=str))
    ref = json.loads((COMMITTED / "sharded_convergence.json").read_text())
    ref_lane = next(ln for ln in ref["lanes"] if ln["name"] == name)
    assert lane["name"] == name and lane["notes"] == ref_lane["notes"]
    assert report_mismatches(flat_report({"overall_status": "pass", "lanes": [lane]}),
                             flat_report({"overall_status": "pass", "lanes": [ref_lane]}),
                             CONV_RULES) == {}
