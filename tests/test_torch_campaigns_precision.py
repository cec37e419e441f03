"""The port's ``precision_budget`` campaign on the CPU against the JAX
package's committed report, as ``tests/test_torch_campaigns.py`` holds the
others (a file of its own: its 513^2 mixed solve takes ~15 s here).

Its float32 solves round differently from XLA's: the metrics that are
rounding floors (each precision's residual and error floors, the mixed
solve's f64 residual and last update, reached through float32 V-cycles)
are held by the lane's own thresholds, or within a factor of their own
size where the lane states none; the float64 GS residual, a sum of
differences, at 1e-8; the counts, the float32 solve's deviation from
float64 and the cascade are held as the others are.
"""

import json
from pathlib import Path

from scpn_fusion_tpu_torch.validation import run_precision_budget
from tests.torch_parity import report_mismatches

ROOT = Path(__file__).resolve().parent.parent

RULES = {
    # the float64 GS residual (~2e-6) is a sum of differences of terms ~1e2
    # times larger: its rounding is ~1e-9 of it
    ("fixed_boundary_f32_penalty", "gs_residual_f64"): ("rel", 1e-8),
    # float32 rounding floors (the float32 solve stops at max_iterations)
    ("fixed_boundary_f32_penalty", "gs_residual_f32"): ("rel", 0.1),
    ("multigrid_operator_precision_floors", "err_vs_exact_f64_span_rel"): ("below", 1e-10),
    ("multigrid_operator_precision_floors", "err_vs_exact_f32_span_rel"): ("below", 1e-4),
    ("multigrid_operator_precision_floors", "residual_floor_f64"): ("below", 1e-12),
    ("multigrid_operator_precision_floors", "residual_floor_f32"): ("below", 1e-4),
    ("mixed_precision_513_residual_gated", "gs_residual_rms"): ("below", 3e-5),
    ("mixed_precision_513_residual_gated", "update_diff"): ("below", 1e-5),
}


def test_precision_budget_matches_the_committed_report(tmp_path):
    assert run_precision_budget.main(device="cpu", out_dir=tmp_path) == 0
    ours = json.loads((tmp_path / "precision_budget.json").read_text())
    ref = json.loads((ROOT / "validation" / "reports" / "precision_budget.json").read_text())
    assert report_mismatches(ours, ref, RULES) == {}
