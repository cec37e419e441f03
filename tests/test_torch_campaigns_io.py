"""The port's ``io_roundtrip`` campaign on the CPU against the JAX package's
committed report (``validation/reports/io_roundtrip.json``, made on the
CPU): the same lanes, statuses but lane 3's, thresholds and notes, and every
metric within 1e-9 relative but where a rule below says why not.

Lane 3 reads the reference's SPARC EFIT files, which are not in the
repository: it reports blocked with the script's note, so the overall
status is blocked and the exit code 1.  The exported equilibrium is the
script's float32 solve; on the CPU the port's stops at its 200-iteration cap
with a mean update of 1.10e-5 against the 1e-5 tolerance (JAX's float32
solve stops at 197 with 9.69e-6): the tolerance sits at float32's rounding
floor for this flux (span 136), so which side of it the last iterate lands
is rounding.  The test exports the float64 solve (183 iterations in both
packages) instead, which moves the exported file by less than the format's
precision; the format-precision metrics are then held below their gates.
"""

import json
from pathlib import Path

import torch

from scpn_fusion_tpu_torch.validation import run_io_roundtrip
from tests.torch_parity import flat_report, report_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports" / "io_roundtrip.json"

RULES = {
    # the write -> read error of a 16-character field: format rounding of
    # whatever the solve gave, held below the lane's gate
    ("geqdsk_write_read_roundtrip", "worst_field_rel"): ("below", 1e-9),
    ("geqdsk_write_read_roundtrip", "psi_rel"): ("below", 1e-9),
    # the solver's response to that rounding (1.2e-10 of the span in both
    # packages): a function of the rounding pattern, held to 1e-2 relative
    ("solve_from_roundtripped", "span_rel_dev"): ("rel", 1e-2),
}


def test_io_roundtrip_matches_the_committed_report(tmp_path, monkeypatch):
    monkeypatch.setattr(run_io_roundtrip, "EXPORT_DTYPE", torch.float64)
    assert run_io_roundtrip.main(device="cpu", out_dir=tmp_path) == 1
    ours = json.loads((tmp_path / "io_roundtrip.json").read_text())
    ref = json.loads(COMMITTED.read_text())
    assert ours["schema"] == ref["schema"] == "scpn-fusion-tpu.io_roundtrip.v1"
    assert ours["overall_status"] == "blocked"
    sparc = ours["lanes"][2]
    assert (sparc["name"], sparc["status"], sparc["notes"]) == (
        "sparc_efit_reparse", "blocked", "SPARC reference data absent")
    for report in (ours, ref):
        report["lanes"].pop(2)
        report["overall_status"] = "pass"
    assert [lane["notes"] for lane in ours["lanes"]] == [lane["notes"] for lane in ref["lanes"]]
    assert report_mismatches(flat_report(ours), flat_report(ref), RULES) == {}


def test_exported_config_is_the_scripts():
    cfg = run_io_roundtrip.exported_config()
    assert cfg.grid_resolution == (65, 65)
    assert cfg.physics.plasma_current_target == 150.0
    sol = cfg.solver
    assert (sol.max_iterations, sol.convergence_threshold, sol.relaxation_factor,
            sol.solver_method) == (200, 1e-5, 0.1, "multigrid")
    assert run_io_roundtrip.EXPORT_DTYPE == torch.float32
