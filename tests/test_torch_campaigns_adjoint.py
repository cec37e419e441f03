"""The port's ``adjoint_fd`` campaign on the CPU against the JAX package's
committed report (``validation/reports/adjoint_fd.json``, made on the CPU in
float64).

The script's 300 forward steps and 300 adjoint iterations take ~50 s here;
the Picard map contracts by ~0.5 a step (relaxation 0.5 on a V-cycle inner
solve), so 60 of each (0.5^60 ~ 9e-19) reach the same fixed point and
gradient to the last bits.  The test passes ``n_steps=60``: every gradient
component, the loss before and after the descent step and the gradient's
scale are held within 1e-9 relative of the committed 300-step numbers, and
``n_fwd`` / ``n_bwd`` equal 60.  The lane's FD deviation (2.28e-9, the
cancellation rounding of central differences of energies that agree to
~1e-16) is held within 1e-11 absolutely.
"""

import json
from pathlib import Path

from scpn_fusion_tpu_torch.validation import run_adjoint_fd
from tests.torch_parity import report_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports" / "adjoint_fd.json"
N_STEPS = 60
RULES = {("coilgrad_adjoint_vs_fd", "max_rel_component_dev"): ("abs", 1e-11),
         ("coilgrad_adjoint_vs_fd", "n_fwd"): ("equal", N_STEPS),
         ("coilgrad_adjoint_vs_fd", "n_bwd"): ("equal", N_STEPS)}


def test_adjoint_fd_matches_the_committed_report(tmp_path):
    assert run_adjoint_fd.main(device="cpu", out_dir=tmp_path, n_steps=N_STEPS) == 0
    ours = json.loads((tmp_path / "adjoint_fd.json").read_text())
    ref = json.loads(COMMITTED.read_text())
    assert ours["schema"] == ref["schema"] == "scpn-fusion-tpu.adjoint_fd.v1"
    assert [lane["notes"] for lane in ours["lanes"]] == [lane["notes"] for lane in ref["lanes"]]
    assert run_adjoint_fd.N_STEPS == ref["lanes"][0]["metrics"]["n_fwd"] == 300
    assert report_mismatches(ours, ref, RULES) == {}
