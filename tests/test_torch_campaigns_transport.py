"""The port's ``transport_conservation`` campaign on the CPU against the
JAX package's committed report, as ``tests/test_torch_campaigns.py`` holds
the others (a file of its own: lane 4 relaxes 3200 transport steps, ~45 s
on one CPU thread; it is not cut).

Lanes 1 and 2 measure rounding residuals: held by the lane's own
thresholds.  Lane 4's dW/dt is the difference of two stored energies
(~1.1e8 J) over 1 s, so its f64 rounding is ~1e-8 of it: held at 1e-6.
"""

import json
from pathlib import Path

from scpn_fusion_tpu_torch.validation import run_transport_conservation
from tests.torch_parity import report_mismatches

ROOT = Path(__file__).resolve().parent.parent

RULES = {
    ("aux_power_balance", "rel_err_multi_efrac0.5"): ("below", 1e-10),
    ("aux_power_balance", "rel_err_multi_efrac0.0"): ("below", 1e-10),
    ("aux_power_balance", "rel_err_single_efrac0.0"): ("below", 1e-10),
    ("quasineutrality", "max_rel_residual"): ("below", 1e-12),
    ("steady_state_energy_balance", "dwdt_fraction_of_p_aux"): ("rel", 1e-6),
}


def test_transport_conservation_matches_the_committed_report(tmp_path):
    assert run_transport_conservation.main(device="cpu", out_dir=tmp_path) == 0
    ours = json.loads((tmp_path / "transport_conservation.json").read_text())
    ref = json.loads((ROOT / "validation" / "reports" / "transport_conservation.json")
                     .read_text())
    assert report_mismatches(ours, ref, RULES) == {}
