"""The port's ``multi_machine`` campaign on the CPU against the JAX
package's committed report (``validation/reports/multi_machine.json``, made
on the CPU in float64): the same lanes, statuses, thresholds and notes, and
every metric (each machine's iterations, flux span, tau_E, phase, densities
and Thomson voltage) within 1e-9 relative."""

import json
from pathlib import Path


from scpn_fusion_tpu_torch.validation import run_multi_machine
from tests.torch_parity import flat_report, report_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports" / "multi_machine.json"


def test_multi_machine_matches_the_committed_report(tmp_path):
    assert run_multi_machine.main(device="cpu", out_dir=tmp_path) == 0
    ours = json.loads((tmp_path / "multi_machine.json").read_text())
    ref = json.loads(COMMITTED.read_text())
    assert ours["schema"] == ref["schema"] == "scpn-fusion-tpu.multi_machine.v1"
    assert [lane["notes"] for lane in ours["lanes"]] == [lane["notes"] for lane in ref["lanes"]]
    assert report_mismatches(flat_report(ours), flat_report(ref)) == {}


def test_machine_configs_are_the_scripts():
    """The PF pattern scaled by R0 and the device Ip, 65^2 over
    (0.35, 1.80) R0 x (-0.70, 0.70) R0, L-mode, multigrid Picard."""
    for name, r0, _a, ip, *_ in run_multi_machine.MACHINES:
        cfg = run_multi_machine.machine_config(name, r0, ip)
        d = cfg.dimensions
        assert (d.R_min, d.R_max, d.Z_min, d.Z_max) == (0.35 * r0, 1.80 * r0, -0.70 * r0,
                                                        0.70 * r0)
        assert [(c.r, c.z, c.current) for c in cfg.coils] == [
            (r0 * pr, r0 * pz, ip * pc) for pr, pz, pc in run_multi_machine.PF_PATTERN]
        assert cfg.physics.profile_mode == "l-mode"
        assert (cfg.solver.relaxation_factor, cfg.solver.inner_sweeps) == (0.1, 1)
