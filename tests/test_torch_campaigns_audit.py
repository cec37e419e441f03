"""The port's ``error_audit`` and ``implementation_parity`` campaigns on the
CPU against the JAX package's committed reports (lanes 1-2 of
``implementation_parity`` and all of ``error_audit`` were made on the CPU in
float64): the same lanes, statuses, thresholds and notes, and every metric
within 1e-9 relative.  ``implementation_parity``'s third implementation is
the port's own float64 ``sor_step``, reported as ``torch`` where the JAX
script reports its ``jax_cpu``; its lane 3 (kernel 1 on the card, made on the
TPU) reports blocked here with the script's note, and its arithmetic is held
to the JAX lane's: the port's ``sor_sweeps`` (its plain version on the
CPU) in float64 against the NumPy twin within 1e-9 of the span, and in
float32 against ``sor_sweeps_pallas`` in interpret mode (a float32-only
kernel), 400 sweeps, within ``F32_KERNEL_TOL`` of the span (the two round
400 sweeps of float32 differently), and within the lane's 1e-5 of the twin.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import run_error_audit, run_implementation_parity
from tests.torch_parity import flat_report, report_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports"
# the port's implementation in the JAX report's names
TORCH_AS_JAX = {"numpy_vs_torch_span_rel": "numpy_vs_jax_cpu_span_rel",
                "err_vs_exact_torch": "err_vs_exact_jax_cpu",
                "dev_cpp_vs_torch": "dev_cpp_vs_jax_cpu",
                "dev_numpy_vs_torch": "dev_jax_cpu_vs_numpy"}
F32_KERNEL_TOL = 1e-6
# one f64 sweep from the same state: both at the rounding floor
# (4.4e-16 in JAX's, the port's ~0 against NumPy), held below the gate;
# the converged pairs likewise (~1.4e-15)
PARITY_RULES = {("sweep_trajectory_parity", "numpy_vs_jax_cpu_span_rel"): ("below", 1e-13),
                ("converged_cross_implementation", "dev_cpp_vs_jax_cpu"): ("below", 1e-13),
                ("converged_cross_implementation", "dev_jax_cpu_vs_numpy"): ("below", 1e-13),
                ("converged_cross_implementation", "err_vs_exact_jax_cpu"): ("abs", 1e-15)}


def test_error_audit_matches_the_committed_report(tmp_path):
    assert run_error_audit.main(device="cpu", out_dir=tmp_path) == 0
    ours = json.loads((tmp_path / "error_audit.json").read_text())
    ref = json.loads((COMMITTED / "error_audit.json").read_text())
    assert ours["schema"] == ref["schema"] == "scpn-fusion-tpu.error_audit.v1"
    assert [lane["notes"] for lane in ours["lanes"]] == [lane["notes"] for lane in ref["lanes"]]
    assert report_mismatches(flat_report(ours), flat_report(ref)) == {}


def test_implementation_parity_matches_the_committed_report(tmp_path):
    assert run_implementation_parity.main(device="cpu", out_dir=tmp_path) == 0
    ours = json.loads((tmp_path / "implementation_parity.json").read_text())
    ref = json.loads((COMMITTED / "implementation_parity.json").read_text())
    lane3 = ours["lanes"][2]
    assert (lane3["name"], lane3["status"], lane3["notes"], lane3["metrics"]) == (
        "tpu_f32_parity", "blocked", "TPU backend unavailable in this environment", {})
    assert ours["lanes"][1]["metrics"]["implementations"] == ["cpp", "numpy", "torch"]
    ours["lanes"][1]["metrics"]["implementations"] = ["cpp", "jax_cpu", "numpy"]
    for report in (ours, ref):
        report["lanes"].pop(2)
        report["overall_status"] = "pass"
    assert [lane["notes"] for lane in ours["lanes"]] == [lane["notes"] for lane in ref["lanes"]]
    assert report_mismatches(flat_report(ours, TORCH_AS_JAX), flat_report(ref),
                             PARITY_RULES) == {}


def test_kernel_lane_arithmetic_against_the_pallas_kernel():
    from scpn_fusion_tpu.ops.pallas_stencil import sor_sweeps_pallas
    r_1d, d_r, d_z, psi_exact, source, psi0 = run_implementation_parity.problem()
    span = float(psi_exact.max() - psi_exact.min())
    n = run_implementation_parity.N_KERNEL_SWEEPS
    ours64, twin = run_implementation_parity.kernel_sweeps("cpu", dtype=torch.float64)
    assert float(np.max(np.abs(ours64 - twin))) / span <= 1e-9
    ours32, _ = run_implementation_parity.kernel_sweeps("cpu")
    f32 = jnp.float32
    ref = np.asarray(sor_sweeps_pallas(jnp.asarray(psi0, f32), jnp.asarray(source, f32),
                                       jnp.asarray(r_1d, f32), d_r, d_z, jnp.asarray(1.6, f32), n,
                                       interpret=True), np.float64)
    assert float(np.max(np.abs(ours32 - ref))) / span <= F32_KERNEL_TOL
    assert float(np.max(np.abs(ours32 - twin))) / span < 1e-5
