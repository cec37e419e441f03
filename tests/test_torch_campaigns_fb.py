"""The port's ``free_boundary_forward`` campaign on the CPU.

The committed ``validation/reports/free_boundary_forward.json`` was made on
the TPU, so the port's CPU run is held to the JAX script's CPU branch: the
lane names, thresholds and notes, lanes 2 and 3 (the float64 and mixed
forwards) blocked with the script's note, and the timing lanes' statuses
following their own numbers and gates (a CPU time passes or fails its H100
gate by the host's speed, in both packages).  The campaign runs at 17^2 and
33^2 here (the script's 129^2 and 257^2 are its defaults, the card's
sizes).  Each lane's solve is held to JAX's ``solve_free_boundary`` at 65^2
in float64 with the lanes' outer settings (Anderson's Gram in float32, as
the script's float64 forwards take it): outer and inner iteration counts
equal, psi within 1e-9 of its span (lane 1's settings here, the float64 and
mixed lanes' in ``tests/test_torch_campaigns_fb_jax.py``).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from scpn_fusion_tpu_torch.bench_config import ITER_LIKE
from scpn_fusion_tpu_torch.validation import run_free_boundary_forward as fbf
from scpn_fusion_tpu_torch.validation._lanes import NO_CARD
from tests.torch_parity import layout_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports" / "free_boundary_forward.json"


def test_cpu_run_layout_and_statuses(tmp_path):
    assert fbf.main(device="cpu", out_dir=tmp_path, n=17, n_wide=33) in (0, 1)
    ours = json.loads((tmp_path / "free_boundary_forward.json").read_text())
    ref = json.loads(COMMITTED.read_text())
    assert layout_mismatches(ours, ref, {"warm_forward_129_device_f64": NO_CARD,
                                         "warm_forward_129_device_mixed": NO_CARD}) == {}
    lanes = {lane["name"]: lane for lane in ours["lanes"]}
    m1 = lanes["warm_forward_129_device"]["metrics"]
    assert m1["backend"] == "cpu" and m1["all_converged"] and len(m1["outer_iterations"]) == 5
    assert lanes["warm_forward_129_device"]["status"] == (
        "pass" if 0.0 < m1["device_per_solve_ms"] <= fbf.REF_WARM_NOMG_MS else "fail")
    m3 = lanes["warm_forward_257_device"]["metrics"]
    assert lanes["warm_forward_257_device"]["status"] == (
        "pass" if m3["all_converged"] and m3["device_per_solve_ms"] > 0.0 else "fail")
    m4 = lanes["cold_vs_warm_compile"]["metrics"]
    assert m4["warm_wall_ms"] == round(m1["wall_1_solve_ms"], 1)
    assert lanes["cold_vs_warm_compile"]["status"] == ("pass" if m4["speedup"] >= 3.0
                                                       else "fail")
    assert ours["overall_status"] in ("pass", "fail", "blocked")


def jax_forward(n, tol, mixed):
    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
    )
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.free_boundary import solve_free_boundary
    cfg = ReactorConfig(
        reactor_name=f"fb-forward-{n}", grid_resolution=(n, n),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=tuple(Coil(**c) for c in ITER_LIKE["coils"]),
        physics=PhysicsParams(plasma_current_target=15.0, vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=400, convergence_threshold=1e-4,
                            relaxation_factor=1.0, solver_method="anderson_mg",
                            anderson_depth=4))
    return solve_free_boundary(cfg, grid=Grid.from_config(cfg, dtype=np.float64),
                               max_outer_iter=16, tol=tol, mu0_green=1.0, dtype=jnp.float64,
                               anderson_gram_f32=True, mixed_n_refine=mixed)


def test_forward_against_jax():
    check_forward_against_jax(fbf.F32_129[1], 0)


def check_forward_against_jax(tol, mixed):
    ref = jax_forward(65, tol, mixed)
    ours = fbf.forward_solve(65, device="cpu", dtype=torch.float64, max_outer_iter=16, tol=tol,
                             mixed_n_refine=mixed)
    p = np.asarray(ref.psi)
    assert ours.converged and bool(ref.converged)
    assert ours.outer_iterations == int(ref.outer_iterations)
    assert ours.equilibrium.iterations == int(ref.equilibrium.iterations)
    assert float(np.max(np.abs(ours.psi.numpy() - p))) / float(p.max() - p.min()) <= 1e-9
