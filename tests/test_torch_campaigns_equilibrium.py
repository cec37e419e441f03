"""The port's ``equilibrium_parity`` campaign, the CLI's default
``validate``, on the CPU.

The committed ``validation/reports/equilibrium_parity.json`` was made on the
TPU (float32, the TPU gates; lane 2 on the reference's fixture files), so
the port's CPU run is held to the JAX script's CPU branch: float64, the CPU
gates, lane 2 blocked (the reference's fixture files are not in the
repository), the
lane names, thresholds and notes; and each lane's arithmetic is held to the
JAX functions the script's lanes call, in float64 on the same inputs:
iteration counts equal, psi within 1e-9 of its span, lane 1's errors within
1e-12 of the span (they are rounding-level differences of converged
solves).  A bare ``validate`` runs this campaign and exits 1, as the JAX mode
does here (lane 2 blocked, and blocked never counts as pass).
"""

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu_torch.bench_config import ITER_LIKE
from scpn_fusion_tpu_torch.validation import collect_results, run_equilibrium_parity
from tests.torch_parity import layout_mismatches, span_rel

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports" / "equilibrium_parity.json"


@pytest.fixture(scope="module")
def bare_validate(tmp_path_factory):
    """``main(["--device", "cpu", "validate"])`` with the campaign and
    ``collect_results`` pointed at a temporary directory: (exit code, the
    report, the directory)."""
    from scpn_fusion_tpu_torch.cli import main
    out = tmp_path_factory.mktemp("equilibrium_parity")
    mp = pytest.MonkeyPatch()
    mp.setattr(run_equilibrium_parity, "main",
               functools.partial(run_equilibrium_parity.main, out_dir=out))
    mp.setattr(collect_results, "main", functools.partial(collect_results.main, out_dir=out))
    try:
        rc = main(["--device", "cpu", "validate"])
    finally:
        mp.undo()
    return rc, json.loads((out / "equilibrium_parity.json").read_text()), out


def test_bare_validate_runs_equilibrium_parity_and_exits_as_jax(bare_validate):
    rc, report, out = bare_validate
    assert rc == 1
    assert report["overall_status"] == "blocked"
    assert (out / "RESULTS.md").exists()
    assert "## equilibrium_parity — BLOCKED" in (out / "RESULTS.md").read_text()


def test_cpu_statuses_gates_and_notes(bare_validate):
    _, report, _ = bare_validate
    ref = json.loads(COMMITTED.read_text())
    lanes = {lane["name"]: lane for lane in report["lanes"]}
    assert {k: v["status"] for k, v in lanes.items()} == {
        "solovev_analytic": "pass", "geqdsk_reconstruction": "blocked",
        "numpy_twin_parity": "pass"}
    # the script's CPU branch: float64 gates and the backend in the note
    assert lanes["solovev_analytic"]["thresholds"] == {"span_rel_err_65": 2e-4}
    assert lanes["solovev_analytic"]["notes"] == "dtype=float64, backend=cpu"
    assert lanes["numpy_twin_parity"]["thresholds"] == {"span_rel_deviation": 1e-6}
    # the JAX script's CPU branch differs from its committed TPU run only
    # in these
    cpu_branch = {"solovev_analytic": ({"span_rel_err_65": 2e-4}, "dtype=float64, backend=cpu"),
                  "numpy_twin_parity": ({"span_rel_deviation": 1e-6}, "")}
    for lane in ref["lanes"]:
        if lane["name"] in cpu_branch:
            lane["thresholds"], lane["notes"] = cpu_branch[lane["name"]]
    assert layout_mismatches(report, ref, {
        "geqdsk_reconstruction": "reference fixture data not mounted"}) == {}


def test_solovev_lane_against_jax(bare_validate):
    """Lane 1: 30 V-cycles from the exact ring at 65^2 and 129^2, float64.
    The errors are the discrete solve minus the exact field, each solve
    converged to f64's floor (~1e-14 of the span): held absolutely at 1e-12
    in units of the span, as ``test_torch_campaigns.py`` holds
    ``mesh_convergence``'s (the 129^2 error, 2.7e-6, differs by 1.3e-14)."""
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.solovev import SolovevParams
    from scpn_fusion_tpu.ops import multigrid as mg
    from scpn_fusion_tpu.ops.stencil import apply_dirichlet

    def jax_err(n):
        params = SolovevParams()
        grid = Grid.from_bounds(n, n, 3.0, 9.0, -3.0, 3.0, dtype=np.float64)
        psi_exact = params.psi(grid.RR, grid.ZZ).astype(jnp.float64)
        src = params.source(grid.RR).astype(jnp.float64)
        psi0 = apply_dirichlet(jnp.zeros_like(psi_exact), psi_exact)
        out = mg.mg_solve(psi0, src, grid.R, grid.dR, grid.dZ, n_cycles=30, use_pallas=False)
        span = float(jnp.max(psi_exact) - jnp.min(psi_exact))
        return float(jnp.max(jnp.abs(out - psi_exact))) / span

    metrics = bare_validate[1]["lanes"][0]["metrics"]
    for n in (65, 129):
        ref = jax_err(n)
        assert abs(metrics[f"span_rel_err_{n}"] - ref) <= 1e-12, n


def test_twin_lane_against_jax():
    """Lane 3: the 65^2 nonlinear solve, float64, the port's against JAX's
    ``solve_equilibrium`` (iterations equal, psi within 1e-9 of its span),
    and both against the NumPy twin at the CPU gate."""
    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
    )
    from scpn_fusion_tpu.models.equilibrium import solve_equilibrium

    res, np_res, dev = run_equilibrium_parity.twin_lane("cpu", torch.float64)
    cfg = ReactorConfig(
        reactor_name="parity-65", grid_resolution=(65, 65),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=tuple(Coil(**c) for c in ITER_LIKE["coils"]),
        physics=PhysicsParams(plasma_current_target=15.0, vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=600, convergence_threshold=1e-4,
                            relaxation_factor=0.1, solver_method="multigrid"))
    ref = solve_equilibrium(cfg, dtype=jnp.float64)
    assert res.converged and bool(ref.converged)
    assert int(res.iterations) == int(ref.iterations) == int(np_res["iterations"])
    assert span_rel(res.psi, np.asarray(ref.psi)) <= 1e-9
    assert dev < 1e-6
