"""Equilibrium parity validation campaign, the port's
``validation/run_equilibrium_parity.py`` (the CLI's default ``validate``).

Lanes (fail-closed, blocked != pass):
1. solovev_analytic      — exact-solution recovery + O(h^2) convergence
2. geqdsk_reconstruction — DIII-D/SPARC public-fixture envelope (the
                           fixtures are synthetic; see tests/test_eqdsk_solve)
3. numpy_twin_parity     — compiled solver vs NumPy twin span-rel deviation

On a CUDA device the script's TPU branch runs: float32, the Solov'ev
V-cycles and the nonlinear solve through the hand-written kernels, and the
float32 gates.  Elsewhere float64 with the CPU gates.  Writes checksummed
JSON+MD evidence into ``out_dir``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import REFERENCE_DATA, iter_like, on_card

GEQDSK_CASES = (("diiid/diiid_hmode_2MA.geqdsk", 0.25),
                ("diiid/diiid_lmode_1MA.geqdsk", 0.30),
                ("sparc/sparc_1300.eqdsk", 0.25))


def solovev_err(n: int, device, dtype: torch.dtype, use_pallas: bool) -> float:
    """Lane 1 at ``n`` x ``n``: 30 V-cycles from the exact ring, the error's
    max over the exact field's span."""
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.solovev import SolovevParams
    from scpn_fusion_tpu_torch.ops import multigrid as mg
    from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet

    params = SolovevParams()
    grid = Grid.from_bounds(n, n, 3.0, 9.0, -3.0, 3.0, dtype=dtype, device=device)
    psi_exact = params.psi(grid.RR, grid.ZZ).to(dtype)
    src = params.source(grid.RR).to(dtype)
    psi0 = apply_dirichlet(torch.zeros_like(psi_exact), psi_exact)
    out = mg.mg_solve(psi0, src, grid.R, grid.dR, grid.dZ, n_cycles=30, use_pallas=use_pallas)
    span = float(psi_exact.max() - psi_exact.min())
    return float((out - psi_exact).abs().max()) / span


def twin_config(n: int = 65):
    """Lane 3's machine and solver: multigrid Picard, relaxation 0.1."""
    return iter_like(f"parity-{n}", n, max_iterations=600, convergence_threshold=1e-4,
                     relaxation_factor=0.1, solver_method="multigrid")


def twin_lane(device, dtype: torch.dtype, n: int = 65) -> tuple:
    """Lane 3's two solves: (the port's result, the NumPy twin's dict, span-rel
    deviation of the port's psi from the twin's)."""
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium
    from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
    from scpn_fusion_tpu_torch.utils import npref

    cfg = twin_config(n)
    res = solve_equilibrium(cfg, dtype=dtype, device=device)
    grid = Grid.from_config(cfg, dtype=torch.float64, device="cpu")
    psi_bc = vacuum_psi_from_config(grid, cfg).numpy()
    np_res = npref.solve_equilibrium_np(grid.R.numpy(), grid.Z.numpy(), psi_bc, 15.0, mu0=1.0,
                                        max_iter=600, tol=1e-4, alpha=0.1)
    span = np_res["psi"].max() - np_res["psi"].min()
    psi = res.psi.detach().cpu().to(torch.float64).numpy()
    return res, np_res, float(np.max(np.abs(psi - np_res["psi"])) / span)


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    lanes = []
    card = on_card(device)
    dtype = torch.float32 if card else torch.float64
    backend = "cuda" if card else "cpu"

    # ── Lane 1: Solov'ev analytic ──
    e65 = solovev_err(65, device, dtype, card)
    e129 = solovev_err(129, device, dtype, card)
    # f32 floors near 1e-6 span-rel; gates per-precision.
    gate = 2e-4 if not card else 2e-3
    # Order check cannot be resolved once the fine-grid error sits at the
    # f32 rounding floor (~1e-5 span-rel in f32); below that floor the
    # solve is as exact as the precision allows.
    order_ok = (e65 / max(e129, 1e-12)) > 2.5 or e129 < 1e-5
    lanes.append(LaneResult(
        name="solovev_analytic",
        status="pass" if (e65 < gate and order_ok) else "fail",
        metrics={"span_rel_err_65": e65, "span_rel_err_129": e129,
                 "convergence_ratio": e65 / max(e129, 1e-12)},
        thresholds={"span_rel_err_65": gate},
        notes=f"dtype={str(dtype).removeprefix('torch.')}, backend={backend}",
    ))

    # ── Lane 2: GEQDSK fixture reconstruction ──
    if not REFERENCE_DATA.exists():
        lanes.append(LaneResult(
            name="geqdsk_reconstruction", status="blocked",
            notes="reference fixture data not mounted"))
    else:
        from scpn_fusion_tpu_torch.io import read_geqdsk
        from scpn_fusion_tpu_torch.models.equilibrium.eqdsk_solve import solve_from_geqdsk
        metrics, thresholds, ok = {}, {}, True
        for rel, gate_v in GEQDSK_CASES:
            eq = read_geqdsk(REFERENCE_DATA / rel)
            res = solve_from_geqdsk(eq, max_iter=400, dtype=dtype, device=device)
            rmse = float(res.span_rel_rmse)
            key = rel.split("/")[-1]
            metrics[f"{key}.span_rel_rmse"] = rmse
            metrics[f"{key}.converged"] = bool(res.converged)
            thresholds[f"{key}.span_rel_rmse"] = gate_v
            ok = ok and bool(res.converged) and rmse < gate_v
        lanes.append(LaneResult(
            name="geqdsk_reconstruction",
            status="pass" if ok else "fail",
            metrics=metrics, thresholds=thresholds,
            notes=("repo-specific ENVELOPE gate on the naive vacuum-outside "
                   "profile-source re-solve; the reference gates psi NRMSE "
                   "at 0.05 (benchmark_sparc_geqdsk_rmse.py:31) — that "
                   "strict parity lives in run_real_shot_accuracy.py "
                   "(measured-external-source lane, all 5 SPARC files "
                   "under 0.0031 NRMSE); this lane only regression-guards "
                   "the simple solver path")))

    # ── Lane 3: NumPy-twin parity on the full nonlinear solve ──
    res, np_res, dev = twin_lane(device, dtype)
    gate3 = 1e-3 if card else 1e-6
    lanes.append(LaneResult(
        name="numpy_twin_parity",
        status="pass" if (bool(res.converged) and np_res["converged"]
                          and dev < gate3) else "fail",
        metrics={"span_rel_deviation": dev,
                 "jax_iterations": int(res.iterations),
                 "numpy_iterations": int(np_res["iterations"])},
        thresholds={"span_rel_deviation": gate3}))

    path = write_report("equilibrium_parity", lanes, out_dir=out_dir)
    payload = json.loads(path.read_text())
    print(f"report: {path}")
    print(f"overall: {payload['overall_status']}")
    for lane in payload["lanes"]:
        print(f"  {lane['name']}: {lane['status']}")
    return 0 if payload["overall_status"] == "pass" else 1
