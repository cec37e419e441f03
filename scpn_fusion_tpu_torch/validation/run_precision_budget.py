"""f32-vs-f64 error-budget campaign, the port's
``validation/run_precision_budget.py``.

Quantifies what float32 costs on the port's own solves, with float64 as the
reference.  On a CUDA device the float32 solves run the hand-written
kernels, so the gates hold the kernel path's float32 penalty:

1. fixed_boundary_f32_penalty — the full fixed-boundary GS solve
   (multigrid-Picard) at 129^2 in f32 vs f64 (on CUDA the f32 solve runs
   the source kernel and the fused V-cycle every Picard iteration):
   span-relative psi deviation, per-precision GS residuals, iteration
   counts.
2. multigrid_operator_precision_floors — the raw MG solve on a
   manufactured problem at 257^2: f32-vs-f64 deviation and the achievable
   residual floor per precision.
3. mixed_precision_513_residual_gated — the f64 master iterate with f32
   multigrid defect correction at 513^2 (on CUDA its f32 V-cycles run the
   fine legs at 513^2 and the fused V-cycle below), converged on the
   GS-residual criterion.

Writes checksummed JSON+MD evidence into ``out_dir``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.core.config import (
        Coil,
        Dimensions,
        PhysicsParams,
        ReactorConfig,
        SolverParams,
    )
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
        solve_equilibrium,
    )
    from scpn_fusion_tpu_torch.ops import multigrid as mg
    from scpn_fusion_tpu_torch.ops.stencil import (
        apply_dirichlet,
        gs_operator,
        gs_residual_rms,
    )
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    lanes = []

    # ── Lane 1: full fixed-boundary solve, f32 vs f64 ──
    def cfg_named(name):
        coils = (Coil(r=3.5, z=4.8, current=-1.0),
                 Coil(r=8.0, z=4.8, current=4.0),
                 Coil(r=10.8, z=0.0, current=6.0),
                 Coil(r=8.0, z=-4.8, current=4.0),
                 Coil(r=3.5, z=-4.8, current=-1.0),
                 Coil(r=10.8, z=2.5, current=3.0))
        return ReactorConfig(
            reactor_name=name,
            grid_resolution=(129, 129),
            dimensions=Dimensions(R_min=2.0, R_max=10.0,
                                  Z_min=-4.0, Z_max=4.0),
            coils=coils,
            physics=PhysicsParams(plasma_current_target=15.0,
                                  vacuum_permeability=1.0),
            solver=SolverParams(max_iterations=300,
                                convergence_threshold=1e-6,
                                relaxation_factor=0.1,
                                solver_method="multigrid"))

    results = {}
    for dtype, label in ((torch.float64, "f64"), (torch.float32, "f32")):
        res = solve_equilibrium(cfg_named(f"prec-{label}"), dtype=dtype, device=dev)
        results[label] = res
    psi64 = results["f64"].psi.detach().cpu().numpy().astype(np.float64)
    psi32 = results["f32"].psi.detach().cpu().numpy().astype(np.float64)
    span = float(psi64.max() - psi64.min())
    dev_rel = float(np.max(np.abs(psi64 - psi32))) / max(span, 1e-30)
    gate_dev = 5e-4   # f32 penalty must stay in the 1e-4 class
    lanes.append(LaneResult(
        name="fixed_boundary_f32_penalty",
        status="pass" if dev_rel < gate_dev else "fail",
        metrics={
            "span_rel_deviation_f32_vs_f64": dev_rel,
            "iterations_f64": int(results["f64"].iterations),
            "iterations_f32": int(results["f32"].iterations),
            "gs_residual_f64": float(results["f64"].gs_residual),
            "gs_residual_f32": float(results["f32"].gs_residual),
            "grid": "129x129",
        },
        thresholds={"span_rel_deviation_f32_vs_f64": gate_dev},
        notes="full multigrid-Picard solve per precision; on a CUDA device "
              "the f32 solve runs the hand-written source and V-cycle "
              "kernels, so this number is the kernel path's precision "
              "penalty"))

    # ── Lane 2: raw MG operator, residual floors per precision ──
    grid = Grid.from_bounds(257, 257, 2.0, 10.0, -4.0, 4.0,
                            dtype=torch.float64, device=dev)
    rr, zz = grid.RR, grid.ZZ
    psi_exact64 = torch.exp(-((rr - 6.0) ** 2 + zz**2) / 3.0)
    src64 = gs_operator(psi_exact64, grid.R, grid.dR, grid.dZ)
    floors = {}
    errs = {}
    for dtype, label in ((torch.float64, "f64"), (torch.float32, "f32")):
        psi_e = psi_exact64.to(dtype)
        src = src64.to(dtype)
        r_1d = grid.R.to(dtype)
        psi0 = apply_dirichlet(torch.zeros_like(psi_e), psi_e)
        out = mg.mg_solve(psi0, src, r_1d, grid.dR, grid.dZ, n_cycles=40)
        floors[label] = float(gs_residual_rms(out, src, r_1d, grid.dR, grid.dZ))
        span_e = float(psi_e.max() - psi_e.min())
        errs[label] = float((out - psi_e).abs().max()) / span_e
    # The source is the DISCRETE operator applied to the exact field, so
    # each precision converges to its own machine-epsilon floor (f64 ~
    # 1e-14, f32 ~ 1e-5 span-rel) — the error budget is each floor's
    # ABSOLUTE level, not their ratio.
    ok = (errs["f32"] < 1e-4) and (errs["f64"] < 1e-10)
    lanes.append(LaneResult(
        name="multigrid_operator_precision_floors",
        status="pass" if ok else "fail",
        metrics={
            "err_vs_exact_f64_span_rel": errs["f64"],
            "err_vs_exact_f32_span_rel": errs["f32"],
            "residual_floor_f64": floors["f64"],
            "residual_floor_f32": floors["f32"],
            "grid": "257x257", "n_cycles": 40,
        },
        thresholds={"err_vs_exact_f32_span_rel": 1e-4,
                    "err_vs_exact_f64_span_rel": 1e-10},
        notes="discrete-exact MG solve: each precision reaches its own "
              "epsilon floor; the f32 floor (~1e-5 span-rel) is 3 orders "
              "below the tightest physics gate, which is the basis for "
              "running the kernel path in f32"))

    # ── Lane 3: mixed-precision (f32 V-cycle + f64 residual) 513^2 ──
    from scpn_fusion_tpu_torch.models.equilibrium.mixed_precision import (
        solve_equilibrium_mixed_fmg,
    )

    n_head = 513
    gs_tol_513 = 3e-5
    cfg_513 = ReactorConfig(
        reactor_name="prec-mixed-513",
        grid_resolution=(n_head, n_head),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=cfg_named("x").coils,
        physics=PhysicsParams(plasma_current_target=15.0,
                              vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=200,
                            convergence_threshold=1e-5,
                            relaxation_factor=1.0,
                            solver_method="anderson_mg",
                            anderson_depth=4,
                            gs_residual_threshold=gs_tol_513))
    res_m, cascade = solve_equilibrium_mixed_fmg(cfg_513, n_refine=2, device=dev)
    gs_m = float(res_m.gs_residual)
    ok3 = bool(res_m.converged) and gs_m < gs_tol_513
    lanes.append(LaneResult(
        name="mixed_precision_513_residual_gated",
        status="pass" if ok3 else "fail",
        metrics={
            "grid": "513x513",
            "converged_on_gs_residual": bool(res_m.converged),
            "gs_residual_rms": gs_m,
            "gs_residual_threshold": gs_tol_513,
            "update_diff": float(res_m.residual),
            "fine_iterations": int(res_m.iterations),
            "cascade": str(cascade),
            "f32_residual_floor_129_for_context": 3.7e-3,
        },
        thresholds={"gs_residual_rms": gs_tol_513},
        notes="f64 master iterate + f32 multigrid defect correction "
              "(2 refinement rounds/outer iteration) + Anderson over f64 "
              "buffers with f32 Gram solve; converges on the GS-residual "
              "criterion at the headline grid, which the pure-f32 path "
              "cannot (its measured residual stalls ~1e-3 from rounding "
              "noise alone).  On a CUDA device its f32 V-cycles run the "
              "hand-written kernels."))

    path = write_report("precision_budget", lanes, out_dir=out_dir)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes) else 1
