"""GS solver mesh-convergence study (spatial order of accuracy), the
port's ``validation/run_mesh_convergence.py``.

Counterpart of the reference's ``validation/mesh_convergence_study.py``
(Solov'ev analytic benchmark at multiple resolutions; gates
``convergence_rate >= 1.8`` over ``>= 2`` rated grid pairs).  Lanes
(fail-closed):

1. mesh_convergence_order — Solov'ev exact-solution error at
   17/33/65/129/257 in float64; per-pair observed order
   log2(e_coarse / e_fine) and a global log-log least-squares fit of
   err ~ h^p.  Gate: fitted order >= 1.8 (5-point star is O(h^2)) on
   BOTH Linf and L2, with every rated pair >= 1.5.
2. richardson_extrapolation — Richardson-extrapolated field from the
   two finest grids must beat the fine-grid error by the factor the
   fitted order implies (>= 2x).

Runs on ``device`` (plain multigrid ops); writes checksummed JSON+MD
evidence into ``out_dir``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR

RESOLUTIONS = (17, 33, 65, 129, 257)
MIN_FITTED_ORDER = 1.8          # reference DEFAULT_MIN_CONVERGENCE_RATE
MIN_PAIR_ORDER = 1.5
MIN_RATED_PAIRS = 2             # reference DEFAULT_MIN_RATED_GRID_COUNT


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.solovev import SolovevParams
    from scpn_fusion_tpu_torch.ops import multigrid as mg
    from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    params = SolovevParams()
    lanes = []

    def solve_at(n):
        grid = Grid.from_bounds(n, n, 3.0, 9.0, -3.0, 3.0, dtype=torch.float64, device=dev)
        psi_exact = params.psi(grid.RR, grid.ZZ)
        src = params.source(grid.RR)
        psi0 = apply_dirichlet(torch.zeros_like(psi_exact), psi_exact)
        # Enough V-cycles that algebraic error sits far below the
        # discretisation error at every resolution.
        out = mg.mg_solve(psi0, src, grid.R, grid.dR, grid.dZ, n_cycles=40,
                          use_pallas=False)
        span = float(psi_exact.max() - psi_exact.min())
        err = out - psi_exact
        linf = float(err.abs().max()) / span
        l2 = float(torch.sqrt(torch.mean(err**2))) / span
        return linf, l2, out.cpu().numpy(), psi_exact.cpu().numpy(), grid

    results = {}
    fine = {}
    for n in RESOLUTIONS:
        linf, l2, out, exact, grid = solve_at(n)
        results[n] = (linf, l2)
        fine[n] = (out, exact, grid)

    h = np.array([1.0 / (n - 1) for n in RESOLUTIONS])
    linf_v = np.array([results[n][0] for n in RESOLUTIONS])
    l2_v = np.array([results[n][1] for n in RESOLUTIONS])

    pair_orders_linf = [float(np.log2(linf_v[i] / linf_v[i + 1]))
                        for i in range(len(RESOLUTIONS) - 1)]
    pair_orders_l2 = [float(np.log2(l2_v[i] / l2_v[i + 1]))
                      for i in range(len(RESOLUTIONS) - 1)]
    fit_linf = float(np.polyfit(np.log(h), np.log(linf_v), 1)[0])
    fit_l2 = float(np.polyfit(np.log(h), np.log(l2_v), 1)[0])

    rated = [p for p in pair_orders_linf if p >= MIN_PAIR_ORDER]
    ok1 = (fit_linf >= MIN_FITTED_ORDER and fit_l2 >= MIN_FITTED_ORDER
           and len(rated) >= MIN_RATED_PAIRS
           and min(pair_orders_linf) >= MIN_PAIR_ORDER)
    lanes.append(LaneResult(
        name="mesh_convergence_order",
        status="pass" if ok1 else "fail",
        metrics={
            "resolutions": list(RESOLUTIONS),
            "span_rel_linf": [float(v) for v in linf_v],
            "span_rel_l2": [float(v) for v in l2_v],
            "pair_orders_linf": pair_orders_linf,
            "pair_orders_l2": pair_orders_l2,
            "fitted_order_linf": fit_linf,
            "fitted_order_l2": fit_l2,
        },
        thresholds={"fitted_order": MIN_FITTED_ORDER,
                    "pair_order": MIN_PAIR_ORDER,
                    "rated_pairs": MIN_RATED_PAIRS},
        notes=("Solov'ev exact-solution ladder, 40 V-cycles/grid, float64; "
               "5-point star expected O(h^2). Reference counterpart: "
               "validation/mesh_convergence_study.py (rate >= 1.8)."),
    ))

    # ── Lane 2: Richardson extrapolation on the two finest grids ──
    out_f, exact_f, _ = fine[RESOLUTIONS[-1]]
    out_c, _, _ = fine[RESOLUTIONS[-2]]
    p = fit_linf
    # Coarse solution sampled onto the fine grid (nodes coincide 2:1).
    out_c_on_f = np.zeros_like(out_f)
    out_c_on_f[::2, ::2] = out_c
    # Only compare at coincident nodes.
    mask = np.zeros_like(out_f, dtype=bool)
    mask[::2, ::2] = True
    rich = (2.0**p * out_f - out_c_on_f) / (2.0**p - 1.0)
    span = float(exact_f.max() - exact_f.min())
    err_fine = float(np.max(np.abs((out_f - exact_f)[mask]))) / span
    err_rich = float(np.max(np.abs((rich - exact_f)[mask]))) / span
    gain = err_fine / max(err_rich, 1e-300)
    ok2 = gain >= 2.0
    lanes.append(LaneResult(
        name="richardson_extrapolation",
        status="pass" if ok2 else "fail",
        metrics={"err_fine_span_rel": err_fine,
                 "err_richardson_span_rel": err_rich,
                 "gain": float(gain),
                 "order_used": float(p)},
        thresholds={"gain": 2.0},
        notes=("Richardson combination of the two finest grids at "
               "coincident nodes; >= 2x error reduction confirms the "
               "asymptotic regime."),
    ))

    write_report("mesh_convergence", lanes, out_dir=out_dir)
    return 0 if all(ln.status == "pass" for ln in lanes
                    if ln.status != "blocked") else 1
