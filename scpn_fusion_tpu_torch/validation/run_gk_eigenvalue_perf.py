"""GK linear-eigenvalue solve cost vs the reference's per-surface figure,
the port's ``validation/run_gk_eigenvalue_perf.py``.

The reference's hybrid-GK scheduler budgets its native linear eigenvalue
spot-check at ~0.3 s per flux surface (BASELINE.md "GK hybrid surrogate
path ... native linear eigenvalue ~0.3 s/surface").  This lane times the
port's kinetic dispersion eigenvalue solve (the 10-point
``solve_linear_gk`` spectrum, its default method, on ``device``).
Lanes (fail-closed):

1. gk_eigenvalue_per_solve — warm per-k_y eigenvalue solve <= 0.3 s, all
   rates finite with labelled mode types.

Writes checksummed JSON+MD evidence into ``out_dir``.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR

REF_PER_SURFACE_S = 0.3


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.models.gyrokinetics.linear import solve_linear_gk
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    solve_linear_gk(device=dev)            # warm-up (allocator, library handles)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solve_linear_gk(device=dev)      # returns host arrays: the time is the whole solve
    spectrum_s = time.perf_counter() - t0
    per_solve_s = spectrum_s / len(res.k_y)

    finite = bool(np.all(np.isfinite(res.gamma))
                  and np.all(np.isfinite(res.omega_r)))
    labelled = all(isinstance(m, str) and m for m in res.mode_type)
    ok = finite and labelled and per_solve_s <= REF_PER_SURFACE_S
    lanes = [LaneResult(
        name="gk_eigenvalue_per_solve",
        status="pass" if ok else "fail",
        metrics={"per_ky_solve_s": round(per_solve_s, 4),
                 "full_10ky_spectrum_s": round(spectrum_s, 3),
                 "n_ky": int(len(res.k_y)),
                 "reference_per_surface_s": REF_PER_SURFACE_S,
                 "all_rates_finite": finite,
                 "mode_types": sorted(set(res.mode_type))},
        thresholds={"per_ky_solve_s": REF_PER_SURFACE_S},
        notes=(f"warm timing on {dev.type}, default 8x12 velocity grid "
               "(the quantitative rate gates live in "
               "gk_growth_rates.json); the reference budget is its "
               "hybrid scheduler's spot-check cost"),
    )]

    write_report("gk_eigenvalue_perf", lanes, out_dir=out_dir)
    return 0 if all(ln.status == "pass" for ln in lanes
                    if ln.status != "blocked") else 1
