"""Batched-forward amortisation + warm/cold evidence, the port's
``validation/run_batched_amortisation.py``.

Mirrors the reference's batched-forward lane
(``jax_predictive_forward_compiled.py:32`` vmap batch variant;
``artifacts/rung2_mg_preconditioner/batched_forward_amortisation_h100.json``:
B=16/64/256 per-solve 13.6/13.0/14.6 ms on H100, warm-start 164.8 -> 13.0 ms).

Lanes (fail-closed):
1. batched_element_parity — element b of the batch solve vs the single
   solve at the same inputs, at the fixed-point-accuracy bound (float32
   shifts the convergence-gated stopping iteration by +-1).
2. batched_amortisation — per-solve wall-clock at B=1/16/64/256 at 129^2:
   the B>=16 per-solve cost must be < 0.5x the B=1 per-solve cost.
3. warm_cold_compile — the first B=256 call against the warm call (the
   reference's 164.8 -> 13.0 ms row).
4. batched_mixed_amortisation — the batched MIXED precision solve (f64
   master iterate + criterion, f32 MG defect correction) on the card:
   per-solve at B=64 <= the reference's FP64 13.0 ms, element parity 1e-5.

On a CUDA device the float32 batches run the batched kernels 2 and 3 (one
launch each a Picard iteration) and the mixed batches' f32 V-cycles the
batched kernel 3; off it lane 4 reports blocked, as the script's does off
the TPU.  The port compiles nothing when it is called, so lane 3's cold
call is the first B=256 call of a fresh process (the CUDA context, the
kernel library's load, the first launches and allocations).  Times are on
the host clock ending in a synchronise, the script's protocol.  Writes
into ``out_dir``.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import NO_CARD, fresh_process, host_ms, on_card

BATCHES = (1, 16, 64, 256)
REF_PER_SOLVE_MS = 13.0


def first_batch_ms(n: int, b: int, batches: list, device: str) -> dict:
    """In a fresh process: the ms of the first B = ``b`` float32 batch call
    of a process on ``device``, from before its first work there to its psi
    on the host, and whether it converged."""
    from scpn_fusion_tpu_torch.bench_config import amortisation_config, amortisation_draws
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch
    cur, tgt = amortisation_draws(batches=tuple(batches))[b]
    t0 = time.perf_counter()
    cfg = amortisation_config(n)
    grid = Grid.from_config(cfg, dtype=torch.float32, device=device)
    out = solve_equilibrium_batch(cfg, grid, torch.from_numpy(cur).to(device),
                                  torch.from_numpy(tgt).to(device))
    out.psi.cpu()
    return {"cold_ms": 1e3 * (time.perf_counter() - t0), "converged": bool(out.converged.all())}


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR,
         n: int = 129, batches: tuple = BATCHES) -> int:
    """The campaign at the script's sizes (``n``, ``batches``; the CPU tests
    pass smaller ones)."""
    from scpn_fusion_tpu_torch.bench_config import amortisation_config, amortisation_draws
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.parallel.ensemble import (
        solve_equilibrium_batch, solve_equilibrium_batch_mixed,
    )
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    card = on_card(dev)
    backend = "cuda" if card else "cpu"
    lanes = []
    cfg = amortisation_config(n)
    grid = Grid.from_config(cfg, dtype=torch.float32, device=dev)
    draws = amortisation_draws(batches=batches)

    def inputs(key, dtype=torch.float32):
        cur, tgt = draws[key]
        return (torch.from_numpy(cur).to(dtype=dtype, device=dev),
                torch.from_numpy(tgt).to(dtype=dtype, device=dev))

    # ── Lane 1: element parity (f32: the stopping iteration may shift by
    # +-1, so the gate is the fixed-point-accuracy bound) ──
    cur_b, tgt_b = inputs("parity")
    out_b = solve_equilibrium_batch(cfg, grid, cur_b, tgt_b)
    out_one = solve_equilibrium_batch(cfg, grid, cur_b[3:4], tgt_b[3:4])
    psi_b = out_b.psi.cpu().to(torch.float64).numpy()
    span = float(psi_b[3].max() - psi_b[3].min())
    dev1 = float(np.max(np.abs(psi_b[3] - out_one.psi[0].cpu().to(torch.float64).numpy()))) / span
    gate1 = 5e-3
    conv_b, conv_one = bool(out_b.converged.all()), bool(out_one.converged[0])
    lanes.append(LaneResult(
        name="batched_element_parity",
        status="pass" if (dev1 < gate1 and conv_b and conv_one) else "fail",
        metrics={"span_rel_dev_element_vs_single": dev1,
                 "iters_in_batch": int(out_b.iterations[3]),
                 "iters_standalone": int(out_one.iterations[0]),
                 "batch_all_converged": conv_b,
                 "backend": backend, "dtype": "float32"},
        thresholds={"span_rel_dev_element_vs_single": gate1},
        notes="both converged to the same tol; dev bounded by the "
              "fixed-point-accuracy scale (f32 on-chip layout noise "
              "shifts the stopping iteration).  Bitwise trajectory "
              "identity is gated at 1e-12 on the CPU f64 straggler "
              "test (guarded while-body)"))

    # ── Lanes 2+3: amortisation sweep + warm/cold ──
    per_solve = {}
    for b in batches:
        cur, tgt = inputs(b)
        host_ms(lambda: solve_equilibrium_batch(cfg, grid, cur, tgt).psi.cpu(), dev)
        times = [host_ms(lambda: solve_equilibrium_batch(cfg, grid, cur, tgt).psi.cpu(), dev)[1]
                 for _ in range(3)]
        per_solve[b] = min(times) / b
    b_top = batches[-1]
    fresh = fresh_process(f"{__name__}:first_batch_ms", n=n, b=b_top, batches=list(batches),
                          device=str(torch.device(device)))
    cold_ms = fresh["cold_ms"]

    amort_ok = all(per_solve[b] < 0.5 * per_solve[1] for b in batches[1:])
    lanes.append(LaneResult(
        name="batched_amortisation",
        status="pass" if amort_ok else "fail",
        metrics={f"per_solve_ms_B{b}": round(v, 3) for b, v in per_solve.items()}
        | {"grid": f"{n}x{n}", "backend": backend},
        thresholds={"amortisation_factor_max": 0.5},
        notes="per-solve wall at B=1/16/64/256, 129^2 multigrid-Picard "
              "(reference lane: 13.6/13.0/14.6 ms on H100 at B=16/64/256); "
              "B>=16 must amortise to <0.5x the B=1 cost"))

    warm_ms = per_solve[b_top] * b_top
    lanes.append(LaneResult(
        name="warm_cold_compile",
        status="pass" if (fresh["converged"] and warm_ms < cold_ms) else "fail",
        metrics={"cold_trace_compile_ms_B256": round(cold_ms, 1),
                 "warm_cached_ms_B256": round(warm_ms, 1),
                 "speedup": round(cold_ms / max(warm_ms, 1e-9), 2)},
        thresholds={"warm_faster_than_cold": 1.0},
        notes="first-call trace+compile wall vs warm cached call for the "
              "B=256 batch program (reference row: 164.8 -> 13.0 ms)"))

    # ── Lane 4: batched MIXED precision ──
    if card:
        grid64 = Grid.from_config(cfg, dtype=torch.float64, device=dev)
        per_solve_mx = {}
        for b in (16, 64):
            cur64, tgt64 = inputs(("mixed", b), torch.float64)
            out = solve_equilibrium_batch_mixed(cfg, grid64, cur64, tgt64)
            out.psi.cpu()
            times = []
            for _ in range(3):
                out, ms = host_ms(lambda: solve_equilibrium_batch_mixed(cfg, grid64, cur64,
                                                                        tgt64), dev)
                out.psi.cpu()
                times.append(ms)
            per_solve_mx[b] = min(times) / b
            if b == 16:
                psi_mb = out.psi.cpu().numpy()
                conv_mb = bool(out.converged.all())
                cur16, tgt16 = cur64, tgt64
        out1 = solve_equilibrium_batch_mixed(cfg, grid64, cur16[3:4], tgt16[3:4])
        span = float(psi_mb[3].max() - psi_mb[3].min())
        dev_mx = float(np.max(np.abs(psi_mb[3] - out1.psi[0].cpu().numpy()))) / span
        ok_mx = conv_mb and dev_mx < 1e-5 and per_solve_mx[64] <= REF_PER_SOLVE_MS
        lanes.append(LaneResult(
            name="batched_mixed_amortisation",
            status="pass" if ok_mx else "fail",
            metrics={f"per_solve_ms_B{b}": round(v, 3) for b, v in per_solve_mx.items()}
            | {"span_rel_element_vs_single": dev_mx, "all_converged_B16": conv_mb,
               "reference_h100_fp64_per_solve_ms": REF_PER_SOLVE_MS},
            thresholds={"per_solve_ms_B64": REF_PER_SOLVE_MS,
                        "span_rel_element_vs_single": 1e-5},
            notes="f64-criterion batched solves (f32 only in the MG "
                  "defect correction) vs the reference's FP64 H100 "
                  "batched row 13.6/13.0/14.6 ms — same precision "
                  "class; element parity at the f32-correction scale "
                  "(~1e-6, the batched/unbatched layouts round the "
                  "injected V-cycle differently; the f64 master iterate "
                  "bounds it there — tests/test_parallel_2d_ensemble.py)"))
    else:
        lanes.append(LaneResult(name="batched_mixed_amortisation", status="blocked",
                                notes=NO_CARD))

    path = write_report("batched_amortisation", lanes, out_dir=out_dir)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes if lane.status != "blocked") else 1
