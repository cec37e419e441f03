"""Sharded Grad-Shafranov validation campaign, the port's
``validation/run_sharded_gs.py``.

Lanes (fail-closed, blocked != pass):
1. shard_count_invariance_1d — the Z-slab sharded SOR program must reach
   the same field for n_shards in {1, 2, 4, 8} (global checkerboard
   parity preserved across shard counts).
2. sharded_scaling_shape     — per-sweep wall-clock vs shard count: a
   SHAPE diagnostic (the shards share one device), recorded as such.
3. shard_count_invariance_2d — the 2D-tiled program (2x4 process grid)
   must match the 1-shard result.
4. sharded_vs_plain_program  — n_shards=1 through the sharded program
   vs the plain single-device sweep path: the distributed-program
   overhead and numerical identity on one device.

The JAX script runs on 8 virtual CPU devices; the port runs on ``device``
(float64) with ``parallel/mesh.Mesh`` shards that all live there, its
single-controller program (exchanges by copies).  The port compiles
nothing, so each timed call is the first.  Writes into ``out_dir``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import host_ms

SHARD_COUNTS = (1, 2, 4, 8)
GATE_DEV = 1e-10   # identical algorithm across shard counts (f64)


def virtual_mesh(device, n: int, axes=("z",), sizes=None):
    """``n`` shards of one ``device`` (the exchanges' arithmetic and launch
    structure; no interconnect)."""
    from scpn_fusion_tpu_torch.parallel.mesh import Mesh
    return Mesh.of([torch.device(device)] * n, axes, sizes)


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR,
         n: int = 256, n_sweeps: int = 200) -> int:
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.ops.stencil import gs_operator, sor_sweeps
    from scpn_fusion_tpu_torch.parallel.halo import sharded_sor_solve
    from scpn_fusion_tpu_torch.parallel.halo2d import optimal_process_grid, sharded_sor_solve_2d
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    f64 = torch.float64
    lanes = []
    grid = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=f64, device=dev)
    psi_exact = torch.exp(-((grid.RR - 6.0) ** 2 + grid.ZZ**2) / 3.0)
    src = gs_operator(psi_exact, grid.R, grid.dR, grid.dZ)
    rng = np.random.default_rng(7)
    psi0 = psi_exact + torch.tensor(0.05 * rng.standard_normal(grid.shape), dtype=f64,
                                    device=dev)
    omega = 1.7
    span = float(psi_exact.max() - psi_exact.min())

    results, timings = {}, {}
    for n_sh in SHARD_COUNTS:
        (out, _), ms = host_ms(lambda: sharded_sor_solve(
            psi0, src, grid.R, omega, mesh=virtual_mesh(dev, n_sh), axis="z", d_r=grid.dR,
            d_z=grid.dZ, n_sweeps=n_sweeps, nz_total=grid.NZ), dev)
        timings[n_sh] = ms / n_sweeps
        results[n_sh] = out.cpu().numpy()

    max_dev = max(float(np.max(np.abs(results[k] - results[1]))) / span
                  for k in SHARD_COUNTS[1:])
    err_vs_exact = float(np.max(np.abs(results[8] - psi_exact.cpu().numpy()))) / span
    lanes.append(LaneResult(
        name="shard_count_invariance_1d",
        status="pass" if max_dev < GATE_DEV else "fail",
        metrics={"max_span_rel_deviation_vs_1shard": max_dev,
                 "err_vs_manufactured_span_rel": err_vs_exact,
                 "n_sweeps": n_sweeps, "grid": f"{n}x{n}"},
        thresholds={"max_span_rel_deviation_vs_1shard": GATE_DEV},
        notes="global checkerboard parity preserved across Z-slab shard "
              "counts 1/2/4/8; x64 CPU mesh"))

    lanes.append(LaneResult(
        name="sharded_scaling_shape",
        status="pass" if all(np.isfinite(list(timings.values()))) else "fail",
        metrics={f"ms_per_sweep_{k}shards": round(t, 4) for k, t in timings.items()},
        notes="virtual devices share host cores — recorded as program-"
              "shape evidence, NOT a speedup claim; the real-chip perf "
              "datapoint is bench.py (driver lane)"))

    pz, pr = optimal_process_grid(8)
    out2d, _ = sharded_sor_solve_2d(psi0, src, grid.R, omega,
                                    mesh=virtual_mesh(dev, 8, ("tz", "tr"), (pz, pr)),
                                    d_r=grid.dR, d_z=grid.dZ, n_sweeps=n_sweeps,
                                    nz_total=grid.NZ, nr_total=grid.NR)
    dev_2d = float(np.max(np.abs(out2d.cpu().numpy() - results[1]))) / span
    lanes.append(LaneResult(
        name="shard_count_invariance_2d",
        status="pass" if dev_2d < GATE_DEV else "fail",
        metrics={"span_rel_deviation_vs_1shard": dev_2d, "process_grid": f"{pz}x{pr}"},
        thresholds={"span_rel_deviation_vs_1shard": GATE_DEV},
        notes="2D Cartesian tiling (halo2d) vs single-shard reference"))

    plain, ms_plain = host_ms(lambda: sor_sweeps(psi0, src, grid.R, grid.dR, grid.dZ, 1.7,
                                                 n_sweeps), dev)
    t_plain = ms_plain / n_sweeps
    dev_plain = float(np.max(np.abs(plain.cpu().numpy() - results[1]))) / span
    lanes.append(LaneResult(
        name="sharded_vs_plain_program",
        status="pass" if dev_plain < GATE_DEV else "fail",
        metrics={"span_rel_deviation": dev_plain,
                 "ms_per_sweep_plain": round(t_plain, 4),
                 "ms_per_sweep_shardmap_1shard": round(timings[1], 4),
                 "shardmap_overhead_ratio": round(timings[1] / max(t_plain, 1e-9), 3)},
        thresholds={"span_rel_deviation": GATE_DEV},
        notes="numerical identity of the distributed program at "
              "n_shards=1 + its dispatch overhead vs the plain XLA path"))

    path = write_report("sharded_gs", lanes, out_dir=out_dir)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes) else 1
