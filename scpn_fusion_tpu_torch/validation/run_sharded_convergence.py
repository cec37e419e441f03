"""Distributed CONVERGENCE campaign: a device mesh converges the headline
solve, the port's ``validation/run_sharded_convergence.py``.

Lanes (fail-closed, blocked != pass):

1. sharded_headline_convergence — the full nonlinear Anderson-MG-Picard
   equilibrium solve at 513^2, distributed over 1/2/4/8 Z-slab shards
   (`parallel/sharded_solve.py`: halo-exchanged fine level, replicated
   coarse levels).  Every shard count must CONVERGE with span-rel parity
   vs the single-device solve and identical outer-iteration count.
2. sharded_linear_residual_gate — the distributed linear MG solve
   (`sharded_mg_solve`) at 513^2 runs V-cycles to an explicit residual
   tolerance and the reported residual matches an independent
   recomputation.
3. sharded_scaling_shape_513 — wall-clock per solve vs shard count:
   SHAPE evidence only (the shards share one device).
4. sharded_fmg_cascade — the nested-iteration ladder on the 8-shard mesh.
5. tile2d_grid_invariant_convergence — the solve with its elliptic step
   2D-tiled over 1x8/2x4/4x2 process grids, iteration-identical.
6. sharded_free_boundary_forward — the free-boundary forward with its
   inner elliptic Z-slab-sharded, on 1/2/4/8 shards.
7. gk_shard_memory — the 5-D GK run on the (sx, sy, v) = (2, 2, 2) mesh
   against the monolithic run (row G on every shard on a CUDA device).

The JAX script runs on 8 virtual CPU devices; the port runs on ``device``
(float64) with ``parallel/mesh.Mesh`` shards that all live there.  The
port compiles nothing, so each timed call is the first.  The sizes are
keyword arguments (the script's by default; the CPU tests pass smaller
ones for lane 7).  Writes into ``out_dir``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import host_ms
from scpn_fusion_tpu_torch.validation.run_sharded_gs import SHARD_COUNTS, virtual_mesh

TILINGS = ((1, 8), (2, 4), (4, 2))
GK_SPEC = dict(n_kx=32, n_ky=32, n_theta=16, n_vpar=16, n_mu=8, n_steps=50,
               save_interval=25, nonlinear=True, collisions=True, dtype="complex128")
GK_SEED = 5
GK_MESH = (2, 2, 2)


def _span_dev(a, b) -> float:
    """max |a - b| over the span of ``b`` (host float64)."""
    a, b = (x.detach().cpu().to(torch.float64) for x in (a, b))
    return float((a - b).abs().max()) / float(b.max() - b.min())


def headline(device, n: int = 513) -> dict:
    """Lane 1's solves: the single-device solve and the 1/2/4/8-shard ones,
    with the sharded solves' ms (lane 3)."""
    from scpn_fusion_tpu_torch.bench_config import sharded_config
    from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium
    from scpn_fusion_tpu_torch.parallel.sharded_solve import solve_equilibrium_sharded
    cfg = dataclasses.replace(sharded_config(n), reactor_name=f"sharded-convergence-{n}")
    ref = solve_equilibrium(cfg, dtype=torch.float64, device=device)
    per_shard, timings = {}, {}
    for k in SHARD_COUNTS:
        res, timings[k] = host_ms(lambda k=k: solve_equilibrium_sharded(
            cfg, virtual_mesh(device, k), dtype=torch.float64), device)
        per_shard[k] = {"converged": bool(res.converged), "iterations": int(res.iterations),
                        "span_rel_dev_vs_single": _span_dev(res.psi, ref.psi)}
    return {"n": n, "cfg": cfg, "ref": ref, "per_shard": per_shard, "timings": timings}


def lane_headline(h: dict):
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    ref_iters = int(h["ref"].iterations)
    per_shard = h["per_shard"]
    max_dev = max(v["span_rel_dev_vs_single"] for v in per_shard.values())
    all_ok = bool(h["ref"].converged) and all(
        v["converged"] and v["iterations"] == ref_iters for v in per_shard.values())
    gate_dev = 1e-8
    return LaneResult(
        name="sharded_headline_convergence",
        status="pass" if (all_ok and max_dev < gate_dev) else "fail",
        metrics={"grid": f"{h['n']}x{h['n']}", "single_device_iterations": ref_iters,
                 "max_span_rel_dev_vs_single": max_dev,
                 **{f"shards_{k}_converged": v["converged"] for k, v in per_shard.items()},
                 **{f"shards_{k}_iterations": v["iterations"] for k, v in per_shard.items()}},
        thresholds={"max_span_rel_dev_vs_single": gate_dev},
        notes="full Anderson-MG-Picard solve CONVERGES (dual residual "
              "criterion) on 1/2/4/8-shard Z-slab meshes with identical "
              "outer-iteration count; x64 CPU mesh")


def lane_linear(device, n: int = 513):
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.ops.stencil import gs_operator, gs_residual
    from scpn_fusion_tpu_torch.parallel.sharded_mg import sharded_mg_solve
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    f64 = torch.float64
    grid = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=f64, device=device)
    psi_exact = torch.exp(-((grid.RR - 6.0) ** 2 + grid.ZZ**2) / 3.0)
    src = gs_operator(psi_exact, grid.R, grid.dR, grid.dZ)
    noise = 0.05 * np.random.default_rng(11).standard_normal(grid.shape)
    noise[0, :] = noise[-1, :] = 0.0
    noise[:, 0] = noise[:, -1] = 0.0
    psi0 = psi_exact + torch.tensor(noise, dtype=f64, device=device)
    tol = 1e-9
    psi_f, res_rms, k = sharded_mg_solve(psi0, src, grid.R, mesh=virtual_mesh(device, 8),
                                         axis="z", d_r=grid.dR, d_z=grid.dZ, tol=tol,
                                         max_cycles=80)
    r = gs_residual(psi_f, src, grid.R, grid.dR, grid.dZ)
    rms_chk = float(torch.sqrt((r * r).sum() / ((grid.NZ - 2) * (grid.NR - 2))))
    err = _span_dev(psi_f, psi_exact)
    ok2 = (float(res_rms) < tol and abs(rms_chk - float(res_rms)) <= 1e-4 * max(rms_chk, 1e-30)
           and int(k) < 80)
    return LaneResult(
        name="sharded_linear_residual_gate",
        status="pass" if ok2 else "fail",
        metrics={"residual_rms": float(res_rms), "v_cycles": int(k),
                 "independent_residual_rms": rms_chk, "err_vs_manufactured_span_rel": err},
        thresholds={"residual_rms": tol},
        notes="distributed MG V-cycles run TO a residual tolerance "
              "(8-shard mesh, 513^2 manufactured problem) — the gated-"
              "convergence counterpart of mpi_domain.rs:804")


def lane_scaling(h: dict):
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    timings = h["timings"]
    return LaneResult(
        name="sharded_scaling_shape_513",
        status="pass" if all(np.isfinite(list(timings.values()))) else "fail",
        metrics={f"ms_per_solve_{k}shards": round(v, 1) for k, v in timings.items()},
        notes="513^2 nonlinear solve wall-clock per shard count on the "
              "virtual CPU mesh — program-shape evidence only; real-chip "
              "perf is bench.py's lane")


def lane_fmg(device, h: dict):
    from scpn_fusion_tpu_torch.parallel.sharded_solve import solve_equilibrium_sharded_fmg
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    ref = h["ref"]
    res_fmg, info = solve_equilibrium_sharded_fmg(h["cfg"], virtual_mesh(device, 8),
                                                  min_coarse=129, dtype=torch.float64)
    dev_fmg = _span_dev(res_fmg.psi, ref.psi)
    ok4 = (all(lv["converged"] for lv in info) and dev_fmg < 1e-3
           and info[-1]["iterations"] <= int(ref.iterations))
    return LaneResult(
        name="sharded_fmg_cascade",
        status="pass" if ok4 else "fail",
        metrics={"ladder": info, "span_rel_dev_vs_single_direct": dev_fmg,
                 "single_direct_iterations": int(ref.iterations)},
        thresholds={"span_rel_dev_vs_single_direct": 1e-3},
        notes="nested-iteration warm-start ladder on the 8-device mesh "
              "(coarse levels at 1e-3, fine at the configured tol): the "
              "distributed counterpart of the bench FMG cascade")


def lane_tile2d(device, h: dict):
    from scpn_fusion_tpu_torch.parallel.sharded_mg2d import solve_equilibrium_sharded_2d
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    per_tiling = {}
    for shape in TILINGS:
        res2d = solve_equilibrium_sharded_2d(h["cfg"], virtual_mesh(device, 8, ("tz", "tr"),
                                                                    shape), dtype=torch.float64)
        per_tiling[f"{shape[0]}x{shape[1]}"] = {
            "converged": bool(res2d.converged), "iterations": int(res2d.iterations),
            "span_rel_dev_vs_single": _span_dev(res2d.psi, h["ref"].psi)}
    max_dev_2d = max(v["span_rel_dev_vs_single"] for v in per_tiling.values())
    iters_2d = {v["iterations"] for v in per_tiling.values()}
    gate_dev_2d = 1e-5
    ok5 = (all(v["converged"] for v in per_tiling.values()) and len(iters_2d) == 1
           and max_dev_2d < gate_dev_2d)
    n = h["n"]
    return LaneResult(
        name="tile2d_grid_invariant_convergence",
        status="pass" if ok5 else "fail",
        metrics={"grid": f"{n}x{n}", "max_span_rel_dev_vs_single": max_dev_2d,
                 "iteration_counts_identical": len(iters_2d) == 1,
                 **{f"tiling_{k}_iterations": v["iterations"] for k, v in per_tiling.items()},
                 **{f"tiling_{k}_converged": v["converged"] for k, v in per_tiling.items()}},
        thresholds={"max_span_rel_dev_vs_single": gate_dev_2d},
        notes="full Anderson-MG-Picard 513^2 solve CONVERGES with the "
              "elliptic inner solve 2D-tiled over 1x8/2x4/4x2 process "
              "grids, iteration-identical across tilings (the reference's "
              "tile == monolithic invariant, mpi_domain.rs:804,1009); "
              "x64 CPU mesh")


def lane_free_boundary(device, h: dict, n_fb: int = 129):
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import solve_free_boundary
    from scpn_fusion_tpu_torch.parallel.sharded_fb import solve_free_boundary_sharded
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    cfg_fb = dataclasses.replace(h["cfg"], grid_resolution=(n_fb, n_fb))
    kw = dict(max_outer_iter=12, tol=1e-5, mu0_green=1.0, dtype=torch.float64)
    fb_ref = solve_free_boundary(cfg_fb, device=device, **kw)
    per_fb, max_dev_fb = {}, 0.0
    ok6 = bool(fb_ref.converged)
    for k in SHARD_COUNTS:
        fb = solve_free_boundary_sharded(cfg_fb, mesh=virtual_mesh(device, k), **kw)
        max_dev_fb = max(max_dev_fb, _span_dev(fb.psi, fb_ref.psi))
        per_fb[k] = {"converged": bool(fb.converged),
                     "outer_iterations": int(fb.outer_iterations)}
        ok6 = (ok6 and bool(fb.converged)
               and int(fb.outer_iterations) == int(fb_ref.outer_iterations))
    gate_fb = 1e-8
    return LaneResult(
        name="sharded_free_boundary_forward",
        status="pass" if (ok6 and max_dev_fb < gate_fb) else "fail",
        metrics={"grid": f"{n_fb}x{n_fb}",
                 "single_device_outer_iterations": int(fb_ref.outer_iterations),
                 "max_span_rel_dev_vs_single": max_dev_fb,
                 **{f"shards_{k}_outer_iterations": v["outer_iterations"]
                    for k, v in per_fb.items()},
                 **{f"shards_{k}_converged": v["converged"] for k, v in per_fb.items()}},
        thresholds={"max_span_rel_dev_vs_single": gate_fb},
        notes="free-boundary predictive forward (coil Green's boundary, "
              "outer while_loop) with the inner elliptic Z-slab-sharded: "
              "converges iteration-identically on 1/2/4/8 shards; x64 "
              "CPU mesh")


def gk_runs(device, spec: dict | None = None) -> dict:
    """Lane 7's two runs at ``spec`` (the script's 32x32x16x16x8 c128, 50
    steps by default): the monolithic run and the run on the (2, 2, 2) mesh
    of ``device``, each its (final state, trace), under ``"mono"`` and
    ``"sharded"``, beside the ``"spec"``."""
    from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import (
        NonlinearGKConfig, run_nonlinear_gk,
    )
    from scpn_fusion_tpu_torch.parallel.gk_shard import run_nonlinear_gk_spatial_sharded_3d
    spec = dict(GK_SPEC if spec is None else spec)
    gk_cfg = NonlinearGKConfig(**spec)
    mono = run_nonlinear_gk(gk_cfg, seed=GK_SEED, device=device)
    sharded = run_nonlinear_gk_spatial_sharded_3d(
        gk_cfg, virtual_mesh(device, 8, ("sx", "sy", "v"), GK_MESH), seed=GK_SEED)
    return {"spec": spec, "mono": mono, "sharded": sharded}


def lane_gk(runs: dict):
    """Lane 7 from :func:`gk_runs`: the sharded run against the monolithic."""
    from scpn_fusion_tpu_torch.parallel.gk_shard import per_device_state_bytes
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    spec, (fin_1, tr_1), (fin_s, tr_s) = runs["spec"], runs["mono"], runs["sharded"]
    gk_steps = spec["n_steps"]
    f_1, f_s = fin_1.f.cpu(), fin_s.f.cpu()
    scale = float(f_1.abs().max())
    dev_gk = float((f_s - f_1).abs().max()) / scale
    mem = per_device_state_bytes(fin_s)
    trace_dev = max(float((a.cpu() - b.cpu()).abs().max()) / max(float(a.abs().max()), 1e-300)
                    for a, b in zip(tr_1[1:], tr_s[1:]))
    ok7 = dev_gk < 1e-12 and trace_dev < 1e-9 and mem["reduction_factor"] == 8.0
    shape = (f"S2 x {spec['n_kx']}kx x {spec['n_ky']}ky x {spec['n_theta']}th x "
             f"{spec['n_vpar']}vpar x {spec['n_mu']}mu, {gk_steps} steps")
    return LaneResult(
        name="gk_shard_memory",
        status="pass" if ok7 else "fail",
        metrics={"shape": shape, "mesh": "(sx, sy, v) = (2, 2, 2)",
                 "state_rel_dev_tile_vs_monolithic": dev_gk,
                 "trace_rel_dev_max": trace_dev,
                 "monolithic_state_bytes": mem["monolithic_bytes"],
                 "bytes_per_device": mem["bytes_per_device"],
                 "memory_reduction_factor": mem["reduction_factor"]},
        thresholds={"state_rel_dev_tile_vs_monolithic": 1e-12,
                    "memory_reduction_factor": 8.0},
        notes="production-shape 5D GK evolution on the full (kx, ky, mu) "
              "mesh: tile == monolithic at 1e-12 (f64, the reference's "
              "own invariant scale) over 50 nonlinear collisional steps; "
              "per-device bytes measured from addressable shards — the "
              "multi-chip-mandatory claim as numbers, not assertion")


def write_lanes(device, runs: dict, *, out_dir: str | Path = REPORTS_DIR, n: int = 513,
                n_fb: int = 129) -> int:
    """Lanes 1-6 at ``n`` and ``n_fb`` on ``device`` and lane 7 from ``runs``
    (:func:`gk_runs`), written as the report; the script's exit code."""
    from scpn_fusion_tpu_torch.utils.evidence import write_report
    dev = torch.device(device)
    h = headline(dev, n)
    lanes = [lane_headline(h), lane_linear(dev, n), lane_scaling(h), lane_fmg(dev, h),
             lane_tile2d(dev, h), lane_free_boundary(dev, h, n_fb), lane_gk(runs)]
    path = write_report("sharded_convergence", lanes, out_dir=out_dir)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes) else 1


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR,
         n: int = 513, n_fb: int = 129, gk_spec: dict | None = None) -> int:
    """The campaign at the script's sizes (``n``, ``n_fb``, ``gk_spec``; the
    CPU tests pass smaller ones)."""
    return write_lanes(device, gk_runs(torch.device(device), gk_spec), out_dir=out_dir, n=n,
                       n_fb=n_fb)
