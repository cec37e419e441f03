#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path -- the converged 129^2 -> 257^2 -> 513^2 FMG
Anderson-multigrid Picard solve of the fixed-boundary Grad-Shafranov
equilibrium for the 6-coil ITER-like bench configuration -- through the
hand-written CUDA kernels, and checks it:

1. preflight: a CUDA device, torch/CUDA versions, the card's name and power
   limit (``nvidia-smi``);
2. builds the kernels from ``scpn_fusion_tpu_torch/csrc`` with ``nvcc``;
3. holds every kernel against its plain PyTorch version on the card, in
   float32 on numpy-seeded inputs at the slice's shapes;
4. runs the FMG cascade with the kernels (counters reset just before and
   read just after: every wrapper must have launched, each as often as the
   cascade's Picard iterations say), against the same cascade with plain
   ops in float32 and float64, and the direct 513^2 solve;
5. times each kernel beside its plain version and the FMG solve with kernels
   and with plain ops (CUDA events, one warm-up, median of 5), and counts
   the launches of one 513^2 V-cycle, which must take the fine route.

Run from the repository root: ``python3 chip_smoke.py``.  Any failure raises
and exits non-zero.  The last line is the JSON result; the line before it is
the card's name and power limit; the one before that lists the kernels.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016
SPAN_TOL = 1e-5      # kernel vs plain version, span-relative, float32
SLICE_TOL = 1e-3     # kernel cascade vs plain f32 / f64 cascades, span-relative


def span_rel(a, b) -> float:
    span = float(b.max() - b.min()) or 1.0
    return float((a - b).abs().max()) / span


def ring_equal(a, b) -> bool:
    import torch
    return all(torch.equal(a[s], b[s]) for s in
               (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "scpn_fusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from scpn_fusion_tpu_torch.bench_config import bench_config
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
        solve_equilibrium, solve_equilibrium_fmg,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_source, cuda_stencil
    from scpn_fusion_tpu_torch.ops.cuda_mg import level_plan
    from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl

    # ── 1. preflight ──
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"card: {card}")
    dev = torch.device("cuda")

    # ── 2. build ──
    t0 = time.perf_counter()
    cb.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(cb.NVCC_FLAGS)})")

    # ── 3. kernels against their plain versions, float32, slice shapes ──
    rng = np.random.default_rng(SEED)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def level(n):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        return g, g.R, g.dR, g.dZ

    results = {}

    def record(name, err, tol, note):
        if not err <= tol:
            raise AssertionError(f"{name}: {note} span-rel {err:.3e} > {tol:.0e}")
        results.setdefault(name, {"max_abs_err": 0.0})
        print(f"check {name} {note}: span-rel {err:.3e} (limit {tol:.0e})")

    def abs_err(name, a, b):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           float((a - b).abs().max()))

    g513, r513, dr513, dz513 = level(513)
    psi = rand(513, 513)
    src = rand(513, 513)
    timing = {}

    # sor_sweeps, 513^2, n = 3
    args = (psi, src, r513, dr513, dz513, 1.0, 3)
    out_k = cuda_stencil.sor_sweeps(*args)
    out_p = cuda_stencil.sor_sweeps_plain(*args)
    torch.cuda.synchronize()
    record("sor_sweeps", span_rel(out_k, out_p), SPAN_TOL, "513^2 n=3")
    abs_err("sor_sweeps", out_k, out_p)
    require(ring_equal(out_k, psi), "sor_sweeps changed the Dirichlet ring")
    timing["sor_sweeps"] = (lambda: cuda_stencil.sor_sweeps(*args),
                            lambda: cuda_stencil.sor_sweeps_plain(*args))

    # fused topology + source, 513^2, L and H mode
    zz = g513.ZZ
    rr = g513.RR
    blob = torch.exp(-(((rr - 6.0) / 2.0) ** 2 + (zz / 2.0) ** 2))
    psi_src = 3.0 * blob + 0.01 * rand(513, 513)
    mask = (zz < g513.Z_min * 0.5).to(torch.float32).contiguous()
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=torch.float32, device=dev).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=torch.float32, device=dev).unbind())
    i_t = torch.full((), 15.0, dtype=torch.float32, device=dev)
    for h_mode in (False, True):
        kw = dict(d_r=dr513, d_z=dz513, mu0=1.0, h_mode=h_mode, with_scalars=True)
        s_k, sc_k = cuda_source.fused_topology_source(psi_src, r513, mask, p_c, ff_c, i_t, **kw)
        s_p, sc_p = cuda_source.fused_topology_source_plain(psi_src, r513, mask, p_c, ff_c,
                                                            i_t, **kw)
        torch.cuda.synchronize()
        mode = "H" if h_mode else "L"
        record("fused_topology_source", span_rel(s_k, s_p), SPAN_TOL, f"513^2 {mode}-mode")
        abs_err("fused_topology_source", s_k, s_p)
        if int(sc_k.x_index) != int(sc_p.x_index):
            raise AssertionError(f"X-point index {int(sc_k.x_index)} != {int(sc_p.x_index)}")
        if not torch.equal(sc_k.psi_axis, sc_p.psi_axis):
            raise AssertionError("psi_axis differs between kernel and plain version")
        print(f"  {mode}-mode X-point index {int(sc_k.x_index)} (same), psi_axis "
              f"{float(sc_k.psi_axis)!r} (same), psi_b {float(sc_k.psi_boundary)!r} vs "
              f"{float(sc_p.psi_boundary)!r}, I_current {float(sc_k.i_current)!r} vs "
              f"{float(sc_p.i_current)!r}")
    src_kw = dict(d_r=dr513, d_z=dz513, mu0=1.0, h_mode=False)
    timing["fused_topology_source"] = (
        lambda: cuda_source.fused_topology_source(psi_src, r513, mask, p_c, ff_c, i_t, **src_kw),
        lambda: cuda_source.fused_topology_source_plain(psi_src, r513, mask, p_c, ff_c, i_t,
                                                        **src_kw))

    # fine_presmooth_restrict (pre = 1), 513^2
    pre_args = (psi, src, r513, dr513, dz513, 1.0)
    ps_k, dc_k = cuda_mg.fine_presmooth_restrict(*pre_args, pre_smooth=1)
    ps_p, dc_p = cuda_mg.fine_presmooth_restrict_plain(*pre_args, pre_smooth=1)
    torch.cuda.synchronize()
    record("fine_presmooth_restrict", span_rel(ps_k, ps_p), SPAN_TOL, "513^2 psi_s")
    record("fine_presmooth_restrict", span_rel(dc_k, dc_p), SPAN_TOL, "513^2 d_c")
    abs_err("fine_presmooth_restrict", ps_k, ps_p)
    abs_err("fine_presmooth_restrict", dc_k, dc_p)
    require(ring_equal(ps_k, psi), "fine_presmooth_restrict changed the Dirichlet ring")
    require(ring_equal(dc_k, torch.zeros_like(dc_k)), "coarse defect ring is not zero")
    timing["fine_presmooth_restrict"] = (
        lambda: cuda_mg.fine_presmooth_restrict(*pre_args, pre_smooth=1),
        lambda: cuda_mg.fine_presmooth_restrict_plain(*pre_args, pre_smooth=1))

    # fine_prolong_smooth (post = 2), 513^2
    e_c = rand(257, 257)
    e_c[0, :] = 0.0
    e_c[-1, :] = 0.0
    e_c[:, 0] = 0.0
    e_c[:, -1] = 0.0
    post_args = (psi, src, e_c, r513, dr513, dz513, 1.0)
    # post = 0 checks the prolongation alone (omega = 1 sweeps overwrite the
    # red phases of the correction); post = 2 is the slice's setting.
    for post in (0, 2):
        po_k = cuda_mg.fine_prolong_smooth(*post_args, post_smooth=post)
        po_p = cuda_mg.fine_prolong_smooth_plain(*post_args, post_smooth=post)
        torch.cuda.synchronize()
        record("fine_prolong_smooth", span_rel(po_k, po_p), SPAN_TOL, f"513^2 post={post}")
        abs_err("fine_prolong_smooth", po_k, po_p)
        require(ring_equal(po_k, psi), "fine_prolong_smooth changed the Dirichlet ring")
    timing["fine_prolong_smooth"] = (
        lambda: cuda_mg.fine_prolong_smooth(*post_args, post_smooth=2),
        lambda: cuda_mg.fine_prolong_smooth_plain(*post_args, post_smooth=2))

    # fused_coarse_vcycle (1, 2), 257^2 and 129^2
    for n in (257, 129):
        _, r_n, dr_n, dz_n = level(n)
        psi_n, src_n = rand(n, n), rand(n, n)
        vc_args = (psi_n, src_n, r_n, dr_n, dz_n, 1.0)
        vc_kw = dict(pre_smooth=1, post_smooth=2, min_grid=5, coarse_sweeps=50)
        v_k = cuda_mg.fused_coarse_vcycle(*vc_args, **vc_kw)
        v_p = cuda_mg.fused_coarse_vcycle_plain(*vc_args, **vc_kw)
        torch.cuda.synchronize()
        record("fused_coarse_vcycle", span_rel(v_k, v_p), SPAN_TOL, f"{n}^2 (1,2)")
        abs_err("fused_coarse_vcycle", v_k, v_p)
        require(ring_equal(v_k, psi_n), "fused_coarse_vcycle changed the Dirichlet ring")
        if n == 257:
            timing["fused_coarse_vcycle"] = (
                lambda a=vc_args: cuda_mg.fused_coarse_vcycle(*a, **vc_kw),
                lambda a=vc_args: cuda_mg.fused_coarse_vcycle_plain(*a, **vc_kw))

    # ── 4. the slice: FMG 129 -> 257 -> 513 on the card ──
    cfg_k = bench_config(513, use_pallas=True)
    cfg_p = bench_config(513, use_pallas=False)
    fmg = dict(min_coarse=129, device=dev)

    cb.reset_launch_counts()
    res_k, info_k = solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)
    torch.cuda.synchronize()
    launches = {name: cb.CALLS[name] for name in timing}
    print(f"FMG with kernels: levels {info_k}")
    print(f"wrapper calls in the FMG run: {launches}; __global__ launches "
          f"{cb.kernel_launches()} ({dict(cb.LAUNCHES)})")
    if [d["n"] for d in info_k] != [129, 257, 513]:
        raise AssertionError(f"unexpected cascade {info_k}")
    if not all(d["converged"] for d in info_k):
        raise AssertionError("the kernel cascade did not converge at every level")
    missing = [name for name in timing if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    # One source and one V-cycle per Picard iteration; every V-cycle ends in
    # one fused coarse V-cycle (257^2 and below) whose coarsest solve is one
    # sor_sweeps call; only the 513^2 iterations take the fine legs.
    picard = sum(d["iterations"] for d in info_k)
    fine = info_k[-1]["iterations"]
    expected = {"sor_sweeps": picard, "fused_topology_source": picard,
                "fused_coarse_vcycle": picard, "fine_presmooth_restrict": fine,
                "fine_prolong_smooth": fine}
    if launches != expected:
        raise AssertionError(f"wrapper calls {launches} != expected {expected}")
    psi_k = res_k.psi
    if tuple(psi_k.shape) != (513, 513) or not bool(torch.isfinite(psi_k).all()):
        raise AssertionError("kernel cascade psi is not a finite 513x513 field")

    res_p, info_p = solve_equilibrium_fmg(cfg_p, dtype=torch.float32, **fmg)
    res_64, info_64 = solve_equilibrium_fmg(cfg_p, dtype=torch.float64, **fmg)
    torch.cuda.synchronize()
    dev_p = span_rel(psi_k, res_p.psi)
    dev_64 = span_rel(psi_k.double(), res_64.psi)
    print(f"FMG plain f32: levels {info_p}")
    print(f"FMG plain f64: levels {info_64}")
    print(f"per-level iterations: kernels {[d['iterations'] for d in info_k]}, "
          f"plain f32 {[d['iterations'] for d in info_p]}, "
          f"plain f64 {[d['iterations'] for d in info_64]}")
    print(f"psi span-rel: kernels vs plain f32 {dev_p:.3e}, kernels vs plain f64 {dev_64:.3e} "
          f"(limit {SLICE_TOL:.0e})")
    if not (res_p.converged and res_64.converged):
        raise AssertionError("a plain cascade did not converge")
    if abs(info_k[-1]["iterations"] - info_p[-1]["iterations"]) > 1:
        raise AssertionError("fine-level iteration counts differ by more than 1")
    if not (dev_p <= SLICE_TOL and dev_64 <= SLICE_TOL):
        raise AssertionError("kernel cascade deviates from the plain cascades")

    res_d = solve_equilibrium(cfg_k, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"direct 513^2 solve with kernels: converged {res_d.converged}, "
          f"iterations {res_d.iterations}, span-rel vs FMG {span_rel(res_d.psi, psi_k):.3e}")
    if not res_d.converged or not bool(torch.isfinite(res_d.psi).all()):
        raise AssertionError("the direct 513^2 solve did not converge")

    # ── 5. times (CUDA events, one warm-up, median of 5) ──
    kernels = []
    sources = {"sor_sweeps": ("csrc/rb_sweep.cu", "scpn_fusion_tpu/ops/pallas_stencil.py:67"),
               "fused_topology_source": ("csrc/source.cu",
                                         "scpn_fusion_tpu/ops/pallas_source.py:59"),
               "fine_presmooth_restrict": ("csrc/transfer.cu",
                                           "scpn_fusion_tpu/ops/pallas_mg.py:272"),
               "fine_prolong_smooth": ("csrc/transfer.cu",
                                       "scpn_fusion_tpu/ops/pallas_mg.py:299"),
               "fused_coarse_vcycle": ("csrc/transfer.cu",
                                       "scpn_fusion_tpu/ops/pallas_mg.py:52")}
    shapes = {"sor_sweeps": "513^2 n=3", "fused_topology_source": "513^2 L-mode",
              "fine_presmooth_restrict": "513^2 pre=1", "fine_prolong_smooth": "513^2 post=2",
              "fused_coarse_vcycle": "257^2 (1,2)"}
    for name, (fk, fp) in timing.items():
        ms_k, ms_p = cuda_ms(fk), cuda_ms(fp)
        print(f"time {name} {shapes[name]}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms [{card}]")
        src_path, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"scpn_fusion_tpu_torch/{src_path}", "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": results[name]["max_abs_err"],
                        "ms": ms_k, "plain_ms": ms_p})

    fmg_k = cuda_ms(lambda: solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg))
    fmg_p = cuda_ms(lambda: solve_equilibrium_fmg(cfg_p, dtype=torch.float32, **fmg))
    print(f"time FMG 129->257->513 f32: kernels {fmg_k:.3f} ms, plain {fmg_p:.3f} ms [{card}]")

    src_v = torch.zeros_like(psi)
    src_v.copy_(src)
    cb.reset_launch_counts()
    _vcycle_impl(psi, src_v, r513, dr513, dz513, 1.0, 1, 2, 5, 50, True)
    torch.cuda.synchronize()
    print(f"one 513^2 V-cycle (1,2) with kernels: {cb.kernel_launches()} __global__ launches "
          f"({dict(cb.LAUNCHES)}), wrapper calls {dict(cb.CALLS)}")
    transfers = len(level_plan(513, 5)) - 1
    if not (cb.LAUNCHES["scpn_defect_restrict"] == cb.LAUNCHES["scpn_prolong_correct"]
            == transfers):
        raise AssertionError(f"513^2 V-cycle made {dict(cb.LAUNCHES)}, not {transfers} "
                             "restrictions and prolongations")
    if dict(cb.CALLS) != {"fine_presmooth_restrict": 1, "fine_prolong_smooth": 1,
                          "fused_coarse_vcycle": 1, "sor_sweeps": 1}:
        raise AssertionError(f"513^2 V-cycle did not take the fine route: {dict(cb.CALLS)}")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
