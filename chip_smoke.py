#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's three paths through the hand-written CUDA kernels and
checks them:

* the converged 129^2 -> 257^2 -> 513^2 FMG Anderson-multigrid Picard solve
  of the fixed-boundary Grad-Shafranov equilibrium for the 6-coil ITER-like
  bench configuration (kernels 2-5);
* the resolution scale-out: the FMG cascade 129^2 -> ... -> 1025^2 in f32
  ending in the mixed-precision, GS-residual-gated 2049^2 solve (f64 master
  iterate, f32 V-cycle defect correction), which runs kernels 2-7, the tiled
  1025^2+ legs (kernels 6 and 7) included;
* the ``anderson`` solver method (inner SOR sweeps, no multigrid) on the same
  machine at 129^2: the path that launches kernel 1, ``sor_sweeps``, now that
  the coarsest solve of every V-cycle runs inside the one-launch V-cycle.

Phases:

1. preflight: a CUDA device, torch/CUDA versions, the card's name and power
   limit (``nvidia-smi``);
2. builds the kernels from ``scpn_fusion_tpu_torch/csrc`` with ``nvcc``;
3. holds every kernel against its plain PyTorch version on the card, in
   float32 on numpy-seeded inputs at the paths' shapes (``sor_sweeps`` at the
   ``anderson`` path's 129^2, at a 5^2 coarsest solve and at 513^2; the tiled
   legs at 1025^2, 2049^2, 4097^2 and a ragged 129^2 tiling, and against the
   fine legs at 513^2 and 1025^2).  The one-launch V-cycle and the
   one-launch source must also equal their staged predecessors (one launch
   per dependent stage; three launches) bit for bit, and make one
   ``__global__`` launch a call;
4. runs the 513^2 FMG cascade with the kernels (counters reset just before
   and read just after: every wrapper must have been called as often as the
   cascade's Picard iterations say), against the same cascade with the
   staged kernels (bit-identical), with plain ops in float32 and float64,
   and the direct 513^2 solve;
5. runs the 2049^2 mixed cascade with the kernels (counters likewise), against
   the same cascade with the staged kernels (bit-identical) and with plain
   ops, and counts one 2049^2 V-cycle;
6. runs the ``anderson`` 129^2 solve with the kernels (counters likewise)
   against the same solve with plain ops;
7. times each kernel beside its plain version at a shape its path gives it
   (the tiled legs also beside the fine legs at 513^2 and 2049^2; the two
   one-launch kernels alternately with their staged predecessors, and as 50
   calls back to back), the cascades with kernels and with plain ops (CUDA
   events, one warm-up, median of 5; 2 for the plain 2049^2 cascade), and
   computes each kernel's bound (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s, whichever is larger, at the timed shape).

Run from the repository root: ``python3 chip_smoke.py``.  Any failure raises
and exits non-zero.  The last line is the JSON result; the line before it is
the card's name and power limit; the one before that lists the kernels, with
``launches`` counted over the 2049^2 mixed cascade (the path that runs six
of the seven; ``sor_sweeps`` over the ``anderson`` solve).
"""

from __future__ import annotations

import contextlib
import ctypes
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
SLICE_TOL = 1e-3     # kernel cascade vs plain cascades, span-relative
GS_TOL = 3e-5        # f64 GS-residual gate of the 2049^2 mixed solve
SOR_SWEEPS, SOR_OMEGA = 50, 1.9   # the ``anderson`` path's inner SOR sweeps
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNELS = ("sor_sweeps", "fused_topology_source", "fine_presmooth_restrict",
           "fine_prolong_smooth", "fused_coarse_vcycle", "tiled_presmooth_restrict",
           "tiled_prolong_smooth")
SOURCES = {
    "sor_sweeps": ("csrc/rb_sweep.cu", "scpn_fusion_tpu/ops/pallas_stencil.py:67"),
    "fused_topology_source": ("csrc/source.cu", "scpn_fusion_tpu/ops/pallas_source.py:59"),
    "fine_presmooth_restrict": ("csrc/transfer.cu", "scpn_fusion_tpu/ops/pallas_mg.py:272"),
    "fine_prolong_smooth": ("csrc/transfer.cu", "scpn_fusion_tpu/ops/pallas_mg.py:299"),
    "fused_coarse_vcycle": ("csrc/vcycle_fused.cu", "scpn_fusion_tpu/ops/pallas_mg.py:52"),
    "tiled_presmooth_restrict": ("csrc/tiled_legs.cu",
                                 "scpn_fusion_tpu/ops/pallas_mg_tiled.py:97"),
    "tiled_prolong_smooth": ("csrc/tiled_legs.cu", "scpn_fusion_tpu/ops/pallas_mg_tiled.py:123"),
}


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


def cuda_ms_pair(fn_a, fn_b, reps: int = 5) -> tuple[float, float]:
    """Median device times of two functions timed in turns (a, b, a, b, ...)
    after one warm-up each, so that both see the same state of the host."""
    import torch
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    times: tuple[list[float], list[float]] = ([], [])
    for _ in range(reps):
        for fn, out in ((fn_a, times[0]), (fn_b, times[1])):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def back_to_back_ms(fn, calls: int = 50) -> float:
    """Device time a call of ``calls`` calls between one pair of events: what
    a call costs when the host runs ahead of the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


# ── work of each kernel at its timed shape, for the bound ──
#
# Bytes: every input read once and every output written once (float32).
# Operations: float32 flops of the arithmetic, per interior point: 11 a
# red-black update, 9 a defect, 11 a full weighting (per coarse point), 2 a
# prolongation, 28 the source (|grad psi|, profiles, Ip sum and scale).

def leg_work(n: int, sweeps: int, leg: str) -> tuple[float, float]:
    nc = (n + 1) // 2
    inner, inner_c = (n - 2) ** 2, (nc - 2) ** 2
    if leg == "sweeps":       # psi, src, R in; psi out
        return 4.0 * (3 * n * n + n), 11.0 * inner * sweeps
    if leg == "down":         # psi, src, R in; psi_s, d_c out
        return (4.0 * (3 * n * n + n + nc * nc),
                11.0 * inner * sweeps + 9.0 * inner + 11.0 * inner_c)
    if leg == "up":           # psi_s, src, e_c, R in; psi out
        return 4.0 * (3 * n * n + n + nc * nc), 2.0 * inner + 11.0 * inner * sweeps
    raise ValueError(leg)


def vcycle_work(n: int, pre: int, post: int, min_grid: int, coarse_sweeps: int):
    """Bytes of the entry level's in/out fields; flops of the whole V-cycle."""
    from scpn_fusion_tpu_torch.ops.cuda_mg import level_plan
    levels = level_plan(n, min_grid)
    flops = 11.0 * (levels[-1] - 2) ** 2 * coarse_sweeps
    for m in levels[:-1]:
        flops += leg_work(m, pre, "down")[1] + leg_work(m, post, "up")[1]
    return 4.0 * (3 * n * n + n), flops


def vcycle_stages(n: int, pre: int, post: int, min_grid: int, coarse_sweeps: int) -> int:
    """Dependent stages of one V-cycle: per upper level the half-sweeps, one
    restriction and one prolongation; the coarsest level's half-sweeps."""
    from scpn_fusion_tpu_torch.ops.cuda_mg import level_plan
    upper = len(level_plan(n, min_grid)) - 1
    return upper * (2 * pre + 2 * post + 2) + 2 * coarse_sweeps


def bound(work: tuple[float, float]) -> tuple[float, str]:
    nbytes, flops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "scpn_fusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from scpn_fusion_tpu_torch.bench_config import BENCH_SOLVER, bench_config, config_dict
    from scpn_fusion_tpu_torch.core.config import config_from_dict
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
        solve_equilibrium, solve_equilibrium_fmg,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.mixed_precision import (
        solve_equilibrium_mixed_fmg,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_mg_tiled, cuda_source, cuda_stencil
    from scpn_fusion_tpu_torch.ops.cuda_mg import level_plan
    from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl

    phases: dict[str, float] = {}
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = now - t_phase
        t_phase = now

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
    phase_done("preflight")

    # ── 2. build ──
    cb.library()
    print(f"build: {time.perf_counter() - t_phase:.2f} s (one nvcc per source, "
          f"{' '.join(cb.NVCC_FLAGS)})")
    for source in ("tiled_legs.cu", "vcycle_fused.cu", "source.cu"):
        for line in cb.BUILD_LOG.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {source}: {line.strip()}")
    # A refused launch raises below; these two lines say how much room there is.
    plan_257 = cuda_mg.vcycle_launch_plan(257, 5)
    clusters = cb.library().scpn_fused_vcycle_clusters(
        ctypes.addressof(cuda_mg.vcycle_plan_struct(257, 5, 1.0, 1.0, 1.0, 1, 2, 50)))
    print(f"fused V-cycle from 257^2: one cluster of {plan_257.n_cta} CTAs x "
          f"{plan_257.smem_bytes} bytes of shared memory; the device holds {clusters} such "
          f"clusters at once")
    resident = cb.library().scpn_source_resident_blocks()
    print(f"fused source: up to {cb.source_blocks(1 << 30)} blocks in a cooperative launch; "
          f"the device holds {resident} at once")
    require(clusters >= 1, f"no cluster of the fused V-cycle fits the device ({clusters})")
    require(resident >= cb.source_blocks(1 << 30),
            f"the fused source's blocks are not all resident ({resident})")
    phase_done("build")

    # ── 3. kernels against their plain versions, float32, the paths' shapes ──
    rng = np.random.default_rng(SEED)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def rand_coarse(n):
        """A compact coarse error for an n x n level, zero on its ring."""
        e = rand((n + 1) // 2, (n + 1) // 2)
        e[0, :] = 0.0
        e[-1, :] = 0.0
        e[:, 0] = 0.0
        e[:, -1] = 0.0
        return e

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
    timing = {}     # name -> (kernel call, plain call, shape, work) at the path's shape
    extra_times = []    # (label, (name, call), (name, call), work or None): printed only
    staged = {}     # name -> the staged predecessor's call at the timed shape

    # sor_sweeps at the shape its path gives it: the ``anderson`` solve's
    # inner sweeps at 129^2 (50 sweeps, omega 1.9, the half-sweep kernel); at
    # a 5^2 level with 50 sweeps (the single-block shared-memory kernel); and
    # at 513^2, n = 3 (the half-sweep kernel that the fine legs share).
    _, r257, dr257, dz257 = level(257)
    _, r129, dr129, dz129 = level(129)
    n_c = level_plan(257, 5)[-1]
    step = (257 - 1) // (n_c - 1)
    r_c, dr_c, dz_c = r257[::step], dr257 * step, dz257 * step
    for what, args in (
            (f"129^2 n={SOR_SWEEPS} omega={SOR_OMEGA}",
             (rand(129, 129), rand(129, 129), r129, dr129, dz129, SOR_OMEGA, SOR_SWEEPS)),
            (f"{n_c}^2 n=50",
             (torch.zeros(n_c, n_c, device=dev), rand_coarse(2 * n_c - 1), r_c, dr_c, dz_c,
              1.0, 50)),
            ("513^2 n=3", (psi, src, r513, dr513, dz513, 1.0, 3))):
        out_k = cuda_stencil.sor_sweeps(*args)
        out_p = cuda_stencil.sor_sweeps_plain(*args)
        torch.cuda.synchronize()
        record("sor_sweeps", span_rel(out_k, out_p), SPAN_TOL, what)
        abs_err("sor_sweeps", out_k, out_p)
        require(ring_equal(out_k, args[0]), f"sor_sweeps changed the Dirichlet ring at {what}")
        kernel = lambda a=args: cuda_stencil.sor_sweeps(*a)   # noqa: E731
        plain = lambda a=args: cuda_stencil.sor_sweeps_plain(*a)   # noqa: E731
        work = leg_work(args[0].shape[0], args[-1], "sweeps")
        if args[0].shape[0] == 129:
            timing["sor_sweeps"] = (kernel, plain, what, work)
        else:
            extra_times.append((f"sor_sweeps {what}", ("kernel", kernel), ("plain", plain), work))

    # fused topology + source: 513^2 in L and H mode, 1025^2 (the cascade's
    # own 1025^2 level runs the kernel) in L mode; against the plain version
    # and, bit for bit, against the three-launch entry
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=torch.float32, device=dev).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=torch.float32, device=dev).unbind())
    i_t = torch.full((), 15.0, dtype=torch.float32, device=dev)
    packed = cuda_source.pack_source_params(p_c, ff_c, i_t)
    for n, modes in ((513, (False, True)), (1025, (False,))):
        g_n, r_n, dr_n, dz_n = level(n)
        rr, zz = g_n.RR, g_n.ZZ
        blob = torch.exp(-(((rr - 6.0) / 2.0) ** 2 + (zz / 2.0) ** 2))
        psi_src = 3.0 * blob + 0.01 * rand(n, n)
        psi_other = 2.0 * torch.exp(-(((rr - 5.0) / 1.5) ** 2 + ((zz - 0.5) / 2.5) ** 2)) \
            + 0.01 * rand(n, n)
        mask = (zz < g_n.Z_min * 0.5).to(torch.float32).contiguous()
        for h_mode in modes:
            kw = dict(d_r=dr_n, d_z=dz_n, mu0=1.0, h_mode=h_mode, with_scalars=True)
            mode = "H" if h_mode else "L"
            cb.reset_launch_counts()
            s_k, sc_k = cuda_source.fused_topology_source(psi_src, r_n, mask, packed, **kw)
            require(dict(cb.LAUNCHES) == {"scpn_fused_source": 1},
                    f"fused_topology_source made {dict(cb.LAUNCHES)}, not one launch")
            s_p, sc_p = cuda_source.fused_topology_source_plain(psi_src, r_n, mask, p_c, ff_c,
                                                                i_t, **kw)
            s_s, sc_s = cuda_source._fused_topology_source_staged(psi_src, r_n, mask, p_c, ff_c,
                                                                  i_t, **kw)
            torch.cuda.synchronize()
            record("fused_topology_source", span_rel(s_k, s_p), SPAN_TOL,
                   f"{n}^2 {mode}-mode")
            abs_err("fused_topology_source", s_k, s_p)
            if int(sc_k.x_index) != int(sc_p.x_index):
                raise AssertionError(f"X-point index {int(sc_k.x_index)} != {int(sc_p.x_index)}")
            if not torch.equal(sc_k.psi_axis, sc_p.psi_axis):
                raise AssertionError("psi_axis differs between kernel and plain version")
            require(torch.equal(s_k, s_s) and all(torch.equal(a, b) for a, b in zip(sc_k, sc_s)),
                    f"one-launch source differs from the three-launch entry at {n}^2 {mode}-mode")
            # another psi through the same cached workspace, then the first
            # again (given as the three arguments, packed on the fly): the
            # workspace carries nothing from call to call
            o_k, oc_k = cuda_source.fused_topology_source(psi_other, r_n, mask, packed, **kw)
            o_p, oc_p = cuda_source.fused_topology_source_plain(psi_other, r_n, mask, p_c, ff_c,
                                                                i_t, **kw)
            a_k, ac_k = cuda_source.fused_topology_source(psi_src, r_n, mask, p_c, ff_c, i_t,
                                                          **kw)
            torch.cuda.synchronize()
            record("fused_topology_source", span_rel(o_k, o_p), SPAN_TOL,
                   f"{n}^2 {mode}-mode, second psi on the same workspace")
            require(int(oc_k.x_index) == int(oc_p.x_index)
                    and torch.equal(oc_k.psi_axis, oc_p.psi_axis),
                    "second call on the same workspace: X-point or psi_axis differ from plain")
            require(torch.equal(a_k, s_k) and all(torch.equal(a, b) for a, b in zip(ac_k, sc_k)),
                    "the source kernel's result depends on the call before it")
            print(f"  {mode}-mode X-point index {int(sc_k.x_index)} (same), psi_axis "
                  f"{float(sc_k.psi_axis)!r} (same), psi_b {float(sc_k.psi_boundary)!r} vs "
                  f"{float(sc_p.psi_boundary)!r}, I_current {float(sc_k.i_current)!r} vs "
                  f"{float(sc_p.i_current)!r}; equal to the three-launch entry; one launch")
        if n == 513:
            src_args = (psi_src, r_n, mask)
            src_kw = dict(d_r=dr_n, d_z=dz_n, mu0=1.0, h_mode=False)
            timing["fused_topology_source"] = (
                lambda: cuda_source.fused_topology_source(*src_args, packed, **src_kw),
                lambda: cuda_source.fused_topology_source_plain(*src_args, p_c, ff_c, i_t,
                                                                **src_kw),
                "513^2 L-mode", (4.0 * (3 * n * n + n), 28.0 * n * n))
            # as the Picard loop called it before: parameters packed in every call
            staged["fused_topology_source"] = (
                lambda: cuda_source._fused_topology_source_staged(*src_args, p_c, ff_c, i_t,
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
        lambda: cuda_mg.fine_presmooth_restrict_plain(*pre_args, pre_smooth=1),
        "513^2 pre=1", leg_work(513, 1, "down"))

    # fine_prolong_smooth (post = 2), 513^2
    e_c = rand_coarse(513)
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
        lambda: cuda_mg.fine_prolong_smooth_plain(*post_args, post_smooth=2),
        "513^2 post=2", leg_work(513, 2, "up"))

    # fused_coarse_vcycle: the cascades' (1, 2) and the mixed path's (3, 3) at
    # 257^2 and 129^2, and a small entry; against the plain version and, bit
    # for bit, against the staged route (one launch per dependent stage)
    for n, pre, post in ((257, 1, 2), (257, 3, 3), (129, 1, 2), (129, 3, 3), (17, 1, 2)):
        _, r_n, dr_n, dz_n = level(n)
        psi_n, src_n = rand(n, n), rand(n, n)
        vc_args = (psi_n, src_n, r_n, dr_n, dz_n, 1.0)
        vc_kw = dict(pre_smooth=pre, post_smooth=post, min_grid=5, coarse_sweeps=50)
        cb.reset_launch_counts()
        v_k = cuda_mg.fused_coarse_vcycle(*vc_args, **vc_kw)
        require(dict(cb.LAUNCHES) == {"scpn_fused_vcycle": 1},
                f"fused_coarse_vcycle made {dict(cb.LAUNCHES)}, not one launch")
        v_s = cuda_mg._fused_coarse_vcycle_staged(*vc_args, **vc_kw)
        staged_launches = cb.kernel_launches() - 1
        v_p = cuda_mg.fused_coarse_vcycle_plain(*vc_args, **vc_kw)
        torch.cuda.synchronize()
        tag = f"{n}^2 ({pre},{post})"
        record("fused_coarse_vcycle", span_rel(v_k, v_p), SPAN_TOL, tag)
        abs_err("fused_coarse_vcycle", v_k, v_p)
        require(ring_equal(v_k, psi_n), f"fused_coarse_vcycle changed the Dirichlet ring at {tag}")
        require(torch.equal(v_k, v_s), f"one-launch V-cycle differs from the staged route at {tag}")
        print(f"  {tag}: equal to the staged route ({staged_launches} launches); one launch, "
              f"{vcycle_stages(n, pre, post, 5, 50)} dependent stages")
        if (n, pre) == (257, 1):
            timing["fused_coarse_vcycle"] = (
                lambda a=vc_args, kw=vc_kw: cuda_mg.fused_coarse_vcycle(*a, **kw),
                lambda a=vc_args, kw=vc_kw: cuda_mg.fused_coarse_vcycle_plain(*a, **kw),
                "257^2 (1,2)", vcycle_work(257, 1, 2, 5, 50))
            staged["fused_coarse_vcycle"] = (
                lambda a=vc_args, kw=vc_kw: cuda_mg._fused_coarse_vcycle_staged(*a, **kw))
    for bad_n, bad_min in ((513, 5), (257, 2)):
        _, r_n, dr_n, dz_n = level(bad_n)
        try:
            cuda_mg.fused_coarse_vcycle(rand(bad_n, bad_n), rand(bad_n, bad_n), r_n, dr_n, dz_n,
                                        1.0, min_grid=bad_min)
        except ValueError as exc:
            print(f"  fused_coarse_vcycle {bad_n}^2 min_grid={bad_min} raises: {exc}")
        else:
            raise AssertionError(f"fused_coarse_vcycle took {bad_n}^2 min_grid={bad_min}")

    # tiled legs (kernels 6 and 7): the cascade's 1025^2 level (1, 2), the
    # 2049^2 V-cycle's (3, 3) at 2049^2 and 4097^2, and a ragged 129^2 tiling
    versus_fine = {}
    for n, pre, posts, t_rows in ((1025, 1, (2,), None), (2049, 3, (0, 3), None),
                                  (4097, 3, (3,), None), (129, 3, (0, 3), 24)):
        _, r_n, dr_n, dz_n = level(n)
        psi_n, src_n, e_n = rand(n, n), rand(n, n), rand_coarse(n)
        a = (psi_n, src_n, r_n, dr_n, dz_n, 1.0)
        pa = (psi_n, src_n, e_n, r_n, dr_n, dz_n, 1.0)
        tag = f"{n}^2" + ("" if t_rows is None else f" t_rows={t_rows}")
        ps_k, dc_k = cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=pre, t_rows=t_rows)
        ps_p, dc_p = cuda_mg_tiled.tiled_presmooth_restrict_plain(*a, pre_smooth=pre)
        torch.cuda.synchronize()
        record("tiled_presmooth_restrict", span_rel(ps_k, ps_p), SPAN_TOL, f"{tag} pre={pre} psi_s")
        record("tiled_presmooth_restrict", span_rel(dc_k, dc_p), SPAN_TOL, f"{tag} pre={pre} d_c")
        abs_err("tiled_presmooth_restrict", ps_k, ps_p)
        abs_err("tiled_presmooth_restrict", dc_k, dc_p)
        require(ring_equal(ps_k, psi_n), f"tiled_presmooth_restrict changed the ring at {tag}")
        require(ring_equal(dc_k, torch.zeros_like(dc_k)), f"coarse defect ring not zero at {tag}")
        po_k = {}
        for post in posts:
            po_k[post] = cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=post, t_rows=t_rows)
            po_p = cuda_mg_tiled.tiled_prolong_smooth_plain(*pa, post_smooth=post)
            torch.cuda.synchronize()
            record("tiled_prolong_smooth", span_rel(po_k[post], po_p), SPAN_TOL,
                   f"{tag} post={post}")
            abs_err("tiled_prolong_smooth", po_k[post], po_p)
            require(ring_equal(po_k[post], psi_n),
                    f"tiled_prolong_smooth changed the ring at {tag}")
        if n == 1025:
            # against the fine legs, which take any size
            fs_k, fd_k = cuda_mg.fine_presmooth_restrict(*a, pre_smooth=pre)
            fo_k = cuda_mg.fine_prolong_smooth(*pa, post_smooth=2)
            torch.cuda.synchronize()
            record("tiled_presmooth_restrict", span_rel(ps_k, fs_k), SPAN_TOL,
                   "1025^2 pre=1 psi_s vs fine_presmooth_restrict")
            record("tiled_presmooth_restrict", span_rel(dc_k, fd_k), SPAN_TOL,
                   "1025^2 pre=1 d_c vs fine_presmooth_restrict")
            record("tiled_prolong_smooth", span_rel(po_k[2], fo_k), SPAN_TOL,
                   "1025^2 post=2 vs fine_prolong_smooth")
        if n == 2049:
            timing["tiled_presmooth_restrict"] = (
                lambda a=a: cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=3),
                lambda a=a: cuda_mg_tiled.tiled_presmooth_restrict_plain(*a, pre_smooth=3),
                "2049^2 pre=3", leg_work(2049, 3, "down"))
            timing["tiled_prolong_smooth"] = (
                lambda pa=pa: cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=3),
                lambda pa=pa: cuda_mg_tiled.tiled_prolong_smooth_plain(*pa, post_smooth=3),
                "2049^2 post=3", leg_work(2049, 3, "up"))
            versus_fine["tiled_presmooth_restrict"] = (
                lambda a=a: cuda_mg.fine_presmooth_restrict(*a, pre_smooth=3))
            versus_fine["tiled_prolong_smooth"] = (
                lambda pa=pa: cuda_mg.fine_prolong_smooth(*pa, post_smooth=3))

    # the tiled legs at 513^2 (1, 2), where the paths take the fine legs:
    # held against those and timed beside them (printed only)
    a = (psi, src, r513, dr513, dz513, 1.0)
    pa = (psi, src, e_c, r513, dr513, dz513, 1.0)
    ts_k, td_k = cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=1)
    fs_k, fd_k = cuda_mg.fine_presmooth_restrict(*a, pre_smooth=1)
    to_k = cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=2)
    fo_k = cuda_mg.fine_prolong_smooth(*pa, post_smooth=2)
    torch.cuda.synchronize()
    record("tiled_presmooth_restrict", span_rel(ts_k, fs_k), SPAN_TOL,
           "513^2 pre=1 psi_s vs fine_presmooth_restrict")
    record("tiled_presmooth_restrict", span_rel(td_k, fd_k), SPAN_TOL,
           "513^2 pre=1 d_c vs fine_presmooth_restrict")
    record("tiled_prolong_smooth", span_rel(to_k, fo_k), SPAN_TOL,
           "513^2 post=2 vs fine_prolong_smooth")
    extra_times.append((
        "down leg 513^2 pre=1",
        ("tiled", lambda a=a: cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=1)),
        ("fine leg", lambda a=a: cuda_mg.fine_presmooth_restrict(*a, pre_smooth=1)),
        leg_work(513, 1, "down")))
    extra_times.append((
        "up leg 513^2 post=2",
        ("tiled", lambda pa=pa: cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=2)),
        ("fine leg", lambda pa=pa: cuda_mg.fine_prolong_smooth(*pa, post_smooth=2)),
        leg_work(513, 2, "up")))
    phase_done("kernel checks")

    @contextlib.contextmanager
    def staged_kernels():
        """Run the solvers through the staged predecessors of the two
        one-launch kernels (the solvers look both up in their modules), the
        source's parameters packed anew in every call as they used to be."""
        def staged_source(psi_k, r_1d, mask, params, **kw):
            return cuda_source._fused_topology_source_staged(
                psi_k, r_1d, mask, params.p_coeffs, params.ff_coeffs, params.i_target, **kw)

        saved = cuda_mg.fused_coarse_vcycle, cuda_source.fused_topology_source
        cuda_mg.fused_coarse_vcycle = cuda_mg._fused_coarse_vcycle_staged
        cuda_source.fused_topology_source = staged_source
        try:
            yield
        finally:
            cuda_mg.fused_coarse_vcycle, cuda_source.fused_topology_source = saved

    # ── 4. the first slice: FMG 129 -> 257 -> 513 on the card ──
    cfg_k = bench_config(513, use_pallas=True)
    cfg_p = bench_config(513, use_pallas=False)
    fmg = dict(min_coarse=129, device=dev)

    cb.reset_launch_counts()
    res_k, info_k = solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)
    torch.cuda.synchronize()
    launches_513 = {name: cb.CALLS[name] for name in KERNELS}
    print(f"FMG with kernels: levels {info_k}")
    print(f"wrapper calls in the 513^2 FMG run: {launches_513}; __global__ launches "
          f"{cb.kernel_launches()} ({dict(cb.LAUNCHES)})")
    if [d["n"] for d in info_k] != [129, 257, 513]:
        raise AssertionError(f"unexpected cascade {info_k}")
    if not all(d["converged"] for d in info_k):
        raise AssertionError("the kernel cascade did not converge at every level")
    # One source and one V-cycle per Picard iteration; every V-cycle ends in
    # one fused coarse V-cycle (257^2 and below: one launch, its coarsest
    # solve inside it, so sor_sweeps is not called); only the 513^2
    # iterations take the fine legs.
    picard = sum(d["iterations"] for d in info_k)
    fine = info_k[-1]["iterations"]
    expected = {"sor_sweeps": 0, "fused_topology_source": picard,
                "fine_presmooth_restrict": fine, "fine_prolong_smooth": fine,
                "fused_coarse_vcycle": picard, "tiled_presmooth_restrict": 0,
                "tiled_prolong_smooth": 0}
    if launches_513 != expected:
        raise AssertionError(f"wrapper calls {launches_513} != expected {expected}")
    if not (cb.LAUNCHES["scpn_fused_vcycle"] == cb.LAUNCHES["scpn_fused_source"] == picard):
        raise AssertionError(f"the one-launch kernels made {dict(cb.LAUNCHES)}, not one launch "
                             f"a call over {picard} Picard iterations")
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

    with staged_kernels():
        res_s, info_s = solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)
    torch.cuda.synchronize()
    print(f"FMG with the staged kernels: levels {info_s}; psi equal to the one-launch "
          f"kernels' {torch.equal(res_s.psi, psi_k)}")
    if info_s != info_k or not torch.equal(res_s.psi, psi_k):
        raise AssertionError("the 513^2 cascade differs between one-launch and staged kernels")

    res_d = solve_equilibrium(cfg_k, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"direct 513^2 solve with kernels: converged {res_d.converged}, "
          f"iterations {res_d.iterations}, span-rel vs FMG {span_rel(res_d.psi, psi_k):.3e}")
    if not res_d.converged or not bool(torch.isfinite(res_d.psi).all()):
        raise AssertionError("the direct 513^2 solve did not converge")

    src_v = torch.zeros_like(psi)
    src_v.copy_(src)
    cb.reset_launch_counts()
    _vcycle_impl(psi, src_v, r513, dr513, dz513, 1.0, 1, 2, 5, 50, True)
    torch.cuda.synchronize()
    print(f"one 513^2 V-cycle (1,2) with kernels: {cb.kernel_launches()} __global__ launches "
          f"({dict(cb.LAUNCHES)}), wrapper calls {dict(cb.CALLS)}")
    if dict(cb.LAUNCHES) != {"scpn_rb_half_sweep": 6, "scpn_defect_restrict": 1,
                             "scpn_prolong_correct": 1, "scpn_fused_vcycle": 1}:
        raise AssertionError(f"513^2 V-cycle made {dict(cb.LAUNCHES)}, not the fine legs' 8 "
                             "launches and one fused V-cycle")
    if dict(cb.CALLS) != {"fine_presmooth_restrict": 1, "fine_prolong_smooth": 1,
                          "fused_coarse_vcycle": 1}:
        raise AssertionError(f"513^2 V-cycle did not take the fine route: {dict(cb.CALLS)}")
    phase_done("513^2 slice")

    # ── 5. this slice: FMG 129 -> ... -> 1025 (f32) -> 2049 mixed on the card ──
    cfg2_k = bench_config(2049, use_pallas=True, gs_residual_threshold=GS_TOL)
    cfg2_p = bench_config(2049, use_pallas=False, gs_residual_threshold=GS_TOL)
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launch_counts()
    res2_k, info2_k = solve_equilibrium_mixed_fmg(cfg2_k, min_coarse=129, device=dev)
    torch.cuda.synchronize()
    launches = {name: cb.CALLS[name] for name in KERNELS}
    peak_mb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e6
    print(f"mixed 2049^2 cascade with kernels: levels {info2_k}")
    print(f"wrapper calls in the 2049^2 mixed run: {launches}; __global__ launches "
          f"{cb.kernel_launches()} ({dict(cb.LAUNCHES)})")
    print(f"peak device memory of the mixed cascade: {peak_mb:.1f} MB above the "
          f"{base_bytes / 1e6:.1f} MB already allocated [{card}]")
    if [d["n"] for d in info2_k] != [129, 257, 513, 1025, 2049]:
        raise AssertionError(f"unexpected mixed cascade {info2_k}")
    if not all(d["converged"] for d in info2_k):
        raise AssertionError("the mixed kernel cascade did not converge at every level")
    gs_k = float(res2_k.gs_residual)
    print(f"final f64 GS residual {gs_k!r} (limit {GS_TOL:.0e})")
    if not gs_k < GS_TOL:
        raise AssertionError(f"final f64 GS residual {gs_k} >= {GS_TOL}")
    psi2_k = res2_k.psi
    if (tuple(psi2_k.shape) != (2049, 2049) or psi2_k.dtype != torch.float64
            or not bool(torch.isfinite(psi2_k).all())):
        raise AssertionError("mixed cascade psi is not a finite 2049x2049 float64 field")
    # Per level: one source and one V-cycle per f32 Picard iteration; the
    # 2049^2 level takes the plain f64 source and n_refine = 2 f32 V-cycles
    # (2049 -> 1025 tiled, 513 fine legs, 257 fused) per iteration.
    it = {d["n"]: d["iterations"] for d in info2_k}
    f32_its = it[129] + it[257] + it[513] + it[1025]
    vcycles = f32_its + 2 * it[2049]
    expected2 = {"sor_sweeps": 0, "fused_topology_source": f32_its,
                 "fine_presmooth_restrict": it[513] + it[1025] + 2 * it[2049],
                 "fine_prolong_smooth": it[513] + it[1025] + 2 * it[2049],
                 "fused_coarse_vcycle": vcycles,
                 "tiled_presmooth_restrict": it[1025] + 4 * it[2049],
                 "tiled_prolong_smooth": it[1025] + 4 * it[2049]}
    if launches != expected2:
        raise AssertionError(f"wrapper calls {launches} != expected {expected2}")
    if (cb.LAUNCHES["scpn_fused_vcycle"], cb.LAUNCHES["scpn_fused_source"]) != (vcycles, f32_its):
        raise AssertionError(f"the one-launch kernels made {dict(cb.LAUNCHES)}, not one launch "
                             "a call")

    with staged_kernels():
        res2_s, info2_s = solve_equilibrium_mixed_fmg(cfg2_k, min_coarse=129, device=dev)
    torch.cuda.synchronize()
    print(f"mixed 2049^2 cascade with the staged kernels: levels {info2_s}, final f64 GS "
          f"residual {float(res2_s.gs_residual)!r}; psi equal to the one-launch kernels' "
          f"{torch.equal(res2_s.psi, psi2_k)}")
    if info2_s != info2_k or not torch.equal(res2_s.psi, psi2_k):
        raise AssertionError("the mixed cascade differs between one-launch and staged kernels")

    res2_p, info2_p = solve_equilibrium_mixed_fmg(cfg2_p, min_coarse=129, use_pallas=False,
                                                  device=dev)
    torch.cuda.synchronize()
    dev2 = span_rel(psi2_k, res2_p.psi)
    print(f"mixed 2049^2 cascade plain: levels {info2_p}, final f64 GS residual "
          f"{float(res2_p.gs_residual)!r}")
    print(f"per-level iterations: kernels {[d['iterations'] for d in info2_k]}, "
          f"plain {[d['iterations'] for d in info2_p]}")
    print(f"psi span-rel: mixed kernels vs mixed plain {dev2:.3e} (limit {SLICE_TOL:.0e})")
    if not res2_p.converged:
        raise AssertionError("the plain mixed cascade did not converge")
    if abs(info2_k[-1]["iterations"] - info2_p[-1]["iterations"]) > 1:
        raise AssertionError("2049^2 iteration counts differ by more than 1")
    if not dev2 <= SLICE_TOL:
        raise AssertionError("mixed kernel cascade deviates from the plain cascade")

    g2049, r2049, dr2049, dz2049 = level(2049)
    defect = rand(2049, 2049)
    cb.reset_launch_counts()
    _vcycle_impl(torch.zeros_like(defect), defect, r2049, dr2049, dz2049, 1.0, 3, 3, 5, 50, True)
    torch.cuda.synchronize()
    print(f"one 2049^2 V-cycle (3,3) with kernels: {cb.kernel_launches()} __global__ launches "
          f"({dict(cb.LAUNCHES)}), wrapper calls {dict(cb.CALLS)}")
    if dict(cb.CALLS) != {"tiled_presmooth_restrict": 2, "tiled_prolong_smooth": 2,
                          "fine_presmooth_restrict": 1, "fine_prolong_smooth": 1,
                          "fused_coarse_vcycle": 1}:
        raise AssertionError(f"2049^2 V-cycle did not take the tiled route: {dict(cb.CALLS)}")
    if cb.LAUNCHES["scpn_fused_vcycle"] != 1:
        raise AssertionError(f"2049^2 V-cycle made {dict(cb.LAUNCHES)}: not one fused launch")
    phase_done("2049^2 mixed slice")

    # ── 6. the path that launches sor_sweeps: the anderson solver at 129^2 ──
    def sor_cfg(use_pallas):
        return config_from_dict(config_dict(
            129, **{**BENCH_SOLVER, "solver_method": "anderson", "inner_sweeps": SOR_SWEEPS,
                    "sor_omega": SOR_OMEGA}, use_pallas=use_pallas))

    cb.reset_launch_counts()
    res3_k = solve_equilibrium(sor_cfg(True), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    launches_sor = {name: cb.CALLS[name] for name in KERNELS}
    res3_p = solve_equilibrium(sor_cfg(False), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    dev3 = span_rel(res3_k.psi, res3_p.psi)
    print(f"anderson 129^2 solve ({SOR_SWEEPS} inner SOR sweeps, omega {SOR_OMEGA}): kernels "
          f"converged {res3_k.converged} in {res3_k.iterations}, plain converged "
          f"{res3_p.converged} in {res3_p.iterations}, psi span-rel {dev3:.3e} "
          f"(limit {SLICE_TOL:.0e}); wrapper calls {launches_sor}, __global__ launches "
          f"{dict(cb.LAUNCHES)}")
    if not (res3_k.converged and res3_p.converged):
        raise AssertionError("an anderson 129^2 solve did not converge")
    if abs(res3_k.iterations - res3_p.iterations) > 1:
        raise AssertionError("anderson 129^2 iteration counts differ by more than 1")
    if not dev3 <= SLICE_TOL or not bool(torch.isfinite(res3_k.psi).all()):
        raise AssertionError("the anderson 129^2 kernel solve deviates from the plain solve")
    expected3 = {name: 0 for name in KERNELS}
    expected3.update(sor_sweeps=res3_k.iterations, fused_topology_source=res3_k.iterations)
    if launches_sor != expected3:
        raise AssertionError(f"wrapper calls {launches_sor} != expected {expected3}")
    if cb.LAUNCHES["scpn_rb_half_sweep"] != 2 * SOR_SWEEPS * res3_k.iterations:
        raise AssertionError(f"anderson solve made {dict(cb.LAUNCHES)}")
    # every kernel's launches over the path that runs it
    launches["sor_sweeps"] = launches_sor["sor_sweeps"]
    missing = [name for name in KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on a path: {missing}")
    phase_done("anderson 129^2 slice")

    # ── 7. times (CUDA events, one warm-up, median of 5) and bounds ──
    kernels = []
    for name in KERNELS:
        fk, fp, shape, work = timing[name]
        earlier_ms = None
        if name in staged:
            # the one-launch kernel and its staged predecessor in turns
            ms_k, earlier_ms = cuda_ms_pair(fk, staged[name])
            ms_p = cuda_ms(fp)
        else:
            ms_k, ms_p = cuda_ms(fk), cuda_ms(fp)
        bound_ms, bound_by = bound(work)
        extra = ""
        if name in versus_fine:
            extra = f", fine leg {cuda_ms(versus_fine[name]):.4f} ms"
        if name in staged:
            extra = (f", staged {earlier_ms:.4f} ms (in turns); 50 calls back to back "
                     f"{back_to_back_ms(fk):.4f} ms a call, staged "
                     f"{back_to_back_ms(staged[name]):.4f} ms a call")
        if name == "fused_coarse_vcycle":
            extra += (f"; {vcycle_stages(257, 1, 2, 5, 50)} dependent stages bound it, "
                      "not the bytes")
        print(f"time {name} {shape}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms{extra}, "
              f"bound {bound_ms:.4g} ms ({bound_by}: {work[0] / 1e6:.4g} MB, "
              f"{work[1] / 1e6:.4g} Mflop) [{card}]")
        src_path, replaces = SOURCES[name]
        row = {"name": name, "route": "cuda",
               "source": f"scpn_fusion_tpu_torch/{src_path}", "replaces": replaces,
               "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
               "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if earlier_ms is not None:
            row["earlier_ms"] = earlier_ms
        kernels.append(row)
    for label, (name_a, fn_a), (name_b, fn_b), work in extra_times:
        bound_ms, bound_by = bound(work)
        print(f"time {label}: {name_a} {cuda_ms(fn_a):.4f} ms, {name_b} {cuda_ms(fn_b):.4f} ms, "
              f"bound {bound_ms:.4g} ms ({bound_by}) [{card}]")

    def staged_run(solve):
        def run():
            with staged_kernels():
                solve()
        return run

    def fmg_run():
        solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)

    def mixed_run():
        solve_equilibrium_mixed_fmg(cfg2_k, min_coarse=129, device=dev)

    fmg_k, fmg_s = cuda_ms_pair(fmg_run, staged_run(fmg_run))
    fmg_p = cuda_ms(lambda: solve_equilibrium_fmg(cfg_p, dtype=torch.float32, **fmg))
    print(f"time FMG 129->257->513 f32: kernels {fmg_k:.3f} ms, with the staged kernels "
          f"{fmg_s:.3f} ms (in turns), plain {fmg_p:.3f} ms [{card}]")
    mix_k, mix_s = cuda_ms_pair(mixed_run, staged_run(mixed_run))
    mix_p = cuda_ms(lambda: solve_equilibrium_mixed_fmg(cfg2_p, min_coarse=129,
                                                        use_pallas=False, device=dev), reps=2)
    print(f"time mixed FMG 129->...->2049: kernels {mix_k:.3f} ms, with the staged kernels "
          f"{mix_s:.3f} ms (in turns, median of 5), plain {mix_p:.3f} ms (median of 2) [{card}]")
    sor_k = cuda_ms(lambda: solve_equilibrium(sor_cfg(True), dtype=torch.float32, device=dev))
    sor_p = cuda_ms(lambda: solve_equilibrium(sor_cfg(False), dtype=torch.float32, device=dev),
                    reps=2)
    print(f"time anderson 129^2 solve: kernels {sor_k:.3f} ms, plain {sor_p:.3f} ms "
          f"(median of 2) [{card}]")
    phase_done("times")
    print("phase seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
