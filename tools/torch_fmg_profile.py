#!/usr/bin/env python3
"""Where the time goes in the port's FMG solves on one NVIDIA GPU.

Runs the bench configuration's 129^2 -> 257^2 -> 513^2 FMG cascade
(``scpn_fusion_tpu_torch.bench_config``) with the hand-written kernels, or
with ``--mixed`` the resolution-scaling cascade 129^2 -> ... -> 1025^2 ending
in the mixed-precision 2049^2 solve gated on the f64 GS residual (3e-5), once
to warm up and once under ``torch.profiler``, and prints:

* wall time of the profiled solve and the summed device-kernel time, hence
  the device's idle share;
* device time by kernel name (top 20), the count of device launches, and
  the device time in the port's own kernels and in float64 PyTorch ops;
* the spread of each of the port's kernels over its launches;
* the chrome trace, written to ``chiprun_out/torch_fmg_trace.json``
  (``torch_mixed_trace.json`` with ``--mixed``).

With ``--kernels`` it profiles, instead of a solve, single calls of the two
one-launch kernels and of their staged predecessors (the fused V-cycle at
257^2 and 129^2, the fused source at 513^2 and 1025^2) and prints for each
the device launches a call and the device time a call, summed over every
device kernel the call ran (mean of 5 profiled calls after a warm-up).

Run from the repository root on a machine with a CUDA device:
``python3 tools/torch_fmg_profile.py [--mixed | --kernels]``.  Exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


CALLS_PROFILED = 5


PORT_PREFIX = "(anonymous namespace)::"   # the port's kernels live in anonymous namespaces


def kernel_name(name: str) -> str:
    """A device event's name without namespaces, template and argument lists."""
    return name.removeprefix(PORT_PREFIX).split("(")[0].split("<")[0].split("::")[-1].strip()


def device_events(prof):
    import torch
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_kernel_calls(card: str) -> None:
    """Device launches and device time of one call of each one-launch kernel
    and of its staged predecessor."""
    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_source

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    cases = []
    for n, pre, post in ((257, 1, 2), (257, 3, 3), (129, 1, 2)):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        args = (rand(n, n), rand(n, n), g.R, g.dR, g.dZ, 1.0)
        kw = dict(pre_smooth=pre, post_smooth=post, min_grid=5, coarse_sweeps=50)
        for label, fn in (("one launch", cuda_mg.fused_coarse_vcycle),
                          ("staged", cuda_mg._fused_coarse_vcycle_staged)):
            cases.append((f"fused_coarse_vcycle {n}^2 ({pre},{post}) {label}",
                          lambda fn=fn, a=args, kw=kw: fn(*a, **kw)))
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=torch.float32, device=dev).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=torch.float32, device=dev).unbind())
    params = cuda_source.pack_source_params(p_c, ff_c, 15.0, like=rand(1))
    for n in (513, 1025):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        psi = 3.0 * torch.exp(-(((g.RR - 6.0) / 2.0) ** 2 + (g.ZZ / 2.0) ** 2)) \
            + 0.01 * rand(n, n)
        mask = (g.ZZ < g.Z_min * 0.5).to(torch.float32).contiguous()
        kw = dict(d_r=g.dR, d_z=g.dZ, mu0=1.0, h_mode=False)
        for label, fn in (("one launch", cuda_source.fused_topology_source),
                          ("staged", cuda_source._fused_topology_source_staged)):
            cases.append((f"fused_topology_source {n}^2 L-mode {label}",
                          lambda fn=fn, a=(psi, g.R, mask, params), kw=kw: fn(*a, **kw)))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, call in cases:
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS_PROFILED):
                call()
            host_us = (time.perf_counter() - t0) * 1e6 / CALLS_PROFILED
            torch.cuda.synchronize()
        events = device_events(prof)
        names = sorted({kernel_name(e.name) for e in events})
        print(f"{label}: {len(events) / CALLS_PROFILED:g} device launches a call, device "
              f"{sum(e.device_time for e in events) / CALLS_PROFILED:.3f} us a call, host "
              f"{host_us:.1f} us a call to enqueue (profiler on) [{card}]; kernels {names}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--mixed", action="store_true",
                       help="profile the 2049^2 mixed-precision cascade")
    group.add_argument("--kernels", action="store_true",
                       help="profile single calls of the one-launch kernels and their "
                            "staged predecessors")
    opts = parser.parse_args()
    mixed = opts.mixed
    import torch
    if not torch.cuda.is_available():
        print("torch_fmg_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    if opts.kernels:
        profile_kernel_calls(card)
        return 0
    from scpn_fusion_tpu_torch.bench_config import bench_config
    from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import solve_equilibrium_fmg
    from scpn_fusion_tpu_torch.models.equilibrium.mixed_precision import (
        solve_equilibrium_mixed_fmg,
    )

    if mixed:
        cfg = bench_config(2049, use_pallas=True, gs_residual_threshold=3e-5)

        def solve():
            return solve_equilibrium_mixed_fmg(cfg, min_coarse=129, device="cuda")
    else:
        cfg = bench_config(513, use_pallas=True)

        def solve():
            return solve_equilibrium_fmg(cfg, min_coarse=129, dtype=torch.float32,
                                         device="cuda")

    solve()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, info = solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = device_events(prof)
    dev_us = sum(e.device_time for e in events)
    print(f"levels {info}")
    print(f"wall {wall_ms:.3f} ms, device kernels {dev_us / 1e3:.3f} ms, "
          f"idle share {1.0 - dev_us / 1e3 / wall_ms:.3f}, device launches {len(events)}")
    port_us = sum(e.device_time for e in events if e.name.startswith(PORT_PREFIX))
    f64_us = sum(e.device_time for e in events if "double" in e.name)
    print(f"device ms in the port's kernels {port_us / 1e3:.3f}, "
          f"in float64 PyTorch ops {f64_us / 1e3:.3f}")
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in rows[:20]:
        print(f"  {sum(ts) / 1e3:9.3f} ms  {len(ts):6d}x  {name[:90]}")
    print("the port's kernels per launch (us): min / median / max, launches within 5% of max")
    for name, ts in rows:
        if name.startswith(PORT_PREFIX):
            ts = sorted(ts)
            near_max = sum(t >= 0.95 * ts[-1] for t in ts)
            print(f"  {ts[0]:8.3f} / {ts[len(ts) // 2]:8.3f} / {ts[-1]:8.3f}  {near_max:5d} of "
                  f"{len(ts):5d}  {kernel_name(name)}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / ("torch_mixed_trace.json" if mixed
                                        else "torch_fmg_trace.json")))
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
