#!/usr/bin/env python3
"""Where the time goes in the port's 513^2 FMG solve on one NVIDIA GPU.

Runs the bench configuration's 129^2 -> 257^2 -> 513^2 FMG cascade
(``scpn_fusion_tpu_torch.bench_config``) with the hand-written kernels, once to warm up
and once under ``torch.profiler``, and prints:

* wall time of the profiled solve and the summed device-kernel time, hence
  the device's idle share;
* device time by kernel name (top 20), and the count of device launches;
* the chrome trace, written to ``chiprun_out/torch_fmg_trace.json``.

Run from the repository root on a machine with a CUDA device:
``python3 tools/torch_fmg_profile.py``.  Exits non-zero without one.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fmg_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.bench_config import bench_config
    from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import solve_equilibrium_fmg

    cfg = bench_config(513, use_pallas=True)

    def solve():
        return solve_equilibrium_fmg(cfg, min_coarse=129, dtype=torch.float32, device="cuda")

    solve()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, info = solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time for e in events)
    print(f"levels {info}")
    print(f"wall {wall_ms:.3f} ms, device kernels {dev_us / 1e3:.3f} ms, "
          f"idle share {1.0 - dev_us / 1e3 / wall_ms:.3f}, device launches {len(events)}")
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in rows[:20]:
        print(f"  {sum(ts) / 1e3:9.3f} ms  {len(ts):6d}x  {name[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "torch_fmg_trace.json"))
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
