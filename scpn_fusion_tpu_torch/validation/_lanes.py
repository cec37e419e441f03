"""What the equilibrium campaigns share: the 6-coil ITER-like machine of the
JAX scripts (``bench_config.ITER_LIKE``), the device switch that takes the place of their TPU switch, the
clock of their timing lanes, a call timed as the first of a fresh process,
and their exit rule."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# where the JAX scripts read the original reference's data, which the
# repository does not hold (validation/run_equilibrium_parity.py:67,
# validation/run_io_roundtrip.py:36): their lanes on it report blocked
# when it is absent
REFERENCE_DATA = Path("/root/reference/validation/reference_data")

NO_CARD = "TPU backend unavailable in this environment"


def on_card(device) -> bool:
    """The scripts' ``jax.default_backend() == "tpu"``: the campaign runs on
    a CUDA device, where the float32 lanes take the hand-written kernels."""
    return torch.device(device).type == "cuda"


def iter_like(name: str, n: int, *, ip: float = 15.0, **solver):
    """The scripts' ``ReactorConfig``: ``bench_config.ITER_LIKE`` (the six
    coils every equilibrium script builds by hand, on (2, 10) x (-4, 4) m,
    mu0 = 1) on an ``n`` x ``n`` grid, named ``name``, ``ip`` the target
    current, ``solver`` the ``SolverParams`` fields."""
    from scpn_fusion_tpu_torch.bench_config import ITER_LIKE, config_dict
    from scpn_fusion_tpu_torch.core.config import config_from_dict
    return config_from_dict({**config_dict(n, **solver), "reactor_name": name,
                             "physics": {**ITER_LIKE["physics"], "plasma_current_target": ip}})


def wall_ms(run, device) -> tuple:
    """(result, ms) of ``run()``: on a CUDA device between two CUDA events
    recorded after a synchronise (the host's driving of the loop stays in,
    as a user waits for it), else on the host clock."""
    if on_card(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = run()
    return out, 1e3 * (time.perf_counter() - t0)


def host_ms(run, device) -> tuple:
    """(result, ms) of ``run()`` on the host clock, ending in a synchronise
    on a CUDA device (the scripts' protocol where they time on the host)."""
    t0 = time.perf_counter()
    out = run()
    if on_card(device):
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def best_ms(run, device, reps: int = 3) -> float:
    """The scripts' ``wall(k, reps)``: one warm call, then the least of
    ``reps`` timed calls."""
    run()
    return min(wall_ms(run, device)[1] for _ in range(reps))


def fresh_process(target: str, **kwargs) -> dict:
    """``module:function(**kwargs)`` in a new Python process of this
    checkout; returns the JSON object the function returns.  The port's
    counterpart of a JAX program's first, compiling call is the first call
    of a process: the CUDA context, the kernel library's load, the first
    launches and allocations."""
    module, func = target.split(":")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"from {module} import {func}\n"
            f"print(json.dumps({func}(**json.loads(sys.argv[1]))))\n")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(kwargs)], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{target} in a fresh process exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def exit_code(lanes) -> int:
    """The scripts' exit rule: 0 when every lane that is not blocked passes."""
    return 0 if all(lane.status == "pass" for lane in lanes if lane.status != "blocked") else 1
