"""Profiling helpers: per-step timing taxonomy + trace capture (port of
``scpn_fusion_tpu/utils/profiling.py``).

Role-parity with the reference's profiling lane
(``profiling/profile_kernel.py`` cProfile drivers, per-step ``wall_time_s``
embedded in solver results ``fusion_kernel_newton_solver.py:613``,
controller ``timing_ms`` JSONL ``scpn/controller.py:397-409``, and the
metric taxonomy ``docs/PERFORMANCE_METRIC_TAXONOMY.md``).

``time_fn`` measures warm wall time of any callable, waiting for the
devices of its output tensors (JAX: ``jax.block_until_ready``); ``trace``
captures a ``torch.profiler`` trace (CPU and, where there is a card, CUDA
activity) and writes it as a Chrome trace into ``log_dir`` (JAX:
``jax.profiler.start_trace``); ``StepTimer`` accumulates a named-metric
taxonomy and dumps JSONL.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def _block_until_ready(out):
    """Wait for the CUDA devices of ``out``'s tensors (any nesting of tuples,
    lists and dicts); return ``out``."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn: Callable, *args, n_warmup: int = 2, n_repeats: int = 10,
            **kwargs) -> dict:
    """Warm wall-time stats of fn(*args, **kwargs) with output blocking."""
    out = fn(*args, **kwargs)
    for _ in range(n_warmup):
        out = fn(*args, **kwargs)
    _block_until_ready(out)
    samples = np.empty(n_repeats)
    for i in range(n_repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block_until_ready(out)
        samples[i] = time.perf_counter() - t0
    return {
        "mean_s": float(samples.mean()),
        "p50_s": float(np.percentile(samples, 50)),
        "min_s": float(samples.min()),
        "max_s": float(samples.max()),
        "n": n_repeats,
    }


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Capture a ``torch.profiler`` trace around the with-block and write it
    to ``log_dir/trace.json`` (Chrome trace format; default: a folder under
    the temporary directory)."""
    log_dir = Path(log_dir) if log_dir is not None else \
        Path(tempfile.gettempdir()) / "scpn_fusion_tpu_torch_trace"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
        log_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(log_dir / "trace.json"))


class StepTimer:
    """Named-metric wall-clock taxonomy (reference
    ``PERFORMANCE_METRIC_TAXONOMY.md`` shape: dotted metric names in us)."""

    def __init__(self):
        self._records: list[dict] = []

    @contextlib.contextmanager
    def measure(self, metric: str, **context):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._records.append({
                "metric": metric,
                "value_us": (time.perf_counter() - t0) * 1e6,
                "t": time.time(),
                **context,
            })

    def summary(self) -> dict:
        out: dict = {}
        for r in self._records:
            out.setdefault(r["metric"], []).append(r["value_us"])
        return {k: {"p50_us": float(np.percentile(v, 50)),
                    "mean_us": float(np.mean(v)), "n": len(v)}
                for k, v in out.items()}

    def dump_jsonl(self, path: str | Path) -> Path:
        p = Path(path)
        with open(p, "w", encoding="utf-8") as fh:
            for r in self._records:
                fh.write(json.dumps(r) + "\n")
        return p

    def reset(self) -> None:
        self._records.clear()
