"""Hardware-in-the-loop latency harness for control steps (port of
``scpn_fusion_tpu/control/hil.py``).

Two measurements:

* ``measure_dispatch_latency`` -- host-visible wall time a call of a step
  function (what an external HIL rig sees a tick), synchronous or pipelined;
* ``measure_fused_throughput`` -- amortised time a tick when n ticks run in
  one call (on the card, e.g. ``run_neuro_closed_loop``: one launch of row N
  for the whole shot).

The JAX package jits the step (``jax.jit``) and blocks on the first leaf of
its output; the port calls the step as given and, where that first leaf is a
CUDA tensor, synchronises its device (PyTorch returns before the card
finishes).  Every time is ``time.perf_counter`` around work that ends in
that synchronisation.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch


class LatencyReport(NamedTuple):
    p50_us: float
    p95_us: float
    p99_us: float
    mean_us: float
    n_samples: int

    def to_dict(self) -> dict:
        return dict(self._asdict())


def _percentiles(samples_us: np.ndarray, n: int) -> LatencyReport:
    return LatencyReport(
        p50_us=float(np.percentile(samples_us, 50)),
        p95_us=float(np.percentile(samples_us, 95)),
        p99_us=float(np.percentile(samples_us, 99)),
        mean_us=float(samples_us.mean()),
        n_samples=n)


def first_tensor(out):
    """The first tensor leaf of ``out`` in ``jax.tree.leaves``' order
    (tuples, lists and named tuples in order, dicts by sorted key), or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        for item in out:
            leaf = first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def _block(out) -> None:
    """``block_until_ready`` of the first leaf: synchronise its device when
    it is a CUDA tensor."""
    leaf = first_tensor(out)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def measure_dispatch_latency(step_fn: Callable, args: tuple, *, n_warmup: int = 10,
                             n_samples: int = 200, pipelined: bool = False) -> LatencyReport:
    """Per-call wall latency of ``step_fn(*args)`` (warm).

    ``pipelined=False`` waits for every call -- the synchronous round trip an
    external HIL rig sees a tick; ``pipelined=True`` issues batches of 20
    calls and waits once a batch -- the amortised cost a call when the
    consumer does not need each result before the next command.
    """
    out = step_fn(*args)
    for _ in range(n_warmup):
        out = step_fn(*args)
    _block(out)

    if pipelined:
        batch = 20
        n_batches = max(n_samples // batch, 3)
        samples = np.empty(n_batches)
        for i in range(n_batches):
            t0 = time.perf_counter()
            for _ in range(batch):
                out = step_fn(*args)
            _block(out)
            samples[i] = (time.perf_counter() - t0) * 1e6 / batch
        return _percentiles(samples, n_batches)

    samples = np.empty(n_samples)
    for i in range(n_samples):
        t0 = time.perf_counter()
        out = step_fn(*args)
        _block(out)
        samples[i] = (time.perf_counter() - t0) * 1e6
    return _percentiles(samples, n_samples)


def measure_fused_throughput(scan_fn: Callable, args: tuple, *, n_ticks: int,
                             n_repeats: int = 5) -> LatencyReport:
    """Amortised time a tick of ``scan_fn(*args)``, which must run
    ``n_ticks`` control ticks in one call; percentiles over the repeats."""
    out = scan_fn(*args)
    _block(out)

    samples = np.empty(n_repeats)
    for i in range(n_repeats):
        t0 = time.perf_counter()
        out = scan_fn(*args)
        _block(out)
        samples[i] = (time.perf_counter() - t0) * 1e6 / n_ticks
    return _percentiles(samples, n_repeats)


def control_rate_hz(report: LatencyReport, percentile: str = "p95_us") -> float:
    """Achievable control rate at the chosen latency percentile."""
    us = getattr(report, percentile)
    return 1e6 / max(us, 1e-9)
