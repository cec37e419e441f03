"""Self-organised-criticality sandpile transport model (port of
``scpn_fusion_tpu/models/physics/sandpile.py``).

The classic Hwa-Kardar/Bak-style 1D sandpile as a turbulence-transport
cartoon: a drive step adds a grain, then ``relax_sweeps`` synchronous
toppling sweeps (branch-free :func:`sweep`) relax the pile.  The JAX package
runs the whole drive sequence as one ``lax.scan`` with the sweeps an inner
scan; the port runs it, every drive and every sweep, in ONE launch of a
hand-written CUDA kernel, one CTA, one thread a cell
(``ops/cuda_sandpile.sandpile_run``, ``csrc/sandpile.cu``; row S).  On a CPU
tensor the same call is its plain version, the loop of :func:`drive` and
:func:`sweep`.

Draws: JAX splits a threefry key a drive and draws the drive cell with
``jax.random.randint``; the port's :func:`run_sandpile` draws the cells from
a ``torch.Generator`` seeded with ``seed``, and :func:`_run_sandpile` takes
them as a tensor (the CPU tests feed it JAX's).  With ``drive_location``
``"core"`` every grain lands on cell 0.  ``run_sandpile`` takes ``dtype``
(float32 by default; JAX takes its float from the x64 flag) and ``device``
(``"cuda"`` by default).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import xla_mean as _xla_mean


@dataclasses.dataclass(frozen=True)
class SandpileConfig:
    n_cells: int = 128
    critical_slope: float = 4.0
    topple_amount: float = 2.0     # transferred downhill per topple
    drive_amount: float = 1.0      # grains added per drive step
    relax_sweeps: int = 64         # synchronous sweeps per drive
    n_steps: int = 2000
    drive_location: str = "random"  # "random" | "core"

    def __post_init__(self):
        if self.topple_amount >= self.critical_slope:
            raise ValueError("topple_amount must be < critical_slope")


class SandpileTrace(NamedTuple):
    heights_final: torch.Tensor   # (n_cells,)
    avalanche_sizes: torch.Tensor  # (n_steps,) topples per drive
    flux_out: torch.Tensor        # (n_steps,) grains leaving the edge
    mean_slope: torch.Tensor      # (n_steps,)


def sweep(cfg: SandpileConfig, h: torch.Tensor, n_top: torch.Tensor, out: torch.Tensor):
    """One synchronous toppling sweep (``sandpile.py:49-58``): returns
    (h', topples so far, edge flux so far)."""
    zero = h.new_zeros(1)
    slope = h - torch.cat([h[1:], zero])
    unstable = slope > cfg.critical_slope
    move = unstable.to(h.dtype) * cfg.topple_amount     # jnp.where(unstable, topple, 0.0)
    h1 = h - move
    h1 = h1 + torch.cat([zero, move[:-1]])
    out = out + move[-1]            # last cell spills off the edge
    n_top = n_top + torch.sum(unstable)
    return h1, n_top, out


def relax(cfg: SandpileConfig, h: torch.Tensor):
    """``relax_sweeps`` sweeps; returns (h, topples, edge flux)."""
    n_top, out = h.new_zeros(()), h.new_zeros(())
    for _ in range(cfg.relax_sweeps):
        h, n_top, out = sweep(cfg, h, n_top, out)
    return h, n_top, out


def drive(cfg: SandpileConfig, h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One grain of ``drive_amount`` on cell ``idx`` (a 0-d index)."""
    return h.index_add(0, idx.reshape(1), h.new_full((1,), cfg.drive_amount))


def mean_slope(h: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(h[:-1] - h[1:])`` as XLA computes it: the sum times the
    reciprocal of n - 1, rounded once in the dtype (XLA turns the division by
    a constant into that product; so does ``torch.mean`` on a CUDA tensor,
    not on a CPU one; the kernel forms the same product)."""
    return _xla_mean(h[:-1] - h[1:])


def drive_indices(cfg: SandpileConfig, seed: int = 0) -> torch.Tensor:
    """The drive cell of every step, (n_steps,) int64 on the CPU: uniform in
    [0, n_cells // 2) from a ``torch.Generator`` seeded with ``seed``, or 0
    with a core drive."""
    if cfg.drive_location == "core":
        return torch.zeros(cfg.n_steps, dtype=torch.int64)
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, cfg.n_cells // 2, (cfg.n_steps,), generator=gen)


def _run_sandpile(cfg: SandpileConfig, idx: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> SandpileTrace:
    """The drive-relax evolution from an empty pile under the drive cells
    ``idx`` (n_steps,), one launch of row S on the card."""
    from scpn_fusion_tpu_torch.ops.cuda_sandpile import sandpile_run

    h0 = torch.zeros(cfg.n_cells, dtype=dtype, device=device)
    return SandpileTrace(*sandpile_run(cfg, h0, idx.to(device=device, dtype=torch.int64)))


def run_sandpile(cfg: SandpileConfig, seed: int = 0, *, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda") -> SandpileTrace:
    """Drive-relax SOC evolution, the drive cells drawn from ``seed``."""
    return _run_sandpile(cfg, drive_indices(cfg, seed), dtype=dtype, device=device)


def avalanche_statistics(trace: SandpileTrace) -> dict:
    """SOC fingerprints: broad avalanche distribution + marginal slope.  The
    quiet fraction is float32, as ``jnp.mean`` of a bool mask is."""
    sizes = trace.avalanche_sizes
    active = sizes[sizes > 0]
    mean = _xla_mean(active) if active.numel() else sizes.new_zeros(())
    return {
        "mean_avalanche": float(mean),
        "max_avalanche": float(torch.max(sizes)),
        "fraction_quiet": float(_xla_mean((sizes == 0).to(torch.float32))),
        "final_mean_slope": float(trace.mean_slope[-1]),
        "total_flux_out": float(torch.sum(trace.flux_out)),
    }
