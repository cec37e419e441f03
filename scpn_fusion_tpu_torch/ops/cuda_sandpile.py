"""The SOC sandpile's drive-and-relax loop as a hand-written CUDA kernel
(``csrc/sandpile.cu``; row S).

:func:`sandpile_run` runs every drive of a sandpile run -- the grain at the
drive cell and ``relax_sweeps`` synchronous toppling sweeps, the loop of the
JAX package's ``run_sandpile`` (``models/physics/sandpile.py:44-84``) -- in
ONE launch of one CTA, the heights double-buffered in shared memory, one
barrier a sweep, and returns (final heights, avalanche sizes, edge flux,
mean slope).  It adds one to ``cb.CALLS["sandpile_run"]``.  The JAX package
has no Pallas kernel here: its run is one ``lax.scan`` with the sweeps an
inner scan, in one compiled program, and this launch takes that program's
place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`sandpile_run_plain`, the loop of the port's ``sandpile.drive`` and
``sandpile.sweep``.  On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_sandpile_f32", torch.float64: "scpn_sandpile_f64"}
MAX_THREADS = 1024
MAX_SMEM_BYTES = 227 * 1024


class _Args(ctypes.Structure):
    """``SandpileArgs`` of ``csrc/sandpile.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "h0", "idx", "h_final", "sizes", "flux", "slope")]
        + [(name, ctypes.c_int) for name in ("n", "n_steps", "sweeps")]
        + [(name, ctypes.c_double) for name in ("critical", "topple", "drive")])


def sandpile_run_plain(cfg, h0: torch.Tensor, idx: torch.Tensor):
    """The drive loop the kernel replaces: (final heights, avalanche sizes,
    edge flux, mean slope) from heights ``h0`` under the drive cells ``idx``
    (n_steps,)."""
    from scpn_fusion_tpu_torch.models.physics.sandpile import drive, mean_slope, relax

    h, rows = h0, []
    for k in range(idx.shape[0]):
        h = drive(cfg, h, idx[k])
        h, n_top, out = relax(cfg, h)
        rows.append((n_top, out, mean_slope(h)))
    if not rows:
        empty = h0.new_zeros(0)
        return h, empty, empty.clone(), empty.clone()
    return (h, *(torch.stack(col) for col in zip(*rows)))


def threads_for(n: int) -> int:
    """Threads of the one CTA: a warp-multiple cover of the cells, at most 1024."""
    return min(MAX_THREADS, 32 * ((n + 31) // 32))


def check_sandpile(cfg, h0: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise unless the kernel takes this configuration and these tensors."""
    if h0.dtype not in _ENTRIES:
        raise TypeError(f"sandpile_run: float32 or float64, got {h0.dtype}")
    for name, t, dtype in (("h0", h0, h0.dtype), ("idx", idx, torch.int64)):
        if not t.is_cuda:
            raise ValueError(f"sandpile_run: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"sandpile_run: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"sandpile_run: {name} must be one contiguous vector")
    if h0.shape[0] != cfg.n_cells or cfg.n_cells < 2:
        raise ValueError(f"sandpile_run: h0 has {h0.shape[0]} cells, the config "
                         f"{cfg.n_cells} (at least 2)")
    if 2 * cfg.n_cells * h0.element_size() > MAX_SMEM_BYTES:
        raise ValueError(f"sandpile_run: {cfg.n_cells} cells do not fit shared memory twice")
    if cfg.relax_sweeps < 0:
        raise ValueError("sandpile_run: relax_sweeps must be >= 0")
    if idx.numel() and not bool(((idx >= 0) & (idx < cfg.n_cells)).all()):
        raise ValueError("sandpile_run: a drive cell lies outside the pile")


def launch_args(cfg, h0: torch.Tensor, idx: torch.Tensor):
    """The kernel's argument block and its outputs (final heights, sizes,
    flux, slope) on ``h0``'s device."""
    n_steps = idx.shape[0]
    outs = (torch.empty_like(h0),
            *(torch.empty(n_steps, dtype=h0.dtype, device=h0.device) for _ in range(3)))
    args = _Args(h0.data_ptr(), idx.data_ptr(), *(t.data_ptr() for t in outs),
                 n=cfg.n_cells, n_steps=n_steps, sweeps=cfg.relax_sweeps,
                 critical=cfg.critical_slope, topple=cfg.topple_amount, drive=cfg.drive_amount)
    return args, outs


def sandpile_run(cfg, h0: torch.Tensor, idx: torch.Tensor):
    """(final heights, avalanche sizes, edge flux, mean slope) of the drives
    ``idx`` (n_steps,) from ``h0``: as :func:`sandpile_run_plain`, in one
    launch on the card."""
    if not h0.is_cuda:
        return sandpile_run_plain(cfg, h0, idx)
    check_sandpile(cfg, h0, idx)
    args, outs = launch_args(cfg, h0, idx)
    cb.launch(_ENTRIES[h0.dtype], ctypes.addressof(args), threads_for(cfg.n_cells))
    cb.CALLS["sandpile_run"] += 1
    return outs
