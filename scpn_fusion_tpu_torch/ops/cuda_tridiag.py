"""Batched Thomas solve as a hand-written CUDA kernel (``csrc/tridiag.cu``).

:func:`thomas_solve_batched` solves B independent tridiagonal systems of
length n in ONE launch (one thread a system), in float32 or float64, and
adds one to ``cb.CALLS["thomas_solve_batched"]``.  It equals
``ops/tridiag.thomas_solve_batched_plain`` bit for bit.  The JAX package has
no Pallas kernel here: its ``thomas_solve`` is two ``lax.scan`` passes inside
one compiled program, and this launch takes that program's place.

Nothing falls back: a failed build or launch raises, and so does an input
that requires a gradient (the kernel has no backward, and needs none: no
path of the JAX package takes ``jax.grad`` through its Thomas solve).
"""

from __future__ import annotations

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_thomas_f32", torch.float64: "scpn_thomas_f64"}


def check_systems(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> None:
    """Raise unless the four are CUDA tensors of one float dtype with shapes
    (B, n-1), (B, n), (B, n-1), (B, n), n >= 2, none requiring a gradient."""
    tensors = dict(a=a, b=b, c=c, d=d)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"thomas_solve_batched: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != d.dtype or t.dtype not in _ENTRIES:
            raise TypeError(f"thomas_solve_batched: {name} is {t.dtype}; all four must be "
                            "float32 or all float64")
        if t.requires_grad:
            raise RuntimeError("thomas_solve_batched: the CUDA kernel has no backward; "
                               f"{name} requires a gradient")
    if d.dim() != 2 or d.shape[1] < 2:
        raise ValueError(f"thomas_solve_batched: d must be (B, n) with n >= 2, got "
                         f"{tuple(d.shape)}")
    n_sys, n = d.shape
    if b.shape != d.shape or a.shape != (n_sys, n - 1) or c.shape != (n_sys, n - 1):
        raise ValueError(f"thomas_solve_batched: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}, d {tuple(d.shape)} do not match")


def thomas_solve_batched(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """x (B, n) with A_k x_k = d_k for each of the B systems, one launch."""
    check_systems(a, b, c, d)
    a, b, c, d = (t.contiguous() for t in (a, b, c, d))
    x = torch.empty_like(d)
    cp = torch.empty_like(d)
    n_sys, n = d.shape
    cb.launch(_ENTRIES[d.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
              x.data_ptr(), cp.data_ptr(), n_sys, n)
    cb.CALLS["thomas_solve_batched"] += 1
    return x
