"""Newcomb field-line integration as a hand-written CUDA kernel
(``csrc/ballooning.cu``; row B).

:func:`newcomb_min_xi` integrates the ballooning equation along every
(s, alpha) line of a call -- the RK4 loop of the JAX package's
``_integrate_newcomb`` (``models/physics/ballooning.py:39-61``) for the
circular s-alpha operator or the Miller-shaped one -- and returns min xi
of each line, in ONE launch: one thread a line, (u1, u2) and the running
minimum in registers, the Miller tables staged once a CTA in shared memory.
It adds one to ``cb.CALLS["newcomb_min_xi"]``.  The JAX package has no
Pallas kernel here: its integration is one ``lax.scan`` vmapped over the
lines in one compiled program, and this launch takes that program's place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`newcomb_min_xi_plain`, the loop of ``ballooning.rk4_step`` over the
lines as one batch.  On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_newcomb_f32", torch.float64: "scpn_newcomb_f64"}
_OPS = {"circular": 0, "miller": 1}
THREADS = 32                 # one warp a CTA: a thread's chain, not the SM's width, sets the time
MAX_SMEM_BYTES = 227 * 1024
N_COEF = 6


class _Args(ctypes.Structure):
    """``NewcombArgs`` of ``csrc/ballooning.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "s", "alpha", "theta_tab", "coef_tab", "out")]
        + [(name, ctypes.c_int) for name in ("n_lines", "n_steps", "n_tab")]
        + [(name, ctypes.c_double) for name in ("h", "h_half", "h_sixth")])


def newcomb_min_xi_plain(op: str, s, alpha, tables, theta_max: float,
                         n_steps: int) -> torch.Tensor:
    """The RK4 loop the kernel replaces: min u1 over the steps of every line
    (``s``, ``alpha``: (n,)), a NaN min for a line that diverged."""
    from scpn_fusion_tpu_torch.models.physics.ballooning import OPERATORS, rk4_step, step_thetas

    coefficients, rhs = OPERATORS[op]
    h = theta_max / n_steps
    thetas = step_thetas(theta_max, n_steps, s.dtype, s.device)
    u1, u2 = torch.ones_like(s), torch.zeros_like(s)
    m = torch.ones((), dtype=s.dtype, device=s.device)
    for i in range(n_steps):
        coefs = [coefficients(tables, thetas[i, j]) for j in range(3)]
        u1, u2 = rk4_step(rhs, coefs, s, alpha, u1, u2, h)
        m = torch.minimum(m, u1)
    return m.expand_as(s)


def check_newcomb(op: str, s, alpha, tables, n_steps: int) -> None:
    """Raise unless the kernel takes this operator and these tensors."""
    if op not in _OPS:
        raise ValueError(f"newcomb_min_xi: operator {op!r}, not one of {sorted(_OPS)}")
    if s.dtype not in _ENTRIES:
        raise TypeError(f"newcomb_min_xi: float32 or float64, got {s.dtype}")
    if n_steps < 1:
        raise ValueError("newcomb_min_xi: n_steps must be >= 1")
    tensors = {"s": s, "alpha": alpha}
    if op == "miller":
        tensors.update(theta_tab=tables[0], coef_tab=tables[1])
        n_tab = tables[0].shape[0]
        if tables[0].dim() != 1 or tuple(tables[1].shape) != (n_tab, N_COEF) or n_tab < 2:
            raise ValueError(f"newcomb_min_xi: tables {tuple(tables[0].shape)} / "
                             f"{tuple(tables[1].shape)}, not (n,) / (n, {N_COEF})")
        if _smem_bytes(op, n_tab, s.element_size()) > MAX_SMEM_BYTES:
            raise ValueError(f"newcomb_min_xi: {n_tab} table rows do not fit shared memory")
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"newcomb_min_xi: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != s.dtype:
            raise TypeError(f"newcomb_min_xi: {name} is {t.dtype}, s is {s.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"newcomb_min_xi: {name} must be contiguous")
    if s.dim() != 1 or alpha.shape != s.shape:
        raise ValueError(f"newcomb_min_xi: s {tuple(s.shape)} and alpha "
                         f"{tuple(alpha.shape)} must be one and the same (n,)")


def _smem_bytes(op: str, n_tab: int, itemsize: int) -> int:
    return (1 + N_COEF) * n_tab * itemsize if op == "miller" else 0


def newcomb_min_xi(op: str, s, alpha, tables, theta_max: float, n_steps: int) -> torch.Tensor:
    """min xi over [0, theta_max] of every line (``s``, ``alpha``: (n,)), as
    :func:`newcomb_min_xi_plain`, in one launch on the card; ``tables`` is
    None for the circular operator and (theta (n_tab,), coefficients
    (n_tab, 6)) for the Miller one."""
    if not s.is_cuda:
        return newcomb_min_xi_plain(op, s, alpha, tables, theta_max, n_steps)
    check_newcomb(op, s, alpha, tables, n_steps)
    out = torch.empty_like(s)
    if s.shape[0] == 0:
        return out
    theta_tab, coef_tab = tables if op == "miller" else (None, None)
    h = theta_max / n_steps
    args = _Args(s.data_ptr(), alpha.data_ptr(),
                 theta_tab.data_ptr() if theta_tab is not None else None,
                 coef_tab.data_ptr() if coef_tab is not None else None, out.data_ptr(),
                 n_lines=s.shape[0], n_steps=n_steps,
                 n_tab=theta_tab.shape[0] if theta_tab is not None else 0,
                 h=h, h_half=0.5 * h, h_sixth=h / 6.0)
    cb.launch(_ENTRIES[s.dtype], ctypes.addressof(args), _OPS[op])
    cb.CALLS["newcomb_min_xi"] += 1
    return out
