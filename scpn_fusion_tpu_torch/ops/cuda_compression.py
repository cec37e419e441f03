"""The voltage-driven FRC compression as a hand-written CUDA kernel, and its
gradient as a second one (``csrc/compression.cu``; row P and its adjoint).

:func:`compression_run` runs every step of a compression trajectory -- coil
circuit, magnetic piston, adiabatic compression and energy ledgers, the loop
of the JAX package's ``run_voltage_driven_compression``
(``models/physics/pulsed_compression.py:154-216``) -- in ONE launch, one
thread, the twelve state fields in registers, and returns the trace, (15,
n_steps): the state rows, then B_ext, beta and the balance residual.  It
adds one to ``cb.CALLS["compression_run"]``.  Its backward pass is ONE
launch of the adjoint sweep, which recomputes each step from the stored
state and applies the step's vector-Jacobian product from the last step to
the first; it adds one to ``cb.CALLS["compression_adjoint"]``.  The JAX
package has no Pallas kernel here: its trajectory is one ``lax.scan`` in one
compiled program, differentiated by ``jax.grad``, and these two launches
take that program's and its gradient's place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`compression_run_plain`, the loop of the port's
``pulsed_compression.compression_step`` over the drive table, and autograd
differentiates it.  On a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_compression_f32", torch.float64: "scpn_compression_f64"}
_ADJOINT = {torch.float32: "scpn_compression_adjoint_f32",
            torch.float64: "scpn_compression_adjoint_f64"}
N_STATE = 12
N_ROWS = 15     # the state, B_ext, beta, the balance residual


class _Args(ctypes.Structure):
    """``CompressionArgs`` of ``csrc/compression.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "consts", "state0", "drive", "trace", "grad_trace", "grad_drive", "grad_state0")]
        + [("n_steps", ctypes.c_int)])


def compression_run_plain(c: dict, state0: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """The step loop the kernel replaces: the trace (15, n_steps) from the
    state ``state0`` (12,) under the drive table ``drive`` (n_steps,), with
    the step constants ``c`` (``pulsed_compression.step_constants``)."""
    from scpn_fusion_tpu_torch.models.physics.pulsed_compression import compression_step

    s, rows = tuple(state0.unbind()), []
    for k in range(drive.shape[0]):
        s, extra = compression_step(c, s, drive[k])
        rows.append((*s, *extra))
    return torch.stack([torch.stack(col) for col in zip(*rows)])


def check_compression(consts: torch.Tensor, state0: torch.Tensor, drive: torch.Tensor) -> None:
    """Raise unless the kernel takes these tensors."""
    if drive.dtype not in _ENTRIES:
        raise TypeError(f"compression_run: float32 or float64, got {drive.dtype}")
    if drive.dim() != 1 or drive.shape[0] < 1:
        raise ValueError(f"compression_run: the drive must be (n_steps,), n_steps >= 1, got "
                         f"{tuple(drive.shape)}")
    for name, t in (("consts", consts), ("state0", state0), ("drive", drive)):
        if not t.is_cuda:
            raise ValueError(f"compression_run: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != drive.dtype:
            raise TypeError(f"compression_run: {name} is {t.dtype}, the drive {drive.dtype}")
    if tuple(state0.shape) != (N_STATE,):
        raise ValueError(f"compression_run: state0 must be ({N_STATE},), got "
                         f"{tuple(state0.shape)}")


def _pointer(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(entry: str, consts, state0, drive, trace, grads=(None, None, None)) -> None:
    args = _Args(*(_pointer(t) for t in (consts, state0, drive, trace, *grads)),
                 n_steps=drive.shape[0])
    cb.launch(entry, ctypes.addressof(args))


class _CompressionRun(torch.autograd.Function):
    """Row P forward, row P's adjoint backward."""

    @staticmethod
    def forward(ctx, consts, state0, drive):
        trace = torch.empty((N_ROWS, drive.shape[0]), dtype=drive.dtype, device=drive.device)
        _launch(_ENTRIES[drive.dtype], consts, state0, drive, trace)
        cb.CALLS["compression_run"] += 1
        ctx.save_for_backward(consts, state0, drive, trace)
        return trace

    @staticmethod
    def backward(ctx, grad_trace):
        consts, state0, drive, trace = ctx.saved_tensors
        grad_drive, grad_state0 = torch.empty_like(drive), torch.empty_like(state0)
        _launch(_ADJOINT[drive.dtype], consts, state0, drive, trace,
                (grad_trace.contiguous(), grad_drive, grad_state0))
        cb.CALLS["compression_adjoint"] += 1
        return None, grad_state0, grad_drive


def compression_run(c: dict, state0: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """The trace (15, n_steps) of :func:`compression_run_plain`, in one
    launch on the card; a backward pass through it is one launch of the
    adjoint."""
    from scpn_fusion_tpu_torch.models.physics.pulsed_compression import CONSTANTS

    if not drive.is_cuda:
        return compression_run_plain(c, state0, drive)
    consts = torch.stack([c[name] for name in CONSTANTS])
    check_compression(consts, state0, drive)
    return _CompressionRun.apply(consts, state0.contiguous(), drive.contiguous())
