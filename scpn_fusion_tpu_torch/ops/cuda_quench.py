"""The HTS quench transient as a hand-written CUDA kernel (``csrc/quench.cu``;
row H).

:func:`quench_run` integrates every step of a REBCO quench transient -- the
loop of the JAX package's ``simulate_quench_transient``
(``models/engineering/hts_quench.py:138-166``) -- in ONE launch of one
thread, returns the five traces (t, current, hotspot, normal zone, terminal
voltage), each (n_steps,), and adds one to ``cb.CALLS["quench_run"]``.  The
JAX package has no Pallas kernel here: its transient is one ``lax.scan`` in
one compiled program, and this launch takes that program's place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`quench_run_plain`, the loop of the port's ``hts_quench.quench_step``.
On a CUDA tensor it launches the kernel or raises, and an input that
requires a gradient raises (the kernel has no backward, and needs none: no
JAX caller differentiates a transient).
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_quench_run_f32", torch.float64: "scpn_quench_run_f64"}
TRACES = ("t", "current_a", "hotspot_k", "normal_zone_m", "terminal_voltage_v")
# the numbers of ``hts_quench.quench_values``, in the order of ``QuenchArgs``
VALUES = ("dt", "t_detect", "z0", "v_nz", "rho", "slope", "t_op", "area", "r_dump",
          "inductance", "h_pw", "t_cool", "cap", "cap_floor", "t_max", "i0", "temp0")


class _Args(ctypes.Structure):
    """``QuenchArgs`` of ``csrc/quench.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in TRACES] + [("n_steps", ctypes.c_int)]
                + [(name, ctypes.c_double) for name in VALUES])


def quench_run_plain(c: dict, n_steps: int):
    """The step loop the kernel replaces: the five traces (n_steps,) from the
    step constants ``c`` (``hts_quench.step_constants``)."""
    from scpn_fusion_tpu_torch.models.engineering.hts_quench import quench_step, step_times

    carry, rows = (c["i0"], c["temp0"]), []
    for t in step_times(c, n_steps):
        carry, row = quench_step(c, carry, t)
        rows.append(row)
    return tuple(torch.stack(col) for col in zip(*rows))


def check_inputs(c: dict) -> None:
    """Raise unless row H takes these step constants: none requires a
    gradient, all float32 or float64 CUDA tensors of one dtype."""
    for name, t in c.items():
        if t.requires_grad:
            raise RuntimeError(f"quench_run: row H has no backward; {name} requires a gradient")
    dtype = c["dt"].dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"quench_run: float32 or float64, got {dtype}")
    for name, t in c.items():
        if not t.is_cuda:
            raise ValueError(f"quench_run: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"quench_run: {name} is {t.dtype}, dt {dtype}")


def launch_args(values: dict, dtype: torch.dtype, device, n_steps: int):
    """The kernel's argument block and its five trace tensors (n_steps,)."""
    traces = tuple(torch.empty(n_steps, dtype=dtype, device=device) for _ in TRACES)
    args = _Args(*(t.data_ptr() for t in traces), n_steps,
                 *(float(values[name]) for name in VALUES))
    return args, traces


def quench_run(values: dict, c: dict, n_steps: int):
    """The five traces of the transient with the numbers ``values``
    (``hts_quench.quench_values``) and their 0-d tensors ``c``: as
    :func:`quench_run_plain`, in one launch of one thread on the card."""
    if not c["dt"].is_cuda:
        return quench_run_plain(c, n_steps)
    check_inputs(c)
    args, traces = launch_args(values, c["dt"].dtype, c["dt"].device, n_steps)
    if n_steps > 0:
        cb.launch(_ENTRIES[c["dt"].dtype], ctypes.addressof(args))
        cb.CALLS["quench_run"] += 1
    return traces
