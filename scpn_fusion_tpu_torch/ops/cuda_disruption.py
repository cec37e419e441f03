"""The staged disruption sequence as a hand-written CUDA kernel
(``csrc/disruption.cu``; row Q).

:func:`disruption_sequence` runs every tick of every sequence of a call --
thermal quench, Spitzer current quench, avalanche and halo, the loop of the
JAX package's ``run_disruption_sequence`` (``models/physics/
disruption_sequence.py:93-135``) -- in ONE launch, one thread a sequence,
and returns the six traces of each, (n_seq, n_steps).  It adds one to
``cb.CALLS["disruption_sequence"]``.  The JAX package has no Pallas kernel
here: its sequence is one ``lax.scan`` (``vmap``ped over SPI inventories by
``spi_mitigation_scan``) in one compiled program, and this launch takes that
program's place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`disruption_sequence_plain`, the loop of the port's
``disruption_step`` over the ticks with the sequences as one batch.  On a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_disruption_f32", torch.float64: "scpn_disruption_f64"}
TRACES = ("t_ms", "te_ev", "ip_ma", "i_re_ma", "e_par", "halo_ma")


class _Args(ctypes.Structure):
    """``DisruptionArgs`` of ``csrc/disruption.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in ("spi_ne20", *TRACES)]
                + [(name, ctypes.c_int) for name in ("n_seq", "n_steps")]
                + [(name, ctypes.c_double) for name in (
                    "dt_ms", "dt", "te_post", "te_span", "tau_tq", "ne0", "spi_time_ms",
                    "c_eta", "pow_exp", "pi", "r0", "area", "two_pi_r0", "l_p", "mec_lnl",
                    "e_charge", "seed", "te_hot", "halo_max", "ip0_a", "mega", "te_init",
                    "ip_init")])


def disruption_sequence_plain(p, spi_ne20: torch.Tensor, spi_time_ms: float):
    """The tick loop the kernel replaces: the six traces (n_seq, n_steps)
    of the sequences with injected densities ``spi_ne20`` (n_seq,)."""
    from scpn_fusion_tpu_torch.models.physics.disruption_sequence import (
        disruption_step, initial_carry, step_constants, tick_times,
    )

    dtype, dev, n_seq = spi_ne20.dtype, spi_ne20.device, spi_ne20.shape[0]
    c = step_constants(p, dtype, dev)
    carry, rows = initial_carry(p, n_seq, dtype, dev), []
    for t in tick_times(p, dtype, dev):
        carry, row = disruption_step(p, c, carry, t, spi_ne20, spi_time_ms)
        rows.append(row)
    return tuple(torch.stack(col, dim=-1).expand(n_seq, -1).contiguous() for col in zip(*rows))


def check_disruption(p, spi_ne20: torch.Tensor) -> None:
    """Raise unless the kernel takes these parameters and this tensor."""
    if spi_ne20.dtype not in _ENTRIES:
        raise TypeError(f"disruption_sequence: float32 or float64, got {spi_ne20.dtype}")
    if not spi_ne20.is_cuda:
        raise ValueError(f"disruption_sequence: spi_ne20 must be a CUDA tensor, got "
                         f"{spi_ne20.device}")
    if spi_ne20.dim() != 1 or not spi_ne20.is_contiguous():
        raise ValueError(f"disruption_sequence: spi_ne20 must be one contiguous (n_seq,), got "
                         f"{tuple(spi_ne20.shape)}")
    if p.n_steps < 1:
        raise ValueError("disruption_sequence: n_steps must be >= 1")


def launch_args(p, spi_ne20: torch.Tensor, spi_time_ms: float):
    """The kernel's argument block and its six trace tensors (n_seq, n_steps),
    on ``spi_ne20``'s device."""
    from scpn_fusion_tpu_torch.models.physics import disruption_sequence as ds

    n_seq = spi_ne20.shape[0]
    traces = tuple(torch.empty((n_seq, p.n_steps), dtype=spi_ne20.dtype,
                               device=spi_ne20.device) for _ in TRACES)
    dt = p.dt_ms * 1e-3
    args = _Args(spi_ne20.data_ptr(), *(t.data_ptr() for t in traces),
                 n_seq=n_seq, n_steps=p.n_steps, dt_ms=p.dt_ms, dt=dt,
                 te_post=p.te_post_tq_ev, te_span=p.te0_kev * 1e3 - p.te_post_tq_ev,
                 tau_tq=p.tau_tq_ms, ne0=p.ne20, spi_time_ms=spi_time_ms,
                 c_eta=5.2e-5 * ds.Z_EFF * ds.LN_LAMBDA, pow_exp=1.5, pi=math.pi, r0=p.r0_m,
                 area=math.pi * p.a_m ** 2 * p.kappa, two_pi_r0=2.0 * math.pi * p.r0_m,
                 l_p=p.l_plasma_uh * 1e-6, mec_lnl=ds.M_E * ds.C_LIGHT * ds.LN_LAMBDA,
                 e_charge=ds.E_CHARGE,
                 seed=p.re_seed_fraction * p.ip0_ma * 1e6 / (p.n_steps * dt),
                 te_hot=ds.TE_HOT_EV, halo_max=p.halo_fraction_max, ip0_a=p.ip0_ma * 1e6,
                 mega=1e6, te_init=p.te0_kev * 1e3, ip_init=p.ip0_ma * 1e6)
    return args, traces


def disruption_sequence(p, spi_ne20: torch.Tensor, spi_time_ms: float):
    """The six traces (t_ms, te_ev, ip_ma, i_re_ma, e_par, halo_ma), each
    (n_seq, n_steps), of the sequences with injected densities ``spi_ne20``
    (n_seq,) delivered at ``spi_time_ms``: as
    :func:`disruption_sequence_plain`, in one launch on the card."""
    if not spi_ne20.is_cuda:
        return disruption_sequence_plain(p, spi_ne20, spi_time_ms)
    check_disruption(p, spi_ne20)
    args, traces = launch_args(p, spi_ne20, spi_time_ms)
    if spi_ne20.shape[0] > 0:
        cb.launch(_ENTRIES[spi_ne20.dtype], ctypes.addressof(args))
        cb.CALLS["disruption_sequence"] += 1
    return traces
