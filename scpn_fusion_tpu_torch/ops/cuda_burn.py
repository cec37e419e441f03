"""The 0-D burn relaxation as a hand-written CUDA kernel (``csrc/burn.cu``;
row E).

:func:`burn_relax` runs every iteration of the damped temperature
relaxation of ``burn_equilibrium_0d`` (the JAX package's
``models/physics/scaling_burn.py:96-114``) for every design point of a call
in ONE launch, one thread a point, and adds one to
``cb.CALLS["burn_relax"]``.  The JAX package has no Pallas kernel here: its
relaxation is a ``lax.fori_loop`` in one compiled program (``vmap``ped over
designs by ``design_scan.scan_designs``), and this launch takes that
program's place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`burn_relax_plain`, the loop of the port's ``scaling_burn.balance``
with the points as one batch; it keeps autograd.  On a CUDA tensor it
launches the kernel or raises, and an input that requires a gradient raises
(the kernel has no backward, and needs none: no JAX caller differentiates a
burn point).
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_burn_relax_f32", torch.float64: "scpn_burn_relax_f64"}
# the per-point inputs, in the order of ``csrc/burn.cu``'s ``BurnArgs``
POINT = ("p_aux_mw", "nd2", "volume", "tau_pre", "r_f", "k_f", "e_f", "w_coeff")
THREADS = 64   # a CTA: compact_reactor_search's 4096 designs on 64 SMs


class _Args(ctypes.Structure):
    """``BurnArgs`` of ``csrc/burn.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "p_aux", "nd2", "volume", "tau_pre", "r_f", "k_f", "e_f", "w_coeff", "t_final")]
        + [(name, ctypes.c_int) for name in ("n", "n_iter")]
        + [(name, ctypes.c_double) for name in (
            "t_init", "f_profile", "fus_const", "m_f", "e_ploss", "third", "bg2", "mrc2", "c1",
            "c2", "c3", "c4", "c5", "c6", "c7", "sv_scale", "five", "relax")])


def burn_relax_plain(k, t_init_kev: float, n_iter: int) -> torch.Tensor:
    """The loop the kernel replaces: ``n_iter`` damped steps of the
    temperature of every point of ``k`` (``scaling_burn.BurnConstants``)
    toward ``scaling_burn.balance``'s, from ``t_init_kev``."""
    from scpn_fusion_tpu_torch.models.physics.scaling_burn import RELAX, balance

    t = torch.as_tensor(t_init_kev, dtype=k.nd2.dtype, device=k.nd2.device)
    for _ in range(n_iter):
        t = t + RELAX * (balance(k, t)[3] - t)
    return t


def check_inputs(k) -> None:
    """Raise unless row E takes these constants: none requires a gradient,
    every per-point tensor is a float32 or float64 CUDA tensor of one dtype."""
    tensors = [(name, getattr(k, name)) for name in POINT]
    for name, t in tensors:
        if t.requires_grad:
            raise RuntimeError(f"burn_relax: row E has no backward; {name} requires a gradient")
    dtype = k.nd2.dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"burn_relax: float32 or float64, got {dtype}")
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"burn_relax: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"burn_relax: {name} is {t.dtype}, the points {dtype}")


def launch_args(k, t_init_kev: float, n_iter: int):
    """The kernel's argument block, the (n,) inputs it points to (keep them
    alive until the launch returns) and the (n,) output."""
    from scpn_fusion_tpu_torch.models.physics import scaling_burn as sb
    from scpn_fusion_tpu_torch.models.transport.closures import BOSCH_HALE_DT

    shape = k.nd2.shape
    inputs = [getattr(k, name).expand(shape).reshape(-1).contiguous() for name in POINT]
    n = inputs[0].numel()
    t_final = torch.empty(n, dtype=k.nd2.dtype, device=k.nd2.device)
    args = _Args(*(t.data_ptr() for t in inputs), t_final.data_ptr(), n=n, n_iter=n_iter,
                 t_init=float(t_init_kev), f_profile=k.f_profile, fus_const=sb.FUS_CONST_MW,
                 m_f=sb.M_AMU_FACTOR, e_ploss=sb.IPB98Y2_EXP["ploss_mw"], third=1.0 / 3.0,
                 sv_scale=1e-6, five=5.0, relax=sb.RELAX, **BOSCH_HALE_DT)
    return args, inputs, t_final


def burn_relax(k, t_init_kev: float, n_iter: int) -> torch.Tensor:
    """The relaxed temperature of every point of ``k``: as
    :func:`burn_relax_plain`, in one launch on the card."""
    if not k.nd2.is_cuda:
        return burn_relax_plain(k, t_init_kev, n_iter)
    check_inputs(k)
    args, inputs, t_final = launch_args(k, t_init_kev, n_iter)
    if t_final.numel() > 0:
        cb.launch(_ENTRIES[t_final.dtype], ctypes.addressof(args))
        cb.CALLS["burn_relax"] += 1
    return t_final.reshape(k.nd2.shape)
