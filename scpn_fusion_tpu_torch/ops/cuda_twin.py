"""The digital twin's shot as a hand-written CUDA kernel (``csrc/digital_twin.cu``).

:func:`twin_shot` runs every step of ``control/digital_twin.run_digital_twin``
-- the MRE island widths, the q-profile under the step's current-drive
action, the danger map and the 2D diffusion-reaction field -- in ONE launch
(one CTA; the step loop inside the kernel, the field double-buffered in
shared memory), in float32 or float64, and adds one to
``cb.CALLS["twin_shot"]``.  The JAX package has no Pallas kernel here: its
shot is one ``lax.scan`` of ``twin_step`` inside one compiled program, and
this launch takes that program's place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`twin_shot_plain`, the loop of the port's ``twin_step``.  On a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_twin_shot_f32", torch.float64: "scpn_twin_shot_f64"}
MAX_THREADS = 1024
MAX_SMEM_BYTES = 227 * 1024


class _Args(ctypes.Structure):
    """``TwinArgs`` of ``csrc/digital_twin.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "r_map", "mask", "actions", "t_field", "widths", "trace_core", "trace_widths",
        "trace_frac")] + [(name, ctypes.c_int) for name in ("n", "n_steps")]
        + [(name, ctypes.c_double) for name in (
            "q0", "qa", "mre_dt_eta", "beta_p", "w_crit_sq", "d_base", "d_turb", "core_heat",
            "edge_sink")] + [("res", ctypes.c_double * 4)])


def twin_shot_plain(cfg, r_map, mask, state0, actions):
    """The step loop the kernel replaces: (final ``TwinState``, (t_core
    (n_steps,), island widths (n_steps, 4), danger fraction (n_steps,)))."""
    from scpn_fusion_tpu_torch.control.digital_twin import twin_step

    state, rows = state0, []
    for k in range(actions.shape[0]):
        state, row = twin_step(cfg, r_map, mask, state, actions[k])
        rows.append(row)
    return state, tuple(torch.stack(col) for col in zip(*rows))


def check_twin_shot(cfg, r_map, mask, state0, actions) -> None:
    """Raise unless the kernel takes this configuration and these tensors."""
    from scpn_fusion_tpu_torch.control.digital_twin import RESONANCES

    dtype, n = r_map.dtype, cfg.grid_size
    if dtype not in _ENTRIES:
        raise TypeError(f"twin_shot: float32 or float64, got {dtype}")
    if len(RESONANCES) != 4:
        raise ValueError("twin_shot: the kernel holds four rational surfaces")
    shapes = {"r_map": (n, n), "mask": (n, n), "t_field": (n, n), "island_widths": (4,),
              "actions": (actions.shape[0],)}
    tensors = {"r_map": r_map, "mask": mask, "t_field": state0.t_field,
               "island_widths": state0.island_widths, "actions": actions}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"twin_shot: {name} must be a CUDA tensor, got {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"twin_shot: {name} has shape {tuple(t.shape)}, not {shapes[name]}")
        if name == "mask" and t.dtype != torch.bool:
            raise TypeError(f"twin_shot: the mask must be bool, got {t.dtype}")
        if name != "mask" and t.dtype != dtype:
            raise TypeError(f"twin_shot: {name} is {t.dtype}, the geometry is {dtype}")
    smem = 2 * n * n * r_map.element_size()
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"twin_shot: a {n}^2 field needs {smem} bytes of shared memory "
                         f"(at most {MAX_SMEM_BYTES})")
    if actions.shape[0] < 1:
        raise ValueError("twin_shot: n_steps must be >= 1")


def launch_args(cfg, r_map, mask, state0, actions):
    """The kernel's argument block, its outputs and its thread count: (args,
    (t_field, widths), (t_core, widths, fraction), threads).  The outputs
    start as ``state0``; the tensors stay on ``r_map``'s device."""
    from scpn_fusion_tpu_torch.control.digital_twin import RESONANCES

    n, n_steps = cfg.grid_size, actions.shape[0]
    dev, dtype = r_map.device, r_map.dtype
    inputs = [t.contiguous() for t in (r_map, mask, actions)]
    state = (state0.t_field.clone().contiguous(), state0.island_widths.clone().contiguous())
    trace = (torch.empty(n_steps, dtype=dtype, device=dev),
             torch.empty((n_steps, 4), dtype=dtype, device=dev),
             torch.empty(n_steps, dtype=dtype, device=dev))
    ptrs = [t.data_ptr() for t in (*inputs, *state, *trace)]
    args = _Args(*ptrs, n=n, n_steps=n_steps, q0=cfg.q0, qa=cfg.qa,
                 mre_dt_eta=cfg.dt_island * cfg.eta, beta_p=cfg.beta_p,
                 w_crit_sq=cfg.w_crit**2, d_base=cfg.d_base, d_turb=cfg.d_turb,
                 core_heat=cfg.core_heat, edge_sink=cfg.edge_sink,
                 res=(ctypes.c_double * 4)(*RESONANCES))
    threads = min(MAX_THREADS, 32 * ((n * n + 31) // 32))
    return args, state, trace, threads


def twin_shot(cfg, r_map, mask, state0, actions):
    """Every step of the twin from ``state0`` under ``actions`` (n_steps,):
    as :func:`twin_shot_plain`, in one launch on the card."""
    if not r_map.is_cuda:
        return twin_shot_plain(cfg, r_map, mask, state0, actions)
    from scpn_fusion_tpu_torch.control.digital_twin import TwinState

    check_twin_shot(cfg, r_map, mask, state0, actions)
    args, state, trace, threads = launch_args(cfg, r_map, mask, state0, actions)
    cb.launch(_ENTRIES[r_map.dtype], ctypes.addressof(args), threads)
    cb.CALLS["twin_shot"] += 1
    return TwinState(*state), trace
