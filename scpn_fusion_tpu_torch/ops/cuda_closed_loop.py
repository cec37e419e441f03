"""The SCPN closed loop as a hand-written CUDA kernel (``csrc/closed_loop.cu``).

:func:`closed_loop` runs ``n_ticks`` of the SCPN controller tick plus the
reduced R/Z plant (``control/neuro_closed_loop.py``) in ONE launch (one
CTA; the tick loop inside the kernel), in float32 or float64, and adds one
to ``cb.CALLS["closed_loop"]``.  :func:`closed_loop_linear` runs the same
kernel against its second plant kind, the linear vertical plant of the
disturbance-rejection ladder (``control/disturbance_ladder.py``: one
observed axis z, one action u clipped to +-u_max, a disturbance a tick), and
counts under the same name.  The JAX package has no Pallas kernel here: its
``run_neuro_closed_loop`` and the ladder's ``run_snn`` are each one
``lax.scan`` of controller and plant inside one compiled program, and this
launch takes that program's place.

On a CPU tensor the wrappers run the kernel's plain versions, the per-tick
loops of the port's ``controller_step`` and the plant step
(:func:`closed_loop_plain`, :func:`closed_loop_linear_plain`; the linear
plant's 2x2 product spelled out elementwise, as the kernel rounds it).  On a
CUDA tensor they launch the kernel or raise; they raise on a configuration
that draws random numbers (a sampled firing vector or bit flips), which
``run_neuro_closed_loop`` keeps on the per-tick loop, and on a net too large
for one CTA.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_closed_loop_f32", torch.float64: "scpn_closed_loop_f64"}
MAX_THREADS = 1024
MAX_SMEM_BYTES = 227 * 1024
_MODES = {"fractional": 0, "binary_margin": 1, "binary": 2}


class _Args(ctypes.Structure):
    """``ClosedLoopArgs`` of ``csrc/closed_loop.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "w_in", "w_out", "thresholds", "delays", "axis_targets", "axis_scales", "inj_place",
        "inj_axis", "inj_is_pos", "inj_scale", "inj_offset", "act_pos", "act_neg", "act_gain",
        "act_abs_max", "act_slew", "marking", "pending", "cursor", "prev_actions", "plant",
        "trace_r", "trace_z", "trace_actions", "trace_firing", "lin_plant", "lin_d")] + [
        (name, ctypes.c_int) for name in (
            "n_p", "n_t", "n_i", "n_act", "n_slots", "n_ticks", "mode", "plant_kind")] + [
        (name, ctypes.c_double) for name in ("margin", "ctrl_dt", "plant_dt", "drift_r",
                                             "u_max")]


class LinearPlant(NamedTuple):
    """The ladder's linear vertical plant for :func:`closed_loop_linear`:
    ``matrices`` (8,) ``a00 a01 a10 a11 b0 b1 bd0 bd1``, ``d`` (n_ticks,) the
    disturbance of each tick, the Euler step ``dt`` and the command clip
    ``u_max``."""

    matrices: torch.Tensor
    d: torch.Tensor
    dt: float
    u_max: float


def firing_mode(cfg) -> tuple[str, float]:
    """The kernel's firing rule of a deterministic configuration and its margin."""
    if cfg.firing_mode == "fractional":
        return "fractional", max(cfg.firing_margin, 1e-12)
    if cfg.sc_binary_margin > 0.0:
        return "binary_margin", float(cfg.sc_binary_margin)
    return "binary", 0.0


def smem_bytes(n_p: int, n_t: int, n_slots: int, n_act: int, itemsize: int) -> int:
    return itemsize * (2 * n_t * n_p + n_p + n_t + n_slots * n_t + n_act)


def closed_loop_plain(ctrl, cfg, plant0, *, n_ticks: int, dt: float):
    """The per-tick loop the kernel replaces: (final controller state, final
    plant state, trace of r, z, actions and firing)."""
    from scpn_fusion_tpu_torch.control.neuro_closed_loop import ReducedPlantState, reduced_plant_step
    from scpn_fusion_tpu_torch.scpn.controller import controller_step, initial_controller_state

    cs, ps = initial_controller_state(ctrl, cfg), ReducedPlantState(*plant0)
    rows = []
    for k in range(n_ticks):
        cs, actions, diag = controller_step(ctrl, cfg, cs, torch.stack([ps.r, ps.z]), k)
        ps, _ = reduced_plant_step(ps, actions, dt)
        rows.append((ps.r, ps.z, actions, diag["firing"]))
    r, z, actions, firing = (torch.stack(col) for col in zip(*rows))
    return cs, ps, {"r": r, "z": z, "actions": actions, "firing": firing}


def check_closed_loop(ctrl, cfg, plant0, n_ticks: int, linear: LinearPlant | None = None) -> None:
    """Raise unless the kernel takes this controller, configuration and plant
    (the reduced plant, or with ``linear`` the linear one)."""
    from scpn_fusion_tpu_torch.scpn.controller import needs_draws

    if needs_draws(cfg):
        raise ValueError("closed_loop: the kernel runs deterministic configurations only "
                         "(no sampled firing, no bit flips); this one draws random numbers")
    dtype = ctrl.w_in.dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"closed_loop: float32 or float64, got {dtype}")
    n_t, n_p = ctrl.w_in.shape
    n_act = ctrl.act_gain.shape[0]
    if linear is not None:
        if ctrl.axis_targets.shape != (1,) or ctrl.axis_scales.shape != (1,) or n_act != 1:
            raise ValueError("closed_loop: the linear plant observes z and takes one action")
        if linear.matrices.shape != (8,) or linear.d.shape != (n_ticks,):
            raise ValueError("closed_loop: the linear plant takes 8 coefficients and a "
                             "disturbance a tick")
        if not (linear.matrices.is_contiguous() and linear.d.is_contiguous()):
            raise ValueError("closed_loop: the linear plant's tensors must be contiguous")
    else:
        if ctrl.axis_targets.shape != (2,) or ctrl.axis_scales.shape != (2,):
            raise ValueError("closed_loop: the reduced plant observes (r, z): two feature axes")
        if n_act < 2:
            raise ValueError("closed_loop: the reduced plant takes actions 0 and 1")
    tensors = {**ctrl._asdict(), "r": plant0[0], "z": plant0[1]}
    if linear is not None:
        tensors.update(matrices=linear.matrices, d=linear.d)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"closed_loop: {name} must be a CUDA tensor, got {t.device}")
        if t.is_floating_point() and t.dtype != dtype:
            raise TypeError(f"closed_loop: {name} is {t.dtype}, the net is {dtype}")
    if max(n_p, n_t, ctrl.inj_place_ids.shape[0], n_act) > MAX_THREADS:
        raise ValueError(f"closed_loop: more than {MAX_THREADS} places, transitions, "
                         "injections or actions")
    smem = smem_bytes(n_p, n_t, cfg.max_delay_ticks + 1, n_act, ctrl.w_in.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"closed_loop: the net needs {smem} bytes of shared memory "
                         f"(at most {MAX_SMEM_BYTES})")
    if n_ticks < 1:
        raise ValueError("closed_loop: n_ticks must be >= 1")


def launch_args(ctrl, cfg, plant0, *, n_ticks: int, dt: float,
                linear: LinearPlant | None = None):
    """The kernel's argument block, its outputs and its thread count: (args,
    (marking, pending, cursor, prev_actions, plant), trace, threads).  The
    outputs start as the initial controller state and ``plant0``; the
    tensors stay on ``ctrl``'s device (only the pointers go to the kernel).
    With ``linear`` the plant is the linear one (``plant0`` its (z, dz/dt))
    and the trace's r and z hold the z seen and the clipped command u."""
    from scpn_fusion_tpu_torch.scpn.controller import initial_controller_state

    ctrl = type(ctrl)(*(t.contiguous() for t in ctrl))
    s0 = initial_controller_state(ctrl, cfg)
    state = (s0.marking.clone(), s0.pending.clone(), s0.cursor.clone(), s0.prev_actions.clone(),
             torch.stack([plant0[0], plant0[1]]).contiguous())
    n_t, n_p = ctrl.w_in.shape
    n_i, n_act = ctrl.inj_place_ids.shape[0], ctrl.act_gain.shape[0]
    dev, dtype = ctrl.w_in.device, ctrl.w_in.dtype
    trace = {"r": torch.empty(n_ticks, dtype=dtype, device=dev),
             "z": torch.empty(n_ticks, dtype=dtype, device=dev),
             "actions": torch.empty((n_ticks, n_act), dtype=dtype, device=dev),
             "firing": torch.empty((n_ticks, n_t), dtype=dtype, device=dev)}
    mode, margin = firing_mode(cfg)
    ptr = {name: t.data_ptr() for name, t in ctrl._asdict().items()}
    ptr.update(zip(("marking", "pending", "cursor", "prev_actions", "plant"),
                   (t.data_ptr() for t in state)))
    ptr.update({f"trace_{key}": t.data_ptr() for key, t in trace.items()})
    renamed = {"inj_place": "inj_place_ids", "inj_axis": "inj_axis_idx",
               "act_slew": "act_slew_per_s"}
    if linear is not None:
        ptr.update(lin_plant=linear.matrices.data_ptr(), lin_d=linear.d.data_ptr())
    else:
        ptr.update(lin_plant=None, lin_d=None)
    pointers = {name: ptr[renamed.get(name, name)] for name, _ in _Args._fields_[:27]}
    args = _Args(**pointers, n_p=n_p, n_t=n_t, n_i=n_i, n_act=n_act,
                 n_slots=cfg.max_delay_ticks + 1, n_ticks=n_ticks, mode=_MODES[mode],
                 plant_kind=int(linear is not None), margin=margin, ctrl_dt=cfg.dt,
                 plant_dt=linear.dt if linear is not None else dt,
                 drift_r=0.01,     # reduced_plant_step's 0.01 * beta at its beta = 1
                 u_max=linear.u_max if linear is not None else 0.0)
    threads = min(MAX_THREADS, 32 * ((max(n_p, n_t, n_i, n_act) + 31) // 32))
    return args, state, trace, threads


def closed_loop(ctrl, cfg, plant0, *, n_ticks: int, dt: float):
    """``n_ticks`` of controller + reduced plant from the initial controller
    state and ``plant0`` (r, z): (final controller state, final plant state,
    trace of r (n,), z (n,), actions (n, nAct) and firing (n, nT))."""
    if not ctrl.w_in.is_cuda:
        return closed_loop_plain(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt)
    from scpn_fusion_tpu_torch.control.neuro_closed_loop import ReducedPlantState
    from scpn_fusion_tpu_torch.scpn.controller import ControllerState

    check_closed_loop(ctrl, cfg, plant0, n_ticks)
    args, state, trace, threads = launch_args(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt)
    cb.launch(_ENTRIES[ctrl.w_in.dtype], ctypes.addressof(args), threads)
    cb.CALLS["closed_loop"] += 1
    *controller, plant = state
    return ControllerState(*controller), ReducedPlantState(plant[0], plant[1]), trace


def closed_loop_linear_plain(ctrl, cfg, x0, plant: LinearPlant):
    """The per-tick loop :func:`closed_loop_linear` replaces: (final
    controller state, final plant state (2,), trace of the z seen (n,), the
    clipped command u (n,), actions (n, 1) and firing (n, nT))."""
    from scpn_fusion_tpu_torch.scpn.controller import controller_step, initial_controller_state

    a00, a01, a10, a11, b0, b1, bd0, bd1 = plant.matrices
    cs, z, v = initial_controller_state(ctrl, cfg), x0[0], x0[1]
    rows = []
    for k in range(plant.d.shape[0]):
        cs, actions, diag = controller_step(ctrl, cfg, cs, z.reshape(1), k)
        u = torch.clamp(actions[0], -plant.u_max, plant.u_max)
        dk = plant.d[k]
        dz = a00 * z + a01 * v + b0 * u + bd0 * dk
        dv = a10 * z + a11 * v + b1 * u + bd1 * dk
        rows.append((z, u, actions, diag["firing"]))
        z, v = z + plant.dt * dz, v + plant.dt * dv
    zs, us, actions, firing = (torch.stack(col) for col in zip(*rows))
    return cs, torch.stack([z, v]), {"z": zs, "u": us, "actions": actions, "firing": firing}


def closed_loop_linear(ctrl, cfg, x0, plant: LinearPlant):
    """``len(plant.d)`` ticks of controller + linear plant from the initial
    controller state and ``x0`` (z, dz/dt): as :func:`closed_loop_linear_plain`."""
    if not ctrl.w_in.is_cuda:
        return closed_loop_linear_plain(ctrl, cfg, x0, plant)
    from scpn_fusion_tpu_torch.scpn.controller import ControllerState

    n_ticks = plant.d.shape[0]
    check_closed_loop(ctrl, cfg, (x0[0], x0[1]), n_ticks, plant)
    args, state, trace, threads = launch_args(ctrl, cfg, (x0[0], x0[1]), n_ticks=n_ticks,
                                              dt=plant.dt, linear=plant)
    cb.launch(_ENTRIES[ctrl.w_in.dtype], ctypes.addressof(args), threads)
    cb.CALLS["closed_loop"] += 1
    *controller, final = state
    return ControllerState(*controller), final, {
        "z": trace["r"], "u": trace["z"], "actions": trace["actions"],
        "firing": trace["firing"]}
