"""The SCPN closed loop as a hand-written CUDA kernel (``csrc/closed_loop.cu``).

:func:`closed_loop` runs ``n_ticks`` of the SCPN controller tick plus the
reduced R/Z plant (``control/neuro_closed_loop.py``) in ONE launch (one
CTA; the tick loop inside the kernel), in float32 or float64, and adds one
to ``cb.CALLS["closed_loop"]``.  :func:`closed_loop_linear` runs the same
kernel against its second plant kind, the linear vertical plant of the
disturbance-rejection ladder (``control/disturbance_ladder.py``: one
observed axis z, one action u clipped to +-u_max, a disturbance a tick), and
counts under the same name.  :func:`closed_loop_fueling` (plant kind 2) runs
the 0-D density model of ``control/fueling_torax.run_fueling_mode`` and
:func:`closed_loop_torax` (plant kind 3) every episode of
``run_torax_hybrid_campaign``, one CTA an episode, in one launch; both count
under the same name too.  The JAX package has no Pallas kernel here: its
``run_neuro_closed_loop``, the ladder's ``run_snn``, the fueling shot and the
campaign are each one ``lax.scan`` of controller and plant inside one
compiled program (the campaign ``vmap``s its episodes), and each launch
takes that program's place.

On a CPU tensor the wrappers run the kernel's plain versions, the per-tick
loops of the port's ``controller_step`` and the plant step
(:func:`closed_loop_plain`, :func:`closed_loop_linear_plain`; the linear
plant's 2x2 product spelled out elementwise, as the kernel rounds it;
:func:`closed_loop_fueling_plain` and :func:`closed_loop_torax_plain` loop
``fueling_torax.fueling_step`` and ``torax_step``, the campaign's episodes
as one ``torch.func.vmap`` batch).  On a
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
LEAK = 1.15     # the fueling plant's leak rate and fueling gain (run_fueling_mode)


class _Args(ctypes.Structure):
    """``ClosedLoopArgs`` of ``csrc/closed_loop.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "w_in", "w_out", "thresholds", "delays", "axis_targets", "axis_scales", "inj_place",
        "inj_axis", "inj_is_pos", "inj_scale", "inj_offset", "act_pos", "act_neg", "act_gain",
        "act_abs_max", "act_slew", "marking", "pending", "cursor", "prev_actions", "plant",
        "trace_r", "trace_z", "trace_actions", "trace_firing", "lin_plant", "lin_d", "noise",
        "trace_c")] + [
        (name, ctypes.c_int) for name in (
            "n_p", "n_t", "n_i", "n_act", "n_slots", "n_ticks", "mode", "plant_kind",
            "n_shots")] + [
        (name, ctypes.c_double) for name in ("margin", "ctrl_dt", "plant_dt", "drift_r",
                                             "u_max", "target", "baseline")]
_POINTERS = 29      # the pointer fields lead the block


class FuelingPlant(NamedTuple):
    """The 0-D density model of ``run_fueling_mode`` for
    :func:`closed_loop_fueling`: the density setpoint, the start density
    and the step ``dt`` (leak and fueling gain 1.15, commands in [-2, 2])."""

    target: float
    density0: float
    dt: float


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


def check_closed_loop(ctrl, cfg, plant0, n_ticks: int, linear: LinearPlant | None = None,
                      *, kind: int | None = None, inputs: dict | None = None) -> None:
    """Raise unless the kernel takes this controller, configuration and plant
    (the reduced plant, with ``linear`` the linear one, or plant kind
    ``kind`` 2 or 3 with its per-tick ``inputs``)."""
    from scpn_fusion_tpu_torch.scpn.controller import needs_draws

    if kind is None:
        kind = int(linear is not None)
    if needs_draws(cfg):
        raise ValueError("closed_loop: the kernel runs deterministic configurations only "
                         "(no sampled firing, no bit flips); this one draws random numbers")
    dtype = ctrl.w_in.dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"closed_loop: float32 or float64, got {dtype}")
    n_t, n_p = ctrl.w_in.shape
    n_act = ctrl.act_gain.shape[0]
    tensors = {**ctrl._asdict(), **{f"plant[{i}]": t for i, t in enumerate(plant0)}}
    if kind in (1, 2, 3):
        if ctrl.axis_targets.shape != (1,) or ctrl.axis_scales.shape != (1,) or n_act != 1:
            raise ValueError("closed_loop: this plant feeds one axis and takes one action")
    if kind == 1:
        if linear.matrices.shape != (8,) or linear.d.shape != (n_ticks,):
            raise ValueError("closed_loop: the linear plant takes 8 coefficients and a "
                             "disturbance a tick")
        tensors.update(matrices=linear.matrices, d=linear.d)
    elif kind == 3:
        n_shots = plant0[0].shape[0] if plant0[0].dim() else 0
        if inputs["d"].shape != (n_shots, n_ticks) or inputs["noise"].shape != (
                n_shots, n_ticks, 2) or n_shots < 1:
            raise ValueError("closed_loop: the TORAX-style plant takes (episodes, ticks) "
                             "disturbances and (episodes, ticks, 2) normals")
        tensors.update(inputs)
    elif kind == 0:
        if ctrl.axis_targets.shape != (2,) or ctrl.axis_scales.shape != (2,):
            raise ValueError("closed_loop: the reduced plant observes (r, z): two feature axes")
        if n_act < 2:
            raise ValueError("closed_loop: the reduced plant takes actions 0 and 1")
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"closed_loop: {name} must be a CUDA tensor, got {t.device}")
        if t.is_floating_point() and t.dtype != dtype:
            raise TypeError(f"closed_loop: {name} is {t.dtype}, the net is {dtype}")
        if name in ("matrices", "d", "noise") and not t.is_contiguous():
            raise ValueError(f"closed_loop: the plant's {name} must be contiguous")
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
                linear: LinearPlant | None = None, kind: int | None = None,
                inputs: dict | None = None, target: float = 0.0, baseline: float = 0.0):
    """The kernel's argument block, its outputs and its thread count: (args,
    (marking, pending, cursor, prev_actions, plant), trace, threads).  The
    outputs start as the initial controller state and ``plant0``; the
    tensors stay on ``ctrl``'s device (only the pointers go to the kernel).
    With ``linear`` the plant is the linear one (``plant0`` its (z, dz/dt))
    and the trace's r and z hold the z seen and the clipped command u.  Plant
    ``kind`` 2 (fueling: ``plant0`` (density, integral)) and 3 (TORAX-style:
    ``plant0`` (beta_N, q95, li3, W_th), each of shape (episodes,), and
    ``inputs`` the disturbance ``d`` and the normals ``noise``) add the
    trace ``c``; kind 3 gives every output a leading episode axis."""
    from scpn_fusion_tpu_torch.scpn.controller import initial_controller_state

    if kind is None:
        kind = int(linear is not None)
    ctrl = type(ctrl)(*(t.contiguous() for t in ctrl))
    s0 = initial_controller_state(ctrl, cfg)
    plant = torch.stack(list(plant0), dim=-1).contiguous()
    batch = tuple(plant.shape[:-1])
    # fresh tensors: the kernel writes the final state into them
    state = (*(t.new_empty((*batch, *t.shape)).copy_(t) for t in s0), plant)
    n_t, n_p = ctrl.w_in.shape
    n_i, n_act = ctrl.inj_place_ids.shape[0], ctrl.act_gain.shape[0]
    dev, dtype = ctrl.w_in.device, ctrl.w_in.dtype

    def empty(*shape):
        return torch.empty((*batch, n_ticks, *shape), dtype=dtype, device=dev)

    trace = {"r": empty(), "z": empty(), "actions": empty(n_act), "firing": empty(n_t)}
    if kind >= 2:
        trace["c"] = empty()
    mode, margin = firing_mode(cfg)
    ptr = {name: t.data_ptr() for name, t in ctrl._asdict().items()}
    ptr.update(zip(("marking", "pending", "cursor", "prev_actions", "plant"),
                   (t.data_ptr() for t in state)))
    ptr.update({f"trace_{key}": t.data_ptr() for key, t in trace.items()})
    ptr.setdefault("trace_c", None)
    renamed = {"inj_place": "inj_place_ids", "inj_axis": "inj_axis_idx",
               "act_slew": "act_slew_per_s"}
    ptr.update(lin_plant=None, lin_d=None, noise=None)
    if kind == 1:
        ptr.update(lin_plant=linear.matrices.data_ptr(), lin_d=linear.d.data_ptr())
    elif kind == 3:
        ptr.update(lin_d=inputs["d"].data_ptr(), noise=inputs["noise"].data_ptr())
    pointers = {name: ptr[renamed.get(name, name)] for name, _ in _Args._fields_[:_POINTERS]}
    args = _Args(**pointers, n_p=n_p, n_t=n_t, n_i=n_i, n_act=n_act,
                 n_slots=cfg.max_delay_ticks + 1, n_ticks=n_ticks, mode=_MODES[mode],
                 plant_kind=kind, n_shots=batch[0] if batch else 1, margin=margin,
                 ctrl_dt=cfg.dt, plant_dt=linear.dt if kind == 1 else dt,
                 drift_r=0.01,     # reduced_plant_step's 0.01 * beta at its beta = 1
                 u_max=linear.u_max if kind == 1 else 0.0, target=target, baseline=baseline)
    threads = min(MAX_THREADS, 32 * ((max(n_p, n_t, n_i, n_act) + 31) // 32))
    return args, state, trace, threads


def _final_state(state):
    from scpn_fusion_tpu_torch.scpn.controller import ControllerState

    *controller, plant = state
    return ControllerState(*controller), plant


def closed_loop(ctrl, cfg, plant0, *, n_ticks: int, dt: float):
    """``n_ticks`` of controller + reduced plant from the initial controller
    state and ``plant0`` (r, z): (final controller state, final plant state,
    trace of r (n,), z (n,), actions (n, nAct) and firing (n, nT))."""
    if not ctrl.w_in.is_cuda:
        return closed_loop_plain(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt)
    from scpn_fusion_tpu_torch.control.neuro_closed_loop import ReducedPlantState

    check_closed_loop(ctrl, cfg, plant0, n_ticks)
    args, state, trace, threads = launch_args(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt)
    cb.launch(_ENTRIES[ctrl.w_in.dtype], ctypes.addressof(args), threads)
    cb.CALLS["closed_loop"] += 1
    cs, plant = _final_state(state)
    return cs, ReducedPlantState(plant[0], plant[1]), trace


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
    n_ticks = plant.d.shape[0]
    check_closed_loop(ctrl, cfg, (x0[0], x0[1]), n_ticks, plant)
    args, state, trace, threads = launch_args(ctrl, cfg, (x0[0], x0[1]), n_ticks=n_ticks,
                                              dt=plant.dt, linear=plant)
    cb.launch(_ENTRIES[ctrl.w_in.dtype], ctypes.addressof(args), threads)
    cb.CALLS["closed_loop"] += 1
    cs, final = _final_state(state)
    return cs, final, {
        "z": trace["r"], "u": trace["z"], "actions": trace["actions"],
        "firing": trace["firing"]}


def _fueling_start(ctrl, plant: FuelingPlant):
    """The fueling plant's start state (density0, integral 0) on ``ctrl``'s device."""
    like = ctrl.initial_marking
    return (torch.full((), plant.density0, dtype=like.dtype, device=like.device),
            torch.zeros((), dtype=like.dtype, device=like.device))


def closed_loop_fueling_plain(ctrl, cfg, plant: FuelingPlant, *, n_ticks: int):
    """The per-tick loop :func:`closed_loop_fueling` replaces: (final
    controller state, final (density, integral) (2,), trace of density,
    command, error (n,), actions (n, 1) and firing (n, nT))."""
    from scpn_fusion_tpu_torch.control.fueling_torax import fueling_step
    from scpn_fusion_tpu_torch.scpn.controller import initial_controller_state

    carry = (*_fueling_start(ctrl, plant), initial_controller_state(ctrl, cfg))
    rows = []
    for k in range(n_ticks):
        carry, row = fueling_step(ctrl, cfg, plant, carry, k)
        rows.append(row)
    density, integ, cs = carry
    cols = (torch.stack(col) for col in zip(*rows))
    return cs, torch.stack([density, integ]), dict(
        zip(("density", "command", "error", "actions", "firing"), cols))


def closed_loop_fueling(ctrl, cfg, plant: FuelingPlant, *, n_ticks: int):
    """``n_ticks`` of controller + the fueling plant from the initial
    controller state, density ``plant.density0`` and integral 0: as
    :func:`closed_loop_fueling_plain`, in one launch on the card."""
    if not ctrl.w_in.is_cuda:
        return closed_loop_fueling_plain(ctrl, cfg, plant, n_ticks=n_ticks)
    plant0 = _fueling_start(ctrl, plant)
    check_closed_loop(ctrl, cfg, plant0, n_ticks, kind=2)
    args, state, trace, threads = launch_args(
        ctrl, cfg, plant0, n_ticks=n_ticks, dt=plant.dt, kind=2, target=plant.target,
        baseline=LEAK * plant.target)
    cb.launch(_ENTRIES[ctrl.w_in.dtype], ctypes.addressof(args), threads)
    cb.CALLS["closed_loop"] += 1
    cs, final = _final_state(state)
    return cs, final, {"density": trace["r"], "command": trace["z"], "error": trace["c"],
                       "actions": trace["actions"], "firing": trace["firing"]}


def closed_loop_torax_plain(ctrl, cfg, plant0, d, noise):
    """The per-tick loop :func:`closed_loop_torax` replaces, every episode
    in one batch (``torch.func.vmap`` of ``fueling_torax.torax_step``):
    (final controller states, final plant (E, 4), trace of beta_N, q95, risk
    (E, n), actions (E, n, 1) and firing (E, n, nT))."""
    from scpn_fusion_tpu_torch.control.fueling_torax import torax_step
    from scpn_fusion_tpu_torch.scpn.controller import ControllerState, initial_controller_state

    n_shots, n_ticks = d.shape
    cs = tuple(t.expand(n_shots, *t.shape) for t in initial_controller_state(ctrl, cfg))
    carry = (*plant0, cs)

    def tick(k):
        def one(beta, q95, li3, w_th, state, d_k, noise_k):
            (*x, state), row = torax_step(ctrl, cfg, (beta, q95, li3, w_th,
                                                      ControllerState(*state)), k, d_k, noise_k)
            return (*x, tuple(state)), row
        return torch.func.vmap(one)

    rows = []
    for k in range(n_ticks):
        carry, row = tick(k)(*carry, d[:, k], noise[:, k])
        rows.append(row)
    *plant, cs = carry
    cols = (torch.stack(col, dim=1) for col in zip(*rows))
    return ControllerState(*cs), torch.stack(plant, dim=-1), dict(
        zip(("beta_n", "q95", "risk", "actions", "firing"), cols))


def closed_loop_torax(ctrl, cfg, plant0, d, noise):
    """Every episode of the TORAX-style campaign from the initial controller
    state and ``plant0`` (beta_N, q95, li3, W_th, each (E,)), with the
    disturbance ``d`` (E, n) and the normals ``noise`` (E, n, 2) of every
    tick: as :func:`closed_loop_torax_plain`, in one launch of E CTAs on the
    card."""
    if not ctrl.w_in.is_cuda:
        return closed_loop_torax_plain(ctrl, cfg, plant0, d, noise)
    inputs = {"d": d, "noise": noise}
    check_closed_loop(ctrl, cfg, plant0, d.shape[1], kind=3, inputs=inputs)
    args, state, trace, threads = launch_args(ctrl, cfg, plant0, n_ticks=d.shape[1], dt=0.0,
                                              kind=3, inputs=inputs)
    cb.launch(_ENTRIES[ctrl.w_in.dtype], ctypes.addressof(args), threads)
    cb.CALLS["closed_loop"] += 1
    cs, final = _final_state(state)
    return cs, final, {"beta_n": trace["r"], "q95": trace["z"], "risk": trace["c"],
                       "actions": trace["actions"], "firing": trace["firing"]}
