"""The monitored UPDE run as a hand-written CUDA kernel (``csrc/phase.cu``;
row U).

:func:`upde_run` runs every tick of a multi-layer UPDE trajectory -- the
loop of the JAX package's ``run_upde`` (``models/phase/upde.py:113-147``) --
and :func:`monitor_run` every tick of the monitored run, the tick with the
Lyapunov guard and the recorder (``models/phase/monitor.py:155-175``), each
in ONE launch of one CTA, and adds one to ``cb.CALLS["phase_run"]``.  The
JAX package has no Pallas kernel here: each run is one ``lax.scan`` in one
compiled program, and this launch takes that program's place.

On a CPU tensor the wrappers run the kernel's plain twin: the tick loop of
the port's ``upde.upde_steps`` (here :func:`upde_run_plain`) and of
``monitor.monitor_tick`` (:func:`monitor_run_plain`), whose every sum
over oscillators is the halving tree the kernel takes (``upde.tree_sum``).
On a CUDA tensor they launch the kernel or raise, and an input that
requires a gradient raises (the kernel has no backward, and needs none: no
JAX caller differentiates these runs).  The wrapper pads the oscillator axis
to a power of two with zeros (mask zero) and allocates the traces; where the
kernel's work arrays do not fit shared memory it allocates them in device
memory, so every size runs on the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scpn_fusion_tpu_torch.models.phase.guard import GuardState
from scpn_fusion_tpu_torch.models.phase.monitor import MonitorState, MonitorTrace, monitor_tick
from scpn_fusion_tpu_torch.models.phase.upde import upde_steps as upde_run_plain
from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_phase_run_f32", torch.float64: "scpn_phase_run_f64"}
MAX_THREADS = 1024
SMEM_BYTES = 200 * 1024     # above this the work arrays go to device memory
_POINTERS = ("theta0", "omega", "mask", "k", "alpha", "zeta", "ring0", "guard0",
             "theta_trace", "theta_final", "r_layer", "r_global", "v_layer", "v_global",
             "lambda_exp", "approved", "violations", "ring", "guard", "scratch")
_INTS = ("L", "n", "n_pad", "l_pad", "n_ticks", "window", "ring_len", "max_violations",
         "mean_field", "wrap", "with_guard", "work")
_DOUBLES = ("dt", "psi", "gain", "pac_gamma", "guard_dt", "lambda_threshold")


class _Args(ctypes.Structure):
    """``PhaseArgs`` of ``csrc/phase.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [(name, ctypes.c_int) for name in _INTS]
                + [(name, ctypes.c_double) for name in _DOUBLES])


def pow2(n: int) -> int:
    """The power of two at or above ``n`` (1 for 0 and 1)."""
    return 1 << max(n - 1, 0).bit_length()


def work_values(n_layers: int, n_pad: int, ring_len: int) -> int:
    """Values of the kernel's work arrays: phases, frequencies, mask and two
    work arrays (L, n_pad); K and alpha; zeta; nine per-layer vectors of
    l_pad; the guard's ring; two scalars."""
    return (5 * n_layers * n_pad + 2 * n_layers * n_layers + n_layers
            + 9 * pow2(n_layers) + ring_len + 2)


@functools.lru_cache(maxsize=None)
def max_threads(dtype: torch.dtype) -> int:
    """The most threads a block of the kernel's ``dtype`` instantiation can
    have with its registers (at most 1024)."""
    n = cb.library().scpn_phase_max_threads(int(dtype == torch.float64))
    if n < 32:
        raise RuntimeError(f"row U: no block of the {dtype} kernel fits ({n} threads)")
    return min(MAX_THREADS, n)


def threads_for(n_layers: int, n_pad: int, limit: int = MAX_THREADS) -> int:
    """Threads of the one CTA: a warp-multiple cover of the padded
    oscillators, at most ``limit`` (a thread then takes several)."""
    return min(limit // 32 * 32, 32 * ((n_layers * n_pad + 31) // 32))


def tick_stages(n_layers: int, n_pad: int) -> int:
    """Barrier stages of a tick (the dependent chain of the run)."""
    return 6 + 2 * (n_pad.bit_length() - 1) + 2 * (pow2(n_layers).bit_length() - 1)


def monitor_run_plain(state, arrays: dict, cfg, n_ticks: int):
    """The monitored tick loop the kernel replaces: (final state, trace)."""
    snaps = []
    for _ in range(n_ticks):
        state, snap = monitor_tick(state, arrays, cfg=cfg)
        snaps.append(snap)
    return state, MonitorTrace(*(torch.stack([s[k] for s in snaps]) for k in (
        "r_global", "r_layer", "v_global", "v_layer", "lambda_exp", "guard_approved",
        "guard_violations")))


def _check(name: str, tensors: dict, dtype) -> None:
    """Raise unless row U takes these tensors: CUDA, ``dtype`` (float32 or
    float64), none requiring a gradient."""
    if dtype not in _ENTRIES:
        raise TypeError(f"{name}: float32 or float64, got {dtype}")
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.requires_grad:
            raise RuntimeError(f"{name}: row U has no backward; {arg} requires a gradient")


def _launch(theta0, omega, mask, k_matrix, alpha, zeta, *, n_ticks: int, theta_trace: bool,
            guard=None, **scalars):
    """Pad, allocate and launch; returns the argument block's tensors by
    field name (the outputs among them)."""
    n_layers, n = theta0.shape
    if n_layers < 1 or n < 1:
        raise ValueError(f"row U: empty phase array {tuple(theta0.shape)}")
    for arg, t, shape in (("omega", omega, (n_layers, n)), ("mask", mask, (n_layers, n)),
                          ("k_matrix", k_matrix, (n_layers, n_layers)),
                          ("alpha", alpha, (n_layers, n_layers)), ("zeta", zeta, (n_layers,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"row U: {arg} has shape {tuple(t.shape)}, expected {shape}")
    dev, dtype = theta0.device, theta0.dtype
    n_pad = pow2(n)

    def padded(x):
        return torch.nn.functional.pad(x, (0, n_pad - n)).contiguous()

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    ring_len = guard[1].v_buffer.shape[0] if guard is not None else 1
    work = work_values(n_layers, n_pad, ring_len)
    tensors = {"theta0": padded(theta0), "omega": padded(omega), "mask": padded(mask),
               "k": k_matrix.contiguous(), "alpha": alpha.contiguous(),
               "zeta": zeta.contiguous(), "theta_final": empty(n_layers, n),
               "r_layer": empty(n_ticks, n_layers), "r_global": empty(n_ticks),
               "v_layer": empty(n_ticks, n_layers), "v_global": empty(n_ticks)}
    if theta_trace:
        tensors["theta_trace"] = empty(n_ticks, n_layers, n)
    if work * theta0.element_size() > SMEM_BYTES:
        tensors["scratch"] = empty(work)
    extra = dict(window=1, ring_len=1, max_violations=0, with_guard=0)
    if guard is not None:
        gcfg, gstate = guard
        tensors.update(
            ring0=gstate.v_buffer.contiguous(),
            guard0=torch.stack([gstate.n_seen, gstate.consecutive]).to(torch.int32),
            lambda_exp=empty(n_ticks), approved=empty(n_ticks, dt=torch.bool),
            violations=empty(n_ticks, dt=torch.int32), ring=empty(ring_len),
            guard=empty(2, dt=torch.int32))
        extra = dict(window=gcfg.window, ring_len=ring_len, max_violations=gcfg.max_violations,
                     with_guard=1, guard_dt=gcfg.dt, lambda_threshold=gcfg.lambda_threshold)
    args = _Args(**{k: t.data_ptr() for k, t in tensors.items()}, L=n_layers, n=n,
                 n_pad=n_pad, l_pad=pow2(n_layers), n_ticks=n_ticks, work=work, **extra,
                 **scalars)
    cb.launch(_ENTRIES[dtype], ctypes.addressof(args),
              threads_for(n_layers, n_pad, max_threads(dtype)))
    cb.CALLS["phase_run"] += 1
    return tensors


def upde_run(theta0, omega, mask, k_matrix, alpha, zeta, *, dt, psi_external=0.0,
             psi_mode: str = "external", actuation_gain=1.0, pac_gamma=0.0,
             n_steps: int = 1000, wrap: bool = True):
    """(thetas, r_layer, r_global, v_layer, v_global) of a UPDE trajectory:
    as :func:`upde_run_plain`, in one launch on the card."""
    if not theta0.is_cuda:
        return upde_run_plain(theta0, omega, mask, k_matrix, alpha, zeta, dt=dt,
                              psi_external=psi_external, psi_mode=psi_mode,
                              actuation_gain=actuation_gain, pac_gamma=pac_gamma,
                              n_steps=n_steps, wrap=wrap)
    if psi_mode not in ("external", "mean_field"):
        raise ValueError(f"unknown psi mode {psi_mode!r}")
    tensors = dict(theta0=theta0, omega=omega, mask=mask, k_matrix=k_matrix, alpha=alpha,
                   zeta=zeta)
    _check("upde_run", tensors, theta0.dtype)
    out = _launch(*tensors.values(), n_ticks=n_steps, theta_trace=True, dt=float(dt),
                  psi=float(psi_external), gain=float(actuation_gain),
                  pac_gamma=float(pac_gamma), mean_field=int(psi_mode == "mean_field"),
                  wrap=int(wrap))
    return tuple(out[k] for k in ("theta_trace", "r_layer", "r_global", "v_layer", "v_global"))


def monitor_run(state, arrays: dict, cfg, n_ticks: int):
    """(final state, trace) of the monitored run: as :func:`monitor_run_plain`,
    in one launch on the card."""
    if not state.theta.is_cuda:
        return monitor_run_plain(state, arrays, cfg, n_ticks)
    tensors = dict(theta0=state.theta, omega=arrays["omega"], mask=arrays["mask"],
                   k_matrix=arrays["k_matrix"], alpha=arrays["alpha"], zeta=arrays["zeta"],
                   v_buffer=state.guard.v_buffer)
    _check("monitor_run", tensors, state.theta.dtype)
    if state.guard.v_buffer.dim() != 1 or state.guard.v_buffer.shape[0] < 1:
        raise ValueError(f"monitor_run: the guard's ring has shape "
                         f"{tuple(state.guard.v_buffer.shape)}")
    out = _launch(*list(tensors.values())[:6], n_ticks=n_ticks, theta_trace=False,
                  guard=(cfg.guard, state.guard), dt=float(cfg.dt), psi=float(cfg.psi_driver),
                  gain=1.0, pac_gamma=float(cfg.pac_gamma), mean_field=0, wrap=1)
    final = MonitorState(theta=out["theta_final"],
                         guard=GuardState(out["ring"], out["guard"][0], out["guard"][1]),
                         tick=state.tick + n_ticks)
    return final, MonitorTrace(out["r_global"], out["r_layer"], out["v_global"],
                               out["v_layer"], out["lambda_exp"], out["approved"],
                               out["violations"])
