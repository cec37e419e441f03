"""The disturbance-rejection ladder's linear lanes as a hand-written CUDA
kernel (``csrc/ladder.cu``).

:func:`ladder` closes the PID, the H-inf observer controller and the
DARE-LQR (MPC) law of ``control/disturbance_ladder.py`` around the
linearised vertical-stability plant, every lane (a controller on a scenario,
each with its own tick count) in ONE launch -- one thread a lane, the tick
loop inside the kernel -- in float32 or float64, and adds one to
``cb.CALLS["ladder"]``.  The JAX package has no Pallas kernel here: its
closed loop is one ``lax.scan`` (``disturbance_ladder._run_loop``) inside
one compiled program, and this launch takes that program's place.

On a CPU tensor the wrapper runs the kernel's plain version, the batched
tick loop :func:`ladder_plain` (the lanes of one controller kind a batch;
the plant step of every lane at once).  It rounds as the kernel does: the
2x2 products are spelled out elementwise, and quotients divide by a tensor
(a Python-scalar divisor is a multiplication by its reciprocal on the card).
On a CUDA tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_ladder_f32", torch.float64: "scpn_ladder_f64"}
KINDS = {"PID": 0, "H-infinity": 1, "MPC": 2}
N_PARAMS = 16        # csrc/ladder.cu:N_PARAMS
INTEG_MAX = 10.0     # the PID's anti-windup clip (disturbance_ladder.py:125)


class _Args(ctypes.Structure):
    """``LadderArgs`` of ``csrc/ladder.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "params", "x0", "plant", "d", "d_off", "out_off", "kind", "n_ticks", "trace_z",
        "trace_u")] + [("n_lanes", ctypes.c_int)]
        + [(name, ctypes.c_double) for name in ("dt", "u_max", "integ_max")])


class LadderLanes(NamedTuple):
    """The lanes of one launch.

    ``kind`` (L,) int32 (:data:`KINDS`); ``params`` (L, N_PARAMS) each lane's
    gains -- PID ``kp, ki, kd``; H-inf ``f0, f1, l0, l1, a00, a01, a10, a11,
    b2_0, b2_1, c0, c1, dt_obs, u_max_obs`` (the time-scaled observer); MPC
    ``k0, k1``; ``x0`` (L, 2) the initial plant state; ``d`` the lanes'
    disturbance traces packed at ``d_off`` (L,) int64, ``n_ticks`` (L,)
    int32 long each; ``plant`` (8,) ``a00 a01 a10 a11 b0 b1 bd0 bd1``."""

    kind: torch.Tensor
    params: torch.Tensor
    x0: torch.Tensor
    d: torch.Tensor
    d_off: torch.Tensor
    n_ticks: torch.Tensor
    plant: torch.Tensor


def out_offsets(n_ticks: torch.Tensor) -> torch.Tensor:
    """Offsets of each lane's traces in the packed outputs."""
    return torch.cumsum(n_ticks.to(torch.int64), 0) - n_ticks.to(torch.int64)


def unpack(packed: torch.Tensor, n_ticks) -> list[torch.Tensor]:
    """The packed trace of every lane, as a list."""
    return list(torch.split(packed, [int(n) for n in n_ticks]))


def ladder_plain(lanes: LadderLanes, *, dt: float, u_max: float):
    """The batched tick loop the kernel replaces: (z, u) packed as the
    kernel writes them (:func:`unpack` splits them by lane)."""
    kinds = lanes.kind.tolist()
    n_ticks = lanes.n_ticks.tolist()
    order = sorted(range(len(kinds)), key=lambda i: kinds[i])    # the lanes of a kind together
    dtype, dev = lanes.params.dtype, lanes.params.device
    n_max = max(n_ticks)
    # each lane's disturbance, zero past its end (its traces stop there)
    d_all = torch.zeros((len(order), n_max), dtype=dtype, device=dev)
    for row, i in enumerate(order):
        off = int(lanes.d_off[i])
        d_all[row, :n_ticks[i]] = lanes.d[off:off + n_ticks[i]]
    d_all = d_all.T.contiguous()
    params = lanes.params[order]
    x0, x1 = lanes.x0[order, 0], lanes.x0[order, 1]
    a00, a01, a10, a11, b0, b1, bd0, bd1 = lanes.plant
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    groups = {}
    start = 0
    for k in sorted(set(kinds)):
        count = kinds.count(k)
        groups[k] = slice(start, start + count)
        start += count
    if KINDS["H-infinity"] in groups:
        caps = params[groups[KINDS["H-infinity"]], 13].unique()
        if caps.numel() != 1:
            raise ValueError("ladder_plain: the H-inf lanes must share their command clip")
        u_max_obs = float(caps[0])
    zero = torch.zeros(len(order), dtype=dtype, device=dev)
    state = {k: (zero[g], zero[g]) for k, g in groups.items()}
    zs, us = [], []
    for t in range(n_max):
        u_parts = []
        for k, g in groups.items():
            z, p = x0[g], params[g]
            s0, s1 = state[k]
            if k == KINDS["PID"]:
                err = -z
                s0 = torch.clamp(s0 + err * dt, -INTEG_MAX, INTEG_MAX)
                deriv = -(z - s1) / dt_t
                u = p[:, 0] * err + p[:, 1] * s0 + p[:, 2] * deriv
                s1 = z
            elif k == KINDS["H-infinity"]:
                uh = torch.clamp(p[:, 0] * s0 + p[:, 1] * s1, -u_max_obs, u_max_obs)
                innov = z - (p[:, 10] * s0 + p[:, 11] * s1)
                dx0 = p[:, 4] * s0 + p[:, 5] * s1 + p[:, 8] * uh + p[:, 2] * innov
                dx1 = p[:, 6] * s0 + p[:, 7] * s1 + p[:, 9] * uh + p[:, 3] * innov
                s0, s1 = s0 + p[:, 12] * dx0, s1 + p[:, 12] * dx1
                u = uh
            else:
                dz = (z - s1) / dt_t
                u = -(p[:, 0] * z + p[:, 1] * dz)
                s1 = z
            state[k] = (s0, s1)
            u_parts.append(u)
        u = torch.clamp(torch.cat(u_parts), -u_max, u_max)
        dk = d_all[t]
        dx0 = a00 * x0 + a01 * x1 + b0 * u + bd0 * dk
        dx1 = a10 * x0 + a11 * x1 + b1 * u + bd1 * dk
        zs.append(x0)
        us.append(u)
        x0, x1 = x0 + dt * dx0, x1 + dt * dx1
    z_all, u_all = torch.stack(zs, dim=1), torch.stack(us, dim=1)   # (L, n_max), sorted
    z_lanes, u_lanes = [None] * len(order), [None] * len(order)
    for row, i in enumerate(order):
        z_lanes[i], u_lanes[i] = z_all[row, :n_ticks[i]], u_all[row, :n_ticks[i]]
    return torch.cat(z_lanes), torch.cat(u_lanes)


def check_ladder(lanes: LadderLanes) -> None:
    """Raise unless the kernel takes these lanes."""
    dtype = lanes.params.dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"ladder: float32 or float64, got {dtype}")
    ints = {"kind": torch.int32, "n_ticks": torch.int32, "d_off": torch.int64}
    for name, t in lanes._asdict().items():
        if not t.is_cuda:
            raise ValueError(f"ladder: {name} must be a CUDA tensor, got {t.device}")
        want = ints.get(name, dtype)
        if t.dtype != want:
            raise TypeError(f"ladder: {name} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"ladder: {name} must be contiguous")
    n = lanes.kind.shape[0]
    if n < 1 or lanes.params.shape != (n, N_PARAMS) or lanes.x0.shape != (n, 2) \
            or lanes.d_off.shape != (n,) or lanes.n_ticks.shape != (n,) \
            or lanes.plant.shape != (8,):
        raise ValueError("ladder: lanes of inconsistent shapes")
    if int(lanes.n_ticks.min()) < 1 or int(lanes.kind.min()) < 0 or int(lanes.kind.max()) > 2:
        raise ValueError("ladder: every lane needs a tick and a kind in 0..2")
    if int((lanes.d_off + lanes.n_ticks.to(torch.int64)).max()) > lanes.d.shape[0] \
            or int(lanes.d_off.min()) < 0:
        raise ValueError("ladder: a lane's disturbance runs past the packed traces")


def launch_args(lanes: LadderLanes, *, dt: float, u_max: float):
    """The kernel's argument block and its outputs (z, u, out_off), packed;
    the outputs are allocated on the lanes' device (only the pointers go to
    the kernel)."""
    out_off = out_offsets(lanes.n_ticks)
    total = int(lanes.n_ticks.to(torch.int64).sum())
    dtype, dev = lanes.params.dtype, lanes.params.device
    z = torch.empty(total, dtype=dtype, device=dev)
    u = torch.empty(total, dtype=dtype, device=dev)
    ptrs = [t.data_ptr() for t in (lanes.params, lanes.x0, lanes.plant, lanes.d, lanes.d_off,
                                   out_off, lanes.kind, lanes.n_ticks, z, u)]
    args = _Args(*ptrs, n_lanes=lanes.kind.shape[0], dt=dt, u_max=u_max, integ_max=INTEG_MAX)
    return args, (z, u, out_off)


def ladder(lanes: LadderLanes, *, dt: float, u_max: float):
    """Every lane's closed loop: (z, u) packed in lane order (:func:`unpack`)."""
    if not lanes.params.is_cuda:
        return ladder_plain(lanes, dt=dt, u_max=u_max)
    check_ladder(lanes)
    args, (z, u, _) = launch_args(lanes, dt=dt, u_max=u_max)
    cb.launch(_ENTRIES[lanes.params.dtype], ctypes.addressof(args))
    cb.CALLS["ladder"] += 1
    return z, u
