"""Disturbance-rejection ladder: PID vs H-inf vs MPC vs SNN on one plant
(port of ``scpn_fusion_tpu/control/disturbance_ladder.py``).

Plant (reference ``LinearPlant``):
    x = [z, dz/dt],  dx/dt = A x + B u + B_d d(t)
    A = [[0, 1], [gamma^2, -10]],  B = [0, 1],  B_d = [0, 0.5]

Scenarios: VDE impulse kick with 1 cm initial displacement, density-ramp
force, 10 Hz ELM pacing bursts, at dt = 1e-4 (2.0, 4.0 and 3.0 s: 20,000,
40,000 and 30,000 ticks).

Where JAX runs every closed loop as one ``lax.scan``, the port runs them
through two hand-written kernels: the PID, H-inf and MPC lanes through row
L (``ops/cuda_ladder.ladder``, ``csrc/ladder.cu``: one thread a lane, the
whole ladder's nine linear lanes in one launch), and the SNN lane through
row N's linear-plant variant (``ops/cuda_closed_loop.closed_loop_linear``,
one launch a scenario).  On the CPU the same calls run the kernels' plain
tick loops.  The controllers' designs -- the H-inf gains (3000 RK4 steps
of the Riccati ODEs, computed once per gamma, dtype and device and reused
for every scenario: the values JAX computes on each call) and the DARE gain
(2000 Riccati iterations) -- are plain PyTorch on the lanes' device; the
metrics are plain PyTorch on the traces.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
from scpn_fusion_tpu_torch.ops import cuda_ladder as cl

DT = 1e-4
GAMMA_GROWTH = 100.0
U_MAX = 1e6          # _run_loop's command clip

SCENARIO_DURATIONS = {"VDE": 2.0, "density_ramp": 4.0, "elm_pacing": 3.0}
SCENARIOS = ("VDE", "density_ramp", "elm_pacing")


def plant_matrices(gamma: float = GAMMA_GROWTH, dtype=torch.float32,
                   device: torch.device | str = "cuda"):
    a = torch.tensor([[0.0, 1.0], [gamma * gamma, -10.0]], dtype=dtype, device=device)
    b = torch.tensor([0.0, 1.0], dtype=dtype, device=device)
    b_d = torch.tensor([0.0, 0.5], dtype=dtype, device=device)
    return a, b, b_d


def plant_vector(dtype=torch.float32, device: torch.device | str = "cuda") -> torch.Tensor:
    """(8,) ``a00 a01 a10 a11 b0 b1 bd0 bd1`` of the kernels' plant."""
    a, b, b_d = plant_matrices(dtype=dtype, device=device)
    return torch.cat([a.reshape(-1), b, b_d]).contiguous()


def disturbance_trace(scenario: str, dtype=torch.float32,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """Precomputed d(t) for the scenario, the JAX package's numpy expressions
    (so the traces have the same lengths)."""
    if scenario not in SCENARIO_DURATIONS:
        raise ValueError(f"unknown scenario {scenario!r}")
    t = np.arange(0.0, SCENARIO_DURATIONS[scenario], DT)
    if scenario == "VDE":
        d = np.where(t < 1e-3, 5000.0, 0.0)
    elif scenario == "density_ramp":
        n_frac = np.where(t >= 2.0, 1.2, 0.5 + 0.7 * (t / 2.0))
        d = 200.0 * (n_frac - 1.0)
    else:
        d = np.where((t % 0.1) < 0.5e-3, 1000.0, 0.0)
    return torch.as_tensor(d, dtype=dtype, device=device)


def initial_state(scenario: str, dtype=torch.float32,
                  device: torch.device | str = "cuda") -> torch.Tensor:
    if scenario == "VDE":
        return torch.tensor([0.01, 0.0], dtype=dtype, device=device)   # 1 cm displacement
    return torch.zeros((2,), dtype=dtype, device=device)


class LadderMetrics(NamedTuple):
    ise: torch.Tensor
    settling_time_s: torch.Tensor
    overshoot: torch.Tensor
    control_effort: torch.Tensor
    stable: torch.Tensor
    z_trace: torch.Tensor


def _metrics(z: torch.Tensor, u: torch.Tensor, threshold: float = 0.05) -> LadderMetrics:
    n = z.shape[0]
    ise = (z**2).sum() * DT
    over = z.abs().max()
    # Settling: last time |z| exceeded threshold * max(|z0|, 1 cm).
    band = threshold * torch.clamp(z[0].abs(), min=0.01)
    outside = z.abs() > band
    idx = torch.arange(n, device=z.device)
    last_out = torch.where(outside, idx, torch.full_like(idx, -1)).max()
    settle = (last_out + 1).to(z.dtype) * DT
    stable = torch.isfinite(ise) & (z[-1].abs() < 0.5)
    return LadderMetrics(ise=ise, settling_time_s=settle, overshoot=over,
                         control_effort=u.abs().sum() * DT, stable=stable, z_trace=z)


# ── the controllers' designs ──────────────────────────────────────────────


def _hinf_plant(dtype, device):
    """The time-scaled plant (tau = g t) of the H-inf design: (a_s, b1_s,
    b2_s, c1, c2)."""
    g = GAMMA_GROWTH

    def t(rows):
        return torch.tensor(rows, dtype=dtype, device=device)

    return (t([[0.0, 1.0], [1.0, -10.0 / g]]), t([[0.0], [0.5 / (g * g)]]),
            t([[0.0], [1.0 / (g * g)]]), t([[1.0, 0.0], [0.0, 0.1]]), t([[1.0, 0.0]]))


@functools.lru_cache(maxsize=None)
def hinf_gains(gamma_hinf: float = 8.0, dtype=torch.float32, device: str = "cuda"):
    """The central H-inf gains of :func:`run_hinf` (3000 RK4 steps of 0.01):
    they depend only on (gamma, dtype), so each is computed once per device."""
    from scpn_fusion_tpu_torch.control.hinf import synthesize_hinf

    a_s, b1_s, b2_s, c1, c2 = _hinf_plant(dtype, device)
    return synthesize_hinf(a_s, b1_s, b2_s, c1, c2,
                           torch.tensor(gamma_hinf, dtype=dtype, device=device),
                           riccati_steps=3000, riccati_dt=0.01)


def _dare_gain(a_d, b_d, q, r, n_iter: int = 2000):
    """Fixed-point Riccati difference iteration -> steady-state gain K."""
    p = torch.eye(2, dtype=a_d.dtype, device=a_d.device)
    for _ in range(n_iter):
        btp = b_d @ p
        denom = r + btp @ b_d
        k = (btp @ a_d) / denom
        p = q + a_d.T @ p @ a_d - torch.outer(a_d.T @ btp, k)
    btp = b_d @ p
    return (btp @ a_d) / (r + btp @ b_d)


@functools.lru_cache(maxsize=None)
def mpc_gain(dtype=torch.float32, device: str = "cuda") -> torch.Tensor:
    """The DARE-LQR gain of :func:`run_mpc` on the ZOH plant."""
    a, b, _ = plant_matrices(dtype=dtype, device=device)
    a_d = torch.eye(2, dtype=dtype, device=device) + DT * a
    b_d = DT * b
    q = torch.tensor([[1.0, 0.0], [0.0, 1e-4]], dtype=dtype, device=device)
    return _dare_gain(a_d, b_d, q, torch.tensor(1e-9, dtype=dtype, device=device))


def _lane_params(name: str, dtype, device, *, kp=3e4, ki=1e4, kd=250.0,
                 gamma_hinf=8.0) -> torch.Tensor:
    """(N_PARAMS,) the lane's gains in the layout of ``cuda_ladder.LadderLanes``."""
    zeros = torch.zeros(cl.N_PARAMS, dtype=dtype, device=device)
    if name == "PID":
        head = torch.tensor([kp, ki, kd], dtype=dtype, device=device)
    elif name == "H-infinity":
        gains = hinf_gains(float(gamma_hinf), dtype, str(device))
        a_s, _, b2_s, _, c2 = _hinf_plant(dtype, device)
        tail = torch.tensor([GAMMA_GROWTH * DT, 1e6], dtype=dtype, device=device)
        head = torch.cat([gains.f.reshape(-1), gains.l.reshape(-1), a_s.reshape(-1),
                          b2_s.reshape(-1), c2.reshape(-1), tail])
    elif name == "MPC":
        head = mpc_gain(dtype, str(device))
    else:
        raise ValueError(f"no linear lane {name!r}")
    return torch.cat([head, zeros[head.shape[0]:]])


def linear_lanes(lanes, dtype=torch.float32, device: torch.device | str = "cuda",
                 **gains) -> cl.LadderLanes:
    """The row-L lanes of ``lanes``, (controller, scenario) pairs."""
    traces = {s: disturbance_trace(s, dtype, device) for _, s in lanes}
    order = list(traces)
    offsets = np.cumsum([0] + [traces[s].shape[0] for s in order])
    d_off = {s: int(offsets[i]) for i, s in enumerate(order)}
    return cl.LadderLanes(
        kind=torch.tensor([cl.KINDS[c] for c, _ in lanes], dtype=torch.int32, device=device),
        params=torch.stack([_lane_params(c, dtype, device, **gains) for c, _ in lanes]),
        x0=torch.stack([initial_state(s, dtype, device) for _, s in lanes]),
        d=torch.cat([traces[s] for s in order]),
        d_off=torch.tensor([d_off[s] for _, s in lanes], dtype=torch.int64, device=device),
        n_ticks=torch.tensor([traces[s].shape[0] for _, s in lanes], dtype=torch.int32,
                             device=device),
        plant=plant_vector(dtype, device))


def run_linear_lanes(lanes, dtype=torch.float32, device: torch.device | str = "cuda",
                     **gains) -> dict:
    """Every (controller, scenario) of ``lanes`` in one ``cuda_ladder.ladder``
    call: {(controller, scenario): LadderMetrics}."""
    spec = linear_lanes(lanes, dtype, device, **gains)
    z, u = cl.ladder(spec, dt=DT, u_max=U_MAX)
    n_ticks = spec.n_ticks.tolist()
    return {lane: _metrics(zl, ul)
            for lane, zl, ul in zip(lanes, cl.unpack(z, n_ticks), cl.unpack(u, n_ticks))}


def run_pid(scenario: str, kp: float = 3e4, ki: float = 1e4, kd: float = 250.0,
            dtype=torch.float32, device: torch.device | str = "cuda") -> LadderMetrics:
    """Tuned PID on z (anti-windup, derivative on measurement)."""
    return run_linear_lanes([("PID", scenario)], dtype, device, kp=kp, ki=ki, kd=kd)[
        ("PID", scenario)]


def run_hinf(scenario: str, gamma_hinf: float = 8.0, dtype=torch.float32,
             device: torch.device | str = "cuda") -> LadderMetrics:
    """Observer-based central H-inf output feedback, designed on the
    time-scaled plant (tau = g t) where the fixed-step Riccati integration
    is stable; the observer runs in scaled time (d tau = g dt)."""
    return run_linear_lanes([("H-infinity", scenario)], dtype, device, gamma_hinf=gamma_hinf)[
        ("H-infinity", scenario)]


def run_mpc(scenario: str, dtype=torch.float32,
            device: torch.device | str = "cuda") -> LadderMetrics:
    """Unconstrained receding-horizon MPC == DARE LQR on the ZOH plant; state
    [z, dz] estimated from successive measurements."""
    return run_linear_lanes([("MPC", scenario)], dtype, device)[("MPC", scenario)]


# ── SNN (SCPN fused controller tick) ─────────────────────────────────────


def _build_z_net(gain: float, dtype, device: torch.device | str = "cuda"):
    from scpn_fusion_tpu_torch.scpn.controller import build_controller
    from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet

    net = StochasticPetriNet()
    for p in ("eZ+", "eZ-", "cZ+", "cZ-", "sink"):
        net.add_place(p)
    for t, src, dst in (("tZ+", "eZ+", "cZ+"), ("tZ-", "eZ-", "cZ-")):
        net.add_transition(t, threshold=0.01)
        net.add_arc(src, t)
        net.add_arc(t, dst)
    # Drain transitions: leaky readout (without them both command places
    # saturate at 1 and the action difference collapses to zero).
    for t, src in (("dZ+", "cZ+"), ("dZ-", "cZ-")):
        net.add_transition(t, threshold=0.0)
        net.add_arc(src, t)
        net.add_arc(t, "sink")
    compiled = net.compile()
    return build_controller(
        compiled,
        axis_targets=[0.0], axis_scales=[0.05],
        injections=[("eZ+", 0, True, 1.0, 0.0),
                    ("eZ-", 0, False, 1.0, 0.0)],
        actions=[("cZ+", "cZ-", gain, 1e6, 1e9)],
        dtype=dtype, device=device)


def snn_config():
    """The SNN lane's controller configuration: fractional firing, margin
    0.5, the plant's dt; it draws nothing, so row N takes it."""
    from scpn_fusion_tpu_torch.scpn.controller import ControllerConfig

    return ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=DT)


def snn_plant(scenario: str, dtype=torch.float32,
              device: torch.device | str = "cuda") -> ccl.LinearPlant:
    return ccl.LinearPlant(plant_vector(dtype, device), disturbance_trace(scenario, dtype, device),
                           DT, U_MAX)


def run_snn(scenario: str, gain: float = 2e3, dtype=torch.float32,
            device: torch.device | str = "cuda") -> LadderMetrics:
    """The SCPN controller in the loop: one launch of row N's linear-plant
    variant (on the CPU its per-tick loop).  The spiking path quantises the
    error through threshold firing, so its ISE is expected orders above the
    linear controllers'."""
    _, _, tr = ccl.closed_loop_linear(_build_z_net(gain, dtype, device), snn_config(),
                                      initial_state(scenario, dtype, device),
                                      snn_plant(scenario, dtype, device))
    return _metrics(tr["z"], tr["u"])


RUNNERS = {"PID": run_pid, "H-infinity": run_hinf, "MPC": run_mpc, "SNN": run_snn}


def _row(m: LadderMetrics) -> dict:
    return {"ise": float(m.ise), "settling_time_s": float(m.settling_time_s),
            "overshoot": float(m.overshoot), "control_effort": float(m.control_effort),
            "stable": bool(m.stable)}


def run_ladder(scenarios=SCENARIOS, dtype=torch.float32,
               device: torch.device | str = "cuda") -> dict:
    """Full controller x scenario table: the linear lanes of every scenario
    in one row-L launch, the SNN lane one row-N launch a scenario."""
    linear = run_linear_lanes([(c, s) for s in scenarios for c in ("PID", "H-infinity", "MPC")],
                              dtype, device)
    out = {}
    for scenario in scenarios:
        for name in RUNNERS:
            m = run_snn(scenario, dtype=dtype, device=device) if name == "SNN" \
                else linear[(name, scenario)]
            out[(name, scenario)] = _row(m)
    return out
