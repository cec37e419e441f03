"""Realtime digital-twin ingest + SNN scenario planning (port of
``scpn_fusion_tpu/control/twin_ingest.py``).

The telemetry stream is a structure of arrays, chaos injection is one
vectorised op, and a session plans at every ``plan_every``-th sample: each
plan point rolls the SNN planner's controller tick and a reduced plant over
a horizon, with the linear-logit disruption-risk estimator over the growing
signal history.  The JAX package ``vmap``s the plan points and scans the
horizon inside one program; here the plan points are one ``torch.func.vmap``
batch and the horizon a Python loop, so a session is ~100 plain launches a
horizon tick on the card (no port kernel: row N's batched kind is a
candidate for it).

Risk model: the deterministic linear-logit estimator of
``control/disruption_risk_runtime.py:154-242`` (feature layout
[mean, std, max, slope, energy, last, n1, n2, n3, asym, spread], published
weights, bias -4.0), evaluated with masked statistics over the signal
history.

Random numbers: the stream's normals and the chaos draws come from a
``torch.Generator`` in the public functions (:func:`generate_emulated_stream`,
:func:`apply_chaos_monkey`, :func:`run_realtime_twin_session`) and as tensors
in the private ones (:func:`_emulated_stream`, :func:`_apply_chaos_monkey`,
:func:`_run_realtime_twin_session`), which the parity tests feed JAX's draws.
As in JAX, the planner's controller is float32 whatever the stream's dtype;
its outputs are promoted where JAX promotes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.scpn.controller import (
    CompiledController,
    ControllerConfig,
    build_controller,
    controller_step,
    initial_controller_state,
)
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet

VALID_MACHINES = ("NSTX-U", "SPARC")

# disruption_risk_runtime.py:19-33 — published linear-logit weights.
RISK_BIAS = -4.0
RISK_WEIGHTS = (0.02, 0.55, 0.03, 0.50, 0.005, 0.02,   # mean std max slope energy last
                1.10, 0.70, 0.45, 0.50, 0.15)          # n1 n2 n3 asym spread

HISTORY_WINDOW = 64  # reference scenario_plan buffer[-64:] (:192)


class TelemetryStream(NamedTuple):
    """Structure-of-arrays telemetry (the reference's packet list, SoA)."""

    t_ms: torch.Tensor          # (n,) int32
    ip_ma: torch.Tensor         # (n,)
    beta_n: torch.Tensor        # (n,)
    q95: torch.Tensor           # (n,)
    density_1e19: torch.Tensor  # (n,)


class PlanSummary(NamedTuple):
    """Per-plan-point outputs (each leaf (n_plans,))."""

    safe_horizon_rate: torch.Tensor
    mean_risk: torch.Tensor
    recommended_action: torch.Tensor
    passes: torch.Tensor


def _normalize_machine(machine: str) -> str:
    key = machine.strip().upper()
    if key not in VALID_MACHINES:
        raise ValueError("machine must be 'NSTX-U' or 'SPARC'")
    return key


def _over(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` divided by a tensor (a true division on every device)."""
    return x / torch.full_like(x, c)


def _check_stream(samples: int, dt_ms: int) -> None:
    if samples < 32:
        raise ValueError("samples must be >= 32.")
    if dt_ms < 1:
        raise ValueError("dt_ms must be >= 1.")


def _emulated_stream(machine: str, noise: torch.Tensor, *, dt_ms: int = 5) -> TelemetryStream:
    """:func:`generate_emulated_stream` with its normals given: ``noise``
    (2, samples), the ip and the q95 channel's, in the stream's dtype on its
    device."""
    machine = _normalize_machine(machine)
    samples = noise.shape[1]
    _check_stream(samples, dt_ms)
    if machine == "NSTX-U":
        ip0, beta0, q0, d0 = 1.2, 1.95, 4.7, 6.5
    else:
        ip0, beta0, q0, d0 = 8.7, 1.65, 3.9, 8.2

    k = torch.arange(samples, device=noise.device)
    phase = _over(k.to(noise.dtype), max(samples - 1, 1))
    burst = torch.where(
        (phase >= 0.58) & (phase <= 0.76),
        0.18 * torch.sin(_over(math.pi * (phase - 0.58), 0.18)), torch.zeros_like(phase))
    return TelemetryStream(
        t_ms=(k * dt_ms).to(torch.int32),
        ip_ma=ip0 + 0.03 * torch.sin(2 * math.pi * phase) + 0.004 * noise[0],
        beta_n=beta0 + 0.05 * torch.cos(2 * math.pi * 1.4 * phase) + burst,
        q95=q0 - 0.12 * burst + 0.01 * noise[1],
        density_1e19=d0 + 0.10 * torch.sin(2 * math.pi * 0.6 * phase),
    )


def generate_emulated_stream(
    machine: str, *, samples: int = 320, dt_ms: int = 5,
    generator: torch.Generator | None = None, dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> TelemetryStream:
    """Deterministic machine telemetry with a mid-shot disruption burst
    (reference ``generate_emulated_stream`` :108-151), fully vectorised; the
    normals come from ``generator`` (a CPU generator seeded with 42 when
    none is given)."""
    _normalize_machine(machine)
    _check_stream(samples, dt_ms)
    if generator is None:
        generator = torch.Generator().manual_seed(42)
    noise = torch.randn((2, samples), generator=generator, dtype=torch.float64)
    return _emulated_stream(machine, noise.to(dtype=dtype, device=device), dt_ms=dt_ms)


def _apply_chaos_monkey(
    stream: TelemetryStream, uniforms: torch.Tensor, normals: torch.Tensor, *,
    dropout_prob: float = 0.0, noise_std: float = 0.0,
) -> tuple[TelemetryStream, torch.Tensor, int]:
    """:func:`apply_chaos_monkey` with its draws given: ``uniforms`` and
    ``normals`` (4, n), one of each a channel sample."""
    drop = min(max(dropout_prob, 0.0), 1.0)
    sigma = max(noise_std, 0.0)
    n = stream.beta_n.shape[0]
    channels = torch.stack([stream.ip_ma, stream.beta_n, stream.q95,
                            stream.density_1e19])            # (4, n)
    dropped = uniforms < drop
    noisy = torch.where(dropped, torch.zeros_like(channels), channels) + sigma * normals
    out = TelemetryStream(
        t_ms=stream.t_ms,
        ip_ma=noisy[0], beta_n=noisy[1], q95=noisy[2],
        density_1e19=torch.clamp(noisy[3], min=0.0),
    )
    n_noise = 4 * n if sigma > 0.0 else 0
    return out, dropped.sum(dtype=torch.int32), n_noise


def apply_chaos_monkey(
    stream: TelemetryStream, generator: torch.Generator, *,
    dropout_prob: float = 0.0, noise_std: float = 0.0,
) -> tuple[TelemetryStream, torch.Tensor, int]:
    """Vectorised channel dropout + Gaussian noise injection (reference
    ``_apply_chaos_monkey`` :246-277), the draws from ``generator``.
    Returns (stream, n_dropouts, n_noise_injections)."""
    like = stream.beta_n
    shape = (4, like.shape[0])
    uniforms = torch.rand(shape, generator=generator, dtype=torch.float64)
    normals = torch.randn(shape, generator=generator, dtype=torch.float64)
    return _apply_chaos_monkey(stream, uniforms.to(like.device, like.dtype),
                               normals.to(like.device, like.dtype),
                               dropout_prob=dropout_prob, noise_std=noise_std)


def risk_signal(stream: TelemetryStream) -> torch.Tensor:
    """Elementwise scalar risk channel (reference ``_risk_signal``
    :172-178)."""
    return (0.45
            + 0.40 * torch.clamp(stream.beta_n - 2.0, min=0.0)
            + 0.30 * torch.clamp(4.2 - stream.q95, min=0.0)
            + 0.10 * torch.clamp(stream.density_1e19 - 8.8, min=0.0))


def disruption_risk_masked(signal: torch.Tensor, mask: torch.Tensor,
                           toroidal: torch.Tensor) -> torch.Tensor:
    """Linear-logit risk over a masked signal buffer
    (``disruption_risk_runtime.py:154-242``).  ``toroidal`` is
    ``[n1, n2, n3, asym, spread]``."""
    m = mask.to(signal.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)
    mean = torch.sum(signal * m) / n
    var = torch.sum(m * (signal - mean) ** 2) / n
    std = torch.sqrt(torch.clamp(var, min=0.0))
    mx = torch.amax(torch.where(mask, signal, torch.full_like(signal, -math.inf)))
    first = signal.gather(0, torch.argmax(m).reshape(1))[0]
    last = signal.gather(0, (signal.shape[0] - 1 - torch.argmax(torch.flip(m, (0,)))).reshape(1))[0]
    slope = (last - first) / torch.clamp(n - 1.0, min=1.0)
    energy = torch.sum(m * signal * signal) / n
    features = torch.cat(
        [torch.stack([mean, std, mx, slope, energy, last]), toroidal.to(signal.dtype)])
    weights = torch.tensor(RISK_WEIGHTS, dtype=signal.dtype, device=signal.device)
    return torch.sigmoid(RISK_BIAS + torch.sum(weights * features))


def build_snn_planner(
    *, seed_base: int = 161803399, dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> tuple[CompiledController, ControllerConfig]:
    """The 4-place/2-transition mitigation-planning net
    (reference ``_build_snn_planner`` :53-105: gain 1800 A, |dI| <= 3500 A,
    R target 1.9 m / scale 0.9 m), compiled to the controller tick."""
    net = StochasticPetriNet()
    net.add_place("x_R_pos", initial_tokens=0.0)
    net.add_place("x_R_neg", initial_tokens=0.0)
    net.add_place("a_R_pos", initial_tokens=0.0)
    net.add_place("a_R_neg", initial_tokens=0.0)
    net.add_transition("T_Rp", threshold=0.1)
    net.add_transition("T_Rn", threshold=0.1)
    net.add_arc("x_R_pos", "T_Rp", weight=1.0)
    net.add_arc("x_R_neg", "T_Rn", weight=1.0)
    net.add_arc("T_Rp", "a_R_pos", weight=1.0)
    net.add_arc("T_Rn", "a_R_neg", weight=1.0)
    compiled = net.compile()
    ctrl = build_controller(
        compiled,
        axis_targets=[1.9], axis_scales=[0.9],
        injections=[("x_R_pos", 0, True, 1.0, 0.0),
                    ("x_R_neg", 0, False, 1.0, 0.0)],
        actions=[("a_R_pos", "a_R_neg", 1800.0, 3500.0, 1.0e6)],
        dtype=dtype, device=device,
    )
    cfg = ControllerConfig(firing_mode="binary", dt=1.0e-3,
                           seed_base=seed_base)
    return ctrl, cfg


def scenario_plan(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    hist: torch.Tensor,       # (HISTORY_WINDOW,) recent risk signals
    hist_mask: torch.Tensor,  # (HISTORY_WINDOW,) bool validity (left-padded)
    beta0, q95_0, dens0,
    *, horizon: int = 24,
) -> PlanSummary:
    """Project near-term risk under SNN mitigation (reference
    ``scenario_plan`` :180-244), the horizon tick by tick.  The controller
    runs in its own dtype and its command is promoted to the history's
    where JAX promotes it."""
    if horizon < 4:
        raise ValueError("horizon must be >= 4.")
    dt, dev = hist.dtype, hist.device
    buf = torch.cat([hist, torch.zeros((horizon,), dtype=dt, device=dev)])
    base_mask = torch.cat([hist_mask, torch.zeros((horizon,), dtype=torch.bool, device=dev)])
    idx = torch.arange(buf.shape[0], device=dev)
    cstate = initial_controller_state(ctrl, cfg)
    beta, q95, dens = (torch.as_tensor(v, dtype=dt, device=dev) for v in (beta0, q95_0, dens0))

    # The signal history accumulates across ticks (the reference appends to
    # ``signal_history`` per tick, :211).
    risks, controls = [], []
    for k in range(horizon):
        obs = beta.reshape(1).to(ctrl.initial_marking.dtype)
        cstate, actions, _ = controller_step(ctrl, cfg, cstate, obs, k)
        control = torch.clamp(_over(actions[0], 3500.0), -0.8, 0.8)
        beta = beta + 0.025 * ((0.9 * control).to(dt) - (beta - 1.9))
        q95 = q95 + 0.030 * ((0.12 - 0.28 * control).to(dt) - 0.15 * (q95 - 4.4))
        dens = dens + 0.010 * ((0.05 * control).to(dt) - 0.08 * (dens - 7.4))
        sig = (0.45 + 0.40 * torch.clamp(beta - 2.0, min=0.0)
               + 0.30 * torch.clamp(4.2 - q95, min=0.0)
               + 0.10 * torch.clamp(dens - 8.8, min=0.0))
        buf = torch.where(idx == HISTORY_WINDOW + k, sig, buf)
        mask_k = base_mask | (idx < HISTORY_WINDOW + k + 1)
        ac = control.abs()
        toroidal = torch.stack([
            0.06 + 0.04 * ac, 0.04 + 0.03 * ac, 0.02 + 0.02 * ac,
            0.07 + 0.06 * ac, 0.02 + 0.01 * ac])
        risks.append(disruption_risk_masked(buf, mask_k, toroidal))
        controls.append(control)
    risks = torch.stack(risks)
    safe_rate = torch.mean((risks < 0.85).to(dt))
    mean_risk = torch.mean(risks)
    return PlanSummary(
        safe_horizon_rate=safe_rate,
        mean_risk=mean_risk,
        recommended_action=controls[-1],
        passes=(safe_rate >= 0.90) & (mean_risk <= 0.75),
    )


def _run_realtime_twin_session(
    machine: str,
    stream_noise: torch.Tensor,
    chaos_uniforms: torch.Tensor,
    chaos_normals: torch.Tensor,
    *,
    dt_ms: int = 5,
    horizon: int = 24,
    plan_every: int = 8,
    chaos_dropout_prob: float = 0.0,
    chaos_noise_std: float = 0.0,
):
    """:func:`run_realtime_twin_session` with its draws given: the stream's
    normals (2, samples) and the chaos uniforms and normals (4, samples), in
    the session's dtype on its device."""
    machine = _normalize_machine(machine)
    if plan_every < 1:
        raise ValueError("plan_every must be >= 1.")
    samples = stream_noise.shape[1]
    stream = _emulated_stream(machine, stream_noise, dt_ms=dt_ms)
    stream, n_drop, n_noise = _apply_chaos_monkey(
        stream, chaos_uniforms, chaos_normals,
        dropout_prob=chaos_dropout_prob, noise_std=chaos_noise_std)
    signals = risk_signal(stream)

    dev = signals.device
    ctrl, cfg = build_snn_planner(device=dev)
    plan_idx = torch.arange(plan_every, samples, plan_every, device=dev)
    pos = plan_idx[:, None] + torch.arange(-(HISTORY_WINDOW - 1), 1, device=dev)[None, :]
    hist = signals[torch.clamp(pos, 0, samples - 1)]
    mask = pos >= 0

    def plan_at(h, m, beta0, q95_0, dens0):
        return tuple(scenario_plan(ctrl, cfg, h, m, beta0, q95_0, dens0, horizon=horizon))

    plans = PlanSummary(*torch.func.vmap(plan_at)(
        hist, mask, stream.beta_n[plan_idx], stream.q95[plan_idx],
        stream.density_1e19[plan_idx]))
    info = {
        "n_plans": plan_idx.shape[0],
        "chaos_dropouts": n_drop,
        "chaos_noise_injections": n_noise,
        "all_pass_rate": torch.mean(plans.passes.to(torch.float32)),
        "worst_mean_risk": torch.amax(plans.mean_risk),
        "min_safe_horizon_rate": torch.amin(plans.safe_horizon_rate),
    }
    return plans, info


def run_realtime_twin_session(
    machine: str,
    *,
    seed: int = 42,
    samples: int = 320,
    dt_ms: int = 5,
    horizon: int = 24,
    plan_every: int = 8,
    chaos_dropout_prob: float = 0.0,
    chaos_noise_std: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
):
    """Full ingest+planning session (reference ``run_realtime_twin_session``
    :280-372); the plan points are one batch.  The draws come from
    ``generator`` (a CPU generator seeded with ``seed`` when none is given),
    so the card and the CPU see the same draws.

    Returns ``(plans: PlanSummary, info: dict of scalars)``.
    """
    _normalize_machine(machine)
    _check_stream(samples, dt_ms)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    draws = (torch.randn((2, samples), generator=generator, dtype=torch.float64),
             torch.rand((4, samples), generator=generator, dtype=torch.float64),
             torch.randn((4, samples), generator=generator, dtype=torch.float64))
    return _run_realtime_twin_session(
        machine, *(d.to(dtype=dtype, device=device) for d in draws), dt_ms=dt_ms,
        horizon=horizon, plan_every=plan_every, chaos_dropout_prob=chaos_dropout_prob,
        chaos_noise_std=chaos_noise_std)
