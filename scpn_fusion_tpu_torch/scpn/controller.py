"""Neuro-symbolic SCPN controller runtime (port of
``scpn_fusion_tpu/scpn/controller.py``).

Feature extraction (error -> unipolar pos/neg), place injection, the float
"oracle" path and the stochastic path (antithetic Bernoulli passes, mantissa
bit-flip fault injection, per-transition delay ring buffer), and action
decoding with gain / slew-rate / absolute clamps, on dense tensors.

Random numbers.  JAX draws with threefry keys (``fold_in(PRNGKey(seed_base),
k)``), whose bits PyTorch cannot reproduce.  So every step that draws is
split in two: :func:`controller_step` draws this tick's numbers from a
``torch.Generator`` seeded from ``(cfg.seed_base, k)`` (deterministic by
tick, as JAX's fold-in is) and hands them to :func:`_controller_step`, which
takes the draws as tensors (:class:`StepDraws`) and does the rest.  The
parity tests feed the private step JAX's own draws.  A deterministic
configuration (:func:`needs_draws` is false) draws nothing.

The state is an explicit NamedTuple, updated out of place, so a tick loop
can carry it (``run_controller``, ``control/neuro_closed_loop.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.scpn.structure import CompiledNet


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Static controller configuration (hashable)."""

    firing_mode: str = "binary"          # "binary" | "fractional"
    firing_margin: float = 0.05
    sc_n_passes: int = 1
    sc_binary_margin: float = 0.0
    sc_antithetic: bool = True
    sc_bitflip_rate: float = 0.0
    max_delay_ticks: int = 0
    dt: float = 1e-4
    seed_base: int = 42

    def __post_init__(self) -> None:
        if self.firing_mode not in ("binary", "fractional"):
            raise ValueError("firing_mode must be 'binary' or 'fractional'")
        if self.sc_n_passes < 1:
            raise ValueError("sc_n_passes must be >= 1")
        if not 0.0 <= self.sc_bitflip_rate < 1.0:
            raise ValueError("sc_bitflip_rate must be in [0, 1)")


class CompiledController(NamedTuple):
    """Controller weights and specs as tensors on one device.

    Feature axes: ``err = clip((target - obs)/scale, -1, 1)`` split into
    pos/neg channels.  Injections write ``value*scale + offset`` into
    ``inj_place_ids``.  Actions difference pos/neg places with gain and
    clamps (reference ``contracts.py:100-242``).
    """

    w_in: torch.Tensor          # (nT, nP)
    w_out: torch.Tensor         # (nP, nT)
    thresholds: torch.Tensor    # (nT,)
    delays: torch.Tensor        # (nT,) int32
    initial_marking: torch.Tensor  # (nP,)
    # feature axes
    axis_targets: torch.Tensor  # (nA,)
    axis_scales: torch.Tensor   # (nA,)
    # injections
    inj_place_ids: torch.Tensor  # (nI,) int32
    inj_axis_idx: torch.Tensor   # (nI,) int32
    inj_is_pos: torch.Tensor     # (nI,) bool
    inj_scale: torch.Tensor      # (nI,)
    inj_offset: torch.Tensor     # (nI,)
    # actions
    act_pos: torch.Tensor       # (nAct,) int32
    act_neg: torch.Tensor       # (nAct,) int32
    act_gain: torch.Tensor      # (nAct,)
    act_abs_max: torch.Tensor   # (nAct,)
    act_slew_per_s: torch.Tensor  # (nAct,)


class ControllerState(NamedTuple):
    marking: torch.Tensor       # (nP,)
    pending: torch.Tensor       # (max_delay+1, nT) delay ring buffer
    cursor: torch.Tensor        # int32
    prev_actions: torch.Tensor  # (nAct,)


class StepDraws(NamedTuple):
    """The random numbers of one tick (``None`` where the configuration
    draws none): ``sample`` the uniforms of the firing estimator ((n_pairs
    or n_passes, nT)); ``flip_firing`` / ``flip_marking`` the (uniforms,
    int32 bit positions) of the bit flips of the firing (nT,) and marking
    (nP,) vectors."""

    sample: torch.Tensor | None = None
    flip_firing: tuple[torch.Tensor, torch.Tensor] | None = None
    flip_marking: tuple[torch.Tensor, torch.Tensor] | None = None


def build_controller(
    net: CompiledNet,
    *,
    axis_targets,
    axis_scales,
    injections,      # list of (place_name, axis_idx, is_pos, scale, offset)
    actions,         # list of (pos_place_name, neg_place_name, gain, abs_max, slew)
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> CompiledController:
    """Assemble the controller tensors from a compiled net + specs."""
    pid = {n: i for i, n in enumerate(net.place_names)}
    inj = list(injections)
    act = list(actions)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return CompiledController(
        w_in=t(net.w_in),
        w_out=t(net.w_out),
        thresholds=t(net.thresholds),
        delays=t(net.delays, torch.int32),
        initial_marking=t(net.initial_marking),
        axis_targets=t(axis_targets),
        axis_scales=t(axis_scales),
        inj_place_ids=t([pid[p] for p, *_ in inj], torch.int32),
        inj_axis_idx=t([a for _, a, *_ in inj], torch.int32),
        inj_is_pos=t([bool(s) for _, _, s, *_ in inj], torch.bool),
        inj_scale=t([sc for *_, sc, _ in inj]),
        inj_offset=t([off for *_, off in inj]),
        act_pos=t([pid[p] for p, *_ in act], torch.int32),
        act_neg=t([pid[n] for _, n, *_ in act], torch.int32),
        act_gain=t([g for *_, g, _, _ in act]),
        act_abs_max=t([m for *_, m, _ in act]),
        act_slew_per_s=t([s for *_, s in act]),
    )


def initial_controller_state(ctrl: CompiledController, cfg: ControllerConfig) -> ControllerState:
    n_t = ctrl.thresholds.shape[0]
    n_act = ctrl.act_gain.shape[0]
    dtype, dev = ctrl.initial_marking.dtype, ctrl.initial_marking.device
    return ControllerState(
        marking=ctrl.initial_marking,
        pending=torch.zeros((cfg.max_delay_ticks + 1, n_t), dtype=dtype, device=dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        prev_actions=torch.zeros((n_act,), dtype=dtype, device=dev),
    )


def extract_features(ctrl: CompiledController, obs_vec: torch.Tensor):
    """obs -> unipolar pos/neg feature channels (``contracts.py:100-165``)."""
    scale = torch.where(ctrl.axis_scales.abs() > 1e-12, ctrl.axis_scales,
                        torch.full_like(ctrl.axis_scales, 1e-12))
    err = torch.clamp((ctrl.axis_targets - obs_vec) / scale, -1.0, 1.0)
    pos = torch.clamp(torch.clamp(err, min=0.0), 0.0, 1.0)
    neg = torch.clamp(torch.clamp(-err, min=0.0), 0.0, 1.0)
    return pos, neg


def is_stochastic(cfg: ControllerConfig) -> bool:
    """Whether the firing vector is sampled (``controller.py:222-223``)."""
    return not (cfg.sc_n_passes <= 1 or (cfg.firing_mode == "binary"
                                         and cfg.sc_binary_margin <= 0.0))


def needs_draws(cfg: ControllerConfig) -> bool:
    """Whether a tick of ``cfg`` takes random numbers at all."""
    return is_stochastic(cfg) or cfg.sc_bitflip_rate > 0.0


def _tick_seed(seed_base: int, k: int) -> int:
    """The generator seed of tick ``k``: one seed a (seed_base, tick) pair."""
    return ((int(seed_base) << 32) ^ int(k)) & 0x7FFF_FFFF_FFFF_FFFF


def _draw_step(ctrl: CompiledController, cfg: ControllerConfig,
              generator: torch.Generator) -> StepDraws:
    """This tick's random numbers from ``generator``, in the marking's dtype
    and on its device (the shapes JAX draws at ``controller.py:158-184``)."""
    dtype, dev = ctrl.initial_marking.dtype, ctrl.initial_marking.device
    n_t, n_p = ctrl.thresholds.shape[0], ctrl.initial_marking.shape[0]

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype, device=dev)

    def flips(n):
        return uniform(n), torch.randint(0, 23, (n,), generator=generator, dtype=torch.int32,
                                         device=dev)

    sample = flip_f = flip_m = None
    if is_stochastic(cfg):
        n = cfg.sc_n_passes
        sample = uniform((n + 1) // 2 if cfg.sc_antithetic and n >= 2 else n, n_t)
    if cfg.sc_bitflip_rate > 0.0:
        flip_f, flip_m = flips(n_t), flips(n_p)
    return StepDraws(sample, flip_f, flip_m)


def _bitflip(values: torch.Tensor, rate: float, uniforms: torch.Tensor,
             bits: torch.Tensor) -> torch.Tensor:
    """Mantissa bit-flip fault injection (``controller_features_mixin.py:
    167-187``), f32 variant: where ``uniforms < rate``, flip bit ``bits`` of
    the float32 value."""
    flips = uniforms < rate
    raw = values.to(torch.float32).view(torch.int32)
    flipped = (raw ^ torch.bitwise_left_shift(torch.ones_like(bits), bits)).view(
        torch.float32).to(values.dtype)
    out = torch.where(flips, flipped, values)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return torch.clamp(out, 0.0, 1.0)


def _sample_firing(p_fire: torch.Tensor, cfg: ControllerConfig,
                   uniforms: torch.Tensor) -> torch.Tensor:
    """Deterministic antithetic-pair Bernoulli estimator of p_fire
    (replaces the reference's packed-bitstream popcount path)."""
    n = cfg.sc_n_passes
    if cfg.sc_antithetic and n >= 2:
        base = uniforms
        low = (base < p_fire[None, :]).sum(0)
        high_base = base if n % 2 == 0 else base[:-1, :]
        counts = low + (high_base > (1.0 - p_fire)[None, :]).sum(0)
    else:
        counts = (uniforms < p_fire[None, :]).sum(0)
    return counts.to(p_fire.dtype) / float(n)


def _firing_probability(ctrl: CompiledController, cfg: ControllerConfig,
                        a: torch.Tensor) -> torch.Tensor:
    if cfg.firing_mode == "fractional":
        margin = max(cfg.firing_margin, 1e-12)
        return torch.clamp((a - ctrl.thresholds) / margin, 0.0, 1.0)
    if cfg.sc_binary_margin > 0.0:
        return torch.clamp(0.5 + 0.5 * (a - ctrl.thresholds) / cfg.sc_binary_margin, 0.0, 1.0)
    return (a >= ctrl.thresholds).to(a.dtype)


def controller_step(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    state: ControllerState,
    obs_vec: torch.Tensor,
    k: int,
):
    """One control tick: features -> inject -> SC Petri step -> actions.

    Returns (new_state, actions, diagnostics) where diagnostics carries the
    firing and marking vectors (the reference's ``last_sc_*`` surface).
    Tick ``k``'s random numbers come from a generator seeded from
    ``(cfg.seed_base, k)``, so a run is deterministic by tick.
    """
    draws = StepDraws()
    if needs_draws(cfg):
        gen = torch.Generator(device=ctrl.initial_marking.device)
        gen.manual_seed(_tick_seed(cfg.seed_base, int(k)))
        draws = _draw_step(ctrl, cfg, gen)
    return _controller_step(ctrl, cfg, state, obs_vec, draws)


def _controller_step(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    state: ControllerState,
    obs_vec: torch.Tensor,
    draws: StepDraws,
):
    """:func:`controller_step` with this tick's random numbers given."""
    dtype = state.marking.dtype
    pos, neg = extract_features(ctrl, obs_vec)

    # Place injection.
    axis = ctrl.inj_axis_idx.long()
    values = torch.where(ctrl.inj_is_pos, pos[axis], neg[axis])
    values = torch.clamp(values * ctrl.inj_scale + ctrl.inj_offset, 0.0, 1.0)
    m = state.marking.index_put((ctrl.inj_place_ids.long(),), values.to(dtype))

    # Activations and firing probability.
    p_fire = _firing_probability(ctrl, cfg, ctrl.w_in @ m)
    f = _sample_firing(p_fire, cfg, draws.sample) if is_stochastic(cfg) else p_fire
    if cfg.sc_bitflip_rate > 0.0:
        f = _bitflip(f, cfg.sc_bitflip_rate, *draws.flip_firing)

    # Per-transition delay ring buffer (``_apply_transition_timing``).
    if cfg.max_delay_ticks > 0:
        pending = state.pending.clone()
        cur = state.cursor.long()
        fired_now = pending[cur].clone()
        pending[cur] = 0.0
        immediate = ctrl.delays == 0
        zero = torch.zeros_like(f)
        fired_now = torch.clamp(fired_now + torch.where(immediate, f, zero), 0.0, 1.0)
        n_t = f.shape[0]
        slots = (state.cursor + ctrl.delays) % pending.shape[0]
        pending.index_put_((slots.long(), torch.arange(n_t, device=f.device)),
                           torch.where(immediate, zero, f).to(pending.dtype), accumulate=True)
        pending = torch.clamp(pending, 0.0, 1.0)
        cursor = (state.cursor + 1) % pending.shape[0]
        f_timed = fired_now
    else:
        pending, cursor, f_timed = state.pending, state.cursor, f

    # Marking update: m' = clip(m - W_in^T f + W_out f, 0, 1).
    m2 = torch.clamp(m - ctrl.w_in.T @ f_timed + ctrl.w_out @ f_timed, 0.0, 1.0)
    if cfg.sc_bitflip_rate > 0.0:
        m2 = _bitflip(m2, cfg.sc_bitflip_rate, *draws.flip_marking)

    # Action decode: gain * (pos - neg), slew limit, abs clamp.
    raw = (m2[ctrl.act_pos.long()] - m2[ctrl.act_neg.long()]) * ctrl.act_gain
    max_delta = ctrl.act_slew_per_s * cfg.dt
    raw = torch.minimum(torch.maximum(raw, state.prev_actions - max_delta),
                        state.prev_actions + max_delta)
    actions = torch.minimum(torch.maximum(raw, -ctrl.act_abs_max), ctrl.act_abs_max)

    new_state = ControllerState(m2, pending, cursor, actions)
    return new_state, actions, {"firing": f_timed, "marking": m2}


def oracle_step(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    marking: torch.Tensor,
):
    """Float-path Petri step for diagnostics (``_oracle_step``)."""
    a = ctrl.w_in @ marking
    if cfg.firing_mode == "fractional":
        margin = max(cfg.firing_margin, 1e-12)
        f = torch.clamp((a - ctrl.thresholds) / margin, 0.0, 1.0)
    else:
        f = (a >= ctrl.thresholds).to(marking.dtype)
    m2 = torch.clamp(marking - ctrl.w_in.T @ f + ctrl.w_out @ f, 0.0, 1.0)
    return f, m2


def run_controller(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    state: ControllerState,
    obs_sequence: torch.Tensor,   # (n_steps, nA)
):
    """Run a whole observation sequence, tick by tick; returns the final
    state and the (n_steps, nAct) action trace."""
    actions = []
    for k in range(obs_sequence.shape[0]):
        state, act, _ = controller_step(ctrl, cfg, state, obs_sequence[k], k)
        actions.append(act)
    return state, torch.stack(actions)
