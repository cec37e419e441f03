"""Petri-net safety interlocks with inhibitor semantics.

Port of the reference's safety-net layer (``scpn/safety_interlocks.py:
50-215``; properties mirrored by its Lean proofs,
``InterlockReplayInvariance.lean:104-193``): a canonical interlock net where
five control actions (heat/density/power/current/position) are each gated by
a request place and inhibited by a safety-flag place, plus the state->token
mapping against operational limits and deterministic transition-enablement
evaluation.  The Lean-proved properties (replay invariance: same tokens ->
same enablement; a raised flag always denies its action) are enforced here as
property-based tests (``tests/test_scpn_safety.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np

from scpn_fusion_tpu_torch.scpn.structure import CompiledNet, StochasticPetriNet

SAFETY_CHANNELS = ("thermal_limit", "density_limit", "beta_limit",
                   "current_limit", "vertical_limit")
CONTROL_TRANSITIONS = ("heat_ramp", "density_ramp", "power_ramp",
                       "current_ramp", "position_move")
_CHANNEL_OF_TRANSITION = dict(zip(CONTROL_TRANSITIONS, SAFETY_CHANNELS))


@dataclasses.dataclass(frozen=True)
class SafetyLimits:
    """Operational limits (reference defaults)."""

    thermal_limit_kev: float = 25.0
    density_limit_1e19_m3: float = 12.0
    beta_limit: float = 2.8
    current_limit_ma: float = 15.0
    vertical_limit_m_s: float = 1.0


def build_safety_net() -> StochasticPetriNet:
    """Canonical safety-interlock net with inhibitor arcs."""
    net = StochasticPetriNet()
    for p in ("heating_request", "density_request", "power_request",
              "current_request", "position_request"):
        net.add_place(p, initial_tokens=1.0)
    for p in SAFETY_CHANNELS:
        net.add_place(p, initial_tokens=0.0)
    for p in ("heat_output", "density_output", "power_output",
              "current_output", "position_output"):
        net.add_place(p, initial_tokens=0.0)

    for name, request, output, safety in [
        ("heat_ramp", "heating_request", "heat_output", "thermal_limit"),
        ("density_ramp", "density_request", "density_output", "density_limit"),
        ("power_ramp", "power_request", "power_output", "beta_limit"),
        ("current_ramp", "current_request", "current_output", "current_limit"),
        ("position_move", "position_request", "position_output", "vertical_limit"),
    ]:
        net.add_transition(name, threshold=0.5)
        net.add_arc(request, name, weight=1.0)
        net.add_arc(name, output, weight=1.0)
        net.add_arc(safety, name, weight=1.0, inhibitor=True)
    net.compile()
    return net


def _safe_float(state: Mapping[str, float], key: str, default: float) -> float:
    v = float(state.get(key, default))
    return v if np.isfinite(v) else float(default)


def safety_tokens_from_state(
    state: Mapping[str, float],
    *,
    limits: SafetyLimits | None = None,
) -> Dict[str, float]:
    """Map plasma state to binary safety-place tokens (fail-safe on NaN)."""
    lim = limits or SafetyLimits()
    t_e = _safe_float(state, "T_e", 0.0)
    t_max = _safe_float(state, "T_max", lim.thermal_limit_kev)
    n_e = _safe_float(state, "n_e", 0.0)
    n_gw = _safe_float(state, "n_greenwald", lim.density_limit_1e19_m3)
    beta_n = _safe_float(state, "beta_N", 0.0)
    beta_max = _safe_float(state, "beta_no_wall", lim.beta_limit)
    i_p = _safe_float(state, "I_p", 0.0)
    i_max = _safe_float(state, "I_max", lim.current_limit_ma)
    dz_dt = _safe_float(state, "dZ_dt", 0.0)
    vde = _safe_float(state, "vde_threshold", lim.vertical_limit_m_s)
    return {
        "thermal_limit": 1.0 if t_e > t_max else 0.0,
        "density_limit": 1.0 if n_e > n_gw else 0.0,
        "beta_limit": 1.0 if beta_n > beta_max else 0.0,
        "current_limit": 1.0 if i_p > i_max else 0.0,
        "vertical_limit": 1.0 if abs(dz_dt) > vde else 0.0,
    }


def evaluate_transition_enablement(
    net: CompiledNet,
    marking: np.ndarray,
) -> Dict[str, bool]:
    """Deterministic enablement with inhibitor semantics.

    A transition is enabled iff every positive input place carries at least
    its arc weight, every inhibitor place is strictly below its magnitude,
    and the positive activation reaches the threshold.
    """
    m = np.asarray(marking, dtype=np.float64)
    if m.shape != (net.n_places,):
        raise ValueError(f"marking must have shape ({net.n_places},)")
    out: Dict[str, bool] = {}
    for t_idx, t_name in enumerate(net.transition_names):
        row = net.w_in[t_idx]
        pos = row > 0
        inh = row < 0
        pos_ok = bool(np.all(m[pos] >= row[pos] - 1e-12)) if pos.any() else True
        inh_ok = bool(np.all(m[inh] < np.abs(row[inh]) - 1e-12)) if inh.any() else True
        activation = float(np.maximum(row, 0.0) @ m)
        out[t_name] = pos_ok and inh_ok and activation >= float(net.thresholds[t_idx])
    return out


class SafetyInterlockRuntime:
    """Stateful allow/deny evaluator for control actions."""

    def __init__(self, *, net: StochasticPetriNet | None = None,
                 limits: SafetyLimits | None = None) -> None:
        builder = net if net is not None else build_safety_net()
        self.net = builder.compile() if builder._compiled is None else builder._compiled
        self.limits = limits or SafetyLimits()
        self._place_idx = {n: i for i, n in enumerate(self.net.place_names)}
        self._marking = self.net.initial_marking.copy()
        self.last_tokens: Dict[str, float] = {k: 0.0 for k in SAFETY_CHANNELS}
        self.last_violations: list[str] = []

    @property
    def marking(self) -> np.ndarray:
        return self._marking.copy()

    def set_safety_tokens(self, tokens: Mapping[str, float]) -> None:
        for place in SAFETY_CHANNELS:
            v = float(tokens.get(place, 0.0))
            self._marking[self._place_idx[place]] = 1.0 if v > 0.0 else 0.0
        self.last_tokens = {p: float(self._marking[self._place_idx[p]])
                            for p in SAFETY_CHANNELS}

    def allowed_actions(self) -> Dict[str, bool]:
        enabled = evaluate_transition_enablement(self.net, self._marking)
        allowed = {n: bool(enabled.get(n, False)) for n in CONTROL_TRANSITIONS}
        # Contract check: a raised flag must deny its action (fail-closed).
        self.last_violations = [
            t for t, ch in _CHANNEL_OF_TRANSITION.items()
            if self.last_tokens.get(ch, 0.0) > 0.0 and allowed[t]
        ]
        return allowed

    def update_from_state(self, state: Mapping[str, float]) -> Dict[str, bool]:
        self.set_safety_tokens(safety_tokens_from_state(state, limits=self.limits))
        return self.allowed_actions()
