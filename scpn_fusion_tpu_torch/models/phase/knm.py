"""Plasma-layer coupling matrices (Knm) + adaptive online tuning (port of
``scpn_fusion_tpu/models/phase/knm.py``).

The 8-layer plasma process hierarchy (micro-turbulence ... plasma-wall
interaction) with a distance-decay coupling backbone, literature-motivated
pair overlays, instability-mode biases, and a diagnostic-driven adaptive
engine (beta scaling, disruption-risk pair boosts, per-layer coherence PI,
rate limiting, guard-veto revert).  Matrix construction is host-side NumPy
(static configuration), as in the JAX package; the adaptive update is plain
tensor ops over an explicit state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

PLASMA_LAYER_NAMES = (
    "micro_turbulence", "zonal_flows", "mhd_tearing", "sawtooth_elm",
    "transport_barrier", "current_profile", "global_equilibrium",
    "plasma_wall",
)

# Natural frequencies per layer (fast -> slow), reference
# ``plasma_knm.py:112-124``.
OMEGA_PLASMA_8 = np.array([8.50, 5.20, 4.80, 3.10, 2.40, 0.85, 0.72, 0.18])

_VALID_MODES = frozenset({"baseline", "elm", "ntm", "sawtooth", "hybrid"})


@dataclasses.dataclass(frozen=True)
class KnmSpec:
    """Coupling spec: K[n, m] = source n -> target m; optional lags/driver."""

    k: np.ndarray
    alpha: Optional[np.ndarray] = None
    zeta: Optional[np.ndarray] = None
    layer_names: Optional[Sequence[str]] = None

    def __post_init__(self):
        k = np.asarray(self.k, dtype=np.float64)
        if k.ndim != 2 or k.shape[0] != k.shape[1]:
            raise ValueError("K must be square (L, L)")
        n = k.shape[0]
        if self.alpha is not None and np.shape(self.alpha) != (n, n):
            raise ValueError(f"alpha shape {np.shape(self.alpha)} != ({n},{n})")
        if self.zeta is not None and np.shape(self.zeta) != (n,):
            raise ValueError(f"zeta shape {np.shape(self.zeta)} != ({n},)")

    @property
    def n_layers(self) -> int:
        return np.asarray(self.k).shape[0]

    def arrays(self, dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"):
        """(K, alpha, zeta) as tensors with zero defaults."""
        n = self.n_layers

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

        return (t(self.k), t(self.alpha if self.alpha is not None else np.zeros((n, n))),
                t(self.zeta if self.zeta is not None else np.zeros(n)))


def plasma_omega(n_layers: int = 8) -> np.ndarray:
    """Layer natural frequencies: table for L<=8, log-interp beyond."""
    if n_layers <= 8:
        return OMEGA_PLASMA_8[:n_layers].copy()
    return np.logspace(np.log10(OMEGA_PLASMA_8[0]),
                       np.log10(OMEGA_PLASMA_8[-1]), num=n_layers)


def build_knm_plasma(mode: str = "baseline", n_layers: int = 8,
                     k_base: float = 0.30, zeta_uniform: float = 0.0,
                     custom_overrides: Optional[dict] = None) -> KnmSpec:
    """Distance-decay backbone + physics pair overlays + mode bias
    (reference ``build_knm_plasma``)."""
    if mode not in _VALID_MODES:
        raise ValueError(f"unknown plasma mode {mode!r}")
    idx = np.arange(n_layers)
    k = k_base * np.exp(-0.5 * np.abs(idx[:, None] - idx[None, :]))

    if n_layers >= 8:
        s = n_layers // 8
        pairs = {   # literature-motivated couplings
            (0, 1): 0.42,   # drift-wave <-> zonal flow predator-prey
            (1, 4): 0.28,   # ExB shear suppression of transport
            (2, 5): 0.35,   # NTM <-> bootstrap current
            (3, 5): 0.30,   # sawtooth <-> current redistribution
            (3, 4): 0.32,   # ELM crash depletes pedestal
            (4, 6): 0.25,   # transport <-> equilibrium
            (7, 4): 0.20,   # PWI <-> edge transport
            (7, 6): 0.15,   # wall conditioning <-> equilibrium
        }
        for (i, j), val in pairs.items():
            k[i * s, j * s] = k[j * s, i * s] = val

        if mode == "elm":
            k[3 * s, 4 * s] *= 1.8
            k[4 * s, 3 * s] *= 1.8
            k[3 * s, 7 * s] = max(k[3 * s, 7 * s], 0.22)
            k[7 * s, 3 * s] = max(k[7 * s, 3 * s], 0.22)
        elif mode == "ntm":
            k[2 * s, 5 * s] *= 1.6
            k[5 * s, 2 * s] *= 1.6
            k[2 * s, 4 * s] = max(k[2 * s, 4 * s], 0.25)
            k[4 * s, 2 * s] = max(k[4 * s, 2 * s], 0.25)
        elif mode == "sawtooth":
            k[3 * s, 5 * s] *= 1.7
            k[5 * s, 3 * s] *= 1.7
            k[3 * s, 0 * s] = max(k[3 * s, 0 * s], 0.18)
            k[0 * s, 3 * s] = max(k[0 * s, 3 * s], 0.18)
        elif mode == "hybrid":
            k *= 1.15

    if custom_overrides:
        for (i, j), val in custom_overrides.items():
            if not (0 <= i < n_layers and 0 <= j < n_layers):
                raise IndexError(f"override ({i},{j}) out of range L={n_layers}")
            k[i, j] = k[j, i] = val

    k = np.maximum(0.5 * (k + k.T), 0.0)
    zeta = (np.full(n_layers, zeta_uniform) if zeta_uniform != 0.0 else None)
    return KnmSpec(k=k, zeta=zeta,
                   layer_names=PLASMA_LAYER_NAMES[:min(n_layers, 8)])


def build_knm_plasma_from_config(r0: float, a: float, b0: float, ip_ma: float,
                                 n_e_19: float, *, mode: str = "baseline",
                                 n_layers: int = 8,
                                 zeta_uniform: float = 0.0) -> KnmSpec:
    """Machine-scaled backbone: K_base = 0.30 (1 + 0.5 beta_proxy),
    beta_proxy = n_e a / B0^2."""
    beta_proxy = n_e_19 * a / max(b0**2, 1e-9)
    return build_knm_plasma(mode=mode, n_layers=n_layers,
                            k_base=0.30 * (1.0 + 0.5 * beta_proxy),
                            zeta_uniform=zeta_uniform)


# ---------------------------------------------------------------------------
# Adaptive Knm engine (functional state)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdaptiveKnmConfig:
    beta_scale: float = 0.3
    beta_max_boost: float = 0.5
    risk_pairs: tuple = ((2, 5), (3, 5), (2, 4))
    risk_gain: float = 0.4
    coherence_kp: float = 0.15
    coherence_ki: float = 0.02
    coherence_r_target: float = 0.6
    coherence_max_boost: float = 0.3
    max_delta_per_tick: float = 0.02
    revert_on_guard_refusal: bool = True


class AdaptiveKnmState(NamedTuple):
    k_current: torch.Tensor
    k_last_good: torch.Tensor
    integral: torch.Tensor      # (L,) coherence PI integrator


def init_adaptive_state(spec: KnmSpec, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda") -> AdaptiveKnmState:
    k = torch.as_tensor(np.asarray(spec.k, np.float64), dtype=dtype, device=device)
    return AdaptiveKnmState(k, k, torch.zeros(spec.n_layers, dtype=dtype, device=device))


def adaptive_knm_update(
    cfg: AdaptiveKnmConfig,
    baseline_k: torch.Tensor,
    state: AdaptiveKnmState,
    *,
    r_layer: torch.Tensor,
    beta_n,
    disruption_risk,
    guard_approved,
) -> AdaptiveKnmState:
    """One adaptation tick (reference ``AdaptiveKnmEngine.update``), pure.

    Channels: beta matrix scaling, risk-pair boosts, per-layer coherence
    PI on the diagonal; invariants (symmetry, K>=0) and per-tick rate
    limit; guard refusal reverts to the last approved matrix.
    """
    n = baseline_k.shape[0]
    kw = dict(dtype=baseline_k.dtype, device=baseline_k.device)
    beta_boost = torch.clamp(cfg.beta_scale * torch.as_tensor(beta_n, **kw),
                             max=cfg.beta_max_boost)
    k_new = baseline_k * (1.0 + beta_boost)     # a new tensor: updated in place below

    delta = cfg.risk_gain * torch.as_tensor(disruption_risk, **kw)
    for i, j in cfg.risk_pairs:
        if i < n and j < n:
            k_new[i, j] = k_new[i, j] + delta
            k_new[j, i] = k_new[j, i] + delta

    error = cfg.coherence_r_target - r_layer[:n]
    integral = torch.clamp(state.integral + cfg.coherence_ki * error,
                           0.0, cfg.coherence_max_boost)
    diag_boost = torch.clamp(cfg.coherence_kp * torch.clamp(error, min=0.0) + integral,
                             max=cfg.coherence_max_boost)
    k_new = k_new + torch.diag(diag_boost)

    k_new = torch.clamp(0.5 * (k_new + k_new.T), min=0.0)
    dk = torch.clamp(k_new - state.k_current, -cfg.max_delta_per_tick, cfg.max_delta_per_tick)
    k_new = torch.clamp(0.5 * ((state.k_current + dk) + (state.k_current + dk).T), min=0.0)

    adapted = AdaptiveKnmState(k_new, k_new, integral)
    if not cfg.revert_on_guard_refusal:
        return adapted
    approved = torch.as_tensor(guard_approved, device=baseline_k.device)
    return AdaptiveKnmState(
        torch.where(approved, adapted.k_current, state.k_last_good),
        torch.where(approved, adapted.k_last_good, state.k_last_good),
        torch.where(approved, adapted.integral, torch.zeros_like(state.integral)))
