"""Phase observability: realtime UPDE monitor, stream codec, GK bridge
(port of ``scpn_fusion_tpu/models/phase/monitor.py``).

* The monitored run -- UPDE tick, Lyapunov guard and trajectory recorder --
  is ONE launch of row U on a CUDA tensor (``ops/cuda_phase.monitor_run``,
  ``csrc/phase.cu``), where the JAX package compiles one ``lax.scan``; on a
  CPU tensor it is the loop of :func:`monitor_tick` (the kernel's plain
  twin).  Snapshots come back as stacked tensors, and ``save_npz`` persists
  the recorder.  :func:`monitor_tick` stays on plain ops: it takes a
  coupling override a tick.
* The stream codec: authenticated snapshot frames (bearer token compared in
  constant time, loopback-only binding guard, JSON snapshot frames, bounded
  command messages) over any byte stream.  Pure Python.
* The GK -> UPDE bridge: turbulence growth rates and fluxes modulate the
  layer coupling matrix K_nm and the turbulence layer's natural frequency.

:func:`init_monitor` draws with ``numpy.random.default_rng(seed)``, as the
JAX package does, so its state is the JAX package's to the bit; it forces
float32 by default, as JAX does.
"""

from __future__ import annotations

import dataclasses
import hmac
import json
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.phase.guard import (
    GuardConfig,
    GuardState,
    guard_update,
    init_guard,
)
from scpn_fusion_tpu_torch.models.phase.knm import KnmSpec, plasma_omega
from scpn_fusion_tpu_torch.models.phase.upde import _counts, _layer_sums, _tick

# ── Realtime monitor (fused tick stream) ─────────────────────────────────


class MonitorState(NamedTuple):
    theta: torch.Tensor        # (L, n) padded phases
    guard: GuardState
    tick: torch.Tensor


class MonitorTrace(NamedTuple):
    """Stacked snapshots — the TrajectoryRecorder as tensors."""

    r_global: torch.Tensor     # (T,)
    r_layer: torch.Tensor      # (T, L)
    v_global: torch.Tensor     # (T,)
    v_layer: torch.Tensor      # (T, L)
    lambda_exp: torch.Tensor   # (T,)
    guard_approved: torch.Tensor
    guard_violations: torch.Tensor

    @property
    def n_ticks(self) -> int:
        return int(self.r_global.shape[0])

    def snapshot(self, i: int) -> dict[str, Any]:
        """One dashboard snapshot dict (reference ``tick`` return shape)."""
        return {
            "tick": int(i) + 1,
            "R_global": float(self.r_global[i]),
            "R_layer": self.r_layer[i].cpu().tolist(),
            "V_global": float(self.v_global[i]),
            "V_layer": self.v_layer[i].cpu().tolist(),
            "lambda_exp": float(self.lambda_exp[i]),
            "guard_approved": bool(self.guard_approved[i]),
            "guard_violations": int(self.guard_violations[i]),
        }

    def save_npz(self, path: str | Path) -> Path:
        path = Path(path)
        np.savez(path, **{k: v.detach().cpu().numpy() for k, v in self._asdict().items()})
        return path


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    dt: float = 1e-3
    psi_driver: float = 0.0
    pac_gamma: float = 0.0
    guard: GuardConfig = GuardConfig()


def init_monitor(spec: KnmSpec, *, n_per: int = 50, seed: int = 42,
                 cfg: MonitorConfig = MonitorConfig(), dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
    """Build (state, static arrays) from a plasma Knm spec (reference
    ``from_plasma`` :150-185)."""
    n_layers = spec.n_layers
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, (n_layers, n_per))
    omega_base = plasma_omega(n_layers)
    omega = omega_base[:, None] + rng.normal(0, 0.2, (n_layers, n_per))
    mask = np.ones((n_layers, n_per))
    k_matrix, alpha, zeta = spec.arrays(dtype, device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    state = MonitorState(theta=t(theta), guard=init_guard(cfg.guard, dtype, device),
                         tick=torch.zeros((), dtype=torch.int32, device=device))
    arrays = {"omega": t(omega), "mask": t(mask), "k_matrix": k_matrix, "alpha": alpha,
              "zeta": zeta}
    return state, arrays


def monitor_tick(state: MonitorState, arrays: dict, *, cfg: MonitorConfig = MonitorConfig(),
                 k_override: torch.Tensor | None = None):
    """One monitored UPDE tick; returns (new_state, snapshot dict).  The
    guard's V is the mean over every oscillator of the flattened phases, its
    sum the tree over the layers of each layer's tree."""
    theta, mask = state.theta, arrays["mask"]
    k_matrix = arrays["k_matrix"] if k_override is None else k_override
    psi = torch.as_tensor(cfg.psi_driver, dtype=theta.dtype, device=theta.device)
    counts, total = _counts(mask)
    theta1, aux, v_sum = _tick(
        theta, arrays["omega"], mask, k_matrix, arrays["alpha"], arrays["zeta"], dt=cfg.dt,
        psi_global=psi, actuation_gain=1.0, pac_gamma=cfg.pac_gamma, wrap=True, counts=counts,
        total=total, layer=_layer_sums(theta, mask))
    v = (v_sum * torch.reciprocal(v_sum.new_full((), float(theta.numel())))).to(
        state.guard.v_buffer.dtype)
    verdict, guard_state = guard_update(cfg.guard, state.guard, v)
    new_state = MonitorState(theta=theta1, guard=guard_state, tick=state.tick + 1)
    snap = {
        "r_global": aux["R_global"], "r_layer": aux["R_layer"],
        "v_global": aux["V_global"], "v_layer": aux["V_layer"],
        "lambda_exp": verdict.lambda_exp,
        "guard_approved": verdict.approved,
        "guard_violations": verdict.consecutive_violations,
    }
    return new_state, snap


def run_monitor(state: MonitorState, arrays: dict, *, cfg: MonitorConfig = MonitorConfig(),
                n_ticks: int = 1000) -> tuple[MonitorState, MonitorTrace]:
    """The whole monitored run — UPDE + guard + recorder: one launch of row
    U on a CUDA tensor, the loop of :func:`monitor_tick` on a CPU one."""
    from scpn_fusion_tpu_torch.ops.cuda_phase import monitor_run

    return monitor_run(state, arrays, cfg, n_ticks)


# ── Stream codec (transport-agnostic ws_phase_stream semantics) ──────────


def constant_time_token_eq(candidate: str, expected: str) -> bool:
    """Constant-time bearer-token comparison (reference
    ``_constant_time_eq`` :61-64)."""
    return hmac.compare_digest(candidate.encode("utf-8"), expected.encode("utf-8"))


def is_loopback_host(host: str) -> bool:
    """Reference ``_is_loopback_host`` :66-68: non-loopback binds require
    explicit opt-in (the stream carries machine state)."""
    return host in ("127.0.0.1", "::1", "localhost")


class StreamAuthError(PermissionError):
    pass


@dataclasses.dataclass(frozen=True)
class PhaseStreamCodec:
    """Authenticated JSON frame codec for monitor snapshots.

    Frames: one JSON object per line with a ``token`` field; decoding
    validates the token in constant time and bounds command values
    (reference ``_message_authorized`` + ``_coerce_command_value``
    :106-146).  Transport-agnostic by design: any byte stream works.
    """

    token: str
    max_frame_bytes: int = 65536
    command_bounds: tuple[float, float] = (-10.0, 10.0)

    def encode_snapshot(self, snap: dict[str, Any]) -> bytes:
        payload = {"type": "snapshot", "token": self.token, **snap}
        return (json.dumps(payload) + "\n").encode("utf-8")

    def decode(self, frame: bytes) -> dict[str, Any]:
        if len(frame) > self.max_frame_bytes:
            raise StreamAuthError("frame exceeds size bound")
        try:
            payload = json.loads(frame.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise StreamAuthError(f"malformed frame: {exc}") from exc
        if not isinstance(payload, dict):
            raise StreamAuthError("frame must be a JSON object")
        token = payload.get("token")
        if not (isinstance(token, str) and constant_time_token_eq(token, self.token)):
            raise StreamAuthError("bad or missing bearer token")
        return payload

    def decode_command(self, frame: bytes) -> tuple[str, float]:
        """Authorised (name, value) command with bounded value."""
        payload = self.decode(frame)
        if payload.get("type") != "command":
            raise StreamAuthError("not a command frame")
        name = payload.get("name")
        if not isinstance(name, str) or not name.strip():
            raise StreamAuthError("command needs a non-empty name")
        try:
            value = float(payload.get("value"))
        except (TypeError, ValueError) as exc:
            raise StreamAuthError("command value must be numeric") from exc
        lo, hi = self.command_bounds
        if not (np.isfinite(value) and lo <= value <= hi):
            raise StreamAuthError(f"command value {value} outside bounds [{lo}, {hi}]")
        return name, value


def stream_trace(trace: MonitorTrace, codec: PhaseStreamCodec, writer) -> int:
    """Write every snapshot of a trace as authenticated frames; returns
    the frame count.  ``writer`` is any object with ``write(bytes)``."""
    n = trace.n_ticks
    for i in range(n):
        writer.write(codec.encode_snapshot(trace.snapshot(i)))
    return n


# ── GK -> UPDE bridge ────────────────────────────────────────────────────


def adaptive_knm_from_gk(
    k_base: torch.Tensor,          # (L, L)
    gamma_max,                     # dominant GK growth rate [c_s/a]
    chi_e,                         # electron heat diffusivity [m^2/s]
    chi_i_profile: torch.Tensor | None = None,
    *,
    gamma_ref: float = 0.2,
    chi_ref: float = 1.0,
) -> torch.Tensor:
    """Modulate K_nm from GK outputs (reference ``adaptive_knm`` :29-73).

    Layer semantics (plasma Knm convention): 0 = microturbulence,
    1 = zonal flows, 3 = sawtooth/ELM, 4 = transport barrier.
    """
    el = k_base.shape[0]
    if el < 6:
        return k_base
    kw = dict(dtype=k_base.dtype, device=k_base.device)
    k = k_base.clone()
    gamma_max = torch.as_tensor(gamma_max, **kw)
    chi_e = torch.as_tensor(chi_e, **kw)

    # P0<->P1: microturbulence <-> zonal flows.
    f01 = 1.0 + 0.5 * torch.tanh(gamma_max / max(gamma_ref, 1e-10))
    k[0, 1] = k_base[0, 1] * f01
    k[1, 0] = k_base[0, 1] * f01

    # P1<->P4: zonal flow <-> transport barrier.
    f14 = 1.0 + 0.3 * torch.clamp(torch.clamp(chi_e, min=1e-10) / chi_ref, 0.0, 2.0)
    k[1, 4] = k_base[1, 4] * f14
    k[4, 1] = k_base[1, 4] * f14

    # P3<->P4: pedestal ratio from the chi_i profile.
    if chi_i_profile is not None:
        chi_i_profile = torch.as_tensor(chi_i_profile, **kw)
        n = chi_i_profile.shape[0]
        chi_core = torch.clamp(torch.mean(chi_i_profile[: n // 3]), min=1e-10)
        chi_ped = torch.clamp(torch.mean(chi_i_profile[-(n // 5):]), min=1e-10)
        f34 = 1.0 + 0.4 * (chi_ped / chi_core - 1.0)
        k[3, 4] = k_base[3, 4] * f34
        k[4, 3] = k_base[3, 4] * f34
    return k


def gk_natural_frequencies(omega_base: torch.Tensor, gamma_max, *,
                           gamma_scale: float = 0.1) -> torch.Tensor:
    """Turbulence layer frequency rises with the dominant growth rate
    (reference ``gk_natural_frequencies`` :76-110)."""
    out = omega_base.clone()
    gamma = torch.as_tensor(gamma_max, dtype=omega_base.dtype, device=omega_base.device)
    out[0] = out[0] + gamma_scale * torch.clamp(gamma, min=0.0)
    return out
