"""Tokamak digital twin: MRE islands + 2D transport + control (port of
``scpn_fusion_tpu/control/digital_twin.py``).

A poloidal-cross-section twin where a Modified-Rutherford-Equation island
model modulates a 2D diffusion-reaction temperature field and a
current-drive action reshapes the q-profile.  The JAX package runs the whole
shot as one ``lax.scan``; here :func:`run_digital_twin` runs it as one launch
of row D (``ops/cuda_twin.twin_shot``, ``csrc/digital_twin.cu``) on the card,
and on the CPU as the loop of :func:`twin_step`, which is also the kernel's
plain twin.

The Laplacian wraps at the edges, as ``jnp.roll`` does: the plasma mask
holds row 0 at the middle column, so that point's upward neighbour is the
last row.  The danger fraction divides a count by a tensor (on a CUDA
tensor ``torch.mean`` multiplies by 1/n^2, and division by a Python number
by its reciprocal; the kernel divides).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.ops import cuda_twin

RESONANCES = (1.5, 2.0, 2.5, 3.0)


@dataclasses.dataclass(frozen=True)
class TwinConfig:
    """Twin knobs (reference defaults :47-160)."""

    grid_size: int = 48
    q0: float = 1.0
    qa: float = 3.0
    eta: float = 1e-5          # resistive MRE timescale
    beta_p: float = 0.6
    w_crit: float = 0.05
    d_base: float = 0.01
    d_turb: float = 0.5
    core_heat: float = 5.0
    dt_island: float = 0.1
    edge_sink: float = 0.05


class TwinState(NamedTuple):
    t_field: torch.Tensor        # (N, N) temperature
    island_widths: torch.Tensor  # (len(RESONANCES),)


class TwinTrace(NamedTuple):
    t_core: torch.Tensor         # (n_steps,)
    island_widths: torch.Tensor  # (n_steps, n_res)
    danger_fraction: torch.Tensor


def _geometry(cfg: TwinConfig, dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cuda"):
    n = cfg.grid_size
    half = n / 2.0
    ax = torch.arange(n, dtype=dtype, device=device) - half
    r_map = torch.sqrt(ax[None, :] ** 2 + ax[:, None] ** 2) / torch.full((), half, dtype=dtype,
                                                                         device=device)
    mask = r_map <= 1.0
    return r_map, mask


def twin_init(cfg: TwinConfig, dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cuda") -> TwinState:
    n = cfg.grid_size
    return TwinState(
        t_field=torch.zeros((n, n), dtype=dtype, device=device),
        island_widths=torch.full((len(RESONANCES),), 0.01, dtype=dtype, device=device))


def q_map(cfg: TwinConfig, r_map: torch.Tensor, action) -> torch.Tensor:
    """Parabolic q(r) with current-drive modulation (reference :75-79)."""
    q0 = cfg.q0 - 0.2 * action
    qa = cfg.qa + 0.5 * action
    return q0 + (qa - q0) * r_map**2


def mre_step(cfg: TwinConfig, widths: torch.Tensor) -> torch.Tensor:
    """Modified Rutherford Equation with neoclassical bootstrap drive:
    dw/dt = eta (Delta'(w) + beta_p w / (w^2 + w_crit^2))."""
    delta_prime = -0.2 - 5.0 * widths
    f_bs = cfg.beta_p * widths / (widths**2 + cfg.w_crit**2)
    return torch.clamp(widths + cfg.dt_island * cfg.eta * (delta_prime + f_bs), min=1e-3)


def danger_map(cfg: TwinConfig, qm: torch.Tensor, mask: torch.Tensor,
               widths: torch.Tensor) -> torch.Tensor:
    """Boolean island map: |q - m/n| < w at each rational surface."""
    res = torch.tensor(RESONANCES, dtype=qm.dtype, device=qm.device)
    hit = torch.any((qm[None, :, :] - res[:, None, None]).abs() < widths[:, None, None], dim=0)
    return hit & mask


def twin_step(cfg: TwinConfig, r_map, mask, state: TwinState, action):
    """One twin tick (reference ``Plasma2D.step`` :105-160)."""
    qm = q_map(cfg, r_map, action)
    widths = mre_step(cfg, state.island_widths)
    danger = danger_map(cfg, qm, mask, widths)

    n = cfg.grid_size
    t = state.t_field.clone()
    t[n // 2, n // 2] = t[n // 2, n // 2] + cfg.core_heat
    diffusivity = torch.full_like(t, cfg.d_base).masked_fill(danger, cfg.d_turb)
    lap = (torch.roll(t, 1, 0) + torch.roll(t, -1, 0)
           + torch.roll(t, 1, 1) + torch.roll(t, -1, 1) - 4.0 * t)
    t = t + diffusivity * lap - cfg.edge_sink * t * (~mask)
    t = torch.where(mask, torch.clamp(t, min=0.0), torch.zeros_like(t))

    new_state = TwinState(t_field=t, island_widths=widths)
    core = t[n // 2, n // 2]
    count = danger.sum(dtype=t.dtype)
    frac = count / torch.full_like(count, n * n)
    return new_state, (core, widths, frac)


def run_digital_twin(
    cfg: TwinConfig = TwinConfig(),
    *,
    n_steps: int = 200,
    actions: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> tuple[TwinState, TwinTrace]:
    """Whole twin shot (on the card one launch of row D).  ``actions`` is a
    per-step current-drive trace in [-1, 1] (zeros = uncontrolled); given,
    it sets the device."""
    if actions is None:
        actions = torch.zeros((n_steps,), dtype=dtype, device=device)
    r_map, mask = _geometry(cfg, dtype, actions.device)
    final, (core, widths, frac) = cuda_twin.twin_shot(cfg, r_map, mask,
                                                      twin_init(cfg, dtype, actions.device),
                                                      actions)
    return final, TwinTrace(t_core=core, island_widths=widths, danger_fraction=frac)


def avoidance_action_trace(cfg: TwinConfig, n_steps: int,
                           gain: float = 1.0,
                           dtype: torch.dtype = torch.float32,
                           device: torch.device | str = "cuda") -> torch.Tensor:
    """Simple island-avoidance schedule: drive current to push the
    q-profile span away from the dominant low-order rational surfaces
    (the role the reference's tiny policy net learns online)."""
    return torch.full((n_steps,), float(np.clip(gain, -1.0, 1.0)), dtype=dtype, device=device)


def twin_to_ids(state: TwinState, cfg: TwinConfig,
                *, time_s: float = 0.0) -> dict:
    """Snapshot -> IMAS-lite IDS tree (reference
    ``run_digital_twin_ids`` :370-420 role)."""
    t = state.t_field.detach().cpu().numpy()
    return {
        "ids_properties": {"homogeneous_time": 1,
                           "comment": "scpn-fusion-tpu digital twin"},
        "time": [float(time_s)],
        "summary": {
            "t_core": float(t[cfg.grid_size // 2, cfg.grid_size // 2]),
            "t_mean": float(t.mean()),
            "island_widths": {
                f"q_{res}": float(w) for res, w in
                zip(RESONANCES, state.island_widths.detach().cpu().numpy())},
        },
        "profiles_2d": [{"temperature": t.tolist(),
                         "grid_type": {"index": 1,
                                       "name": "rectangular"}}],
    }
