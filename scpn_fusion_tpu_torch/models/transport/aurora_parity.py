"""Aurora/STRAHL-parity charge-state impurity transport solver (port of
``scpn_fusion_tpu/models/transport/aurora_parity.py``).

A conservative finite-volume radial step with per-charge-state diffusion D
and pinch V on Aurora's upwind face flux ``F = -D_face grad(n) + V_face
n_upwind``, zero-flux boundaries; availability-limited neighbouring
collisional-radiative transfer, sequential over the charge ladder; the
inventory conservation audit; the same-case effective source closure; the
STRAHL-style artifact builder.  All charge states advance together in the
transport step; the CR ladder and the time march are Python loops where JAX
has ``lax.scan``.  The case holds numpy arrays; the functions that take one
put its arrays on ``device`` (or on the density's device).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AuroraParityCase:
    """Same-case contract (subset of the reference's ``AuroraParityCase``)."""

    element: str
    charge_states: np.ndarray          # (Z+1,)
    radius_m: np.ndarray               # (nr,) strictly increasing
    time_s: np.ndarray                 # (nt,) strictly increasing
    major_radius_m: float
    ne_t_r: np.ndarray                 # (nt, nr) electron density [m^-3]
    diffusion_m2_s_r_z: np.ndarray     # (nr, Z+1)
    convection_m_s_r_z: np.ndarray     # (nr, Z+1) pinch velocity
    ionisation_m3_s_t_r_z: np.ndarray  # (nt, nr, Z+1) rate coefficients
    recombination_m3_s_t_r_z: np.ndarray

    def __post_init__(self) -> None:
        if np.any(np.diff(self.radius_m) <= 0.0):
            raise ValueError("radius_m must be strictly increasing")
        if np.any(np.diff(self.time_s) <= 0.0):
            raise ValueError("time_s must be strictly increasing")
        if self.major_radius_m <= 0.0:
            raise ValueError("major_radius_m must be positive")


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def radial_edges(radius_m: torch.Tensor) -> torch.Tensor:
    """Cell-face radii."""
    inner = torch.clamp(radius_m[0] - 0.5 * (radius_m[1] - radius_m[0]), min=0.0)
    outer = radius_m[-1] + 0.5 * (radius_m[-1] - radius_m[-2])
    mid = 0.5 * (radius_m[:-1] + radius_m[1:])
    return torch.cat([inner[None], mid, outer[None]])


def radial_transport_step(density: torch.Tensor, d_r_z: torch.Tensor, v_r_z: torch.Tensor,
                          radius_m: torch.Tensor, dt_s) -> torch.Tensor:
    """Conservative finite-volume D+V step, all charge states at once,
    zero-flux boundaries."""
    edges = radial_edges(radius_m)
    annulus = 0.5 * (edges[1:] ** 2 - edges[:-1] ** 2)       # (nr,)
    dr = (radius_m[1:] - radius_m[:-1])[:, None]             # (nr-1, 1)
    grad = (density[1:, :] - density[:-1, :]) / dr
    d_face = 0.5 * (d_r_z[1:, :] + d_r_z[:-1, :])
    v_face = 0.5 * (v_r_z[1:, :] + v_r_z[:-1, :])
    upwind = torch.where(v_face >= 0.0, density[:-1, :], density[1:, :])
    flux_interior = -d_face * grad + v_face * upwind         # (nr-1, Z+1)
    zeros = density.new_zeros((1, density.shape[1]))
    flux = torch.cat([zeros, flux_interior, zeros], dim=0)
    div = (edges[1:, None] * flux[1:, :] - edges[:-1, None] * flux[:-1, :]) / annulus[:, None]
    return torch.clamp(density - dt_s * div, min=0.0)


def cr_transfer_step(density: torch.Tensor, ionisation: torch.Tensor,
                     recombination: torch.Tensor, dt_s) -> torch.Tensor:
    """Availability-limited neighbouring CR transfer, sequential over the
    charge ladder: each pair sees the previous pair's update."""
    n = density.clone()
    for z in range(density.shape[1] - 1):
        ion_flux = torch.minimum(ionisation[:, z], n[:, z] / dt_s)
        rec_flux = torch.minimum(recombination[:, z + 1], n[:, z + 1] / dt_s)
        n[:, z] = n[:, z] + dt_s * (rec_flux - ion_flux)
        n[:, z + 1] = n[:, z + 1] + dt_s * (ion_flux - rec_flux)
    return torch.clamp(n, min=0.0)


def _rates(ne_t: torch.Tensor, density: torch.Tensor, ion_c: torch.Tensor,
           rec_c: torch.Tensor):
    """Volumetric CR rates ``n_e n_z <sigma v>`` with the ladder ends zeroed."""
    ion = ne_t[:, None] * density * ion_c
    rec = ne_t[:, None] * density * rec_c
    ion[:, -1] = 0.0
    rec[:, 0] = 0.0
    return ion, rec


def advance_transport_and_cr(case: AuroraParityCase, density: torch.Tensor, step: int,
                             dt_s) -> torch.Tensor:
    """One predictor step: radial transport, then CR transfer."""
    dev = density.device
    advanced = radial_transport_step(density, _t(case.diffusion_m2_s_r_z, dev),
                                     _t(case.convection_m_s_r_z, dev),
                                     _t(case.radius_m, dev), dt_s)
    ion, rec = _rates(_t(case.ne_t_r[step], dev), advanced,
                      _t(case.ionisation_m3_s_t_r_z[step], dev),
                      _t(case.recombination_m3_s_t_r_z[step], dev))
    return cr_transfer_step(advanced, ion, rec, dt_s)


def finite_volume_inventory(total_density_r: torch.Tensor, radius_m: torch.Tensor,
                            major_radius_m: float) -> torch.Tensor:
    """Toroidal particle inventory."""
    edges = radial_edges(radius_m)
    annulus = math.pi * (edges[1:] ** 2 - edges[:-1] ** 2)
    volume = 2.0 * math.pi * major_radius_m * annulus
    return torch.sum(total_density_r * volume)


def radial_transport_budget_diagnostic(case: AuroraParityCase, density_r_z: np.ndarray,
                                       dt_s: float, *,
                                       device: torch.device | str = "cuda") -> dict[str, Any]:
    """Zero-flux conservation audit."""
    density = _t(density_r_z, device)
    if not bool(torch.isfinite(density).all()) or bool((density < 0).any()):
        raise ValueError("density_r_z must be finite and non-negative")
    if not np.isfinite(dt_s) or dt_s <= 0.0:
        raise ValueError("dt_s must be finite and positive")
    radius = _t(case.radius_m, device)
    before = finite_volume_inventory(density.sum(dim=1), radius, case.major_radius_m)
    after_density = radial_transport_step(
        density, _t(case.diffusion_m2_s_r_z, device), _t(case.convection_m_s_r_z, device),
        radius, dt_s)
    after = finite_volume_inventory(after_density.sum(dim=1), radius, case.major_radius_m)
    rel = abs(float(after) - float(before)) / max(abs(float(before)), 1.0)
    # The FV update is exactly conservative in exact arithmetic; the
    # representable floor scales with the working dtype.
    eps = float(torch.finfo(after_density.dtype).eps)
    tol = max(1.0e-12, 2.0e3 * eps)
    return {
        "inventory_before": float(before),
        "inventory_after": float(after),
        "relative_inventory_error": rel,
        "tolerance": tol,
        "dtype": str(after_density.dtype).replace("torch.", ""),
        "passed": bool(rel <= tol),
    }


def derive_effective_source_closure(case: AuroraParityCase,
                                    reference_density_t_r_z: np.ndarray, *,
                                    device: torch.device | str = "cuda") -> torch.Tensor:
    """Per-step density-rate residual that reproduces a supplied Aurora
    trajectory after the native predictor: a diagnostic closure, not a
    mechanistic source model."""
    reference = _t(reference_density_t_r_z, device)
    expected = (case.time_s.size, case.radius_m.size, case.charge_states.size)
    if tuple(reference.shape) != expected:
        raise ValueError(f"reference_density_t_r_z must have shape {expected}")
    if not bool(torch.isfinite(reference).all()) or bool((reference < 0).any()):
        raise ValueError("reference_density_t_r_z must be finite and non-negative")
    dt = _t(np.diff(case.time_s), device)
    d = _t(case.diffusion_m2_s_r_z, device)
    v = _t(case.convection_m_s_r_z, device)
    radius = _t(case.radius_m, device)
    ne = _t(case.ne_t_r, device)
    ion_c = _t(case.ionisation_m3_s_t_r_z, device)
    rec_c = _t(case.recombination_m3_s_t_r_z, device)

    rows = [torch.zeros_like(reference[0])]
    for k in range(reference.shape[0] - 1):
        advanced = radial_transport_step(reference[k], d, v, radius, dt[k])
        ion, rec = _rates(ne[k + 1], advanced, ion_c[k + 1], rec_c[k + 1])
        predicted = cr_transfer_step(advanced, ion, rec, dt[k])
        rows.append((reference[k + 1] - predicted) / dt[k])
    return torch.stack(rows)


def build_aurora_strahl_artifact(case: AuroraParityCase, density_t_r_z: np.ndarray, *,
                                 closure: np.ndarray | None = None,
                                 device: torch.device | str = "cuda") -> dict[str, Any]:
    """Checksummed charge-state artifact (the inventories computed on
    ``device`` in float64)."""
    density = np.asarray(density_t_r_z, np.float64)
    radius = _t(case.radius_m, device)
    inv = [float(finite_volume_inventory(_t(density[t].sum(axis=1), device), radius,
                                         case.major_radius_m))
           for t in range(density.shape[0])]
    payload: dict[str, Any] = {
        "schema": "scpn-fusion-tpu.aurora-strahl-charge-state.v1",
        "element": case.element,
        "charge_states": [int(z) for z in case.charge_states],
        "n_radius": int(case.radius_m.size),
        "n_time": int(case.time_s.size),
        "major_radius_m": float(case.major_radius_m),
        "inventory_per_step": inv,
        "final_mean_charge": float(
            (density[-1] * case.charge_states[None, :]).sum()
            / max(density[-1].sum(), 1e-300)),
        "closure_linf": (None if closure is None
                         else float(np.max(np.abs(closure)))),
        "claim": ("native finite-volume same-case parity solver; "
                  "not an Aurora/STRAHL wrapper"),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    payload["payload_sha256"] = hashlib.sha256(blob).hexdigest()
    return payload
