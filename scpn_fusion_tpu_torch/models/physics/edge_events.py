"""Edge event models: pellet ablation/fueling, blob transport, MARFE onset
(port of ``scpn_fusion_tpu/models/physics/edge_events.py``).

Role-parity with the reference's edge-event modules (NGS pellet ablation and
fueling deposition, interchange-blob convective transport, MARFE
radiative-condensation onset).  The pellet flight is a Python loop of a few
0-d ops a tick on plain PyTorch ops (the JAX package's ``lax.scan``); its
deposition is a scatter-add (``index_add_``: on a CUDA tensor two ticks of
one cell sum in either order, so the card agrees with the CPU to rounding).

The pellet follows its profiles' device and dtype; the blob and MARFE
screens take numbers or tensors, with ``dtype`` (float32; JAX takes its
float from the x64 flag) and ``device`` (``"cuda"``) for numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.scenario import interp
from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors


# ---------------------------------------------------------------------------
# Pellet injection (NGS ablation)
# ---------------------------------------------------------------------------

class PelletTrace(NamedTuple):
    rho: torch.Tensor            # pellet position (normalised radius)
    radius_mm: torch.Tensor      # remaining pellet radius
    deposition: torch.Tensor     # d n_e / d rho (arbitrary 1e19 units)
    penetration_rho: torch.Tensor


def pellet_ablation(*, r_pellet_mm: float = 2.0, v_pellet_m_s: float = 300.0,
                    a_m: float = 2.0, te_profile_kev: torch.Tensor,
                    ne_profile_19: torch.Tensor, n_steps: int = 400) -> PelletTrace:
    """Neutral-gas-shielding ablation along a radial flight path.

    NGS scaling: dN/dt ~ ne^0.33 Te^1.64 r_p^1.33 (Parks-Turnbull), pellet
    launched from the edge (rho=1) flying inward; deposition is where the
    ablated inventory lands.
    """
    n_rho = te_profile_kev.shape[0]
    dtype, dev = te_profile_kev.dtype, te_profile_kev.device
    rho_grid = linspace(0.0, 1.0, n_rho, dtype, dev)
    dt = a_m / v_pellet_m_s / n_steps

    rho, r_mm = torch.ones((), dtype=dtype, device=dev), torch.full((), r_pellet_mm,
                                                                   dtype=dtype, device=dev)
    rows = []
    for _ in range(n_steps):
        te = torch.clamp(interp(rho, rho_grid, te_profile_kev), min=1e-3)
        ne = torch.clamp(interp(rho, rho_grid, ne_profile_19), min=1e-3)
        alive = (r_mm > 0.01) & (rho > 0.0)
        dndt = 4.0 * ne ** 0.33 * te ** 1.64 * torch.clamp(r_mm, min=0.0) ** 1.33
        # dN/dt -> dr/dt via N ~ r^3: dr = dN/(3 r^2)
        drdt = -dndt / (3.0 * torch.clamp(r_mm, min=0.05) ** 2)
        r1 = torch.where(alive, torch.clamp(r_mm + dt * drdt * 1e3, min=0.0), r_mm)
        rho1 = torch.where(alive, rho - dt * v_pellet_m_s / a_m, rho)
        ablated = torch.where(alive, r_mm ** 3 - r1 ** 3, torch.zeros_like(r_mm))
        rho, r_mm = rho1, r1
        rows.append((rho1, r1, ablated))
    rho_tr, r_tr, abl = (torch.stack(col) for col in zip(*rows))
    # bin ablated inventory onto the rho grid
    idx = torch.clamp((rho_tr * (n_rho - 1)).to(torch.int64), 0, n_rho - 1)
    deposition = torch.zeros(n_rho, dtype=dtype, device=dev).index_add_(0, idx, abl)
    dead = ~(r_tr > 0.01)
    pen = torch.where(torch.any(dead), rho_tr[torch.argmax(dead.to(torch.uint8))], rho_tr[-1])
    return PelletTrace(rho=rho_tr, radius_mm=r_tr, deposition=deposition, penetration_rho=pen)


# ---------------------------------------------------------------------------
# Blob transport
# ---------------------------------------------------------------------------

class BlobResult(NamedTuple):
    v_blob_m_s: torch.Tensor
    gamma_flux_m2_s: torch.Tensor    # particle flux carried by blobs
    e_fold_width_mm: torch.Tensor


def blob_transport(*, blob_size_mm: float = 10.0, te_ev: float = 25.0, ne19: float = 0.5,
                   b_t: float = 2.5, r0_m: float = 1.7, packing_fraction: float = 0.1,
                   l_par_m: float = 20.0, dtype=None, device="cuda") -> BlobResult:
    """Sheath-connected interchange blob velocity and convective flux:
    v_b ~ c_s (2 delta_b / R)^{1/2} in the inertial regime, capped by the
    sheath-dissipation branch."""
    te_ev, ne19, b_t = as_tensors(te_ev, ne19, b_t, dtype=dtype, device=device)
    c_s = 9.79e3 * torch.sqrt(torch.clamp(te_ev, min=0.1))  # m/s (deuterium)
    delta = blob_size_mm * 1e-3
    v_inertial = c_s * math.sqrt(2.0 * delta / r0_m)
    # sheath branch: v ~ c_s (delta/R) (L_par/delta) rho_s^2/delta^2 form
    rho_s = 1.02e-4 * torch.sqrt(torch.clamp(te_ev, min=0.1)) / torch.clamp(b_t, min=0.1)
    v_sheath = c_s * 2.0 * l_par_m * rho_s ** 2 / (r0_m * delta ** 2)
    v_b = torch.minimum(v_inertial, v_sheath)
    flux = packing_fraction * ne19 * 1e19 * v_b
    # SOL e-folding width from v_b against parallel losses
    tau_par = l_par_m / c_s
    width = torch.sqrt(v_b * delta * tau_par) * 1e3
    return BlobResult(v_blob_m_s=v_b, gamma_flux_m2_s=flux, e_fold_width_mm=width)


# ---------------------------------------------------------------------------
# MARFE onset
# ---------------------------------------------------------------------------

class MARFEResult(NamedTuple):
    n_marfe_19: torch.Tensor     # onset density
    margin: torch.Tensor         # n_edge / n_marfe (>1 = MARFE expected)
    at_risk: torch.Tensor


def marfe_onset(*, n_edge_19, te_edge_ev, ip_ma, a_m, impurity_fraction: float = 0.02,
                q95: float = 3.5, dtype=None, device="cuda") -> MARFEResult:
    """Radiative-condensation onset: the edge density above which impurity
    line radiation outruns parallel conduction (reduced Borrass-like form:
    n_MARFE ~ sqrt(j_plasma) Te_edge^(3/4) / sqrt(f_imp q95))."""
    n_edge_19, te_edge_ev, ip_ma, a_m, f_imp = as_tensors(
        n_edge_19, te_edge_ev, ip_ma, a_m, impurity_fraction, dtype=dtype, device=device)
    j_ma_m2 = ip_ma / (math.pi * a_m ** 2)
    n_marfe = (6.0 * torch.sqrt(torch.clamp(j_ma_m2, min=1e-6))
               * torch.clamp(te_edge_ev, min=1.0) ** 0.75
               / torch.sqrt(torch.clamp(f_imp, min=1e-4) * q95)
               / 30.0)
    margin = n_edge_19 / torch.clamp(n_marfe, min=1e-9)
    return MARFEResult(n_marfe_19=n_marfe, margin=margin, at_risk=margin > 1.0)
