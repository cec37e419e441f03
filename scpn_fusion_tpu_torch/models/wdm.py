"""Whole-device-model driver: transport <-> wall <-> impurity radiation
(port of ``scpn_fusion_tpu/models/wdm.py``).

A discharge timeline that couples core transport to plasma-wall
interaction: edge sound-speed flux drives tungsten sputtering, prompt
redeposition scales with edge density and field, the net impurity flux
feeds back into the core impurity channel, and accumulated high-Z radiation
can quench the core temperature ("radiative collapse").

The JAX package runs the discharge as one ``lax.scan`` over its transport
step; the port runs :func:`run_discharge` as a Python loop over the port's
``transport.solver.evolve_profiles`` (its Thomas solves through row T on the
card) with the wall model inlined.  Collapse does not ``break``: a
``collapsed`` latch, a tensor ``torch.where`` as in JAX, freezes further
evolution, so no step reads the host; :func:`collapse_time_s` reads it once.
As in the JAX package the edge sound speed is the dimensionally correct
``c_s = sqrt(e (T_e + T_i) / m_i)`` (the reference omits the eV -> J
conversion).  Entry points of Python numbers take ``dtype`` (float32 by
default; JAX takes its float from the x64 flag) and ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import as_tensors
from scpn_fusion_tpu_torch.models.nuclear.pwi import SputteringMaterial, sputtering_yield
from scpn_fusion_tpu_torch.models.transport.solver import (
    TransportParams,
    TransportState,
    evolve_profiles,
    initial_state,
)

E_CHARGE = 1.602176634e-19
HBAR = 1.054571817e-34
M_ELECTRON = 9.1093837015e-31
M_PROTON = 1.67262192369e-27


@dataclasses.dataclass(frozen=True)
class WDMConfig:
    """Static whole-device discharge configuration (hashable)."""

    transport: TransportParams = TransportParams()
    dt_s: float = 0.01
    p_aux_mw: float = 50.0
    b_edge_t: float = 5.0
    wall_area_m2: float = 700.0
    ion_mass_amu: float = 2.0
    # Fraction of the net (post-redeposition) impurity flux that penetrates
    # into the confined-plasma impurity channel (screening in the SOL).
    core_penetration: float = 1.0e-2
    collapse_te_kev: float = 0.5
    material_name: str = "Tungsten"
    sputter_angle_deg: float = 45.0


class WDMTrace(NamedTuple):
    """Per-step discharge history (stacked over the steps)."""

    time_s: torch.Tensor
    te_core_kev: torch.Tensor
    w_impurity_total: torch.Tensor    # volume-integrated channel [1e19 units]
    gross_erosion_flux: torch.Tensor  # [atoms / m^2 s]
    net_impurity_flux: torch.Tensor   # after prompt redeposition
    redeposition_fraction: torch.Tensor
    collapsed: torch.Tensor           # latched bool per step
    final_state: TransportState


def thomas_fermi_pressure(n_e_m3, t_ev, *, dtype: torch.dtype | None = None,
                          device: torch.device | str = "cuda") -> torch.Tensor:
    """Hardened Thomas-Fermi EOS: ideal + electron degeneracy pressure
    ``P = n k_B T + (hbar^2/m_e) n^(5/3)`` (reference
    ``thomas_fermi_pressure:50-64``).  Broadcasts."""
    n_e, t = as_tensors(n_e_m3, t_ev, dtype=dtype, device=device)
    p_ideal = n_e * t * E_CHARGE
    p_deg = (HBAR**2 / M_ELECTRON) * n_e ** (5.0 / 3.0)
    return p_ideal + p_deg


def redeposition_fraction(b_field_t, n_e_edge_m3, *, dtype: torch.dtype | None = None,
                          device: torch.device | str = "cuda") -> torch.Tensor:
    """Prompt-redeposition fraction of sputtered high-Z atoms,
    ``f = clip(0.95 (1 - exp(-(B/5)(n_edge/1e19))), 0, 0.99)``
    (reference ``calculate_redeposition_fraction:66-81``)."""
    b, n = as_tensors(b_field_t, n_e_edge_m3, dtype=dtype, device=device)
    f = 0.95 * (1.0 - torch.exp(-(b / 5.0) * (n / 1e19)))
    return torch.clamp(f, 0.0, 0.99)


def _volume_m3(tp: TransportParams) -> float:
    return float(2.0 * math.pi**2 * tp.r0 * tp.a_minor**2 * tp.kappa)


def run_discharge(cfg: WDMConfig, state0: TransportState, n_steps: int = 200) -> WDMTrace:
    """Run the whole-device discharge timeline on ``state0``'s device and
    dtype (reference ``run_discharge:83-151``)."""
    tp = cfg.transport
    mat = SputteringMaterial.from_name(cfg.material_name)
    kw = dict(dtype=state0.ti.dtype, device=state0.ti.device)
    dt = torch.tensor(cfg.dt_s, **kw)
    p_aux = torch.tensor(cfg.p_aux_mw, **kw)
    rho = tp.rho(**kw)
    # Edge-localised deposition profile for the penetrating impurity flux.
    src_shape = torch.exp(-((rho - 1.0) / 0.08) ** 2)
    src_shape = src_shape / torch.clamp(torch.sum(src_shape), min=1e-30)
    volume = _volume_m3(tp)
    m_i = cfg.ion_mass_amu * M_PROTON

    s, t = state0, torch.zeros((), **kw)
    collapsed = torch.zeros((), dtype=torch.bool, device=kw["device"])
    rows = []
    for _ in range(n_steps):
        s_new = evolve_profiles(s, dt, p_aux, tp)

        t_edge_ev = torch.clamp(s_new.te[-1], min=tp.t_edge_kev) * 1e3
        n_edge = torch.clamp(s_new.ne[-1], min=0.01) * 1e19
        c_s = torch.sqrt(E_CHARGE * 2.0 * t_edge_ev / m_i)
        flux_wall = n_edge * c_s

        y = sputtering_yield(mat, 5.0 * t_edge_ev, cfg.sputter_angle_deg)
        gross = flux_wall * y
        f_redep = redeposition_fraction(cfg.b_edge_t, n_edge)
        net = gross * (1.0 - f_redep)

        # atoms/s into the core channel -> density source in 1e19 m^-3.
        atoms_s = net * cfg.wall_area_m2 * cfg.core_penetration
        dn_imp = atoms_s * dt / volume / 1e19
        s_new = s_new._replace(n_imp=s_new.n_imp + dn_imp * src_shape * rho.shape[0])

        now_collapsed = collapsed | (s_new.te[0] < cfg.collapse_te_kev)
        # Latch: once collapsed, freeze the plasma state.
        s = TransportState._make(torch.where(collapsed, frozen, new)
                                 for frozen, new in zip(s, s_new))
        t = t + dt
        rows.append((t, s.te[0], torch.sum(s.n_imp), gross, net, f_redep, now_collapsed))
        collapsed = now_collapsed
    if not rows:
        raise ValueError("run_discharge: n_steps must be >= 1")
    time_s, te_core, w_tot, gross, net, f_redep, flags = (torch.stack(c) for c in zip(*rows))
    return WDMTrace(time_s=time_s, te_core_kev=te_core, w_impurity_total=w_tot,
                    gross_erosion_flux=gross, net_impurity_flux=net,
                    redeposition_fraction=f_redep, collapsed=flags, final_state=s)


def default_initial_state(cfg: WDMConfig, dtype: torch.dtype = torch.float32,
                          device: torch.device | str = "cuda") -> TransportState:
    return initial_state(cfg.transport, dtype, device)


def collapse_time_s(trace: WDMTrace) -> float | None:
    """Host-side: first collapsed sample time, or None (one read of the
    device)."""
    both = torch.stack([trace.collapsed.to(trace.time_s.dtype), trace.time_s]).cpu()
    flags = both[0] > 0
    if not bool(flags.any()):
        return None
    return float(both[1][int(torch.argmax(flags.to(torch.uint8)))])
