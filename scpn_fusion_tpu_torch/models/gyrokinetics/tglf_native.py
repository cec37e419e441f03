"""Native TGLF-class quasilinear transport model, GK path A, no binary
(port of ``scpn_fusion_tpu/models/gyrokinetics/tglf_native.py``).

SAT0/SAT1/SAT2 spectral saturation, ExB shear quench, trapped-particle
damping, multi-scale ITG-ETG coupling and FLR-weighted quasilinear fluxes
(Staebler 2007/2017, Waltz 1997, Maeyama 2015, Connor 1974), with the
linear spectrum from the resonant local kinetic dispersion relation
(``local_dispersion.py``).  The saturation and the quasilinear weights are
masked reductions over the last (k_y) axis, so any leading axes are a batch:
:func:`tglf_native_fluxes` solves every k_y of a surface in one batched
root-find, and :func:`tglf_native_fluxes_profile` every k_y of every surface
(JAX's ``vmap`` over surfaces).

The deck-file contract (:class:`TGLFNativeSolver`) matches the registry
interface so the native model is a drop-in for the external binary.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.gyrokinetics.interface import (
    GKLocalParams,
    GKOutput,
    GKSolverBase,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.local_dispersion import (
    solve_local_kinetic_dispersion,
)
from scpn_fusion_tpu_torch.models.gyrokinetics.species import (
    E_CHARGE,
    M_PROTON,
    VelocityGrid,
)

# Staebler et al. 2007, Table I
ALPHA_EXB_DEFAULT = 0.67
# Staebler et al. 2017 Eq. (12) / Maeyama et al. 2015 Fig. 3
ALPHA_CS_DEFAULT = 3.0
# Ion/electron scale boundary in k_y rho_s
KY_ETG_BOUNDARY = 2.0
# sqrt(m_D / m_e): maps electron-scale normalisation to ion-scale units
SQRT_MI_ME = float(np.sqrt(2.0 * M_PROTON / 9.1093837015e-31))


@dataclasses.dataclass(frozen=True)
class TGLFNativeConfig:
    """SAT-model selection + spectrum resolution."""

    sat_model: str = "SAT1"
    multiscale: bool = False
    n_ky_ion: int = 12
    n_ky_etg: int = 0
    ky_ion_min: float = 0.08
    ky_ion_max: float = 1.0   # TGLF ion-scale standard range k_y rho_s <= 1
    # Velocity resolution: 24x16 is the local-dispersion module's default;
    # coarser grids expose unconverged spurious roots at strong drive.
    n_energy: int = 24
    n_lambda: int = 16
    alpha_exb: float = ALPHA_EXB_DEFAULT
    alpha_cs: float = ALPHA_CS_DEFAULT
    # Opt-in kinetic trapped-electron response in the ion-scale dispersion
    # (a genuine TEM branch; over-drives the TGLF TEM fixture rate, see the
    # JAX module); default adiabatic (ITG-accurate).
    kinetic_electrons: bool = False

    def __post_init__(self) -> None:
        if self.sat_model not in ("SAT0", "SAT1", "SAT2"):
            raise ValueError(f"unknown SAT model: {self.sat_model!r}")
        if self.sat_model == "SAT2":
            # SAT2 is the multi-scale rule: force the ETG branch on.
            object.__setattr__(self, "multiscale", True)
            if self.n_ky_etg == 0:
                object.__setattr__(self, "n_ky_etg", 6)


class TGLFNativeFluxes(NamedTuple):
    """Spectrum + fluxes; every leaf is a tensor (leading axes: the batch)."""

    chi_i: torch.Tensor
    chi_e: torch.Tensor
    d_e: torch.Tensor
    v_e: torch.Tensor
    chi_e_etg: torch.Tensor
    k_y: torch.Tensor
    gamma: torch.Tensor
    gamma_net: torch.Tensor
    omega_r: torch.Tensor
    phi_sq: torch.Tensor
    gamma_exb: torch.Tensor


# ── Scalar physics factors (Waltz 1997 / Wesson / Connor 1974) ───────────


def exb_shear_rate(s_hat, q, epsilon, r_l_ti):
    """gamma_ExB proxy in c_s/a: |s_hat/q| * eps * R/L_Ti * 0.1."""
    ok = torch.abs(q) > 1e-10
    return torch.where(ok, torch.abs(s_hat / torch.where(ok, q, torch.ones_like(q)))
                       * epsilon * r_l_ti * 0.1, torch.zeros_like(q))


def trapped_fraction(epsilon):
    """f_t = sqrt(2 eps / (1 + eps))."""
    eps = torch.clamp(epsilon, min=1e-6)
    return torch.sqrt(2.0 * eps / (1.0 + eps))


def trapped_particle_damping(epsilon, nu_star):
    """Multiplicative growth-rate factor in [0.1, 1]."""
    return torch.clamp(1.0 - trapped_fraction(epsilon) * nu_star, 0.1, 1.0)


def gamma0_flr(b):
    """Gamma_0(b) = I_0(b) exp(-b) FLR reduction."""
    return torch.special.i0e(torch.clamp(b, min=0.0))


# ── Saturation rules (whole-spectrum, vectorised over the last axis) ─────


def spectral_weight(gamma_net, k_y):
    """I_k = (gamma_net/k_y) / sum(gamma_net/k_y) (Staebler 2007 Eq. 7)."""
    zero = torch.zeros_like(gamma_net)
    raw = torch.where(gamma_net > 0.0, gamma_net / torch.clamp(k_y, min=1e-10), zero)
    total = torch.sum(raw, dim=-1, keepdim=True)
    return torch.where(total > 1e-30, raw / torch.clamp(total, min=1e-30), zero)


def sat_phi_sq(gamma_net, omega_r, k_y, sat_model: str,
               alpha_cs: float, etg_unit_scale=1.0) -> torch.Tensor:
    """phi^2_k under SAT0/SAT1/SAT2 from the quenched spectrum.

    ``etg_unit_scale`` = sqrt(m_i/m_e * T_e/T_i): the factor by which
    electron-scale growth rates exceed ion-scale ones in c_s/a units (the
    Maeyama ratio compares them in their own gyro-units); a number or a
    tensor of the batch shape.
    """
    zero = torch.zeros_like(gamma_net)
    etg = k_y > KY_ETG_BOUNDARY
    w_eff = torch.clamp(torch.maximum(torch.abs(omega_r), gamma_net), min=1e-6)
    mixing = torch.where(gamma_net > 0.0, gamma_net / (k_y**2 * w_eff), zero)
    if sat_model == "SAT0":
        return mixing

    # SAT1: ion-scale peak-mode amplitude distributed by spectral weight.
    g_ion = torch.where(etg, zero, gamma_net)
    i_k = spectral_weight(g_ion, k_y)
    idx = torch.argmax(g_ion, dim=-1, keepdim=True)
    peak = (torch.gather(g_ion, -1, idx)
            / torch.clamp(torch.gather(k_y, -1, idx) ** 2, min=1e-10))
    g_max = torch.amax(g_ion, dim=-1, keepdim=True)
    phi_ion = torch.where(g_max > 0.0, i_k * peak, zero)
    phi = torch.where(etg, mixing, phi_ion)
    if sat_model == "SAT1":
        return phi

    # SAT2: cross-scale enhancement of unstable ETG modes, clamped ratio.
    g_itg_max = torch.clamp(g_max, min=1e-10)
    scale = torch.as_tensor(etg_unit_scale, dtype=gamma_net.dtype, device=gamma_net.device)
    g_etg_own = gamma_net / torch.clamp(scale, min=1e-10)[..., None]
    ratio = torch.clamp(g_etg_own / g_itg_max, max=2.0)
    enhance = 1.0 + alpha_cs * ratio
    return torch.where(etg & (gamma_net > 0.0), phi * enhance, phi)


# ── Quasilinear weights → physical fluxes ────────────────────────────────


def quasilinear_fluxes(
    k_y, gamma_net, omega_r, phi_sq,
    *, r_l_ti, r_l_te, r_l_ne, te_ti, a, b0, t_i_kev,
    ion_mass_amu: float = 2.0, etg_unit_scale=1.0,
):
    """Masked-reduction QL weights over the last axis.  Returns
    gyro-Bohm-scaled (chi_i, chi_e, D_e, V_e, chi_e_etg) in m^2/s; the
    parameters are numbers or tensors of the batch shape (the ETG unit
    algebra is the JAX module's, documented there)."""
    def t(x):
        return torch.as_tensor(x, dtype=gamma_net.dtype, device=gamma_net.device)

    r_l_ti, r_l_te, r_l_ne, te_ti, a, b0, t_i_kev = (
        t(x) for x in (r_l_ti, r_l_te, r_l_ne, te_ti, a, b0, t_i_kev))
    m_i = ion_mass_amu * M_PROTON
    t_i_j = t_i_kev * 1e3 * E_CHARGE
    c_s = torch.sqrt(t_i_j / m_i)
    rho_s = m_i * c_s / (E_CHARGE * b0)
    chi_gb = rho_s**2 * c_s / a

    rho_i = m_i * torch.sqrt(2.0 * t_i_j / m_i) / (E_CHARGE * b0)
    b_i = k_y**2 * (rho_i / a)[..., None] ** 2
    g0 = gamma0_flr(b_i)

    active = (gamma_net > 0.0) & (phi_sq > 0.0) & (torch.abs(omega_r) > 1e-10)
    # Same effective-frequency regularisation as the saturation rule.
    inv_w = 1.0 / torch.clamp(torch.maximum(torch.abs(omega_r), gamma_net), min=1e-10)
    etg = k_y > KY_ETG_BOUNDARY
    ion_scale = active & ~etg
    etg_scale = active & etg

    w_i = k_y * r_l_ti[..., None] * inv_w
    w_e = k_y * r_l_te[..., None] * inv_w
    w_n = k_y * r_l_ne[..., None] * inv_w
    zero = torch.zeros_like(gamma_net)

    def total(mask, x):
        return torch.sum(torch.where(mask, x, zero), dim=-1)

    chi_i_n = total(ion_scale, phi_sq * w_i * g0)
    chi_e_ion = total(ion_scale, phi_sq * w_e)
    d_e_n = total(ion_scale, phi_sq * w_n)
    # Thermodiffusion pinch (Connor & Wilson 1994).
    v_e_n = total(ion_scale, phi_sq * w_n * 1.5 * te_ti[..., None])
    # ETG channel: electron-unit normalisation collapsed to one factor.
    chi_e_etg_n = total(etg_scale, phi_sq * w_e * t(etg_unit_scale)[..., None])

    return (chi_i_n * chi_gb, (chi_e_ion + chi_e_etg_n) * chi_gb,
            d_e_n * chi_gb, v_e_n * chi_gb, chi_e_etg_n * chi_gb)


# ── Spectrum assembly + the whole model ──────────────────────────────────


def tglf_native_fluxes(
    r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star,
    a, b0, r0, t_i_kev,
    *, cfg: TGLFNativeConfig = TGLFNativeConfig(),
    device: torch.device | str = "cuda",
) -> TGLFNativeFluxes:
    """Full native TGLF evaluation (float64).  The parameters are numbers or
    tensors that broadcast to one batch shape (a profile of surfaces is a
    batch); every k_y of every surface is one batched root-find.  Tensor
    arguments set the device (``device`` where all are numbers)."""
    params = (r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star, a, b0, r0, t_i_kev)
    like = next((p for p in params if isinstance(p, torch.Tensor)), None)
    dev = like.device if like is not None else torch.device(device)
    (r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star, a, b0, r0, t_i_kev) = \
        torch.broadcast_tensors(*[torch.as_tensor(p, dtype=torch.float64, device=dev)
                                  for p in params])
    vgrid = VelocityGrid(n_energy=cfg.n_energy, n_lambda=cfg.n_lambda)
    tau = 1.0 / torch.clamp(te_ti, min=1e-6)          # T_i / T_e
    r_over_a = (r0 / a)[..., None]

    def b(x):   # a surface value against the k_y axis
        return x[..., None]

    ky_ion = torch.as_tensor(np.linspace(cfg.ky_ion_min, cfg.ky_ion_max, cfg.n_ky_ion),
                             dtype=torch.float64, device=dev)
    out = solve_local_kinetic_dispersion(
        ky_ion, r_l_t=b(r_l_ti), r_l_n=b(r_l_ne), tau=b(tau), q=b(q),
        epsilon_r=b(epsilon), vgrid=vgrid,
        kinetic_electrons=cfg.kinetic_electrons, r_l_te=b(r_l_te),
        nu_detrap=b(nu_star / torch.clamp(epsilon, min=1e-3)))
    # Unconverged roots are spurious values, not modes: mask them; c_s/R -> c_s/a.
    zero = torch.zeros_like(out.gamma)
    gamma_ion = torch.where(out.converged, torch.clamp(out.gamma, min=0.0), zero) * r_over_a
    omega_ion = out.omega_r * r_over_a
    k_ion = ky_ion.expand_as(omega_ion)

    if cfg.multiscale and cfg.n_ky_etg > 0:
        # ETG isomorphism: electrons drive, ions adiabatic (tau -> 1/tau),
        # solved in electron-scale units then mapped back.
        ky_etg_e = torch.as_tensor(np.linspace(0.1, 0.6, cfg.n_ky_etg),
                                   dtype=torch.float64, device=dev)
        out = solve_local_kinetic_dispersion(
            ky_etg_e, r_l_t=b(r_l_te), r_l_n=b(r_l_ne),
            tau=b(torch.clamp(te_ti, min=1e-6)), q=b(q),
            epsilon_r=b(epsilon), vgrid=vgrid)
        scale = SQRT_MI_ME * torch.sqrt(torch.clamp(te_ti, min=1e-6))[..., None] * r_over_a
        # Only roots in the driving species' diamagnetic direction are genuine;
        # the sign then flips (ETG propagates in the electron direction).
        genuine = (out.omega_r < 0.0) & out.converged
        zero = torch.zeros_like(out.gamma)
        gamma_etg = torch.where(genuine, torch.clamp(out.gamma, min=0.0), zero) * scale
        omega_etg = -out.omega_r * scale
        k_y = torch.cat([k_ion, (SQRT_MI_ME * ky_etg_e).expand_as(omega_etg)], dim=-1)
        omega_r = torch.cat([omega_ion, omega_etg], dim=-1)
        gamma = torch.cat([gamma_ion, gamma_etg], dim=-1)
    else:
        k_y, omega_r, gamma = k_ion, omega_ion, gamma_ion

    g_exb = exb_shear_rate(s_hat, q, epsilon, r_l_ti)
    tp = trapped_particle_damping(epsilon, nu_star)
    gamma_net = torch.clamp(gamma * b(tp) - cfg.alpha_exb * b(torch.abs(g_exb)), min=0.0)
    etg_unit = SQRT_MI_ME * torch.sqrt(torch.clamp(te_ti, min=1e-6))
    phi_sq = sat_phi_sq(gamma_net, omega_r, k_y, cfg.sat_model, cfg.alpha_cs,
                        etg_unit_scale=etg_unit)

    chi_i, chi_e, d_e, v_e, chi_e_etg = quasilinear_fluxes(
        k_y, gamma_net, omega_r, phi_sq,
        r_l_ti=r_l_ti, r_l_te=r_l_te, r_l_ne=r_l_ne, te_ti=te_ti,
        a=a, b0=b0, t_i_kev=t_i_kev, etg_unit_scale=etg_unit)

    return TGLFNativeFluxes(
        chi_i=chi_i, chi_e=chi_e, d_e=d_e, v_e=v_e, chi_e_etg=chi_e_etg,
        k_y=k_y, gamma=gamma, gamma_net=gamma_net, omega_r=omega_r,
        phi_sq=phi_sq, gamma_exb=g_exb)


def tglf_native_fluxes_profile(
    r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star,
    a, b0, r0, t_i_kev,
    *, cfg: TGLFNativeConfig = TGLFNativeConfig(),
    device: torch.device | str = "cuda",
) -> TGLFNativeFluxes:
    """Whole radial profile in one batched evaluation: ``r_l_ti`` is
    (n_rho,), every other argument (n_rho,) or a number.  n_rho surfaces
    cost one batched dispersion solve, not n_rho host round-trips."""
    n = r_l_ti.shape[0] if isinstance(r_l_ti, torch.Tensor) else np.shape(r_l_ti)[0]
    like = next((p for p in (r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star,
                             a, b0, r0, t_i_kev) if isinstance(p, torch.Tensor)), None)
    dev = like.device if like is not None else torch.device(device)

    def bc(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev).broadcast_to((n,))

    args = tuple(bc(v) for v in (
        r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star,
        a, b0, r0, t_i_kev))
    return tglf_native_fluxes(*args, cfg=cfg)


# ── Deck-file solver wrapper (registry contract) ─────────────────────────


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _classify(r: "TGLFNativeFluxes") -> str:
    """Dominant mode by FLUX attribution, not raw growth rate: electron-
    scale gammas are ~sqrt(m_i/m_e) larger in c_s/a units, so a raw-gamma
    argmax would call every multiscale case ETG even when the ETG channel
    carries negligible transport."""
    gamma_net = _host(r.gamma_net)
    k_y = _host(r.k_y)
    if gamma_net.size == 0 or np.all(gamma_net <= 0.0):
        return "stable"
    if float(r.chi_e_etg) > 0.5 * max(float(r.chi_e), 1e-30):
        return "ETG"
    ion = k_y <= KY_ETG_BOUNDARY
    g_ion = np.where(ion, gamma_net, 0.0)
    if np.all(g_ion <= 0.0):
        return "ETG" if float(r.chi_e_etg) > 0.0 else "stable"
    i = int(np.argmax(g_ion))
    return "ITG" if float(_host(r.omega_r)[i]) < 0.0 else "TEM"


class TGLFNativeSolver(GKSolverBase):
    """Registry adapter around :func:`tglf_native_fluxes`.

    ``prepare_input``/``run`` speak the JSON-deck contract (reference
    ``gk_tglf_native.py:309-361``); ``solve`` exposes the raw fluxes,
    computed on ``device``.
    """

    def __init__(self, config: TGLFNativeConfig | None = None,
                 device: torch.device | str = "cuda") -> None:
        self.config = config or TGLFNativeConfig()
        self.device = device

    def is_available(self) -> bool:
        return True

    def prepare_input(self, params: GKLocalParams) -> Path:
        payload = {"params": params.as_dict(),
                   "config": dataclasses.asdict(self.config)}
        with tempfile.NamedTemporaryFile(
                mode="w", encoding="utf-8", prefix="tglf_native_",
                suffix=".json", delete=False) as fh:
            json.dump(payload, fh)
            return Path(fh.name)

    def run(self, input_path: Path, *, timeout_s: float = 30.0) -> GKOutput:
        path = Path(input_path)
        if path.suffix.lower() != ".json":
            raise ValueError("native deck must be a .json file")
        payload = json.loads(path.read_text(encoding="utf-8"))
        params_dict = payload.get("params")
        if not isinstance(params_dict, dict):
            raise ValueError("native deck missing 'params' object")
        cfg_dict = payload.get("config")
        if isinstance(cfg_dict, dict):
            self.config = TGLFNativeConfig(**cfg_dict)
        return self.run_from_params(GKLocalParams(**params_dict),
                                    timeout_s=timeout_s)

    def run_from_params(self, params: GKLocalParams, *,
                        timeout_s: float = 30.0) -> GKOutput:
        del timeout_s  # native model: no subprocess to bound
        r = self.solve(params)
        return GKOutput(
            chi_i=float(r.chi_i), chi_e=float(r.chi_e), d_e=float(r.d_e),
            d_i=0.0, gamma=_host(r.gamma),
            omega_r=_host(r.omega_r), k_y=_host(r.k_y),
            dominant_mode=_classify(r),
            converged=True)

    def solve(self, params: GKLocalParams) -> TGLFNativeFluxes:
        return tglf_native_fluxes(
            params.r_l_ti, params.r_l_te, params.r_l_ne, params.q,
            params.s_hat, params.epsilon, params.te_ti, params.nu_star,
            params.a, params.b0, params.r0, params.t_i_kev,
            cfg=self.config, device=self.device)
