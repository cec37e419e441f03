"""Reduced multichannel critical-gradient transport closure (ITG/TEM/ETG)
(port of ``scpn_fusion_tpu/models/transport/reduced_closure.py``).

Per-channel critical gradients with Dimits-shift, shear and beta
corrections, a stiffness power-law excess, trapped-fraction and
collisionality weighting for TEM and an electron-ratio-weighted ETG channel,
in local gyro-Bohm units (Wesson Ch.14 Eq.14.5.4 collisionality).  The
closure is elementwise: every field of :class:`ClosureInputs` may be a
number or a tensor, and the whole profile (JAX's ``vmap`` over radius) is
one call on (n,) tensors.  The dominant channel is an integer code (0 stable,
1 ITG, 2 TEM, 3 ETG) by ``argmax`` over the channel strengths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

E_CHARGE = 1.602176634e-19
M_DEUTERON = 2.0 * 1.672621924e-27

# Critical gradient thresholds (Dimits PoP 2000; Jenko PoP 2001 for ETG).
CRIT_ITG = 4.0
CRIT_TEM = 5.0
CRIT_ETG = 12.0
# Transport stiffness exponent; physical range 1.5-4 (Citrin NF 2015).
STIFFNESS = 2.0
STIFFNESS_MIN = 1.0
STIFFNESS_MAX = 6.0
TRANSPORT_FLOOR = 1e-6

CHANNEL_NAMES = ("stable", "ITG", "TEM", "ETG")


class ClosureInputs(NamedTuple):
    """Local reduced-transport state (gradients in R/L_x form)."""

    rho: torch.Tensor          # normalised toroidal radius
    te_kev: torch.Tensor
    ti_kev: torch.Tensor
    ne_19: torch.Tensor        # electron density [1e19 m^-3]
    grad_te: torch.Tensor      # R/L_Te
    grad_ti: torch.Tensor      # R/L_Ti
    grad_ne: torch.Tensor      # R/L_ne
    q: torch.Tensor
    s_hat: torch.Tensor
    beta_e: torch.Tensor
    r_major_m: torch.Tensor
    a_minor_m: torch.Tensor
    b_tesla: torch.Tensor
    z_eff: torch.Tensor


class ClosureFluxes(NamedTuple):
    chi_i: torch.Tensor        # [m^2/s]
    chi_e: torch.Tensor        # [m^2/s]
    d_e: torch.Tensor          # [m^2/s]
    channel: torch.Tensor      # int32 code into CHANNEL_NAMES
    chi_i_itg: torch.Tensor
    chi_e_itg: torch.Tensor
    chi_e_tem: torch.Tensor
    chi_e_etg: torch.Tensor


def channel_name(code) -> str:
    """Host-side name of the channel code."""
    return CHANNEL_NAMES[int(code)]


def _relu(x):
    return torch.clamp(x, min=0.0)


def _as_tensors(inp: ClosureInputs, device: torch.device | str = "cuda") -> ClosureInputs:
    """``inp`` with every number made a tensor of its tensor fields' dtype and
    device (float64 on ``device`` where every field is a number)."""
    like = next((v for v in inp if isinstance(v, torch.Tensor)), None)
    dtype, dev = (like.dtype, like.device) if like is not None else (torch.float64, device)
    return ClosureInputs(*(v if isinstance(v, torch.Tensor)
                           else torch.as_tensor(v, dtype=dtype, device=dev) for v in inp))


def gyro_bohm_diffusivity(inp: ClosureInputs) -> torch.Tensor:
    """Local gyro-Bohm diffusivity rho_s^2 c_s / R [m^2/s]."""
    inp = _as_tensors(inp)
    te_kev = torch.clamp(inp.te_kev, min=0.01)
    b_t = torch.clamp(inp.b_tesla, min=0.1)
    r_major = torch.clamp(inp.r_major_m, min=0.1)
    te_j = te_kev * 1e3 * E_CHARGE
    cs = torch.sqrt(te_j / M_DEUTERON)
    rho_s = torch.sqrt(M_DEUTERON * te_j) / (E_CHARGE * b_t)
    chi_gb = rho_s**2 * cs / r_major
    return torch.clamp(torch.nan_to_num(chi_gb, nan=TRANSPORT_FLOOR), min=TRANSPORT_FLOOR)


def nu_star_electron(te_kev, ne_19, q, rho, r_major=6.2, a_minor=2.0, z_eff=1.0):
    """Electron collisionality nu_* (Wesson Ch.14 Eq.14.5.4)."""
    ln_lambda = 15.2
    ne_m3 = ne_19 * 1e19
    te_ev = torch.clamp(te_kev * 1e3, min=1.0)
    eps = torch.clamp(rho * a_minor / r_major, min=1e-4)
    return (6.921e-18 * ne_m3 * q * r_major * z_eff**2 * ln_lambda
            / (te_ev**2 * eps**1.5))


def critical_gradient_fluxes(inp: ClosureInputs, *, stiffness: float = STIFFNESS,
                             device: torch.device | str = "cuda") -> ClosureFluxes:
    """Reduced multichannel gyrokinetic closure, branchless: the reference's
    thresholds, suppression factors and channel strengths.  Numbers in
    ``inp`` follow its tensors (``device`` where all are numbers)."""
    if not (STIFFNESS_MIN <= stiffness <= STIFFNESS_MAX):
        raise ValueError(
            f"stiffness={stiffness} outside [{STIFFNESS_MIN}, {STIFFNESS_MAX}]")
    inp = _as_tensors(inp, device)

    eps = torch.clamp(inp.rho * inp.a_minor_m / torch.clamp(inp.r_major_m, min=1e-6),
                      0.0, 0.8)
    trapped_frac = torch.clamp(1.46 * torch.sqrt(_relu(eps)), 0.0, 1.0)
    nustar = nu_star_electron(inp.te_kev, inp.ne_19, inp.q, inp.rho, inp.r_major_m,
                              inp.a_minor_m, inp.z_eff)
    chi_gb = gyro_bohm_diffusivity(inp)
    shear_supp = 1.0 / (1.0 + 0.35 * _relu(inp.s_hat)**2)
    beta_supp = 1.0 / (1.0 + _relu(inp.beta_e) / 0.03)
    electron_ratio = torch.clamp(inp.te_kev / torch.clamp(inp.ti_kev, min=0.05), 0.5, 4.0)

    # Per-channel critical gradients (shear/beta/collisionality shifted).
    crit_itg = CRIT_ITG + 0.4 * _relu(inp.s_hat) + 8.0 * _relu(inp.beta_e)
    density_excess = _relu(inp.grad_ne - 2.5)
    crit_tem = torch.clamp(
        CRIT_TEM + 1.1 * eps + 0.12 * torch.clamp(nustar, 0.0, 10.0)
        - 0.35 * density_excess, min=2.5)
    # ETG operating threshold below the nominal Jenko CRIT_ETG = 12 once
    # geometry/collisionality shifts are folded in.
    crit_etg = (10.5 + 1.0 * eps + 0.3 * _relu(inp.s_hat) + 0.2 * _relu(nustar))

    excess_itg = _relu(inp.grad_ti - crit_itg)
    excess_tem = _relu(inp.grad_te - crit_tem)
    excess_etg = _relu(inp.grad_te - crit_etg)

    chi_i_itg = chi_gb * excess_itg**stiffness * shear_supp * beta_supp
    chi_e_itg = 0.35 * chi_i_itg

    collisional_tem = 1.0 / (1.0 + 0.8 * _relu(nustar))
    density_drive = 0.15 + 0.35 * density_excess
    chi_e_tem = (chi_gb * excess_tem**stiffness * trapped_frac
                 * collisional_tem * beta_supp * density_drive)

    collisional_etg = 1.0 / (1.0 + 1.5 * _relu(nustar))
    etg_shear = 1.0 / (1.0 + 0.2 * _relu(inp.s_hat)**2)
    gradient_split = 1.0 + 0.18 * _relu(inp.grad_te - inp.grad_ti)
    chi_e_etg = (0.85 * chi_gb * excess_etg**(0.9 * stiffness)
                 * collisional_etg * etg_shear * electron_ratio * gradient_split)

    chi_i = _relu(chi_i_itg)
    chi_e = _relu(chi_e_itg + chi_e_tem + chi_e_etg)
    d_e = chi_e * (0.1 + 0.5 * torch.sqrt(_relu(eps)))

    # Dominant channel by strength (argmax, first on ties; 0 if all zero).
    strengths = torch.stack([chi_i_itg + chi_e_itg, chi_e_tem, chi_e_etg], dim=-1)
    best = torch.argmax(strengths, dim=-1).to(torch.int32) + 1
    channel = torch.where(torch.amax(strengths, dim=-1) > 0.0, best, 0)

    return ClosureFluxes(
        chi_i=chi_i, chi_e=chi_e, d_e=d_e, channel=channel,
        chi_i_itg=_relu(chi_i_itg), chi_e_itg=_relu(chi_e_itg),
        chi_e_tem=_relu(chi_e_tem), chi_e_etg=_relu(chi_e_etg))


def _gradient_on(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.gradient(f, x)`` on the coordinates ``x``: second order inside,
    one-sided first order at the edges."""
    upper = (f[1:2] - f[0:1]) / (x[1:2] - x[0:1])
    lower = (f[-1:] - f[-2:-1]) / (x[-1:] - x[-2:-1])
    dx1 = x[1:-1] - x[:-2]
    dx2 = x[2:] - x[1:-1]
    a = -(dx2) / (dx1 * (dx1 + dx2))
    b = (dx2 - dx1) / (dx1 * dx2)
    c = dx1 / (dx2 * (dx1 + dx2))
    inner = a * f[:-2] + b * f[1:-1] + c * f[2:]
    return torch.cat([upper, inner, lower])


def evaluate_closure_profile(rho, te_kev, ti_kev, ne_19, q, s_hat, *, r_major_m: float = 6.2,
                             a_minor_m: float = 2.0, b_tesla: float = 5.3, z_eff: float = 1.5,
                             beta_e: float = 0.01, stiffness: float = STIFFNESS
                             ) -> ClosureFluxes:
    """Whole-profile reduced closure: R/L gradients from the profiles, then
    :func:`critical_gradient_fluxes` on the (n,) profiles at once."""
    r = rho * a_minor_m

    def rlx(f):
        df = _gradient_on(f, r)
        return torch.clamp(-r_major_m * df / torch.clamp(f, min=1e-6), min=0.0)

    def full(v):
        return torch.full(rho.shape, v, dtype=rho.dtype, device=rho.device)

    inp = ClosureInputs(
        rho=rho, te_kev=te_kev, ti_kev=ti_kev, ne_19=ne_19,
        grad_te=rlx(te_kev), grad_ti=rlx(ti_kev), grad_ne=rlx(ne_19),
        q=q, s_hat=s_hat, beta_e=full(beta_e), r_major_m=full(r_major_m),
        a_minor_m=full(a_minor_m), b_tesla=full(b_tesla), z_eff=full(z_eff))
    return critical_gradient_fluxes(inp, stiffness=stiffness)
