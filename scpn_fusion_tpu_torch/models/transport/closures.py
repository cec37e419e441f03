"""Transport closures: neoclassical, gyro-Bohm, bootstrap, reactivity,
radiation (port of ``scpn_fusion_tpu/models/transport/closures.py``).

Same formulas, constants and guards as the JAX closures, in PyTorch ops on
the inputs' device and dtype:

* Chang-Hinton (1982) neoclassical chi_i;
* gyro-Bohm anomalous chi;
* the full Sauter bootstrap current (Sauter et al., Phys. Plasmas 6, 1999);
* Bosch-Hale D-T reactivity (NF 32 (1992) 611, Table IV);
* the coronal tungsten radiation rate and bremsstrahlung.

Scalar parameters (``r0``, ``z_eff``, ...) may be Python floats or 0-d
tensors.
"""

from __future__ import annotations

import numpy as _np
import torch

E_CHARGE = 1.602176634e-19
E_KEV_J = 1.602176634e-16
EPS0 = 8.854187812e-12
M_P = 1.672621924e-27
M_E = 9.10938370e-31


def _coulomb_prefactor(mass_kg: float) -> float:
    """Python-float constant K such that
    nu = K * n_19 * Z_factor * ln_lambda / T_keV^1.5  [1/s]
    (the SI expression underflows float32, so it is folded on the host)."""
    return float(1e19 * E_CHARGE**4
                 / (12.0 * _np.pi**1.5 * EPS0**2 * _np.sqrt(mass_kg)
                    * (1e3 * E_CHARGE) ** 1.5))


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its subnormal values set to zero.  XLA flushes float32
    subnormals (on the CPU as on the TPU); PyTorch keeps them, on the CPU and
    on the card.  The reference's float32 gyro-Bohm closure depends on it:
    ``T_i m_i`` (~5e-43 J kg) is subnormal in float32, so there rho_s is 0 and
    chi_gB sits at its 0.01 floor, one cause of the float32 stepper's
    departure from its float64 one, which the port keeps."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, 0.0, x)


def _ln_lambda(t_kev: torch.Tensor, n_e_m3: torch.Tensor) -> torch.Tensor:
    """NRL Coulomb logarithm with the reference's clamps."""
    return torch.clamp(
        17.7 + torch.log(torch.clamp(t_kev, min=0.01) / 10.0)
        - 0.5 * torch.log(torch.clamp(n_e_m3, min=1e10) / 1e20),
        10.0, 25.0)


def chang_hinton_chi(rho, t_i_kev, n_e_19, q, r0, a_minor, b0, a_ion=2.0, z_eff=1.5):
    """Chang-Hinton (1982) neoclassical ion thermal diffusivity [m^2/s]."""
    rho_c = torch.clamp(rho, 0.0, 1.0)
    t_i = torch.clamp(t_i_kev, min=0.01)
    n_e = torch.clamp(n_e_19, min=0.1)
    q_c = torch.clamp(q, min=0.1)
    m_i = a_ion * M_P

    epsilon = rho_c * a_minor / r0
    valid = epsilon >= 1e-6

    t_j = t_i * E_KEV_J
    v_ti = torch.sqrt(2.0 * t_j / m_i)
    rho_i = m_i * v_ti / (E_CHARGE * b0)
    n_m3 = n_e * 1e19
    ll = _ln_lambda(t_i, n_m3)
    nu_ii = _coulomb_prefactor(m_i) * n_e * z_eff**2 * ll / t_i**1.5

    eps_safe = torch.where(valid, epsilon, 1.0)
    eps32 = eps_safe**1.5
    nu_star = torch.clamp(nu_ii * q_c * r0 / (eps32 * v_ti), min=0.0)
    chi = (0.66 * (1.0 + 1.54 * eps_safe) * q_c**2 * rho_i**2 * nu_ii
           / (eps32 * (1.0 + 0.74 * nu_star ** (2.0 / 3.0))))
    chi = torch.where(torch.isfinite(chi), torch.clamp(chi, min=0.01), 0.01)
    return torch.where(valid, chi, 0.01)


def gyro_bohm_chi(t_i_kev, t_e_kev, q, r0, a_minor, b0, a_ion=2.0, c_gb=1.0):
    """Gyro-Bohm anomalous transport diffusivity [m^2/s]."""
    m_i = a_ion * M_P
    ti = torch.clamp(t_i_kev, min=0.01)
    te = torch.clamp(t_e_kev, min=0.01)
    qi = torch.clamp(q, min=0.5)
    t_i_j = ti * 1e3 * E_CHARGE
    t_e_j = te * 1e3 * E_CHARGE
    rho_s = torch.sqrt(flush_subnormal(t_i_j * m_i)) / (E_CHARGE * b0)
    c_s = torch.sqrt(t_e_j / m_i)
    denom = torch.clamp(a_minor * qi * r0, min=1e-6)
    chi = c_gb * rho_s**2 * c_s / denom
    return torch.where(torch.isfinite(chi), torch.clamp(chi, min=0.01), 0.01)


def sauter_bootstrap_current(rho, te_kev, ti_kev, ne_19, q, r0, a_minor, b0, z_eff=1.5):
    """Full Sauter bootstrap current density [A/m^2] (zero at both edges)."""
    n = rho.shape[0]
    te = torch.clamp(te_kev, min=0.01)
    ti = torch.clamp(ti_kev, min=0.01)
    ne = torch.clamp(ne_19, min=0.1)
    q_c = torch.clamp(q, min=0.1)

    eps = torch.clamp(rho * a_minor / r0, 1e-6, 0.999999)
    sqrt_trap = torch.sqrt(torch.clamp(1.0 - eps**2, min=1e-12))
    f_t = 1.0 - (1.0 - eps) ** 2 / (sqrt_trap * (1.0 + 1.46 * torch.sqrt(eps)))
    f_t = torch.clamp(f_t, 0.0, 1.0)

    t_e_j = te * 1e3 * E_CHARGE
    v_te = torch.sqrt(2.0 * t_e_j / M_E)
    n_m3 = ne * 1e19
    ll = _ln_lambda(te, n_m3)
    nu_ei = _coulomb_prefactor(M_E) * ne * z_eff * ll / te**1.5
    nu_ei = torch.where(torch.isfinite(nu_ei) & (nu_ei >= 0), nu_ei, 0.0)
    nu_star_e = torch.where(v_te > 0, nu_ei * q_c * r0 / (eps**1.5 * v_te), 1e6)
    nu_star_e = torch.where(torch.isfinite(nu_star_e) & (nu_star_e >= 0), nu_star_e, 1e6)

    alpha31 = 1.0 / (1.0 + 0.36 / z_eff)
    l31 = f_t * alpha31 / (1.0 + alpha31 * torch.sqrt(nu_star_e)
                           + 0.25 * nu_star_e * (1.0 - f_t) ** 2)
    l32 = f_t * (0.05 + 0.62 * z_eff) / (z_eff * (1.0 + 0.44 * z_eff))
    l32 = l32 / (1.0 + 0.22 * torch.sqrt(nu_star_e) + 0.19 * nu_star_e * (1.0 - f_t))
    l34 = l31 * ti / torch.clamp(te, min=0.01)

    def diff(x):
        return torch.roll(x, -1) - torch.roll(x, 1)

    dr = diff(rho) * a_minor
    dr_ok = dr.abs() >= 1e-12
    dr_safe = torch.where(dr_ok, dr, 1.0)
    dn_dr = torch.where(dr_ok, diff(ne) * 1e19 / dr_safe, 0.0)
    dte_dr = torch.where(dr_ok, diff(te) * 1e3 * E_CHARGE / dr_safe, 0.0)
    dti_dr = torch.where(dr_ok, diff(ti) * 1e3 * E_CHARGE / dr_safe, 0.0)

    b_pol = b0 * eps / torch.clamp(q_c, min=0.1)
    b_ok = b_pol >= 1e-10
    t_floor = 10.0 * E_CHARGE
    p_e = n_m3 * t_e_j
    j = -(p_e / torch.where(b_ok, b_pol, 1.0)) * (
        l31 * dn_dr / torch.clamp(n_m3, min=1e10)
        + l32 * dte_dr / torch.clamp(t_e_j, min=t_floor)
        + l34 * dti_dr / torch.clamp(ti * 1e3 * E_CHARGE, min=t_floor)
    )
    j = torch.where(dr_ok & b_ok & torch.isfinite(j), j, 0.0)
    idx = torch.arange(n, device=rho.device)
    return torch.where((idx == 0) | (idx == n - 1), 0.0, j)


# Bosch-Hale D-T coefficients (NF 32 (1992) 611, Table IV): B_G^2, m_r c^2
# [keV] and C1-C7; row E (``csrc/burn.cu``) takes the same numbers.
BOSCH_HALE_DT = {"bg2": 34.3827**2, "mrc2": 1124656.0, "c1": 1.17302e-9,
                 "c2": 1.51361e-2, "c3": 7.51886e-2, "c4": 4.60643e-3, "c5": 1.35000e-2,
                 "c6": -1.06750e-4, "c7": 1.36600e-5}


def bosch_hale_sigmav(t_i_kev: torch.Tensor) -> torch.Tensor:
    """D-T fusion reactivity <sigma v> [m^3/s] (Bosch & Hale 1992)."""
    t = torch.clamp(t_i_kev, 0.2, 100.0)
    bg2, mrc2, c1, c2, c3, c4, c5, c6, c7 = BOSCH_HALE_DT.values()
    theta = t / (1.0 - t * (c2 + t * (c4 + t * c6))
                 / (1.0 + t * (c3 + t * (c5 + t * c7))))
    xi = (bg2 / (4.0 * theta)) ** (1.0 / 3.0)
    sv = c1 * theta * torch.sqrt(xi / (mrc2 * t**3)) * torch.exp(-3.0 * xi) * 1e-6
    return torch.clamp(sv, min=0.0)


def tungsten_radiation_rate(te_kev: torch.Tensor) -> torch.Tensor:
    """Coronal-equilibrium tungsten Lz [W m^3] (piecewise fit)."""
    te = torch.clamp(te_kev, 0.01, 1e3)
    return torch.where(
        te < 1.0, 5.0e-31 * torch.sqrt(te),
        torch.where(te < 5.0, 5.0e-31,
                    torch.where(te < 20.0, 2.0e-31 * te**0.3, 8.0e-31)))


def bremsstrahlung_power_density(ne_19, te_kev, z_eff):
    """Bremsstrahlung power density [W/m^3], in 1e19-normalised density
    units (ne^2 in SI overflows float32; the 1e38 is folded on the host)."""
    ne19 = torch.clamp(ne_19, 0.0, 1e6)
    te = torch.clamp(te_kev, 0.01, 1e3)
    z = torch.clamp(torch.as_tensor(z_eff, dtype=te.dtype, device=te.device), 1e-6, 100.0)
    p = (5.35e-37 * 1e38) * z * ne19**2 * torch.sqrt(te)
    return torch.where(torch.isfinite(p), p, 0.0)
