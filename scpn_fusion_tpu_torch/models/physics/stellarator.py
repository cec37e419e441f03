"""Stellarator geometry, neoclassical transport, and ISS04 confinement
(port of ``scpn_fusion_tpu/models/physics/stellarator.py``).

Boozer-coordinate flux surfaces with helical mirror + axis-excursion |B|
modulation, a Nemov-style effective-ripple spectrum estimate (``torch.fft.
rfft`` along the toroidal angle), the ISS04 scaling and the 1/nu
neoclassical chi.  Plain PyTorch ops.  JAX's ``jnp.linspace`` and
``jnp.mean`` under ``jit`` are reproduced as XLA rounds them
(``core.grid.linspace``, ``core.grid.xla_mean``: the sum times the
reciprocal of the count).  Functions given Python numbers and a frozen
configuration take ``dtype`` (float32 by default; JAX takes its float from
the x64 flag) and ``device`` (``"cuda"`` by default); given tensors they
follow them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from scpn_fusion_tpu_torch.core.grid import linspace, xla_mean
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors


@dataclasses.dataclass(frozen=True)
class StellaratorConfig:
    """Device + magnetic configuration (hashable).

    Fields mirror the reference's ``StellaratorConfig`` (:34-88).
    """

    n_fp: int = 5
    r0: float = 5.5
    a: float = 0.53
    b0: float = 2.5
    iota_0: float = 0.85
    iota_a: float = 0.97
    mirror_ratio: float = 0.05
    helical_excursion: float = 0.2

    def __post_init__(self) -> None:
        if self.n_fp < 1:
            raise ValueError("n_fp must be >= 1")
        for name in ("r0", "a", "b0"):
            if getattr(self, name) <= 0.0:
                raise ValueError(f"{name} must be > 0")


def w7x_config() -> StellaratorConfig:
    """Wendelstein 7-X-like preset (reference :105-121)."""
    return StellaratorConfig(n_fp=5, r0=5.5, a=0.53, b0=2.5,
                             iota_0=0.85, iota_a=0.97,
                             mirror_ratio=0.05, helical_excursion=0.2)


def iota_profile(cfg: StellaratorConfig, s, *, dtype=None, device="cuda"):
    """Rotational transform iota(s), linear in the flux label."""
    s, = as_tensors(s, dtype=dtype, device=device)
    return cfg.iota_0 + (cfg.iota_a - cfg.iota_0) * s


def stellarator_flux_surface(cfg: StellaratorConfig, s, n_theta: int = 64, n_phi: int = 64, *,
                             dtype=None, device="cuda"):
    """(R, Z, |B|) on one Boozer flux surface (reference :144-199), each
    (n_theta, n_phi).

    |B| modulation: toroidal (eps_t cos th), helical mirror
    (eps_h cos(N phi - iota th)), and helical-axis curvature.
    """
    s, = as_tensors(s, dtype=dtype, device=device)
    s = torch.clamp(s, 1e-6, 1.0)
    r = cfg.a * torch.sqrt(s)
    iota = iota_profile(cfg, s)

    theta = linspace(0.0, 2.0 * math.pi, n_theta, s.dtype, s.device, endpoint=False)
    phi = linspace(0.0, 2.0 * math.pi, n_phi, s.dtype, s.device, endpoint=False)
    th, ph = torch.meshgrid(theta, phi, indexing="ij")

    delta_r = cfg.helical_excursion * torch.cos(cfg.n_fp * ph)
    r_maj = cfg.r0 + r * torch.cos(th) + delta_r
    z = r * torch.sin(th) + cfg.helical_excursion * torch.sin(cfg.n_fp * ph)

    eps_t = r / cfg.r0
    eps_h = cfg.mirror_ratio * torch.sqrt(s)
    axis_curv = (cfg.helical_excursion / cfg.r0) * torch.sqrt(s)
    b = cfg.b0 * (1.0
                  - eps_t * torch.cos(th)
                  - eps_h * torch.cos(cfg.n_fp * ph - iota * th)
                  - axis_curv * torch.cos(cfg.n_fp * ph))
    return r_maj, z, b


def effective_ripple(cfg: StellaratorConfig, s, *, dtype=None, device="cuda") -> torch.Tensor:
    """Effective helical ripple eps_eff (Nemov-style field-spectrum
    estimate, reference :200-249): remove the toroidally-averaged |B| per
    poloidal ring, measure the non-axisymmetric RMS and its spectral
    concentration at the N_fp harmonic.  0 in the working dtype for an
    axisymmetric configuration."""
    s, = as_tensors(s, dtype=dtype, device=device)
    if cfg.mirror_ratio == 0.0 and cfg.helical_excursion == 0.0:
        return torch.zeros((), dtype=s.dtype, device=s.device)
    n_phi = max(64, 16 * cfg.n_fp)
    _, _, b = stellarator_flux_surface(cfg, s, n_theta=96, n_phi=n_phi)
    b_mean = xla_mean(b)
    b_norm = b / torch.clamp(b_mean, min=1e-30) - 1.0
    nonax = b_norm - xla_mean(b_norm, dim=1, keepdim=True)
    rms = torch.sqrt(xla_mean(nonax**2))

    spec = torch.fft.rfft(nonax, dim=1)
    harmonic = min(cfg.n_fp, n_phi // 2)
    power_h = xla_mean(torch.abs(spec[:, harmonic]) ** 2)
    power_t = xla_mean(torch.sum(torch.abs(spec[:, 1:]) ** 2, dim=1))
    concentration = power_h / torch.clamp(power_t, min=1e-30)

    helical = math.sqrt(2.0) * rms * torch.sqrt(torch.clamp(concentration, min=0.0))
    aspect = math.sqrt(cfg.a / cfg.r0)
    eps_eff = helical**1.5 * aspect / math.sqrt(float(cfg.n_fp))
    return torch.clamp(eps_eff, 0.0, 1.0)


def iss04_tau_e(cfg: StellaratorConfig, n_e19, p_heat_mw, *, dtype=None,
                device="cuda") -> torch.Tensor:
    """ISS04 stellarator confinement scaling (Yamada 2005 Eq. 4,
    reference :251-294): tau = 0.134 a^2.28 R^0.64 P^-0.61 n^0.54
    B^0.84 iota_{2/3}^0.41."""
    n_e19, p_heat_mw, s23 = as_tensors(n_e19, p_heat_mw, 2.0 / 3.0, dtype=dtype, device=device)
    iota_ref = iota_profile(cfg, s23)
    return (0.134 * cfg.a**2.28 * cfg.r0**0.64
            * p_heat_mw ** -0.61
            * n_e19 ** 0.54
            * cfg.b0**0.84 * iota_ref**0.41)


_M_D = 3.344e-27          # deuteron mass [kg]
_E_KEV_J = 1.602176634e-16
_E_CHARGE = 1.602176634e-19
_EPS0 = 8.8541878128e-12
_LN_LAMBDA = 17.0


def stellarator_neoclassical_chi(cfg: StellaratorConfig, s, t_kev, n_e19, *, dtype=None,
                                 device="cuda") -> torch.Tensor:
    """1/nu-regime neoclassical chi ~ eps_eff^1.5 v_th^2 / (nu R N_fp)
    (Beidler 2011, reference :296-340)."""
    s, t_kev, n_e19 = as_tensors(s, t_kev, n_e19, dtype=dtype, device=device)
    eps_eff = effective_ripple(cfg, s)
    t_kev = torch.clamp(t_kev, min=1e-3)
    n_m3 = torch.clamp(n_e19, min=1e-3) * 1e19
    v_th = torch.sqrt(t_kev * _E_KEV_J / _M_D)
    nu = (n_m3 * _LN_LAMBDA * _E_CHARGE**4
          / (4.0 * math.pi * _EPS0**2 * _M_D**2 * v_th**3))
    chi = eps_eff**1.5 * v_th**2 / (torch.clamp(nu, min=1e-30) * cfg.r0 * float(cfg.n_fp))
    return torch.clamp(chi, 0.0, 1e6)
