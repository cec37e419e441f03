"""Monte Carlo uncertainty quantification for fusion performance (port of
``scpn_fusion_tpu/models/uq/mc.py``).

Sample the IPB98(y,2) scaling-law coefficients from their Gaussian
(optionally correlated) posteriors, propagate through confinement -> fusion
power with alpha self-heating, and report medians / sigmas / percentile
bands.  The whole posterior ensemble propagates as one batch of tensor ops.
float32-safe: the n_e^2 E_fus volume factor (~1e40 in SI) is folded into
host-double constants in 1e19 units.

Statistics as JAX takes them: ``jnp.median`` averages an even count's middle
pair (``core.stats.median``; ``torch.median`` returns the lower one),
``jnp.std`` divides by the count (``correction=0``), ``jnp.percentile`` is
linear (``core.stats.percentile``, float64 positions, no 2^24 limit).

Draws: :func:`quantify_uncertainty` and :func:`quantify_full_chain` draw
their standard normals from a ``torch.Generator`` seeded with ``seed`` (on the
CPU, then moved to ``device``); :func:`_quantify_uncertainty` and
:func:`_quantify_full_chain` take them (the CPU tests feed them JAX's).
They take ``dtype`` (float32 by default; JAX takes its float from the x64
flag) and ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.stats import median, percentile
from scpn_fusion_tpu_torch.models.transport.closures import bosch_hale_sigmav

# IPB98(y,2) central exponents and Verdoolaege-2021-style 1-sigma
# posteriors (reference ``uncertainty.py:43-66``).
IPB98_KEYS = ("C", "alpha_I", "alpha_B", "alpha_P", "alpha_n", "alpha_R",
              "alpha_A", "alpha_kappa", "alpha_M")
IPB98_CENTRAL = np.array([0.0562, 0.93, 0.15, -0.69, 0.41, 1.97, -0.58, 0.78, 0.19])
IPB98_SIGMA = np.array([0.012, 0.03, 0.05, 0.02, 0.04, 0.08, 0.06, 0.07, 0.04])

_KEV_PER_MJ_N19 = 1e6 / (3.0 * 1e19 * 1.602176634e-16)   # Ti = W*this/(n19 V)
_E_FUS_J = 17.6e6 * 1.602176634e-19
_FUS_CONST_MW = 0.25 * 1e38 * _E_FUS_J / 1e6   # P[MW] = this * n19^2 sv V
PERCENTILES = (5.0, 25.0, 50.0, 75.0, 95.0)
BANDS = (5.0, 50.0, 95.0)


@dataclasses.dataclass(frozen=True)
class PlasmaScenario:
    """Machine point held fixed during coefficient sampling."""

    i_p_ma: float
    b_t: float
    p_heat_mw: float
    n_e_19: float
    r_major: float
    aspect: float
    kappa: float
    m_amu: float = 2.5


class UQResult(NamedTuple):
    tau_e: torch.Tensor
    p_fusion: torch.Tensor
    q: torch.Tensor
    tau_e_sigma: torch.Tensor
    p_fusion_sigma: torch.Tensor
    q_sigma: torch.Tensor
    tau_e_percentiles: torch.Tensor     # [5, 25, 50, 75, 95]
    p_fusion_percentiles: torch.Tensor
    q_percentiles: torch.Tensor
    n_samples: int


def ipb98_tau_e(s: PlasmaScenario, coeffs: torch.Tensor) -> torch.Tensor:
    """tau_E from coefficient vectors (..., 9) (order = IPB98_KEYS);
    log-linear."""
    def log(v: float) -> torch.Tensor:
        return torch.log(torch.tensor(v, dtype=coeffs.dtype, device=coeffs.device))

    c = torch.clamp(coeffs[..., 0], min=1e-4)
    alpha_p = torch.clamp(coeffs[..., 3], max=-0.1)
    log_tau = (torch.log(c)
               + coeffs[..., 1] * log(s.i_p_ma)
               + coeffs[..., 2] * log(s.b_t)
               + alpha_p * log(s.p_heat_mw)
               + coeffs[..., 4] * log(s.n_e_19)
               + coeffs[..., 5] * log(s.r_major)
               + coeffs[..., 6] * log(s.aspect)
               + coeffs[..., 7] * log(s.kappa)
               + coeffs[..., 8] * log(s.m_amu))
    return torch.exp(torch.clamp(log_tau, -60.0, 60.0))


def fusion_power_from_tau(s: PlasmaScenario, tau_e, *, dtype: torch.dtype | None = None,
                          device: torch.device | str = "cuda") -> torch.Tensor:
    """P_fus with one alpha self-heating fixed-point refinement
    (reference ``fusion_power_from_tau``); 1e19-normalised, float32-safe."""
    if not isinstance(tau_e, torch.Tensor):
        tau_e = torch.tensor(tau_e, dtype=dtype or torch.float32, device=device)
    a_minor = s.r_major / s.aspect
    volume = 2.0 * math.pi**2 * s.r_major * a_minor**2 * s.kappa
    f_alpha = 3.5 / 17.6

    def pfus_at(p_tot_mw):
        w_mj = p_tot_mw * tau_e
        ti = torch.clamp(w_mj * _KEV_PER_MJ_N19 / (s.n_e_19 * volume), 0.5, 100.0)
        sv = bosch_hale_sigmav(ti)
        return _FUS_CONST_MW * s.n_e_19**2 * sv * volume

    p0 = pfus_at(s.p_heat_mw)
    return torch.clamp(pfus_at(s.p_heat_mw + f_alpha * p0), min=0.0)


def _chain_q(s: PlasmaScenario, pfus: torch.Tensor) -> torch.Tensor:
    q = pfus / s.p_heat_mw if s.p_heat_mw > 0 else torch.zeros_like(pfus)
    return torch.nan_to_num(q)


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x, correction=0)


def _quantify_uncertainty(s: PlasmaScenario, z: torch.Tensor) -> UQResult:
    """:func:`quantify_uncertainty` on its standard normals ``z`` (n, 9)."""
    kw = dict(dtype=z.dtype, device=z.device)
    coeffs = (torch.as_tensor(IPB98_CENTRAL, **kw)
              + z * torch.as_tensor(IPB98_SIGMA, **kw))
    tau = torch.clamp(ipb98_tau_e(s, coeffs), min=1e-6)
    pfus = fusion_power_from_tau(s, tau)
    q = _chain_q(s, pfus)
    return UQResult(median(tau), median(pfus), median(q), _std(tau), _std(pfus), _std(q),
                    percentile(tau, PERCENTILES), percentile(pfus, PERCENTILES),
                    percentile(q, PERCENTILES), z.shape[0])


def quantify_uncertainty(s: PlasmaScenario, *, n_samples: int = 10000, seed: int = 0,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> UQResult:
    """Vectorised MC over the IPB98 posterior (reference
    ``quantify_uncertainty``, which loops sample-by-sample)."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((n_samples, len(IPB98_KEYS)), generator=g, dtype=dtype)
    return _quantify_uncertainty(s, z.to(device))


@dataclasses.dataclass(frozen=True)
class EquilibriumUncertainty:
    """Reconstruction-channel uncertainty (reference dataclass parity)."""

    psi_nrmse_mean: float = 0.0
    psi_nrmse_sigma: float = 0.01
    r_axis_sigma: float = 0.02
    z_axis_sigma: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransportUncertainty:
    chi_gb_factor_sigma: float = 0.3
    pedestal_height_sigma: float = 0.2


class FullChainUQResult(NamedTuple):
    tau_e: torch.Tensor
    p_fusion: torch.Tensor
    q: torch.Tensor
    tau_e_sigma: torch.Tensor
    p_fusion_sigma: torch.Tensor
    q_sigma: torch.Tensor
    psi_nrmse_bands: torch.Tensor     # [5, 50, 95]
    tau_e_bands: torch.Tensor
    p_fusion_bands: torch.Tensor
    q_bands: torch.Tensor
    n_samples: int


def ipb98_covariance() -> np.ndarray:
    """Correlated coefficient covariance: C <-> alpha_R anti-correlation
    -0.7 from global regressions (reference ``_build_ipb98_covariance``)."""
    cov = np.diag(IPB98_SIGMA**2)
    cov[0, 5] = cov[5, 0] = -0.7 * IPB98_SIGMA[0] * IPB98_SIGMA[5]
    return cov


def _quantify_full_chain(s: PlasmaScenario, eq: EquilibriumUncertainty,
                         tr: TransportUncertainty, z: torch.Tensor, z_psi: torch.Tensor,
                         z_chi: torch.Tensor, z_ped: torch.Tensor) -> FullChainUQResult:
    """:func:`quantify_full_chain` on its standard normals: ``z`` (n, 9) for
    the coefficients, ``z_psi``, ``z_chi``, ``z_ped`` (n,) for the
    reconstruction, gyro-Bohm and pedestal channels."""
    kw = dict(dtype=z.dtype, device=z.device)
    chol = torch.as_tensor(np.linalg.cholesky(ipb98_covariance() + 1e-12 * np.eye(len(IPB98_KEYS))),
                           **kw)
    coeffs = torch.as_tensor(IPB98_CENTRAL, **kw) + z @ chol.T
    psi_nrmse = torch.abs(eq.psi_nrmse_mean + eq.psi_nrmse_sigma * z_psi)
    chi_factor = torch.clamp(1.0 + tr.chi_gb_factor_sigma * z_chi, min=0.1)
    ped_factor = torch.clamp(1.0 + tr.pedestal_height_sigma * z_ped, min=0.1)

    tau = torch.clamp(ipb98_tau_e(s, coeffs), min=1e-6)
    # Higher chi -> shorter tau; taller pedestal -> longer tau;
    # reconstruction error degrades the usable stored energy.
    tau = tau * ped_factor / chi_factor * (1.0 - torch.clamp(psi_nrmse, 0.0, 0.5))
    pfus = fusion_power_from_tau(s, tau)
    q = _chain_q(s, pfus)
    return FullChainUQResult(
        median(tau), median(pfus), median(q), _std(tau), _std(pfus), _std(q),
        percentile(psi_nrmse, BANDS), percentile(tau, BANDS), percentile(pfus, BANDS),
        percentile(q, BANDS), z.shape[0])


def quantify_full_chain(s: PlasmaScenario, eq: EquilibriumUncertainty = EquilibriumUncertainty(),
                        tr: TransportUncertainty = TransportUncertainty(), *,
                        n_samples: int = 5000, seed: int = 0,
                        dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda") -> FullChainUQResult:
    """Equilibrium -> transport -> burn chain with correlated IPB98
    posterior sampling (reference ``quantify_full_chain``):

    - psi reconstruction NRMSE jitters the effective stored energy,
    - the gyro-Bohm / pedestal channels jitter tau_E multiplicatively,
    - the correlated scaling posterior drives the burn model.
    """
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((n_samples, len(IPB98_KEYS)), generator=g, dtype=dtype)
    rest = [torch.randn((n_samples,), generator=g, dtype=dtype) for _ in range(3)]
    return _quantify_full_chain(s, eq, tr, z.to(device), *(x.to(device) for x in rest))
