"""Miller local equilibrium geometry for flux-tube gyrokinetics
(port of ``scpn_fusion_tpu/models/gyrokinetics/geometry.py``).

Miller parameterisation R(theta) = R0 + r cos(theta + arcsin(delta)
sin(theta)), Z = kappa r sin(theta), metric coefficients from the (r, theta)
Jacobian, vacuum toroidal field, q-consistent poloidal field with metric
stretching, and the curvature components (Miller Eqs. 18-19 approximation).
The shape parameters are numbers; every profile is a tensor of ``dtype`` on
``device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class MillerGeometry(NamedTuple):
    theta: torch.Tensor
    r_s: torch.Tensor           # R(theta)
    z_s: torch.Tensor
    b_mag: torch.Tensor
    jacobian: torch.Tensor
    g_rr: torch.Tensor
    g_rt: torch.Tensor
    g_tt: torch.Tensor
    kappa_n: torch.Tensor
    kappa_g: torch.Tensor
    b_dot_grad_theta: torch.Tensor


def miller_geometry(
    *,
    r0: float = 2.78,
    a: float = 1.0,
    rho: float = 0.5,
    kappa: float = 1.0,
    delta: float = 0.0,
    s_kappa: float = 0.0,
    s_delta: float = 0.0,
    q: float = 1.4,
    s_hat: float = 0.78,
    alpha_mhd: float = 0.0,
    dr_dr: float = 0.0,
    b0: float = 2.0,
    n_theta: int = 64,
    n_period: int = 2,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
) -> MillerGeometry:
    r = rho * a
    theta = torch.as_tensor(np.linspace(-n_period * np.pi, n_period * np.pi, n_theta),
                            dtype=dtype, device=device)
    delta_angle = math.asin(min(max(delta, -0.99), 0.99))

    arg = theta + delta_angle * torch.sin(theta)
    r_s = r0 + r * torch.cos(arg)
    z_s = kappa * r * torch.sin(theta)

    dr_dt = -r * torch.sin(arg) * (1 + delta_angle * torch.cos(theta))
    dz_dt = kappa * r * torch.cos(theta)

    delta_angle_shear = (s_delta * delta / math.sqrt(max(1.0 - delta**2, 1e-12))
                         if delta != 0.0 else 0.0)
    dr_dr_tot = (torch.cos(arg) + dr_dr
                 - torch.sin(arg) * torch.sin(theta) * delta_angle_shear)
    dz_dr_r = kappa * (1.0 + s_kappa) * torch.sin(theta)

    jac = dr_dr_tot * dz_dt - dr_dt * dz_dr_r
    jac = torch.where(torch.abs(jac) < 1e-30, torch.full_like(jac, 1e-30), jac)

    g_rr = (dr_dt**2 + dz_dt**2) / jac**2
    g_rt = -(dr_dr_tot * dr_dt + dz_dr_r * dz_dt) / jac**2
    g_tt = (dr_dr_tot**2 + dz_dr_r**2) / jac**2

    b_phi = b0 * r0 / r_s
    theta_arc = torch.sqrt(dr_dt**2 + dz_dt**2)
    metric_stretch = theta_arc / max(r, 1e-6)
    b_p = (torch.abs(b_phi) * max(r, 1e-6)
           / (q * r_s * torch.clamp(metric_stretch, min=1e-12)))
    b_mag = torch.sqrt(b_phi**2 + b_p**2)
    b_dot_grad_theta = b_p / b_mag * torch.sqrt(g_tt)

    inv_r = 1.0 / r_s
    kappa_n = -inv_r * (torch.cos(theta) + (s_hat * theta - alpha_mhd) * torch.sin(theta))
    kappa_g = -inv_r * (torch.sin(theta) - (s_hat * theta - alpha_mhd) * torch.cos(theta))

    return MillerGeometry(theta, r_s, z_s, b_mag, jac, g_rr, g_rt, g_tt,
                          kappa_n, kappa_g, b_dot_grad_theta)


def circular_geometry(
    r0: float = 2.78, a: float = 1.0, rho: float = 0.5, q: float = 1.4,
    s_hat: float = 0.78, b0: float = 2.0, n_theta: int = 64,
    n_period: int = 2, dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
) -> MillerGeometry:
    """Circular limit (Cyclone Base Case verification geometry)."""
    return miller_geometry(r0=r0, a=a, rho=rho, kappa=1.0, delta=0.0,
                           q=q, s_hat=s_hat, b0=b0, n_theta=n_theta,
                           n_period=n_period, dtype=dtype, device=device)
