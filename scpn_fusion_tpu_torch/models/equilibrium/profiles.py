"""Pressure / current profile shapes for the GS source term (port of
``scpn_fusion_tpu/models/equilibrium/profiles.py``).

L-mode linear and H-mode mtanh pedestal profiles on normalised flux, and the
composite ``J_phi = beta_mix R p' + (1 - beta_mix) FF' / (mu0 R)`` source
renormalised to the target plasma current.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.config import PhysicsParams


class ProfileCoeffs(NamedTuple):
    """mtanh profile parameters (one instance per p'/FF' channel), each a
    0-dim tensor on the solve's device."""

    ped_top: torch.Tensor
    ped_width: torch.Tensor
    ped_height: torch.Tensor
    core_alpha: torch.Tensor

    @classmethod
    def from_config(cls, p, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> "ProfileCoeffs":
        vals = torch.tensor([p.ped_top, p.ped_width, p.ped_height, p.core_alpha],
                            dtype=dtype, device=device)
        return cls(*vals.unbind())


def mtanh_profile(psi_norm: torch.Tensor, p: ProfileCoeffs) -> torch.Tensor:
    """Modified-tanh pedestal profile; zero outside 0 <= psi_norm < 1."""
    inside = (psi_norm >= 0.0) & (psi_norm < 1.0)
    y = torch.clamp((p.ped_top - psi_norm) / p.ped_width, -20.0, 20.0)
    pedestal = 0.5 * p.ped_height * (1.0 + torch.tanh(y))
    zero = torch.zeros_like(psi_norm)
    core = torch.where(psi_norm < p.ped_top,
                       torch.clamp(1.0 - (psi_norm / p.ped_top) ** 2, min=0.0), zero)
    return torch.where(inside, pedestal + p.core_alpha * core, zero)


def lmode_profile(psi_norm: torch.Tensor) -> torch.Tensor:
    """Linear L-mode profile ``1 - psi_norm`` inside the plasma, else zero."""
    inside = (psi_norm >= 0.0) & (psi_norm < 1.0)
    return torch.where(inside, 1.0 - psi_norm, torch.zeros_like(psi_norm))


def raw_current_density(psi: torch.Tensor, psi_axis: torch.Tensor,
                        psi_boundary: torch.Tensor, rr: torch.Tensor, *, h_mode: bool,
                        p_coeffs: ProfileCoeffs, ff_coeffs: ProfileCoeffs, mu0: float,
                        beta_mix: float = 0.5) -> torch.Tensor:
    """Toroidal current density before the Ip renormalisation."""
    denom = psi_boundary - psi_axis
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    psi_norm = (psi - psi_axis) / denom

    if h_mode:
        p_profile = mtanh_profile(psi_norm, p_coeffs)
        ff_profile = mtanh_profile(psi_norm, ff_coeffs)
    else:
        p_profile = lmode_profile(psi_norm)
        ff_profile = p_profile

    j_p = rr * p_profile
    j_f = ff_profile / (mu0 * rr)
    return beta_mix * j_p + (1.0 - beta_mix) * j_f


def plasma_current_density(
    psi: torch.Tensor,
    psi_axis: torch.Tensor,
    psi_boundary: torch.Tensor,
    rr: torch.Tensor,
    *,
    h_mode: bool,
    p_coeffs: ProfileCoeffs,
    ff_coeffs: ProfileCoeffs,
    mu0: float,
    i_target: torch.Tensor,
    d_r: float,
    d_z: float,
    beta_mix: float = 0.5,
) -> torch.Tensor:
    """Toroidal current density from the GS source profiles, Ip-renormalised."""
    j_raw = raw_current_density(psi, psi_axis, psi_boundary, rr, h_mode=h_mode,
                                p_coeffs=p_coeffs, ff_coeffs=ff_coeffs, mu0=mu0,
                                beta_mix=beta_mix)
    i_current = j_raw.sum() * d_r * d_z
    scale = torch.where(i_current.abs() > 1e-9, i_target / i_current,
                        torch.zeros_like(i_current))
    return j_raw * scale


def profile_coeffs_from_physics(phys: PhysicsParams, dtype: torch.dtype = torch.float32,
                                device: torch.device | str = "cpu"):
    """(p', FF') mtanh coefficients from a static config."""
    return (ProfileCoeffs.from_config(phys.p_prime, dtype, device),
            ProfileCoeffs.from_config(phys.ff_prime, dtype, device))
