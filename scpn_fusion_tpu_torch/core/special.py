"""Special functions for toroidal Green's functions (port of
``scpn_fusion_tpu/core/special.py``).

Complete elliptic integrals K(m) and E(m) by the Abramowitz & Stegun
polynomial approximations 17.3.34 / 17.3.36 (|error| < 2e-8), with the same
coefficients and the same ``m = k**2`` convention, and the circular-filament
flux Green's function built on them.
"""

from __future__ import annotations

import math

import torch

# A&S 17.3.34 — K(m) = P(m1) - Q(m1) ln(m1), m1 = 1 - m
_K_P = (1.38629436112, 0.09666344259, 0.03590092383, 0.03742563713, 0.01451196212)
_K_Q = (0.5, 0.12498593597, 0.06880248576, 0.03328355346, 0.00441787012)
# A&S 17.3.36 — E(m) = P(m1) - Q(m1) ln(m1)
_E_P = (1.0, 0.44325141463, 0.06260601220, 0.04757383546, 0.01736506451)
_E_Q = (0.0, 0.24998368310, 0.09200180037, 0.04069697526, 0.00526449639)

_M1_FLOOR = 1e-12


def _poly4(c, x: torch.Tensor) -> torch.Tensor:
    # Horner evaluation of c0 + c1 x + c2 x^2 + c3 x^3 + c4 x^4
    return c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * c[4])))


def ellipk(m: torch.Tensor) -> torch.Tensor:
    """Complete elliptic integral of the first kind, K(m), m = k^2 in [0, 1)."""
    m1 = torch.clamp(1.0 - m, _M1_FLOOR, 1.0)
    return _poly4(_K_P, m1) - _poly4(_K_Q, m1) * torch.log(m1)


def ellipe(m: torch.Tensor) -> torch.Tensor:
    """Complete elliptic integral of the second kind, E(m), m = k^2 in [0, 1]."""
    m1 = torch.clamp(1.0 - m, _M1_FLOOR, 1.0)
    return _poly4(_E_P, m1) - _poly4(_E_Q, m1) * torch.log(m1)


def green_coil_psi(
    r_src: torch.Tensor,
    z_src: torch.Tensor,
    r_obs: torch.Tensor,
    z_obs: torch.Tensor,
    mu0: float,
) -> torch.Tensor:
    """Poloidal flux per ampere-turn of a circular filament at
    (r_src, z_src), seen at (r_obs, z_obs).  All inputs broadcast; the
    singular self-observation limit is regularised to zero."""
    dz = z_obs - z_src
    denom = (r_obs + r_src) ** 2 + dz**2
    k2 = 4.0 * r_obs * r_src / torch.clamp(denom, min=1e-30)
    k2 = torch.clamp(k2, 1e-12, 1.0 - 1e-12)
    k = torch.sqrt(k2)
    K = ellipk(k2)
    E = ellipe(k2)
    prefactor = mu0 / (2.0 * math.pi) * torch.sqrt(torch.clamp(r_obs * r_src, min=0.0))
    psi = prefactor * ((2.0 - k2) * K - 2.0 * E) / k
    self_mask = (r_obs - r_src) ** 2 + dz**2 < 1e-24
    return torch.where(self_mask, torch.zeros_like(psi), psi)
