"""Field-reversed-configuration rigid-rotor 1D equilibrium (port of
``scpn_fusion_tpu/models/physics/frc.py``).

The rigid-rotor closure family (Steinhauer, Phys. Plasmas 18, 070501 (2011)):

    B_z(r) = -B_e tanh(K u),      u = 2 r^2 / r_s^2 - 1,
    p(r)   = (B_e^2 / 2 mu0) sech^2(K u),
    n(r)   = n_m sech^2(K u),
    J_theta = -(1/mu0) dB_z/dr,
    psi(r) = int_0^r B_z r' dr'   (log-cosh closed form),

which satisfies radial force balance d/dr (p + B_z^2/2mu0) = 0 exactly.  The
field null sits at R_null = r_s / sqrt(2).  The state is the input contract
of the pulsed Hall-MHD carrier (``hall_mhd_pulsed``).

Plain PyTorch ops.  The radial grid is ``jnp.linspace``'s, bit for bit
(``core/grid.linspace``).  :func:`solve_rigid_rotor` takes ``dtype``
(float32 by default; JAX takes its float from the x64 flag) and ``device``
(``"cuda"`` by default).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace

MU0 = 4.0e-7 * math.pi


class FRCEquilibriumState(NamedTuple):
    rho: torch.Tensor        # radial grid [m]
    psi: torch.Tensor        # poloidal-flux-per-radian analogue [Wb]
    b_z: torch.Tensor        # axial field [T]
    pressure: torch.Tensor   # [Pa]
    density: torch.Tensor    # [m^-3]
    j_theta: torch.Tensor    # azimuthal current density [A/m^2]
    r_null: torch.Tensor     # field-null radius [m]
    r_s: torch.Tensor        # separatrix radius [m]
    force_balance_residual: torch.Tensor  # max |d(p + B^2/2mu0)/dr| / scale


def _log_cosh(x: torch.Tensor) -> torch.Tensor:
    return x.abs() + torch.log1p(torch.exp(-2.0 * x.abs())) - math.log(2.0)


def solve_rigid_rotor(*, b_external_t: float, separatrix_radius_m: float,
                      sharpness_k: float = 1.0, peak_density_m3: float = 1e20,
                      n_points: int = 256, wall_radius_factor: float = 1.4,
                      dtype: torch.dtype | None = None,
                      device: torch.device | str = "cuda") -> FRCEquilibriumState:
    """Solve the rigid-rotor FRC equilibrium on a uniform radial grid."""
    dtype = dtype or torch.float32
    if separatrix_radius_m <= 0 or b_external_t <= 0 or sharpness_k <= 0:
        raise ValueError("b_external_t, separatrix_radius_m, sharpness_k must be > 0")
    r_s, b_e, k = (torch.tensor(v, dtype=dtype, device=device)
                   for v in (separatrix_radius_m, b_external_t, sharpness_k))

    rho = linspace(0.0, wall_radius_factor * separatrix_radius_m, n_points, dtype, device)
    u = 2.0 * rho**2 / r_s**2 - 1.0
    tanh = torch.tanh(k * u)
    b_z = -b_e * tanh
    p = (b_e**2 / (2.0 * MU0)) * (1.0 - tanh**2)
    n = peak_density_m3 * (1.0 - tanh**2)

    # psi(r) = int_0^r B_z r' dr' ; with du = 4 r dr / r_s^2:
    # psi = -(B_e r_s^2 / 4K) [ln cosh(K u) - ln cosh(-K)]
    psi = -(b_e * r_s**2 / (4.0 * k)) * (_log_cosh(k * u) - _log_cosh(-k))

    # J_theta = -(1/mu0) dB_z/dr = (B_e K / mu0) sech^2(K u) * 4 r / r_s^2.
    sech2 = 1.0 - tanh**2
    j_theta = (b_e * k / MU0) * sech2 * 4.0 * rho / r_s**2

    # Force-balance audit: d/dr (p + B^2/2mu0) should vanish.
    total = p + b_z**2 / (2.0 * MU0)
    d_total = torch.diff(total).abs() / (rho[1] - rho[0])
    scale = b_e**2 / (2.0 * MU0 * separatrix_radius_m)
    return FRCEquilibriumState(
        rho=rho, psi=psi, b_z=b_z, pressure=p, density=n, j_theta=j_theta,
        r_null=r_s / math.sqrt(2.0), r_s=r_s, force_balance_residual=d_total.max() / scale)
