"""Reduced 3D equilibrium: Fourier flux-coordinate map + force balance (port
of ``scpn_fusion_tpu/models/equilibrium/force_balance_3d.py``).

* ``Geometry3D``: the VMEC-like Fourier-parameterised map
  (rho, theta, phi) -> (R, Z, phi) with elongation / triangularity /
  ``n != 0`` shaping; the mode indices are static, the mode amplitudes a
  ``(K, 4)`` tensor ``[r_cos, r_sin, z_cos, z_sin]``.
* ``force_residual``: volume-RMS of ``J x B - grad p`` on a
  (rho, theta, phi) sampling grid with the reduced field model (toroidal
  ``B0 R0 / R``, cylindrical-Ampere poloidal field, ``p ~ (1-rho^2)^alpha``,
  ``J ~ (1-rho^2)^beta``).
* ``solve_force_balance_3d``: Armijo-backtracked descent of the residual
  over the amplitudes with the exact gradient from autograd (the JAX
  ``value_and_grad``).  The ladder of trial steps is evaluated one step
  after another (the JAX module ``vmap``s it) and the loop (a
  ``lax.while_loop`` there) is a Python loop with one host read an
  iteration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace

MU0 = 4.0e-7 * math.pi


@dataclasses.dataclass(frozen=True)
class Geometry3D:
    """VMEC-like reduced 3D geometry.

    ``modes_m`` / ``modes_n`` are the Fourier indices of the shaping
    harmonics; their amplitudes live outside this dataclass.
    """

    r_axis: float = 6.2
    z_axis: float = 0.0
    a_minor: float = 2.0
    kappa: float = 1.0
    triangularity: float = 0.0
    nfp: int = 1
    modes_m: tuple[int, ...] = (0, 0, 1, 1, 2, 2)
    modes_n: tuple[int, ...] = (0, 1, 0, 1, 0, 1)

    def __post_init__(self) -> None:
        if self.a_minor <= 0.0:
            raise ValueError("a_minor must be > 0")
        if self.kappa <= 0.0:
            raise ValueError("kappa must be > 0")
        if self.nfp < 1:
            raise ValueError("nfp must be >= 1")
        if len(self.modes_m) != len(self.modes_n):
            raise ValueError("modes_m and modes_n must have equal length")

    @property
    def n_modes(self) -> int:
        return len(self.modes_m)

    def zero_amplitudes(self, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda") -> torch.Tensor:
        return torch.zeros((self.n_modes, 4), dtype=dtype, device=device)


def flux_to_cylindrical(geom: Geometry3D, amps: torch.Tensor, rho, theta, phi):
    """(rho, theta, phi) -> (R, Z, phi); amps is (K, 4)
    [r_cos, r_sin, z_cos, z_sin], all K harmonics at once."""
    rho_c = torch.clamp(rho, 0.0, 1.25)
    delta = min(max(geom.triangularity, -0.95), 0.95)
    theta_geo = theta + delta * torch.sin(theta)
    minor = geom.a_minor * rho_c
    r_val = geom.r_axis + minor * torch.cos(theta_geo)
    z_val = geom.z_axis + geom.kappa * minor * torch.sin(theta)

    m = torch.tensor(geom.modes_m, dtype=rho_c.dtype, device=rho_c.device)    # (K,)
    n = torch.tensor(geom.modes_n, dtype=rho_c.dtype, device=rho_c.device) * geom.nfp
    # phase[k, ...] = m_k theta - n_k nfp phi  (broadcast over the grid).
    phase = m[:, None] * theta.reshape(-1)[None, :] - n[:, None] * phi.reshape(-1)[None, :]
    cos_p, sin_p = torch.cos(phase), torch.sin(phase)
    d_r = amps[:, 0][:, None] * cos_p + amps[:, 1][:, None] * sin_p
    d_z = amps[:, 2][:, None] * cos_p + amps[:, 3][:, None] * sin_p
    minor_flat = minor.reshape(-1)[None, :]
    r_val = r_val + (minor_flat * d_r).sum(0).reshape(r_val.shape)
    z_val = z_val + (minor_flat * d_z).sum(0).reshape(z_val.shape)
    return r_val, z_val, phi


def flux_to_cartesian(geom: Geometry3D, amps: torch.Tensor, rho, theta, phi):
    r_val, z_val, phi_val = flux_to_cylindrical(geom, amps, rho, theta, phi)
    return r_val * torch.cos(phi_val), r_val * torch.sin(phi_val), z_val


@dataclasses.dataclass(frozen=True)
class ForceBalanceConfig:
    """Physics profiles + solver knobs."""

    b0_tesla: float = 5.3
    r0_major: float = 6.2
    p0_pa: float = 5e5
    j0_ma_m2: float = 1.0
    pressure_exp: float = 2.0
    current_exp: float = 1.5
    n_rho: int = 12
    n_theta: int = 24
    n_phi: int = 16
    max_iterations: int = 20
    tolerance: float = 1e-4
    # Initial trial length along the NORMALISED gradient direction; the
    # objective is residual/res0, so steps are dimensionless and the
    # Armijo ladder is scale-free.
    step0: float = 0.5
    armijo_c: float = 1e-4
    armijo_backtracks: int = 12


def _profiles(cfg: ForceBalanceConfig, rho):
    rho_c = torch.clamp(rho, 0.0, 1.0)
    p = cfg.p0_pa * (1.0 - rho_c**2) ** cfg.pressure_exp
    j_phi = cfg.j0_ma_m2 * 1e6 * (1.0 - rho_c**2) ** cfg.current_exp
    return p, j_phi


def force_residual(amps: torch.Tensor, geom: Geometry3D,
                   cfg: ForceBalanceConfig) -> torch.Tensor:
    """Volume-RMS of ``J x B - grad p`` on the sampling grid (reduced field
    model), in ``amps``' dtype on its device."""
    dtype, device = amps.dtype, amps.device
    rho_pts = linspace(0.05, 0.95, cfg.n_rho, dtype, device)
    # endpoint=False: the first n of n + 1 points
    th_pts = linspace(0.0, 2.0 * math.pi, cfg.n_theta + 1, dtype, device)[:-1]
    ph_pts = linspace(0.0, 2.0 * math.pi, cfg.n_phi + 1, dtype, device)[:-1]
    rho_g, th_g, ph_g = torch.meshgrid(rho_pts, th_pts, ph_pts, indexing="ij")

    r_val, z_val, _ = flux_to_cylindrical(geom, amps, rho_g, th_g, ph_g)

    # Radial pressure gradient mapped to (R, Z) by the flux-coordinate
    # chain rule (drho/dR ~ cos th / a, drho/dZ ~ sin th / ka).
    drho = 0.01
    p_plus, _ = _profiles(cfg, rho_g + drho)
    p_minus, _ = _profiles(cfg, rho_g - drho)
    dp_drho = (p_plus - p_minus) / (2.0 * drho)
    grad_p_r = dp_drho * torch.cos(th_g) / geom.a_minor
    grad_p_z = dp_drho * torch.sin(th_g) / (geom.kappa * geom.a_minor)

    # Reduced field model: B_phi = B0 R0 / R; poloidal field from
    # cylindrical Ampere on the current profile.
    _, j_phi = _profiles(cfg, rho_g)
    b_theta = MU0 * j_phi * geom.a_minor * torch.clamp(rho_g, 0.0, 1.0) / 2.0
    theta_approx = torch.atan2(z_val - geom.z_axis, r_val - geom.r_axis)
    b_r = -b_theta * torch.sin(theta_approx)
    b_z = b_theta * torch.cos(theta_approx)

    f_r = j_phi * b_z - grad_p_r
    f_z = -j_phi * b_r - grad_p_z
    return torch.sqrt(torch.mean(f_r**2 + f_z**2))


class ForceBalanceResult(NamedTuple):
    """``iterations`` is a host value."""

    amplitudes: torch.Tensor         # (K, 4) optimised mode amplitudes
    residual: torch.Tensor           # final volume-RMS force residual
    initial_residual: torch.Tensor
    iterations: int
    converged: torch.Tensor
    history: torch.Tensor            # (max_iterations + 1,) residuals


def solve_force_balance_3d(geom: Geometry3D, cfg: ForceBalanceConfig = ForceBalanceConfig(),
                           amps0: torch.Tensor | None = None, *,
                           device: torch.device | str = "cuda") -> ForceBalanceResult:
    """Minimise the force residual over the Fourier amplitudes, on
    ``amps0``'s device (float32 zeros on ``device`` when none is given, as
    the JAX default is float32).

    Exact-gradient descent along the normalised gradient with Armijo
    backtracking: of ``armijo_backtracks`` halved trial lengths the largest
    that passes is taken; a zero gradient or a fully rejected ladder ends
    the descent.
    """
    if amps0 is None:
        amps0 = geom.zero_amplitudes(device=device)
    amps0 = amps0.detach()
    dtype, dev = amps0.dtype, amps0.device

    with torch.no_grad():
        res0 = force_residual(amps0, geom, cfg)

    def val_grad(a):
        a = a.detach().requires_grad_(True)
        with torch.enable_grad():
            value = force_residual(a, geom, cfg) / res0
            (grad,) = torch.autograd.grad(value, a)
        return value.detach(), grad

    n_max = cfg.max_iterations
    hist = torch.full((n_max + 1,), float("nan"), dtype=dtype, device=dev)
    hist[0] = res0
    tol_f = cfg.tolerance / torch.clamp(res0, min=1e-30)
    steps = cfg.step0 * 0.5 ** torch.arange(cfg.armijo_backtracks, dtype=dtype, device=dev)

    k, amps = 0, amps0
    f_val = torch.ones((), dtype=dtype, device=dev)
    f_h, tol_h = 1.0, float(tol_f)
    while k < n_max and f_h > tol_h:
        value, grad = val_grad(amps)
        with torch.no_grad():
            gnorm = torch.sqrt(torch.sum(grad * grad))
            direction = grad / torch.clamp(gnorm, min=1e-30)
            f_trials = torch.stack([force_residual(amps - step * direction, geom, cfg) / res0
                                    for step in steps])
            ok = f_trials < value - cfg.armijo_c * steps * gnorm
            any_ok = ok.any()
            idx = torch.argmax(ok.to(torch.uint8))   # first (largest) passing step
            step = torch.where(any_ok, steps[idx], torch.zeros_like(value))
            new_amps = amps - step * direction
            new_f = torch.where(any_ok, f_trials[idx], value)
            # A zero gradient or a fully rejected line search ends progress.
            stalled = (gnorm < 1e-20) | ~any_ok
            new_f = torch.where(stalled, f_val, new_f)
            amps = torch.where(stalled, amps, new_amps)
            f_val = new_f
            hist[min(k + 1, n_max)] = new_f * res0
            f_h, stalled_h = torch.stack([new_f, stalled.to(dtype)]).tolist()
            k = n_max if stalled_h else k + 1
    res = f_val * res0
    return ForceBalanceResult(amplitudes=amps, residual=res, initial_residual=res0,
                              iterations=k, converged=res <= cfg.tolerance, history=hist)
