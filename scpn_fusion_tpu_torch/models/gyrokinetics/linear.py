"""Linear gyrokinetic eigenvalue solver, flux-tube, ballooning space
(port of ``scpn_fusion_tpu/models/gyrokinetics/linear.py``).

The dispersion matrix is a velocity-space quadrature over the (E, lambda)
grid of FLR-weighted drive and parallel-streaming contributions plus the
adiabatic-electron response (the reference's ``core/gk_eigenvalue.py:
42-330``); JAX's ``vmap`` over the (E, lambda) points is a leading batch
dimension here, summed.  The most-unstable mode comes from dense ``eig`` or
from the initial-value lane (RK4 on dphi/dt = -i M phi, the eigenvalue from
the final Rayleigh quotient).  ``method="auto"`` takes ``eig`` iff the
matrix lies on the CPU, as JAX takes it iff its backend is the CPU: the card
takes the initial-value lane, where :func:`solve_linear_gk` steps every k_y
of the scan as one batch.

Parity note (the JAX module's): the reference computes drift/collision
coefficients but accumulates only the drive + streaming terms, so the
effective matrix is Hermitian and its growth rates are round-off;
``include_drifts=True`` adds the omega_D + nu diagonal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.gyrokinetics.geometry import MillerGeometry, circular_geometry
from scpn_fusion_tpu_torch.models.gyrokinetics.species import (
    E_CHARGE,
    GKSpecies,
    VelocityGrid,
    bessel_j0,
    collision_frequencies,
    deuterium_ion,
)


@dataclasses.dataclass
class EigenMode:
    k_y_rho_s: float
    omega_r: float
    gamma: float
    mode_type: str
    phi_theta: np.ndarray | None = None


@dataclasses.dataclass
class LinearGKResult:
    k_y: np.ndarray
    gamma: np.ndarray
    omega_r: np.ndarray
    mode_type: list

    @property
    def gamma_max(self) -> float:
        return float(np.max(self.gamma)) if len(self.gamma) else 0.0

    @property
    def k_y_max(self) -> float:
        return float(self.k_y[np.argmax(self.gamma)]) if len(self.gamma) else 0.0


def _streaming_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Periodic central-difference d/dtheta matrix (coefficient applied later)."""
    n = theta.shape[0]
    dtheta = theta[1] - theta[0]
    ones = torch.ones(n - 1, dtype=theta.dtype, device=theta.device)
    d = torch.diag(ones, 1) - torch.diag(ones, -1)
    d[0, -1] = -1.0
    d[-1, 0] = 1.0
    return d / (2.0 * dtheta)


def assemble_dispersion_matrix(
    k_y_rho_s: float,
    ion: GKSpecies,
    geom: MillerGeometry,
    vgrid: VelocityGrid,
    *,
    r0: float = 2.78,
    a: float = 1.0,
    b0: float = 2.0,
    z_eff: float = 1.0,
    nu_star: float = 0.01,
    include_drifts: bool = False,
    adiabatic_electrons: bool = True,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """Build the (n_theta, n_theta) complex128 dispersion matrix at one k_y,
    on ``geom``'s device."""
    dev = geom.theta.device
    n_theta = geom.theta.shape[0]
    b_ratio = geom.b_mag / torch.mean(geom.b_mag)
    energy, e_w, lam, l_w = vgrid.nodes(dtype, dev)

    omega_star_n = k_y_rho_s * ion.r_l_n
    omega_star_t = k_y_rho_s * ion.r_l_t
    eta_i = (omega_star_t / max(abs(omega_star_n), 1e-10)) if omega_star_n != 0 else 0.0
    rho_i_over_a = (ion.mass_kg * ion.thermal_speed
                    / (abs(ion.charge_e) * E_CHARGE * b0) / a)
    d_theta_mat = _streaming_matrix(geom.theta).to(dtype)

    nu_d, nu_e = collision_frequencies(ion, ion.density_19,
                                       ion.temperature_kev, z_eff)

    # the (E, lambda) points: a leading batch dimension P (JAX's vmap)
    e_norm = energy[:, None].expand(-1, lam.shape[0]).reshape(-1)
    lam_val = lam[None, :].expand(energy.shape[0], -1).reshape(-1)
    w_e = e_w[:, None].expand(-1, l_w.shape[0]).reshape(-1)
    w_l = l_w[None, :].expand(e_w.shape[0], -1).reshape(-1)

    fm = (2.0 / math.sqrt(math.pi)) * torch.sqrt(e_norm) * torch.exp(-e_norm) * w_e
    weight = fm * w_l
    b_arg = k_y_rho_s * rho_i_over_a * torch.sqrt(2.0 * lam_val * e_norm)
    j0 = bessel_j0(b_arg[:, None] * torch.ones(n_theta, dtype=dtype, device=dev))
    omega_star_full = omega_star_n * (1.0 + eta_i * (e_norm - 1.5))

    xi = torch.sqrt(torch.clamp(1.0 - lam_val[:, None] * b_ratio[None, :], min=0.0))
    v_par = torch.sqrt(2.0 * e_norm)[:, None] * xi
    coeff = v_par * geom.b_dot_grad_theta[None, :]
    d_par = coeff[:, :, None] * d_theta_mat[None]   # diag(coeff) @ D

    drive = torch.diag_embed(j0 * j0 * omega_star_full[:, None]).to(torch.complex128)
    stream = 1j * (j0[:, :, None] * d_par * j0[:, None, :])
    m = drive + stream
    if include_drifts:
        xi_sq = torch.clamp(1.0 - lam_val[:, None] * b_ratio[None, :], min=0.0)
        omega_d = k_y_rho_s * 2.0 * e_norm[:, None] * (
            geom.kappa_n[None, :] * xi_sq + geom.kappa_g[None, :] * torch.sqrt(xi_sq))
        pitch = nu_d * (1.0 - xi_sq[:, 0])
        e_diff = nu_e * (e_norm - 1.5) ** 2 / torch.clamp(e_norm, min=1e-12)
        nu_eff = nu_star * (pitch + e_diff)
        m = m + torch.diag_embed(omega_d + nu_eff[:, None]).to(torch.complex128)
    r_ion = torch.sum(weight[:, None, None] * m, dim=0)

    if adiabatic_electrons:
        eye = torch.eye(n_theta, dtype=torch.complex128, device=dev)
        fsa = torch.ones((n_theta, n_theta), dtype=torch.complex128, device=dev) / n_theta
        r_ion = r_ion + (eye - fsa)
    return r_ion


class IVResult(NamedTuple):
    omega_r: torch.Tensor
    gamma: torch.Tensor
    phi: torch.Tensor


def most_unstable_mode_initial_value(
    m: torch.Tensor,
    *,
    dt: float = 0.02,
    n_steps: int = 4000,
) -> IVResult:
    """Most-unstable eigenvalue of M via initial-value RK4 on
    dphi/dt = -i M phi, eigenvalue from the final Rayleigh quotient (no
    dense eig).  ``m`` is (n, n) or a batch (..., n, n), each stepped on
    its own (the norm is a matrix's own)."""
    n = m.shape[-1]
    idx = torch.arange(n, device=m.device, dtype=torch.float64)
    phi0 = (torch.ones(n, dtype=torch.float64, device=m.device)
            + 0.1 * torch.sin(idx)).to(torch.complex128)
    phi = phi0.expand(*m.shape[:-1]).unsqueeze(-1)

    def rhs(p):
        return -1j * (m @ p)

    for _ in range(n_steps):
        k1 = rhs(phi)
        k2 = rhs(phi + 0.5 * dt * k1)
        k3 = rhs(phi + 0.5 * dt * k2)
        k4 = rhs(phi + dt * k3)
        phi_new = phi + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        norm = torch.linalg.vector_norm(phi_new, dim=(-2, -1), keepdim=True)
        phi = phi_new / torch.clamp(norm, min=1e-300)

    conj = phi.conj().transpose(-2, -1)
    num = (conj @ (m @ phi))[..., 0, 0]
    den = (conj @ phi)[..., 0, 0]
    # jnp.maximum(den, 1e-300) on a complex value: the larger by real part
    den = torch.where(den.real >= 1e-300, den, torch.full_like(den, 1e-300))
    rayleigh = num / den
    return IVResult(rayleigh.real, rayleigh.imag, phi[..., 0])


def _mode(k_y_rho_s: float, omega_r: float, gamma: float, phi) -> EigenMode:
    mode = "ITG" if omega_r < 0 else ("TEM" if omega_r > 0 else "stable")
    return EigenMode(k_y_rho_s, omega_r, max(gamma, 0.0), mode, phi)


def _resolve(method: str, m: torch.Tensor) -> str:
    if method == "auto":
        return "eig" if m.device.type == "cpu" else "initial_value"
    return method


def _eig_mode(k_y_rho_s: float, m: torch.Tensor) -> EigenMode:
    eigvals, eigvecs = torch.linalg.eig(m)
    gammas = eigvals.imag.cpu().numpy()
    omegas = eigvals.real.cpu().numpy()
    if np.all(gammas <= 0):
        return EigenMode(k_y_rho_s, 0.0, 0.0, "stable")
    idx = int(np.argmax(gammas))
    gamma, omega_r = float(gammas[idx]), float(omegas[idx])
    phi = np.abs(eigvecs[:, idx].cpu().numpy())
    return _mode(k_y_rho_s, omega_r, gamma, phi)


def _iv_modes(k_y_values, ms: torch.Tensor) -> list[EigenMode]:
    out = most_unstable_mode_initial_value(ms)
    gammas, omegas = out.gamma.cpu().numpy(), out.omega_r.cpu().numpy()
    phis = np.abs(out.phi.cpu().numpy())
    modes = []
    for ky, gamma, omega_r, phi in zip(k_y_values, gammas, omegas, phis):
        if gamma <= 0:
            modes.append(EigenMode(float(ky), 0.0, 0.0, "stable"))
        else:
            modes.append(_mode(float(ky), float(omega_r), float(gamma), phi))
    return modes


def solve_eigenvalue_single_ky(
    k_y_rho_s: float,
    species_list: list,
    geom: MillerGeometry,
    vgrid: VelocityGrid,
    *,
    r0: float = 2.78,
    a: float = 1.0,
    b0: float = 2.0,
    z_eff: float = 1.0,
    nu_star: float = 0.01,
    method: str = "auto",
) -> EigenMode:
    """Solve for the most-unstable mode at one k_y.

    method: "eig" (dense), "initial_value", "auto" (``eig`` on the CPU).
    """
    ion = species_list[0]
    m = assemble_dispersion_matrix(
        k_y_rho_s, ion, geom, vgrid, r0=r0, a=a, b0=b0,
        z_eff=z_eff, nu_star=nu_star)
    if _resolve(method, m) == "eig":
        return _eig_mode(k_y_rho_s, m)
    return _iv_modes([k_y_rho_s], m[None])[0]


def solve_linear_gk(
    species_list: list | None = None,
    geom: MillerGeometry | None = None,
    vgrid: VelocityGrid | None = None,
    *,
    k_y_values: np.ndarray | None = None,
    r0: float = 2.78,
    a: float = 1.0,
    b0: float = 2.0,
    q: float = 1.4,
    s_hat: float = 0.78,
    z_eff: float = 1.0,
    nu_star: float = 0.01,
    method: str = "auto",
    device: torch.device | str = "cuda",
) -> LinearGKResult:
    """k_y spectrum scan (reference ``solve_linear_gk``); the default
    geometry is made on ``device``, a given one keeps its own."""
    if species_list is None:
        species_list = [deuterium_ion()]
    if geom is None:
        geom = circular_geometry(r0=r0, a=a, q=q, s_hat=s_hat, b0=b0, device=device)
    if vgrid is None:
        vgrid = VelocityGrid(n_energy=8, n_lambda=12)
    if k_y_values is None:
        k_y_values = np.linspace(0.1, 1.0, 10)

    ms = torch.stack([assemble_dispersion_matrix(
        float(ky), species_list[0], geom, vgrid, r0=r0, a=a, b0=b0,
        z_eff=z_eff, nu_star=nu_star) for ky in k_y_values])
    if _resolve(method, ms) == "eig":
        modes = [_eig_mode(float(ky), m) for ky, m in zip(k_y_values, ms)]
    else:
        modes = _iv_modes(k_y_values, ms)
    return LinearGKResult(
        k_y=np.asarray([m.k_y_rho_s for m in modes]),
        gamma=np.asarray([m.gamma for m in modes]),
        omega_r=np.asarray([m.omega_r for m in modes]),
        mode_type=[m.mode_type for m in modes],
    )
