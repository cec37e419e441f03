"""RF heating: ICRH Hamiltonian ray tracing + ECRH deposition (port of
``scpn_fusion_tpu/models/physics/rf_heating.py``).

* ICRH (50 MHz fast-wave) ray tracing: the whole bundle advances together,
  one fixed-step RK4 a step over the rays as one batch, the dispersion
  derivatives from ``torch.func.grad`` batched by ``torch.func.vmap`` (JAX:
  ``jax.grad`` inside ``vmap``); a ray whose new state is not finite freezes
  at its last finite state.
* ICRH power deposition: per-segment cyclotron damping exp(-delta^2), the
  Beer-Lambert drain a ``cumsum``, the radial binning a one-hot product (a
  scatter-add would sum in another order).
* ECRH (170 GHz) Gaussian deposition at the cold resonance layer with
  Doppler width + single-pass optical-depth efficiency, its temperature,
  density and angle in float32 as JAX forces them.

Plain PyTorch ops; the ray loop is a Python loop of RK4 steps (~150
launches a step).  The entry points take Python numbers and a frozen
parameter set, so they take ``dtype`` (float32 by default; JAX takes its
float from the x64 flag) and ``device`` (``"cuda"`` by default);
:func:`icrh_power_deposition` follows the rays.  ``jnp.linspace`` under
``jit`` is the jitted form (``core.grid.linspace``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

E_CHARGE = 1.602176634e-19
M_E = 9.1093837e-31
M_D = 3.34e-27
MU_0 = 4.0e-7 * math.pi
EPS_0 = 8.8541878e-12


@dataclasses.dataclass(frozen=True)
class ICRHParams:
    """Fast-wave launch + plasma model (reference ``RFHeatingSystem``)."""

    freq_hz: float = 50e6
    b0_tesla: float = 5.3
    r0_major: float = 6.2
    a_minor: float = 2.0
    n0_m3: float = 1e20
    blob_sigma_sq: float = 2.0     # Gaussian density blob variance [m^2]
    t_ion_kev: float = 10.0
    r_antenna: float = 9.0
    k0: float = 10.0               # launch wavenumber [1/m]

    @property
    def omega(self) -> float:
        return 2.0 * math.pi * self.freq_hz

    @property
    def b_resonance(self) -> float:
        """Fundamental D cyclotron resonance field omega = qB/m."""
        return self.omega * M_D / E_CHARGE


def _density(p: ICRHParams, r, z):
    """Gaussian blob density surrogate (reference ``get_plasma_params``)."""
    dist_sq = (r - p.r0_major) ** 2 + z**2
    return p.n0_m3 * torch.exp(-dist_sq / p.blob_sigma_sq)


def icrh_dispersion(p: ICRHParams, r, z, k_r, k_z, *, dtype=None, device="cuda"):
    """Warm-plasma fast-wave dispersion D = k^2 v_A^2 (1 + 3/4 k^2 rho_i^2) - w^2,
    smoothly gated to the vacuum value D = 1 below the cutoff density so the
    ray Hamiltonian stays differentiable."""
    r, z, k_r, k_z = as_tensors(r, z, k_r, k_z, dtype=dtype, device=device)
    r_safe = torch.clamp(r, min=0.1)
    b_tor = p.b0_tesla * p.r0_major / r_safe
    n_e = _density(p, r, z)

    # Alfven speed, FLR thermal correction (deuterium).
    v_a_sq = b_tor**2 / (MU_0 * torch.clamp(n_e, min=1e16) * M_D)
    v_thi = math.sqrt(2.0 * p.t_ion_kev * 1e3 * E_CHARGE / M_D)
    rho_i = M_D * v_thi / (E_CHARGE * b_tor)
    k_sq = k_r**2 + k_z**2
    flr = 1.0 + 0.75 * k_sq * rho_i**2

    d_plasma = k_sq * v_a_sq * flr - p.omega**2
    # Normalise by omega^2 so plasma and vacuum branches share a scale.
    d_plasma = d_plasma / p.omega**2
    in_plasma = torch.sigmoid((torch.log10(torch.clamp(n_e, min=1.0)) - 18.0) * 4.0)
    return in_plasma * d_plasma + (1.0 - in_plasma) * 1.0


class RayBundle(NamedTuple):
    r: torch.Tensor       # (n_rays, n_steps)
    z: torch.Tensor
    k_r: torch.Tensor
    k_z: torch.Tensor
    frozen: torch.Tensor  # (n_rays, n_steps) bool — past the caustic


def trace_icrh_rays(p: ICRHParams, *, n_rays: int = 10, n_steps: int = 160,
                    path_length_m: float = 8.0, dtype=torch.float32,
                    device="cuda") -> RayBundle:
    """Trace the antenna ray bundle.

    Arc-length parametrised Hamiltonian rays: dr/ds = g/|g| with g = dD/dk
    and dk/ds = -(dD/dr)/|g|; RK4 with exact derivatives; any non-finite
    step freezes the ray at its last finite state.
    """
    dt = path_length_m / n_steps

    def hamiltonian(state):
        return icrh_dispersion(p, state[0], state[1], state[2], state[3])

    grad_d = torch.func.vmap(torch.func.grad(hamiltonian))

    def rhs(state):
        # dr/ds = +dD/dk normalised to unit speed, dk/ds = -dD/dr / |dD/dk|
        # (launch with k_R < 0 propagates inward).
        g = grad_d(state)
        d_r, d_z, d_kr, d_kz = g.unbind(dim=1)
        g_norm = torch.clamp(torch.sqrt(d_kr**2 + d_kz**2), min=1e-12)
        return torch.stack([d_kr, d_kz, -d_r, -d_z], dim=1) / g_norm[:, None]

    def rk4(state):
        k1 = rhs(state)
        k2 = rhs(state + 0.5 * dt * k1)
        k3 = rhs(state + 0.5 * dt * k2)
        k4 = rhs(state + dt * k3)
        return state + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    z_spread = linspace(-1.0, 1.0, n_rays, dtype, device)
    state = torch.stack([torch.full_like(z_spread, p.r_antenna), z_spread,
                         torch.full_like(z_spread, -p.k0), torch.zeros_like(z_spread)], dim=1)
    frozen = torch.zeros(n_rays, dtype=torch.bool, device=state.device)
    traj, flags = [], []
    for _ in range(n_steps):
        new = rk4(state)
        frozen = frozen | ~torch.all(torch.isfinite(new), dim=1)
        state = torch.where(frozen[:, None], state, new)
        traj.append(state)
        flags.append(frozen)
    traj = torch.stack(traj, dim=1)   # (n_rays, n_steps, 4)
    return RayBundle(traj[..., 0], traj[..., 1], traj[..., 2], traj[..., 3],
                     torch.stack(flags, dim=1))


def icrh_power_deposition(p: ICRHParams, rays: RayBundle, p_rf_mw: float = 20.0, *,
                          n_radial_bins: int = 50):
    """Radial deposition profile from cyclotron damping along each ray.

    Beer-Lambert drain P_j = P_0 exp(-sum_{i<=j} alpha_i ds_i) is a cumsum;
    the per-bin scatter is a one-hot contraction.
    Returns (rho_bins, P_dep [MW/m^3], absorption_efficiency).
    """
    r, z = rays.r, rays.z
    n_rays = r.shape[0]
    v_thi = math.sqrt(2.0 * 20.0 * 1e3 * E_CHARGE / M_D)

    r_mid = 0.5 * (r[:, 1:] + r[:, :-1])
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    ds = torch.sqrt((r[:, 1:] - r[:, :-1]) ** 2 + (z[:, 1:] - z[:, :-1]) ** 2)

    b_local = p.b0_tesla * p.r0_major / torch.clamp(r_mid, min=0.1)
    omega_ci = E_CHARGE * b_local / M_D
    delta = (p.omega - omega_ci) / max(10.0 * v_thi, 1e6)
    alpha = 0.5 * torch.exp(-delta**2) / p.a_minor

    # Remaining power before each segment, then per-segment absorption.
    tau = torch.cumsum(alpha * ds, dim=1)
    p_per_ray = p_rf_mw / max(n_rays, 1)
    p_before = p_per_ray * torch.exp(-torch.cat(
        [torch.zeros((n_rays, 1), dtype=r.dtype, device=r.device), tau[:, :-1]], dim=1))
    dp = p_before * (1.0 - torch.exp(-alpha * ds))

    rho = torch.clamp(torch.sqrt((r_mid - p.r0_major) ** 2 + z_mid**2) / p.a_minor, max=1.0)
    bin_idx = torch.clamp((rho * n_radial_bins).to(torch.int32), 0, n_radial_bins - 1)
    rho_bins = linspace(0.0, 1.0, n_radial_bins, r.dtype, r.device)

    # Shell volumes (reference geometry: dV = (2 pi R)(2 pi r_inner a drho)).
    dr = 1.0 / n_radial_bins
    r_inner = rho_bins[bin_idx.long()] * p.a_minor
    dv = torch.clamp(2.0 * math.pi * r_mid * 2.0 * math.pi * r_inner * p.a_minor * dr,
                     min=1e-6)

    onehot = torch.nn.functional.one_hot(bin_idx.reshape(-1).long(),
                                         n_radial_bins).to(dp.dtype)
    p_dep = (dp / dv).reshape(-1) @ onehot            # MW/m^3 per bin
    efficiency = torch.clamp(torch.sum(dp) / max(p_rf_mw, 1e-12), 0.0, 1.0)
    return rho_bins, p_dep, efficiency


@dataclasses.dataclass(frozen=True)
class ECRHParams:
    """ECRH launcher (reference ``ECRHHeatingSystem``)."""

    b0_tesla: float = 5.3
    r0_major: float = 6.2
    a_minor: float = 2.0
    freq_ghz: float = 170.0
    harmonic: int = 1

    @property
    def omega(self) -> float:
        return 2.0 * math.pi * self.freq_ghz * 1e9

    @property
    def resonance_radius(self) -> float:
        """Major radius where n Omega_ce = omega."""
        b_res = self.omega * M_E / (self.harmonic * E_CHARGE)
        return self.b0_tesla * self.r0_major / b_res


def ecrh_deposition(p: ECRHParams, *, p_ecrh_mw: float = 20.0, t_e_kev=20.0, n_e_m3=1e20,
                    launch_angle_deg=0.0, n_radial_bins: int = 50, dtype=torch.float32,
                    device="cuda"):
    """Gaussian deposition at the EC resonance with Doppler width and
    single-pass O-mode optical-depth efficiency.  The temperature, density
    and launch angle are float32 (as JAX forces them), the radial grid
    ``dtype``; differentiable w.r.t. (t_e, n_e, launch angle)."""
    rho_res = abs(p.resonance_radius - p.r0_major) / p.a_minor
    f32 = torch.float32

    t_e = torch.clamp(torch.as_tensor(t_e_kev, device=device).to(f32), min=0.01)
    v_the = torch.sqrt(2.0 * t_e * (1e3 * E_CHARGE / M_E))
    theta = torch.deg2rad(torch.as_tensor(launch_angle_deg, device=device).to(f32))
    obliquity = torch.clamp(torch.cos(theta) ** 2, 0.05, 1.0)
    delta_rho = torch.clamp(v_the / (p.omega * p.a_minor) * 50.0
                            * (1.0 + 0.35 * torch.abs(torch.sin(theta))), min=0.02)

    rho = linspace(0.0, 1.0, n_radial_bins, dtype, t_e.device)
    r_local = p.r0_major + rho * p.a_minor
    dv = torch.clamp(2.0 * math.pi * r_local * 2.0 * math.pi * rho * p.a_minor * p.a_minor
                     / n_radial_bins, min=1e-6)
    p_dep = torch.exp(-((rho - rho_res) ** 2) / (2.0 * delta_rho**2).to(dtype)) / dv

    # omega_pe^2/omega^2 with the e^2/(m_e eps0) prefactor folded host-side
    # (f32-safe: e^2 ~ 2.6e-38 underflows in float32).
    wpe_sq_per_n = E_CHARGE**2 / (M_E * EPS_0)      # host double
    wpe_ratio_sq = torch.as_tensor(n_e_m3, device=device).to(f32) * (wpe_sq_per_n / p.omega**2)
    overlap = 1.0 if rho_res <= 1.0 else math.exp(-(((rho_res - 1.0) / 0.18) ** 2))
    tau_opt = wpe_ratio_sq * 20.0 * p.harmonic * obliquity * overlap
    efficiency = torch.clamp(1.0 - torch.exp(-tau_opt), 0.01, 0.99)

    total = torch.clamp(torch.sum(p_dep), min=1e-12)
    p_dep = p_dep * ((p_ecrh_mw * efficiency).to(dtype) / total)
    return rho, p_dep, efficiency
