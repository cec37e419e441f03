"""Nonlinear 5D flux-tube gyrokinetic solver, delta-f, pseudo-spectral
(port of ``scpn_fusion_tpu/models/gyrokinetics/nonlinear.py``).

The perturbed distribution f(s, kx, ky, theta, v_par, mu) evolves by the
gyrokinetic Vlasov equation with a quasineutrality field solve (Padé
gyro-screening, adiabatic or kinetic electrons, + Ampère A_par and B_par in
the electromagnetic mode), the dealiased pseudo-spectral ExB bracket,
4th-order parallel streaming with the ballooning kx-connection, magnetic
drifts, the omega_* drive, Krook or conservative collisions, k_perp^(2p)
hyperdiffusion and optional zonal damping; all species in one array.

The operators (``field_solve`` ... ``gradient_drive``, ``heat_flux``,
``diagnostics``) are exact translations of the JAX functions; ``gk_rhs`` is
the fused stage's plain right-hand side on the same terms.  The RK4 step
is four calls of :func:`scpn_fusion_tpu_torch.ops.cuda_gk.gk_stage`: each
makes the stage's non-local terms here (the field solve, the bracket's FFTs,
the conservative collision model, the four ballooning-twisted theta planes)
and the rest of the stage -- the pointwise right-hand side and the RK4
bookkeeping -- is one launch of row G (``csrc/gk_rhs.cu``) on the card, its
plain version on the CPU.  JAX's ``lax.scan`` loops are Python loops; the
adaptive dt and the time stay 0-d tensors on the device, and the trace is
stacked at the end, so a run reads nothing back until it returns.

The draws: JAX's threefry bits cannot be reproduced, so :func:`init_state`
draws its complex noise from a CPU ``torch.Generator`` seeded with ``seed``
and :func:`_init_state` takes the noise as a tensor, as the tests hand it
JAX's own.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.ops import cuda_gk
from scpn_fusion_tpu_torch.ops.cuda_gk import GKStageSpec, StageTerms, gk_stage, stage_rhs_plain


@dataclasses.dataclass(frozen=True)
class NonlinearGKConfig:
    """Grid + physics parameters (reference ``_gk_nonlinear_types.py:22``)."""

    n_kx: int = 16
    n_ky: int = 16
    n_theta: int = 32
    n_vpar: int = 16
    n_mu: int = 8
    n_species: int = 2

    dt: float = 0.05
    n_steps: int = 200
    save_interval: int = 10

    box_lx: float = 80.0
    box_ly: float = 62.83
    vpar_max: float = 3.0
    mu_max: float = 9.0

    dealias: bool = True
    hyper_order: int = 4
    hyper_coeff: float = 0.1
    cfl_factor: float = 0.5
    cfl_adapt: bool = True

    collisions: bool = True
    nu_collision: float = 0.01
    collision_model: str = "krook"          # "krook" | "conservative"
    nonlinear: bool = True
    kinetic_electrons: bool = False
    mass_ratio_me_mi: float = 1.0 / 400.0
    electromagnetic: bool = False
    beta_e: float = 0.01
    zonal_damping_rate: float = 0.0

    # Local geometry (s-alpha defaults; full Miller via `geometry=`)
    r_major: float = 2.78
    a_minor: float = 1.0
    b0: float = 2.0
    q: float = 1.4
    s_hat: float = 0.78

    # Normalised gradients R/L_x
    r_l_ti: float = 6.9
    r_l_te: float = 6.9
    r_l_ne: float = 2.2

    dtype: str = "complex64"


class GKGrids(NamedTuple):
    """Everything precomputed once per config; tensors on the run's device."""

    kx: torch.Tensor            # (n_kx,)
    ky: torch.Tensor            # (n_ky,)
    kperp2: torch.Tensor        # (n_kx, n_ky)
    dealias_mask: torch.Tensor  # (n_kx, n_ky)
    theta: torch.Tensor         # (n_theta,)
    d_theta: torch.Tensor       # scalar
    vpar: torch.Tensor          # (n_vpar,)
    mu: torch.Tensor            # (n_mu,)
    d_vpar: torch.Tensor
    d_mu: torch.Tensor
    maxwellian: torch.Tensor    # (n_vpar, n_mu)  e^{-E}/pi^{3/2}
    energy: torch.Tensor        # (n_vpar, n_mu)  E = vpar^2/2 + mu (B=1 ref)
    b_dot_grad: torch.Tensor    # (n_theta,)
    b_ratio: torch.Tensor       # (n_theta,) B(theta)/B0
    kappa_n: torch.Tensor       # (n_theta,)
    kappa_g: torch.Tensor       # (n_theta,)
    ball_phase_fwd: torch.Tensor  # (n_kx, n_ky) e^{+i s_hat ky x}
    ball_phase_bwd: torch.Tensor
    rho_ratio_i: torch.Tensor   # scalar
    rho_ratio_e: torch.Tensor   # scalar
    vth_ratio_e: torch.Tensor   # scalar sqrt(m_i/m_e)


class GKState(NamedTuple):
    f: torch.Tensor             # (S, n_kx, n_ky, n_theta, n_vpar, n_mu) complex
    time: torch.Tensor          # scalar


class GKTrace(NamedTuple):
    times: torch.Tensor         # (n_saves,)
    q_ion: torch.Tensor         # (n_saves,) gyro-Bohm heat flux
    q_elec: torch.Tensor
    phi_rms: torch.Tensor
    zonal_rms: torch.Tensor
    free_energy: torch.Tensor


def _dtypes(cfg: NonlinearGKConfig):
    """(complex dtype, real dtype, numpy real dtype) of the configuration."""
    if cfg.dtype == "complex64":
        return torch.complex64, torch.float32, np.float32
    return torch.complex128, torch.float64, np.float64


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def build_grids(cfg: NonlinearGKConfig, geometry=None,
                device: torch.device | str = "cuda") -> GKGrids:
    """Precompute spectral grids, velocity grids, geometry, phases."""
    cdt, fdt, _ = _dtypes(cfg)
    kx = 2.0 * np.pi * np.fft.fftfreq(cfg.n_kx, d=cfg.box_lx / cfg.n_kx)
    ky = 2.0 * np.pi * np.fft.fftfreq(cfg.n_ky, d=cfg.box_ly / cfg.n_ky)
    kperp2 = kx[:, None] ** 2 + ky[None, :] ** 2
    if cfg.dealias:
        mask = ((np.abs(kx[:, None]) <= np.max(np.abs(kx)) * 2.0 / 3.0)
                & (np.abs(ky[None, :]) <= np.max(np.abs(ky)) * 2.0 / 3.0))
    else:
        mask = np.ones_like(kperp2, dtype=bool)

    theta = np.linspace(-np.pi, np.pi, cfg.n_theta, endpoint=False)
    d_theta = theta[1] - theta[0]
    vpar = np.linspace(-cfg.vpar_max, cfg.vpar_max, cfg.n_vpar)
    mu = np.linspace(0.0, cfg.mu_max, cfg.n_mu)
    d_vpar = vpar[1] - vpar[0] if cfg.n_vpar > 1 else 1.0
    d_mu = mu[1] - mu[0] if cfg.n_mu > 1 else 1.0
    energy = 0.5 * vpar[:, None] ** 2 + mu[None, :]
    maxwellian = np.exp(-energy) / np.pi ** 1.5

    if geometry is not None:
        b_ratio = _host(geometry.b_mag) / _host(geometry.b_mag)[0]
        b_dot_grad = _host(geometry.b_dot_grad_theta)
        kappa_n = _host(geometry.kappa_n)
        kappa_g = _host(geometry.kappa_g)
    else:
        # s-alpha circular: B ~ 1/(1 + eps cos theta), bhat.grad = 1/(qR)
        eps = 0.5 * cfg.a_minor / cfg.r_major
        b_ratio = 1.0 / (1.0 + eps * np.cos(theta))
        b_dot_grad = np.full_like(theta, 1.0 / (cfg.q * cfg.r_major))
        kappa_n = (np.cos(theta) + cfg.s_hat * theta * np.sin(theta)) \
            / cfg.r_major
        kappa_g = np.sin(theta) / cfg.r_major

    x = np.arange(cfg.n_kx) * cfg.box_lx / cfg.n_kx
    ball_fwd = np.exp(1j * cfg.s_hat * ky[None, :] * x[:, None])

    def real(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=fdt, device=device)

    def cplx(a):
        return torch.as_tensor(a, dtype=cdt, device=device)

    return GKGrids(
        kx=real(kx), ky=real(ky), kperp2=real(kperp2), dealias_mask=real(mask),
        theta=real(theta), d_theta=real(d_theta), vpar=real(vpar), mu=real(mu),
        d_vpar=real(d_vpar), d_mu=real(d_mu), maxwellian=real(maxwellian),
        energy=real(energy), b_dot_grad=real(b_dot_grad), b_ratio=real(b_ratio),
        kappa_n=real(kappa_n), kappa_g=real(kappa_g),
        ball_phase_fwd=cplx(ball_fwd), ball_phase_bwd=cplx(np.conj(ball_fwd)),
        rho_ratio_i=real(1.0), rho_ratio_e=real(np.sqrt(cfg.mass_ratio_me_mi)),
        vth_ratio_e=real(1.0 / np.sqrt(cfg.mass_ratio_me_mi)),
    )


# ---------------------------------------------------------------------------
# Field solves
# ---------------------------------------------------------------------------

def velocity_moment(f_s: torch.Tensor, weight, g: GKGrids) -> torch.Tensor:
    """Integral over (vpar, mu) of weight * f -- the only cross-velocity
    reduction."""
    return torch.sum(f_s * weight, dim=(-2, -1)) * (g.d_vpar * g.d_mu)


def field_solve(cfg: NonlinearGKConfig, g: GKGrids,
                f: torch.Tensor) -> torch.Tensor:
    """Quasineutrality phi(kx, ky, theta) (reference
    ``_gk_nonlinear_operators.py:21-46``)."""
    n_elec = velocity_moment(f[1], 1.0, g) if cfg.kinetic_electrons else None
    phi = phi_of_moments(cfg, g, velocity_moment(f[0], 1.0, g), n_elec)
    phi[0, 0, :] = 0.0
    return phi


def phi_of_moments(cfg: NonlinearGKConfig, g: GKGrids, n_ion: torch.Tensor,
                   n_elec: torch.Tensor | None) -> torch.Tensor:
    """:func:`field_solve` from the density moments, the (kx, ky) = (0, 0)
    mode not yet zeroed (``parallel/gk_shard`` zeroes it on the shard that
    holds it)."""
    b_i = 0.5 * g.kperp2 * g.rho_ratio_i ** 2
    gamma0_i = 1.0 / (1.0 + b_i)
    if cfg.kinetic_electrons:
        b_e = 0.5 * g.kperp2 * g.rho_ratio_e ** 2
        gamma0_e = 1.0 / (1.0 + b_e)
        denom = torch.clamp((1.0 - gamma0_i) + (1.0 - gamma0_e), min=1e-10)
        phi = (gamma0_i[:, :, None] * n_ion
               - gamma0_e[:, :, None] * n_elec) / denom[:, :, None]
    else:
        # Adiabatic electrons with zonal-flow correction: the Boltzmann
        # response does not act on the flux-surface-averaged (ky=0) modes.
        ky_nonzero = (torch.abs(g.ky)[None, :] > 1e-10).to(n_ion.real.dtype)
        denom = torch.clamp((1.0 - gamma0_i) + ky_nonzero, min=1e-10)
        phi = gamma0_i[:, :, None] * n_ion / denom[:, :, None]
    return phi


def ampere_solve(cfg: NonlinearGKConfig, g: GKGrids,
                 f: torch.Tensor) -> torch.Tensor:
    """A_par from parallel current (electromagnetic mode)."""
    vpar_w = g.vpar[:, None]
    j_elec = velocity_moment(f[1], vpar_w, g) if cfg.kinetic_electrons else None
    a_par = a_par_of_current(cfg, g, velocity_moment(f[0], vpar_w, g), j_elec)
    a_par[0, 0, :] = 0.0
    return a_par


def a_par_of_current(cfg: NonlinearGKConfig, g: GKGrids, j_ion: torch.Tensor,
                     j_elec: torch.Tensor | None) -> torch.Tensor:
    """:func:`ampere_solve` from the current moments, (0, 0) not zeroed."""
    j_par = j_ion if j_elec is None else j_ion - g.vth_ratio_e * j_elec
    return cfg.beta_e * j_par / torch.clamp(g.kperp2[:, :, None], min=1e-10)


def bpar_solve(cfg: NonlinearGKConfig, g: GKGrids,
               f: torch.Tensor) -> torch.Tensor:
    """B_par from perpendicular pressure balance (electromagnetic mode)."""
    mu_w = g.mu[None, :]
    p_elec = velocity_moment(f[1], mu_w, g) if cfg.kinetic_electrons else None
    b_par = b_par_of_pressure(cfg, g, velocity_moment(f[0], mu_w, g), p_elec)
    b_par[0, 0, :] = 0.0
    return b_par


def b_par_of_pressure(cfg: NonlinearGKConfig, g: GKGrids, p_ion: torch.Tensor,
                      p_elec: torch.Tensor | None) -> torch.Tensor:
    """:func:`bpar_solve` from the perpendicular pressure moments, (0, 0) not
    zeroed."""
    p_perp = p_ion if p_elec is None else p_ion + p_elec
    return -cfg.beta_e * p_perp / (1.0 + g.kperp2[:, :, None])


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def exb_bracket(g: GKGrids, phi: torch.Tensor,
                f_s: torch.Tensor) -> torch.Tensor:
    """Dealiased pseudo-spectral Poisson bracket {phi, f}: one batched
    ifft2/fft2 over (kx, ky), the trailing five dims of ``f_s`` (any leading
    dims are a batch of species)."""
    kxg = g.kx[:, None, None, None, None]
    kyg = g.ky[None, :, None, None, None]
    phi5 = phi[:, :, :, None, None]
    dims = (-5, -4)
    dphi_dx = torch.fft.ifft2(1j * kxg * phi5, dim=dims)
    dphi_dy = torch.fft.ifft2(1j * kyg * phi5, dim=dims)
    df_dx = torch.fft.ifft2(1j * kxg * f_s, dim=dims)
    df_dy = torch.fft.ifft2(1j * kyg * f_s, dim=dims)
    bracket = torch.fft.fft2(dphi_dx * df_dy - dphi_dy * df_dx, dim=dims)
    return bracket * g.dealias_mask[:, :, None, None, None]


def _kx_shift(g: GKGrids, f_s: torch.Tensor, forward: bool) -> torch.Tensor:
    """Ballooning kx-shift: x-space phase twist e^{+-i s_hat ky x}."""
    phase = g.ball_phase_fwd if forward else g.ball_phase_bwd
    fx = torch.fft.ifft(f_s, dim=0)
    fx = fx * phase[:, :, None, None, None]
    return torch.fft.fft(fx, dim=0)


def _roll_ballooning(g: GKGrids, f_s: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll along theta; planes that wrap the boundary get the ballooning
    kx connection (reference ``_gk_nonlinear_setup.py:131-160``)."""
    rolled = torch.roll(f_s, shift, dims=2)
    n_theta = f_s.shape[2]
    shifted = _kx_shift(g, rolled, forward=(shift > 0))
    idx = torch.arange(n_theta, device=f_s.device)
    wrapped = (idx < shift) if shift > 0 else (idx >= n_theta + shift)
    sel = wrapped[None, None, :, None, None]
    return torch.where(sel, shifted, rolled)


def parallel_streaming(g: GKGrids, f_s: torch.Tensor) -> torch.Tensor:
    """v_par bhat.grad(theta) d f/d theta, 4th-order centred."""
    dfdt = (-_roll_ballooning(g, f_s, -2)
            + 8.0 * _roll_ballooning(g, f_s, -1)
            - 8.0 * _roll_ballooning(g, f_s, 1)
            + _roll_ballooning(g, f_s, 2)) / (12.0 * g.d_theta)
    return (g.vpar[None, None, None, :, None]
            * g.b_dot_grad[None, None, :, None, None] * dfdt)


def ballooning_planes(g: GKGrids, f: torch.Tensor) -> torch.Tensor:
    """The theta planes that wrap the boundary in :func:`parallel_streaming`,
    twisted: (S, n_kx, n_ky, 4, n_vpar, n_mu) holding e^{-i s ky x} of planes
    0 and 1 and e^{+i s ky x} of planes n_theta-2 and n_theta-1 -- the
    ballooning kx-shift of four planes instead of four whole arrays."""
    n_theta = f.shape[3]
    planes = f[:, :, :, [0, 1, n_theta - 2, n_theta - 1]]
    phase = torch.stack([g.ball_phase_bwd, g.ball_phase_bwd,
                         g.ball_phase_fwd, g.ball_phase_fwd], dim=-1)
    fx = torch.fft.ifft(planes, dim=1)
    fx = fx * phase[:, :, :, None, None]
    return torch.fft.fft(fx, dim=1).contiguous()


def magnetic_drift(g: GKGrids, f_s: torch.Tensor) -> torch.Tensor:
    """i omega_D f with curvature/grad-B frequency from local geometry."""
    return 1j * cuda_gk.drift_frequency(g) * f_s


def collide_krook(cfg: NonlinearGKConfig, g: GKGrids,
                  f_s: torch.Tensor) -> torch.Tensor:
    return -cfg.nu_collision * g.kperp2[:, :, None, None, None] * f_s


def conservative_gram_inverse(g: GKGrids, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of the (n, p_par, E) Gram matrix against the Maxwellian
    (3 x 3, complex ``dtype``): :func:`collide_conservative`'s projection,
    the same on every call."""
    basis, fm = _conservative_basis(g, dtype)
    dv = g.d_vpar * g.d_mu
    gram = torch.stack([torch.stack([torch.sum(torch.real(a * b * fm)) * dv for b in basis])
                        for a in basis]).to(g.d_vpar.dtype)
    # inv_ex: no check of the result, so no host read inside a time loop
    return torch.linalg.inv_ex(gram)[0].to(dtype)


def collide_conservative(cfg: NonlinearGKConfig, g: GKGrids,
                         f_s: torch.Tensor, gram_inv: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Pitch-angle + energy diffusion with (n, p_par, E) conservation.

    Same contract as the reference's Sugama-like model
    (``_gk_nonlinear_operators.py:171-210``): a velocity-space diffusion
    whose density / parallel-momentum / energy moments are projected out
    against the Maxwellian so the collision operator conserves them.  The
    trailing five dims of ``f_s`` are (kx, ky, theta, vpar, mu); any leading
    dims are a batch of species.  ``gram_inv``: the run's
    :func:`conservative_gram_inverse`, made here when not given.
    """
    cf, sums = conservative_sums(cfg, g, f_s)
    return conservative_finish(g, cf, sums, gram_inv)


def _conservative_basis(g: GKGrids, dtype: torch.dtype):
    """(1, vpar, E) and the Maxwellian, broadcast against one species' f."""
    fm = g.maxwellian[None, None, None, :, :].to(dtype)
    vpar5 = g.vpar[None, None, None, :, None].to(dtype)
    energy5 = g.energy[None, None, None, :, :].to(dtype)
    return (torch.ones_like(energy5), vpar5, energy5), fm


def conservative_sums(cfg: NonlinearGKConfig, g: GKGrids, f_s: torch.Tensor):
    """The first half of :func:`collide_conservative`: (the diffusion term
    cf, its sums against (1, vpar, E) over (vpar, mu), stacked), the sums
    not yet scaled by dv (``parallel/gk_shard`` adds the mu shards' sums
    first)."""
    nu = cfg.nu_collision
    d2f = (torch.roll(f_s, -1, dims=-2) - 2.0 * f_s
           + torch.roll(f_s, 1, dims=-2)) / g.d_vpar ** 2
    d2f[..., 0, :] = 0.0
    d2f[..., -1, :] = 0.0

    vpar2 = g.vpar[None, None, None, :, None] ** 2
    mu_v = g.mu[None, None, None, None, :]
    v2 = vpar2 + 2.0 * mu_v
    nu_v = nu * torch.clamp(1.0 / torch.clamp(v2, min=0.1) ** 1.5, max=10.0)
    pitch = 2.0 * mu_v / torch.clamp(v2, min=0.01)
    cf = nu_v * pitch * d2f
    basis, _ = _conservative_basis(g, f_s.dtype)
    return cf, torch.stack([torch.sum(cf * b, dim=(-2, -1)) for b in basis], dim=0)


def conservative_finish(g: GKGrids, cf: torch.Tensor, sums: torch.Tensor,
                        gram_inv: torch.Tensor | None = None) -> torch.Tensor:
    """The second half of :func:`collide_conservative`: cf less its
    projection on (1, vpar, E) against the Maxwellian."""
    (ones, vpar5, energy5), fm = _conservative_basis(g, cf.dtype)
    moments = sums * (g.d_vpar * g.d_mu)
    if gram_inv is None:
        gram_inv = conservative_gram_inverse(g, cf.dtype)
    coeffs = torch.tensordot(gram_inv, moments, dims=([1], [0]))
    corr = (coeffs[0][..., None, None] * ones
            + coeffs[1][..., None, None] * vpar5
            + coeffs[2][..., None, None] * energy5) * fm
    return cf - corr


def gradient_drive(cfg: NonlinearGKConfig, g: GKGrids, phi: torch.Tensor,
                   a_par=None, b_par=None) -> torch.Tensor:
    """Background omega_* drive for all species, stacked."""
    eta_i, eta_e = _etas(cfg)
    return cuda_gk.gradient_drive(
        g, phi, a_par if cfg.electromagnetic else None, b_par if cfg.electromagnetic else None,
        r_l_ne=cfg.r_l_ne, eta_i=eta_i, eta_e=eta_e, n_species=cfg.n_species,
        electrons_active=cfg.kinetic_electrons)


def _etas(cfg: NonlinearGKConfig) -> tuple[float, float]:
    """(eta_i, eta_e): R/L_T over R/L_n floored at 0.1 (0 for R/L_n <= 0)."""
    r_l_ne = max(cfg.r_l_ne, 0.1)
    if cfg.r_l_ne <= 0:
        return 0.0, 0.0
    return cfg.r_l_ti / r_l_ne, cfg.r_l_te / r_l_ne


def gk_rhs(cfg: NonlinearGKConfig, g: GKGrids,
           f: torch.Tensor) -> torch.Tensor:
    """Full Vlasov RHS, all species: the fused stage's right-hand side
    (:func:`~scpn_fusion_tpu_torch.ops.cuda_gk.stage_rhs_plain`) on
    :func:`stage_terms`.  An inactive (adiabatic) electron species gets the
    zonal term alone, where JAX multiplies its terms by 0: the same for
    finite f."""
    return stage_rhs_plain(f, stage_terms(cfg, g, f, field_solve(cfg, g, f)),
                           stage_spec(cfg, g))


# ---------------------------------------------------------------------------
# The fused stage (row G on the card)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stage_scalars(cfg: NonlinearGKConfig):
    """(d_theta, vth_ratio_e) rounded to the run's real dtype, as numbers."""
    _, _, np_real = _dtypes(cfg)
    theta = np.linspace(-np.pi, np.pi, cfg.n_theta, endpoint=False)
    return (float(np_real(theta[1] - theta[0])),
            float(np_real(1.0 / np.sqrt(cfg.mass_ratio_me_mi))))


def stage_spec(cfg: NonlinearGKConfig, g: GKGrids) -> GKStageSpec:
    """What :func:`~scpn_fusion_tpu_torch.ops.cuda_gk.gk_stage` needs of the
    configuration."""
    if cfg.collision_model not in ("krook", "conservative"):
        raise ValueError(f"unknown collision model {cfg.collision_model!r}")
    eta_i, eta_e = _etas(cfg)
    d_theta, vth_e = _stage_scalars(cfg)
    return GKStageSpec(
        grids=g, n_species=cfg.n_species,
        electrons_active=cfg.n_species >= 2 and cfg.kinetic_electrons,
        nonlinear=cfg.nonlinear,
        collision=cfg.collision_model if cfg.collisions else None,
        electromagnetic=cfg.electromagnetic, nu=cfg.nu_collision,
        hyper_coeff=cfg.hyper_coeff, hyper_p=cfg.hyper_order // 2,
        zonal_rate=cfg.zonal_damping_rate, r_l_ne=cfg.r_l_ne,
        eta_i=eta_i, eta_e=eta_e, d_theta=d_theta, v_scale_e=vth_e)


def stage_terms(cfg: NonlinearGKConfig, g: GKGrids, f: torch.Tensor, phi: torch.Tensor,
                gram_inv: torch.Tensor | None = None) -> StageTerms:
    """The non-local terms of one stage at input ``f`` (``phi`` its field
    solve), for the active species (ions; electrons too when kinetic)."""
    n_act = 2 if (cfg.n_species >= 2 and cfg.kinetic_electrons) else 1
    f_act = f[:n_act]
    bracket = exb_bracket(g, phi, f_act).contiguous() if cfg.nonlinear else None
    coll = None
    if cfg.collisions and cfg.collision_model == "conservative":
        coll = collide_conservative(cfg, g, f_act, gram_inv).contiguous()
    a_par = ampere_solve(cfg, g, f) if cfg.electromagnetic else None
    b_par = bpar_solve(cfg, g, f) if cfg.electromagnetic else None
    return StageTerms(phi=phi.contiguous(), tw=ballooning_planes(g, f_act), bracket=bracket,
                      coll=coll, a_par=a_par, b_par=b_par)


# ---------------------------------------------------------------------------
# Time stepping + diagnostics
# ---------------------------------------------------------------------------

def cfl_dt(cfg: NonlinearGKConfig, g: GKGrids, phi: torch.Tensor) -> torch.Tensor:
    """Adaptive CFL dt, a 0-d tensor on phi's device (reference
    ``_gk_nonlinear_time.py:95``)."""
    return cfl_dt_of_max(cfg, g, torch.max(torch.abs(phi)))


def cfl_dt_of_max(cfg: NonlinearGKConfig, g: GKGrids, phi_abs_max: torch.Tensor) -> torch.Tensor:
    """:func:`cfl_dt` from max |phi| (a 0-d real tensor), on its device."""
    if not cfg.cfl_adapt:
        return torch.full((), cfg.dt, dtype=phi_abs_max.dtype, device=phi_abs_max.device)
    phi_max = phi_abs_max + 1e-30
    kmax = torch.maximum(torch.max(torch.abs(g.kx)), torch.max(torch.abs(g.ky)))
    vmax = torch.clamp(torch.max(torch.abs(g.vpar)), min=1.0)
    v_scale = g.vth_ratio_e if (cfg.kinetic_electrons) else 1.0
    v_exb = kmax * phi_max
    v_par = vmax * v_scale * torch.max(torch.abs(g.b_dot_grad))
    v_hyper = cfg.hyper_coeff * torch.max(g.kperp2) ** (cfg.hyper_order // 2)
    dt = cfg.cfl_factor / torch.clamp(v_exb + v_par + v_hyper, min=1e-30)
    return torch.clamp(dt, max=cfg.dt)


def _rk4_step(cfg: NonlinearGKConfig, g: GKGrids, spec: GKStageSpec, state: GKState,
              gram_inv: torch.Tensor | None, stage_fn=gk_stage) -> GKState:
    """One RK4 step through ``stage_fn`` (``gk_stage``; the smoke and the
    profiler also pass its plain version, ``cuda_gk.gk_stage_plain``)."""
    f = state.f
    phi = field_solve(cfg, g, f)
    dt = cfl_dt(cfg, g, phi)
    fin, acc = f, None
    for stage in range(4):
        phi_s = phi if stage == 0 else field_solve(cfg, g, fin)
        terms = stage_terms(cfg, g, fin, phi_s, gram_inv)
        fin, acc = stage_fn(stage, f, fin, acc, terms, dt, spec)
    return GKState(f=fin, time=state.time + dt)


def _gram_inv(cfg: NonlinearGKConfig, g: GKGrids, cdt: torch.dtype):
    if cfg.collisions and cfg.collision_model == "conservative":
        return conservative_gram_inverse(g, cdt)
    return None


def rk4_step(cfg: NonlinearGKConfig, g: GKGrids,
             state: GKState) -> GKState:
    """One RK4 step: four fused stages (four launches of row G on the card)."""
    return _rk4_step(cfg, g, stage_spec(cfg, g), state,
                     _gram_inv(cfg, g, state.f.dtype))


def heat_flux(cfg: NonlinearGKConfig, g: GKGrids, f: torch.Tensor,
              phi: torch.Tensor):
    """Gyro-Bohm heat fluxes Q_i, Q_e (reference
    ``_gk_nonlinear_time.py:114-150``)."""
    def one(f_s):
        return flux_of_pressure(g, phi, velocity_moment(f_s, g.energy, g))

    q_i = one(f[0])
    q_e = one(f[1]) if cfg.kinetic_electrons else 0.5 * q_i
    return q_i, q_e


def flux_of_pressure(g: GKGrids, phi: torch.Tensor, pressure: torch.Tensor) -> torch.Tensor:
    """A species' heat flux from its energy moment: the sum over the modes of
    ``g`` (on a (kx, ky) tile of ``parallel/gk_shard``, the tile's share)."""
    ky_col = g.ky[None, :, None]
    ky_mask = (g.ky > 1e-10).to(phi.real.dtype)[None, :, None]
    flux_k = 1j * ky_col * torch.conj(phi) * pressure
    return torch.sum(torch.real(flux_k) * ky_mask)


def diagnostics(cfg: NonlinearGKConfig, g: GKGrids, state: GKState):
    phi = field_solve(cfg, g, state.f)
    q_i, q_e = heat_flux(cfg, g, state.f, phi)
    phi_rms = torch.sqrt(torch.mean(torch.abs(phi) ** 2))
    ky0 = int(np.argmin(np.abs(np.fft.fftfreq(cfg.n_ky))))
    zonal = torch.sqrt(torch.mean(torch.abs(phi[:, ky0, :]) ** 2))
    fm = torch.clamp(g.maxwellian[None, None, None, :, :], min=1e-30)
    w = torch.sum(torch.abs(state.f) ** 2 / fm) * g.d_vpar * g.d_mu
    return q_i, q_e, phi_rms, zonal, 0.5 * w


def _state_shape(cfg: NonlinearGKConfig):
    return (cfg.n_species, cfg.n_kx, cfg.n_ky, cfg.n_theta, cfg.n_vpar, cfg.n_mu)


def _init_state(cfg: NonlinearGKConfig, g: GKGrids, noise: torch.Tensor,
                amplitude: float = 1e-5) -> GKState:
    """Maxwellian-weighted perturbation ``amplitude * noise`` on the
    dealiased modes (``noise``: complex, of f's shape)."""
    cdt, fdt, _ = _dtypes(cfg)
    noise = noise.to(g.maxwellian.device)
    f = (amplitude * noise
         * g.maxwellian[None, None, None, None, :, :]
         * g.dealias_mask[None, :, :, None, None, None]).to(cdt)
    f[:, 0, 0, :, :, :] = 0.0
    return GKState(f=f, time=torch.tensor(0.0, dtype=fdt, device=f.device))


def init_state(cfg: NonlinearGKConfig, g: GKGrids, amplitude: float = 1e-5,
               seed: int = 42, generator: torch.Generator | None = None) -> GKState:
    """Maxwellian-weighted random perturbation on the dealiased modes: the
    real and imaginary noise are float64 normals from ``generator`` (a CPU
    generator seeded with ``seed`` by default)."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    shape = _state_shape(cfg)
    noise = torch.complex(torch.randn(shape, generator=generator, dtype=torch.float64),
                          torch.randn(shape, generator=generator, dtype=torch.float64))
    return _init_state(cfg, g, noise, amplitude)


def _run(cfg: NonlinearGKConfig, g: GKGrids, state: GKState, stage_fn=gk_stage):
    """The run of :func:`run_nonlinear_gk` from ``state``, each stage through
    ``stage_fn``."""
    n_saves = max(cfg.n_steps // cfg.save_interval, 1)
    spec = stage_spec(cfg, g)
    gram_inv = _gram_inv(cfg, g, state.f.dtype)
    rows = []
    for _ in range(n_saves):
        for _ in range(cfg.save_interval):
            state = _rk4_step(cfg, g, spec, state, gram_inv, stage_fn)
        rows.append((state.time, *diagnostics(cfg, g, state)))
    t, qi, qe, pr, zr, w = (torch.stack(col) for col in zip(*rows))
    return state, GKTrace(times=t, q_ion=qi, q_elec=qe, phi_rms=pr,
                          zonal_rms=zr, free_energy=w)


def run_nonlinear_gk(cfg: NonlinearGKConfig, geometry=None,
                     state: GKState | None = None,
                     amplitude: float = 1e-5, seed: int = 42,
                     device: torch.device | str = "cuda"):
    """Whole nonlinear run: n_saves x save_interval RK4 steps, the
    diagnostics every save_interval.  Returns (final GKState, GKTrace)."""
    g = build_grids(cfg, geometry, device=device)
    if state is None:
        state = init_state(cfg, g, amplitude=amplitude, seed=seed)
    return _run(cfg, g, state)
