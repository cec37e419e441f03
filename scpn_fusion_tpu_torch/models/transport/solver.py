"""1.5D integrated transport stepper, multi-ion Crank-Nicolson (port of
``scpn_fusion_tpu/models/transport/solver.py``).

One step (:func:`evolve_profiles`): species burn and fuelling, auxiliary
heating, Patankar-implicit radiation sinks, symmetric implicit electron-ion
equilibration, Crank-Nicolson implicit diffusion of each channel through the
Thomas solver (``ops/tridiag.py``: one CUDA kernel launch a solve on the
card), and the in-step Picard predictor-corrector on the nonlinear chi
closure.  Same formulas, constants, guards and boundary conditions as the
JAX stepper:

* CN system ``(I - 0.5 dt L_h + dt nu_sink) T^{n+1} = T^n + 0.5 dt L_h T^n
  + dt S`` with cylindrical ``L_h = (1/r) d/dr(r chi dT/dr)`` on half-grid
  diffusivities; axis Neumann (T0 = T1), fixed edge (ions 0.1 keV,
  electrons ``t_edge_kev``);
* radiation as ``nu = S_rad / T_old`` on the diagonal; equilibration with
  ``tau_eq = 0.01 Te^1.5 / max(ne/10, 0.1)`` clipped to [1 ms, 1 s];
* D/T burn, He ash with the ``tau_He = tau_He_factor * tau_E`` pump
  (IPB98(y,2) tau_E by default), quasi-neutral ``ne`` with tungsten
  ``Z_W(log Te)`` and the charge-weighted ``Z_eff``;
* chi = chi_CH + chi_gB, or the neural closure (``surrogate``) with a
  per-point out-of-distribution fallback to it.

Where the JAX stepper runs ``lax.while_loop`` / ``lax.scan`` on the device,
the port runs Python loops: the Picard corrector reads its residual once an
iteration (one host synchronisation) and stops where JAX's loop stops, so the
iteration counts are JAX's.  The three species' CN systems are independent
and go through one batched Thomas call.  ``dt`` and ``p_aux_mw`` are taken in
the state's dtype (as the JAX stepper computes with x64 off), and tolerances
are rounded to it before the host compares.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import _as_dtype
from scpn_fusion_tpu_torch.models.transport.closures import (
    E_KEV_J,
    bosch_hale_sigmav,
    bremsstrahlung_power_density,
    chang_hinton_chi,
    gyro_bohm_chi,
    tungsten_radiation_rate,
)
from scpn_fusion_tpu_torch.ops.tridiag import thomas_solve, thomas_solve_batched


@functools.lru_cache(maxsize=64)
def rho_grid(nr: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0, 1, nr)`` on ``device``, made once (a step asks for it
    many times; a new one would be a host-to-device copy each time).  The
    tensor is shared: never write to it."""
    return linspace(0.0, 1.0, nr, dtype, device)


@dataclasses.dataclass(frozen=True)
class TransportParams:
    """Static transport configuration (the JAX ``TransportParams``)."""

    nr: int = 50
    r0: float = 6.2
    a_minor: float = 2.0
    b0: float = 5.3
    kappa: float = 1.7
    a_ion: float = 2.0
    c_gb: float = 1.0
    ip_ma: float = 15.0
    # He-pump timescale: IPB98(y,2) chain by default; False reverts to the
    # stored-energy/power estimate.
    use_ipb98_tau_he: bool = True
    # Neural-closure OOD gate: points whose max |z| against the surrogate's
    # training envelope exceeds this fall back to the analytic closure.
    ood_sigma: float = 3.0
    multi_ion: bool = True
    t_edge_kev: float = 0.08
    d_species: float = 0.5
    tau_he_factor: float = 5.0
    aux_heating_profile_width: float = 0.1
    aux_heating_electron_fraction: float = 0.5
    picard_max_iter: int = 20
    picard_tol: float = 1e-5
    picard_theta: float = 0.5
    picard_damping: float = 0.15

    @property
    def drho(self) -> float:
        return 1.0 / (self.nr - 1)

    def rho(self, dtype: torch.dtype = torch.float32,
            device: torch.device | str = "cuda") -> torch.Tensor:
        """``jnp.linspace(0, 1, nr)`` bit for bit (its eager form: the JAX
        stepper evaluates it under ``jit`` too, where it may differ by an
        ulp off a 2^k + 1 grid).  The tensor is shared: do not write to it."""
        return rho_grid(self.nr, dtype, torch.device(device))


class TransportState(NamedTuple):
    """Profile state (the JAX ``TransportState``)."""

    ti: torch.Tensor       # keV
    te: torch.Tensor       # keV
    ne: torch.Tensor       # 1e19 m^-3
    n_d: torch.Tensor
    n_t: torch.Tensor
    n_he: torch.Tensor
    n_imp: torch.Tensor
    chi_i: torch.Tensor    # m^2/s
    chi_e: torch.Tensor
    d_n: torch.Tensor
    q: torch.Tensor        # safety factor profile
    z_eff: torch.Tensor    # scalar


def initial_state(params: TransportParams, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> TransportState:
    """The reference's initial profiles on ``device``."""
    rho = params.rho(dtype, device)
    te = 1.0 * (1.0 - rho**2)
    ne = 5.0 * (1.0 - rho**2) ** 0.5
    ones = torch.ones_like(rho)
    return TransportState(
        ti=te, te=te, ne=ne,
        n_d=0.5 * ne, n_t=0.5 * ne,
        n_he=torch.zeros_like(rho), n_imp=torch.zeros_like(rho),
        chi_i=ones, chi_e=ones, d_n=ones,
        q=1.0 + 2.0 * rho**2,
        z_eff=torch.full((), 1.5, dtype=dtype, device=rho.device),
    )


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a number or a tensor) as a 0-d tensor of ``like``'s dtype and device."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def _where_finite(x: torch.Tensor, fallback) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, fallback)


# ── CN assembly (reference runtime_utils.py:63-144) ──────────────────────


def explicit_diffusion_rhs(t: torch.Tensor, chi: torch.Tensor, rho: torch.Tensor,
                           drho) -> torch.Tensor:
    """L_h(T) = (1/r) d/dr(r chi dT/dr) on the interior points (edges zero),
    along the last axis (a leading batch of profiles is solved row by row)."""
    r = rho[1:-1]
    chi_ip = 0.5 * (chi[..., 1:-1] + chi[..., 2:])
    chi_im = 0.5 * (chi[..., 1:-1] + chi[..., :-2])
    flux_ip = chi_ip * (r + 0.5 * drho) * (t[..., 2:] - t[..., 1:-1]) / drho
    flux_im = chi_im * (r - 0.5 * drho) * (t[..., 1:-1] - t[..., :-2]) / drho
    out = torch.zeros_like(t)
    out[..., 1:-1] = (flux_ip - flux_im) / (r * drho)
    return out


def build_cn_tridiag(chi: torch.Tensor, dt, rho: torch.Tensor, drho):
    """Sub/main/super diagonals of (I - 0.5 dt L_h) (interior rows)."""
    r = rho[1:-1]
    inv = 1.0 / (r * drho * drho)
    geo_ip = (r + 0.5 * drho) * inv
    geo_im = (r - 0.5 * drho) * inv
    chi_ip = 0.5 * (chi[1:-1] + chi[2:])
    chi_im = 0.5 * (chi[1:-1] + chi[:-2])
    coeff_ip = chi_ip * geo_ip
    coeff_im = chi_im * geo_im
    zero = chi.new_zeros(1)
    a = torch.cat([-0.5 * dt * coeff_im, zero])
    b = torch.cat([zero + 1.0, 1.0 + 0.5 * dt * (coeff_ip + coeff_im), zero + 1.0])
    c = torch.cat([zero, -0.5 * dt * coeff_ip])
    return a, b, c


def _cn_channel_solve(t_old, chi, dt, rhs_core, nu_sink, edge_value, rho, drho):
    """One CN channel solve with axis-Neumann / fixed-edge BCs."""
    a, b, c = build_cn_tridiag(chi, dt, rho, drho)
    b = b + dt * nu_sink
    # Axis: T0 - T1 = 0; edge: T_{n-1} = edge_value (rows set on fresh tensors).
    b[0] = 1.0
    b[-1] = 1.0
    c[0] = -1.0
    a[-1] = 0.0
    rhs = rhs_core.clone()
    rhs[0] = 0.0
    rhs[-1] = edge_value
    t_new = thomas_solve(a, b, c, rhs)
    t_new[0] = t_new[1]
    t_new[-1] = edge_value
    # Sanitise with fallback to the old state, floors as in the reference.
    return torch.clamp(_where_finite(t_new, t_old), 0.01, 1e3)


def _thermal_cn_step(params: TransportParams, dt, ti_old, te_old, chi_i, chi_e, heat_i,
                     nu_rad_i, nu_eq, s_heat_e_aux, p_rad_line, ne, z_eff, rho, drho):
    """Ion then electron CN solves (sequential-implicit equilibration)."""
    lh_i = _where_finite(explicit_diffusion_rhs(ti_old, chi_i, rho, drho), 0.0)
    rhs_i = ti_old + 0.5 * dt * lh_i + dt * heat_i + dt * nu_eq * te_old
    rhs_i = _where_finite(rhs_i, ti_old)
    ti_new = _cn_channel_solve(ti_old, chi_i, dt, rhs_i, nu_rad_i + nu_eq, 0.1, rho, drho)

    if not params.multi_ion:
        return ti_new, ti_new

    p_brem = bremsstrahlung_power_density(ne, te_old, z_eff)
    ne_safe = torch.clamp(ne, min=0.1) * 1e19
    s_brem_e = p_brem / (ne_safe * E_KEV_J)
    s_rad_e = p_rad_line / (ne_safe * E_KEV_J) * 0.5
    src_e = _where_finite(s_heat_e_aux + nu_eq * ti_new, 0.0)
    nu_rad_e = torch.clamp((s_rad_e + s_brem_e) / torch.clamp(te_old, min=0.01), min=0.0)
    nu_rad_e = _where_finite(nu_rad_e, 0.0)

    lh_e = _where_finite(explicit_diffusion_rhs(te_old, chi_e, rho, drho), 0.0)
    rhs_e = te_old + 0.5 * dt * lh_e + dt * src_e
    rhs_e = _where_finite(rhs_e, te_old)
    te_new = _cn_channel_solve(te_old, chi_e, dt, rhs_e, nu_rad_e + nu_eq, params.t_edge_kev,
                               rho, drho)
    return ti_new, te_new


# ── sources ──────────────────────────────────────────────────────────────


def _volume_element(params: TransportParams, rho: torch.Tensor) -> torch.Tensor:
    """dV = 4 pi^2 R0 kappa a^2 rho drho."""
    return (4.0 * math.pi**2 * params.r0 * params.kappa
            * params.a_minor**2 * rho * params.drho)


def _aux_heating(params: TransportParams, p_aux_mw, ne, rho):
    """Gaussian-deposition aux heating, returns (S_i, S_e) in keV/s."""
    shape = torch.exp(-(torch.clamp(rho, 0.0, 1.0) ** 2)
                      / max(params.aux_heating_profile_width, 1e-6))
    d_v = _volume_element(params, rho)
    norm = torch.clamp(torch.sum(shape * d_v), min=1e-30)
    ne_safe = torch.clamp(ne, 0.1, 1e3) * 1e19
    e_frac = params.aux_heating_electron_fraction if params.multi_ion else 0.0
    p_w = torch.clamp(p_aux_mw, min=0.0) * 1e6
    p_i = (1.0 - e_frac) * p_w * shape / norm
    p_e = e_frac * p_w * shape / norm
    s_i = (2.0 / 3.0) * p_i / (ne_safe * E_KEV_J)
    s_e = (2.0 / 3.0) * p_e / (ne_safe * E_KEV_J)
    return s_i, s_e


def _confinement_time_estimate(params: TransportParams, s: TransportState, p_aux_mw, rho):
    """tau_E for the He-pump timescale: the IPB98(y,2) chain on the
    volume-averaged density and the loss power (aux + alpha) by default, the
    stored-energy/power estimate as the opt-out."""
    d_v = _volume_element(params, rho)
    if params.use_ipb98_tau_he:
        from scpn_fusion_tpu_torch.models.physics.scaling_burn import ipb98y2_tau_e

        vol = torch.clamp(torch.sum(d_v), min=1e-30)
        ne_avg = torch.clamp(torch.sum(s.ne * d_v) / vol, 0.1, 1e3)
        sigmav = bosch_hale_sigmav(s.ti)
        p_alpha_w = torch.sum((s.n_d * s.n_t * sigmav) * 1e38 * (3.52e3 * E_KEV_J) * d_v)
        p_loss_mw = torch.clamp(p_aux_mw + p_alpha_w / 1e6, 0.5, 1e4)
        tau = ipb98y2_tau_e(s.ti.new_full((), params.ip_ma), params.b0, ne_avg, p_loss_mw,
                            params.r0, params.kappa, params.a_minor / params.r0)
        return torch.clamp(tau, 0.05, 50.0)
    w_j = 1.5 * torch.sum((s.ne * 1e19) * (s.ti + s.te) * E_KEV_J * d_v)
    p_w = torch.clamp(p_aux_mw, min=0.1) * 1e6
    return torch.clamp(w_j / p_w, 0.05, 50.0)


def _evolve_species(params: TransportParams, s: TransportState, dt, p_aux_mw, rho, drho):
    """D/T burn, He ash with pump, quasi-neutral ne, Z_eff, line radiation.
    The three species' CN systems share their matrix and go through one
    batched Thomas call."""
    sigmav = bosch_hale_sigmav(s.ti)
    # 1e19-normalised burn rate (SI n_d*n_t ~ 1e39 overflows f32).
    s_fuel = (s.n_d * s.n_t * sigmav) * 1e19   # [1e19 m^-3 / s]
    s_he = s_fuel

    tau_e = _confinement_time_estimate(params, s, p_aux_mw, rho)
    tau_he = torch.clamp(params.tau_he_factor * tau_e, min=0.5)
    pump = 1.0 / tau_he

    d_prof = params.d_species * torch.ones_like(rho)
    a, b, c = build_cn_tridiag(d_prof, dt, rho, drho)

    n_old = torch.stack([s.n_d, s.n_t, s.n_he])
    source = torch.stack([-s_fuel, -s_fuel, s_he - pump * s.n_he])
    lh = explicit_diffusion_rhs(n_old, d_prof, rho, drho)
    rhs = n_old + 0.5 * dt * lh + dt * source
    n_new = thomas_solve_batched(a.expand(3, -1), b.expand(3, -1), c.expand(3, -1), rhs)
    n_new[:, 0] = n_new[:, 1]
    n_new[:2, -1] = 0.01       # D and T edge density; He's edge is 0
    n_new[2, -1] = 0.0
    n_new = _where_finite(n_new, n_old)
    n_d = torch.clamp(n_new[0], min=0.001)
    n_t = torch.clamp(n_new[1], min=0.001)
    n_he = torch.clamp(n_new[2], min=0.0)

    te_safe = torch.clamp(s.te, 0.1, 1e3)
    z_w = torch.clamp(15.0 + 12.0 * torch.log10(te_safe), 10.0, 50.0)
    n_imp = torch.clamp(s.n_imp, min=0.0)
    ne = torch.clamp(n_d + n_t + 2.0 * n_he + z_w * n_imp, min=0.1)

    ne_m3 = torch.clamp(ne * 1e19, min=1e10)
    sum_nz2 = (n_d * 1e19 + n_t * 1e19 + n_he * 1e19 * 4.0
               + n_imp * 1e19 * z_w**2)
    z_eff = torch.clamp(torch.mean(sum_nz2 / ne_m3), 1.0, 10.0)

    lz = tungsten_radiation_rate(s.te)
    # f32-safe ordering: (ne19 * n_imp19) ~ 1e2, then one 1e38-folded factor.
    p_rad_line = (ne * n_imp) * (lz * 1e38)
    return s._replace(n_d=n_d, n_t=n_t, n_he=n_he, ne=ne, z_eff=z_eff), p_rad_line


_M_PROTON = 1.67262192369e-27
_E_CHARGE = 1.602176634e-19


def _gradient(x: torch.Tensor, h: float) -> torch.Tensor:
    """``jnp.gradient(x, h)`` for a scalar spacing: one-sided first-order
    edges, central differences inside."""
    upper = (x[1:2] - x[0:1]) / h
    lower = (x[-1:] - x[-2:-1]) / h
    inner = (x[2:] - x[:-2]) * 0.5 / h
    return torch.cat([upper, inner, lower])


def _local_surrogate_inputs(params: TransportParams, s: TransportState,
                            rho: torch.Tensor) -> torch.Tensor:
    """(nr, 7) local dimensionless inputs [R/L_Ti, R/L_Te, R/L_ne, q, s_hat,
    Te/Ti, nu_star] of the neural closure."""
    inv_scale = params.r0 / params.a_minor

    def r_l(x):
        grad = _gradient(x, params.drho)
        return torch.clamp(-inv_scale * grad / torch.clamp(x, min=1e-2), 0.0, 20.0)

    dq = _gradient(s.q, params.drho)
    s_hat = torch.clamp(rho * dq / torch.clamp(s.q, min=0.2), -1.0, 4.0)
    te_ti = torch.clamp(s.te / torch.clamp(s.ti, min=1e-2), 0.05, 10.0)
    eps = torch.clamp(rho * params.a_minor / params.r0, min=1e-3)
    # Banana-regime electron collisionality with n_e in 1e19 m^-3, T_e in
    # keV and lnL = 17: the coefficient folds to 0.02.
    nu_star = torch.clamp(
        0.02 * s.ne * s.q * params.r0 * s.z_eff
        / (torch.clamp(s.te, min=0.05) ** 2 * eps**1.5), 1e-3, 1e2)
    return torch.stack([r_l(s.ti), r_l(s.te), r_l(s.ne), s.q, s_hat, te_ti,
                        nu_star.expand(rho.shape)], dim=1)


def _gyro_bohm_unit(params: TransportParams, ti_kev: torch.Tensor) -> torch.Tensor:
    """chi_gB = rho_s^2 c_s / a per radial point [m^2/s]."""
    m_i = params.a_ion * _M_PROTON
    t_j = torch.clamp(ti_kev, min=0.01) * E_KEV_J
    c_s = torch.sqrt(t_j / m_i)
    rho_s = m_i * c_s / (_E_CHARGE * params.b0)
    return rho_s**2 * c_s / params.a_minor


def _transport_coefficients(params: TransportParams, s: TransportState, surrogate=None):
    """(chi_e, chi_i, D_n) on the current state: Chang-Hinton + gyro-Bohm, or
    the neural fluxes of ``surrogate`` (a ``TransportSurrogate``) wherever the
    point's max |z| against the training envelope is within
    ``params.ood_sigma``, the analytic closure elsewhere."""
    rho = params.rho(s.ti.dtype, s.ti.device)
    chi_nc = chang_hinton_chi(rho, s.ti, s.ne, s.q, params.r0, params.a_minor, params.b0,
                              params.a_ion, s.z_eff)
    chi_gb = gyro_bohm_chi(s.ti, s.te, s.q, params.r0, params.a_minor, params.b0,
                           params.a_ion, params.c_gb)
    chi_e = torch.clamp(chi_nc + chi_gb, min=1e-6)
    chi_i = torch.clamp(chi_nc + chi_gb, min=1e-6)
    d_n = torch.maximum(0.5 * chi_gb, 0.1 * chi_nc)

    if surrogate is not None:
        x = _local_surrogate_inputs(params, s, rho)
        y_gb = surrogate.fluxes_gb(x)              # (nr, 3) gyro-Bohm
        unit = _gyro_bohm_unit(params, s.ti)
        ood = surrogate.max_abs_z(x) > params.ood_sigma

        def pick(nn, an):
            return torch.where(ood, an, torch.clamp(nn, min=1e-6))

        chi_i = pick(y_gb[:, 0] * unit, chi_i)
        chi_e = pick(y_gb[:, 1] * unit, chi_e)
        d_n = pick(y_gb[:, 2] * unit, d_n)

    return (torch.clamp(chi_e, 0.01, 1e4), torch.clamp(chi_i, 0.01, 1e4),
            torch.clamp(d_n, 0.0, 1e4))


# ── one full step ────────────────────────────────────────────────────────


def _evolve(s: TransportState, dt, p_aux_mw, params: TransportParams,
            surrogate=None) -> tuple[TransportState, int]:
    """One CN step and the number of Picard corrector iterations it took."""
    dtype, device = s.ti.dtype, s.ti.device
    dt = _scalar(dt, s.ti)
    p_aux_mw = _scalar(p_aux_mw, s.ti)
    rho = params.rho(dtype, device)
    drho = params.drho
    ti_old, te_old = s.ti, s.te

    if params.multi_ion:
        s, p_rad_line = _evolve_species(params, s, dt, p_aux_mw, rho, drho)
    else:
        p_rad_line = torch.zeros_like(rho)

    s_heat_i, s_heat_e = _aux_heating(params, p_aux_mw, s.ne, rho)

    if params.multi_ion:
        ne_safe = torch.clamp(s.ne, min=0.1) * 1e19
        s_rad_i = p_rad_line / (ne_safe * E_KEV_J) * 0.5
        tau_eq = torch.clamp(0.01 * te_old**1.5 / torch.clamp(s.ne / 10.0, min=0.1),
                             0.001, 1.0)
        nu_eq = 1.0 / tau_eq
    else:
        s_rad_i = 5.0 * s.ne * s.n_imp * torch.sqrt(te_old + 0.1)
        nu_eq = torch.zeros_like(rho)

    heat_i = _where_finite(s_heat_i, 0.0)
    nu_rad_i = torch.clamp(s_rad_i / torch.clamp(ti_old, min=0.01), min=0.0)
    nu_rad_i = _where_finite(nu_rad_i, 0.0)

    def thermal(chi_i, chi_e, state):
        return _thermal_cn_step(params, dt, ti_old, te_old, chi_i, chi_e, heat_i, nu_rad_i,
                                nu_eq, s_heat_e, p_rad_line, state.ne, state.z_eff, rho, drho)

    # Predictor with beginning-of-step coefficients.
    chi_i_n, chi_e_n, d_n_n = s.chi_i, s.chi_e, s.d_n
    ti_c, te_c = thermal(chi_i_n, chi_e_n, s)

    # Picard corrector on the nonlinear chi closure: theta-centred target,
    # damped after the first iteration, the thermal step re-solved from the
    # frozen beginning-of-step state each time.
    theta = params.picard_theta
    tol = _as_dtype(params.picard_tol, dtype)
    chi_i_c, chi_e_c, d_n_c = chi_i_n, chi_e_n, d_n_n
    k, resid = 0, math.inf
    while k < params.picard_max_iter and resid > tol:
        trial = s._replace(ti=ti_c, te=te_c)
        chi_e_pred, chi_i_pred, d_n_pred = _transport_coefficients(params, trial, surrogate)
        chi_i_t = (1.0 - theta) * chi_i_n + theta * chi_i_pred
        chi_e_t = (1.0 - theta) * chi_e_n + theta * chi_e_pred
        d_n_t = (1.0 - theta) * d_n_n + theta * d_n_pred
        blend = 1.0 if k == 0 else params.picard_damping
        chi_i_c = chi_i_c + blend * (chi_i_t - chi_i_c)
        chi_e_c = chi_e_c + blend * (chi_e_t - chi_e_c)
        d_n_c = d_n_c + blend * (d_n_t - d_n_c)
        ti_new, te_new = thermal(chi_i_c, chi_e_c, trial)
        rel = torch.stack([
            torch.linalg.vector_norm(ti_new - ti_c)
            / torch.clamp(torch.linalg.vector_norm(ti_c), min=1e-30),
            torch.linalg.vector_norm(te_new - te_c)
            / torch.clamp(torch.linalg.vector_norm(te_c), min=1e-30)])
        resid = float(rel.max())    # the one host read of the iteration
        ti_c, te_c = ti_new, te_new
        k += 1

    return s._replace(ti=ti_c, te=te_c, chi_i=chi_i_c, chi_e=chi_e_c, d_n=d_n_c), k


def evolve_profiles(s: TransportState, dt, p_aux_mw, params: TransportParams,
                    surrogate=None) -> TransportState:
    """Advance the transport state by one CN step on the state's device.
    ``surrogate`` (a ``TransportSurrogate``) switches the chi closure to the
    neural lane with its per-point OOD fallback."""
    return _evolve(s, dt, p_aux_mw, params, surrogate)[0]


def run_transport(s: TransportState, dt, p_aux_mw, params: TransportParams, n_steps: int,
                  surrogate=None) -> tuple[TransportState, dict]:
    """Run ``n_steps`` steps; returns the final state and the per-step traces
    ``ti0``, ``te0``, ``ne0``, ``n_he0`` (the values at the first interior
    point, stacked, as JAX's) and ``picard`` (each step's Picard iterations,
    a CPU integer tensor)."""
    keys = ("ti0", "te0", "ne0", "n_he0")
    traces: dict[str, list] = {k: [] for k in keys}
    picard = []
    for _ in range(n_steps):
        s, k = _evolve(s, dt, p_aux_mw, params, surrogate)
        for key, field in zip(keys, (s.ti, s.te, s.ne, s.n_he)):
            traces[key].append(field[1])
        picard.append(k)
    out = {k: torch.stack(v) if v else s.ti.new_zeros(0) for k, v in traces.items()}
    out["picard"] = torch.tensor(picard, dtype=torch.int64)
    return s, out
