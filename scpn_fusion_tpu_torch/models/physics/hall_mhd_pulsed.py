"""Pulsed axisymmetric Hall-MHD flux carrier, Ono Eq. 8 closure (port of
``scpn_fusion_tpu/models/physics/hall_mhd_pulsed.py``).

Spitzer resistivity, the circular-loop Faraday drive ``E_theta = -r/2
dB_ext/dt`` from the external-field ramp, implicit-backward-Euler and
IMEX-RK2 integrators of

    dpsi/dt = hall_scale * R_null * E_theta - eta * J_theta - psi / tau_psi,

the axial field ``B_z = (1/r) dpsi/dr``, and the magnetic-energy / L2 sink
diagnostics.  The JAX package runs the trajectory as one ``lax.scan``; the
port runs it as a Python loop of plain ops on the radial vectors (~100
launches a step on the card), following the device and dtype of ``psi0``.

The ramp is any function of time: a Python number that it returns (a flat
ramp, ``lambda t: 0.1``) is taken in the working dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

MU_0 = 4.0e-7 * math.pi


def spitzer_resistivity_ohm_m(temperature_ev, *, z_eff: float = 1.0, ln_lambda: float = 17.0,
                              dtype: torch.dtype | None = None,
                              device: torch.device | str = "cuda") -> torch.Tensor:
    """Spitzer parallel resistivity [Ohm m] for T_e in eV: Wesson's
    ``eta = 1.65e-9 Z lnLambda / T_keV^1.5`` on the eV input converted to
    keV (8.9e-7 Ohm m at 100 eV, Z=1, lnL=17, the NRL parallel value).  The
    same disclosed fix of the reference's keV coefficient on an eV input as
    the JAX package.  A tensor input sets dtype and device."""
    (t,) = as_tensors(temperature_ev, dtype=dtype, device=device)
    num = torch.tensor(1.65e-9 * z_eff * ln_lambda, dtype=t.dtype, device=t.device)
    return torch.div(num, torch.pow(t / 1.0e3, 1.5))


def _as_like(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def faraday_e_theta_from_b_ramp(rho_m: torch.Tensor, b_ext_t: Callable, t_s, *,
                                derivative_dt_s: float = 1.0e-9) -> torch.Tensor:
    """Circular-loop Faraday drive ``E_theta = -r/2 dB_ext/dt`` (two-sided
    difference away from t=0, one-sided at the origin; reference :92-106)."""
    dt = derivative_dt_s
    t_s = _as_like(t_s, rho_m)
    db_central = _as_like((b_ext_t(t_s + dt) - b_ext_t(t_s - dt)) / (2.0 * dt), rho_m)
    db_onesided = _as_like((b_ext_t(t_s + dt) - b_ext_t(t_s)) / dt, rho_m)
    db_dt = torch.where(t_s >= dt, db_central, db_onesided)
    return -0.5 * rho_m * db_dt


def axial_field_from_flux(rho_m: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """``B_z = (1/r) dpsi/dr`` with finite-axis handling (B_z[0] = B_z[1]);
    second-order one-sided edge stencils (``np.gradient(..., edge_order=2)``
    on a uniform grid)."""
    h = rho_m[1] - rho_m[0]
    interior = (psi[2:] - psi[:-2]) / (2.0 * h)
    left = (-3.0 * psi[0] + 4.0 * psi[1] - psi[2]) / (2.0 * h)
    right = (3.0 * psi[-1] - 4.0 * psi[-2] + psi[-3]) / (2.0 * h)
    dpsi_dr = torch.cat([left.reshape(1), interior, right.reshape(1)])
    field = dpsi_dr / torch.where(rho_m > 0, rho_m, torch.ones_like(rho_m))
    return torch.cat([field[1:2], field[1:]])


def _trapezoid(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (0.5 * (y[1:] + y[:-1]) * (x[1:] - x[:-1])).sum()


def magnetic_energy_proxy(rho: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    return _trapezoid(0.5 * psi * psi * 2.0 * math.pi * rho / MU_0, rho)


def _l2(rho: torch.Tensor, profile: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(_trapezoid(profile * profile * 2.0 * math.pi * rho, rho),
                                  min=0.0))


@dataclasses.dataclass(frozen=True)
class HallMHDPulsedParams:
    """Carrier configuration (grid + profiles arrive as tensors)."""

    tau_psi_s: float
    electron_temperature_ev: float
    r_null_m: float
    z_eff: float = 1.0
    ln_lambda: float = 17.0
    hall_scale: float = 1.0
    time_integrator: str = "implicit_be"   # "implicit_be" | "imex_rk2"

    def __post_init__(self) -> None:
        for name in ("tau_psi_s", "electron_temperature_ev", "r_null_m"):
            if not getattr(self, name) > 0:
                raise ValueError(f"{name} must be positive")
        if self.time_integrator not in ("implicit_be", "imex_rk2"):
            raise ValueError("time_integrator must be 'implicit_be' or 'imex_rk2'")


class HallMHDState(NamedTuple):
    t_s: torch.Tensor
    psi: torch.Tensor


class HallMHDDiagnostics(NamedTuple):
    energy_proxy: torch.Tensor
    hall_drive_l2: torch.Tensor
    resistive_sink_l2: torch.Tensor
    damping_sink_l2: torch.Tensor
    source_residual_linf: torch.Tensor


def _ono_source(params: HallMHDPulsedParams, rho, j_theta, b_ext_t, t_s):
    e_theta = faraday_e_theta_from_b_ramp(rho, b_ext_t, t_s)
    eta = spitzer_resistivity_ohm_m(torch.full_like(rho, params.electron_temperature_ev),
                                    z_eff=params.z_eff, ln_lambda=params.ln_lambda)
    return params.hall_scale * params.r_null_m * e_theta - eta * j_theta, e_theta, eta


def step_hall_mhd_pulsed(state: HallMHDState, params: HallMHDPulsedParams, rho: torch.Tensor,
                         j_theta: torch.Tensor, b_ext_t: Callable, dt_s):
    """One carrier step (implicit BE or IMEX-RK2, reference :218-243)."""
    psi, t = state.psi, state.t_s
    if params.time_integrator == "implicit_be":
        source, _, _ = _ono_source(params, rho, j_theta, b_ext_t, t + dt_s)
    else:  # imex_rk2
        source, _, _ = _ono_source(params, rho, j_theta, b_ext_t, t + 0.5 * dt_s)
    psi_new = (psi + dt_s * source) / (1.0 + dt_s / params.tau_psi_s)

    residual = (psi_new - psi) / dt_s - source + psi_new / params.tau_psi_s
    scale = torch.clamp(torch.maximum(source.abs().max(),
                                      (psi_new / params.tau_psi_s).abs().max()), min=1.0)

    _, e_theta, eta = _ono_source(params, rho, j_theta, b_ext_t, t + dt_s)
    diag = HallMHDDiagnostics(
        energy_proxy=magnetic_energy_proxy(rho, psi_new),
        hall_drive_l2=_l2(rho, params.hall_scale * params.r_null_m * e_theta),
        resistive_sink_l2=_l2(rho, eta * j_theta),
        damping_sink_l2=_l2(rho, psi_new / params.tau_psi_s),
        source_residual_linf=residual.abs().max() / scale,
    )
    return HallMHDState(t + dt_s, psi_new), diag


def run_hall_mhd_pulsed(params: HallMHDPulsedParams, psi0: torch.Tensor, rho: torch.Tensor,
                        j_theta: torch.Tensor, b_ext_t: Callable, dt_s, *, n_steps: int):
    """Run the carrier trajectory; returns the final state, final B_z and
    the per-step diagnostics, each (n_steps,)."""
    state = HallMHDState(psi0.new_zeros(()), psi0)
    diags = []
    for _ in range(n_steps):
        state, diag = step_hall_mhd_pulsed(state, params, rho, j_theta, b_ext_t, dt_s)
        diags.append(diag)
    stacked = HallMHDDiagnostics(*(torch.stack(col) for col in zip(*diags)))
    return state, axial_field_from_flux(rho, state.psi), stacked
