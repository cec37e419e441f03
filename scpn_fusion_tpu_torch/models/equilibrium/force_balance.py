"""Radial force balance: PF-coil currents for static equilibrium at R (port
of ``scpn_fusion_tpu/models/equilibrium/force_balance.py``).

The net radial force on the plasma column is

    F_R = 2 pi R I_p (B_z_ext(R, 0) - B_v_eq)

with the Shafranov equilibrium field

    B_v_eq = -(mu0 I_p / 4 pi R) (ln(8R/a) + beta_p + l_i/2 - 3/2)

and B_z_ext linear in the coil currents through the Green's function, so
the paired-coil adjustment that zeroes F_R is one closed-form division.  The
Newton variant, for a force that is not linear in its knob, takes its
derivative from autograd and runs as a host loop (one host read of the
force an iteration).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import CoilSet
from scpn_fusion_tpu_torch.models.equilibrium.shape_control import probe_response_matrix

MU0_SI = 4.0e-7 * math.pi


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def shafranov_vertical_field(r0, a_minor, ip_a, *, beta_p=0.5, li=0.9, mu0: float = MU0_SI):
    """Equilibrium vertical field B_v (Shafranov, standard form)."""
    return -(mu0 * ip_a / (4.0 * math.pi * r0)) * (
        _log(8.0 * r0 / a_minor) + beta_p + li / 2.0 - 1.5)


def external_bz_at(coils: CoilSet, r, z, *, mu0: float = MU0_SI):
    """B_z from the coil set at one point: one response row @ currents."""
    like = coils.currents
    pt = torch.stack([torch.as_tensor(r, dtype=like.dtype, device=like.device),
                      torch.as_tensor(z, dtype=like.dtype, device=like.device)])[None]
    row = probe_response_matrix(
        coils, b_probe_points=pt,
        b_probe_dirs=torch.tensor([1], dtype=torch.int32, device=like.device), mu0=mu0)[0]
    return row @ coils.currents, row


def radial_force(coils: CoilSet, r_target, ip_a, a_minor, *, beta_p=0.5, li=0.9,
                 mu0: float = MU0_SI):
    """Net radial force [N] on the plasma column at ``r_target``."""
    b_ext, _ = external_bz_at(coils, r_target, 0.0, mu0=mu0)
    b_eq = shafranov_vertical_field(r_target, a_minor, ip_a, beta_p=beta_p, li=li, mu0=mu0)
    return 2.0 * math.pi * r_target * ip_a * (b_ext - b_eq)


class ForceBalanceSolution(NamedTuple):
    currents: torch.Tensor          # balanced coil currents
    delta_i: torch.Tensor           # applied change on the control pair
    residual_force_n: torch.Tensor  # force after the solve
    initial_force_n: torch.Tensor
    converged: torch.Tensor


def solve_force_balance(
    coils: CoilSet,
    *,
    r_target: float = 6.2,
    ip_a: float = 15e6,
    a_minor: float = 2.0,
    control_indices: tuple[int, int] = (2, 3),
    beta_p: float = 0.5,
    li: float = 0.9,
    mu0: float = MU0_SI,
    tolerance_n: float = 1e4,
) -> ForceBalanceSolution:
    """Closed-form balanced currents for a symmetric control pair, on the
    coils' device: B_z is linear in the currents, so the exact step is
    ``dI = (B_eq - B_ext) / (s_i + s_j)`` with s the response-row entries of
    the control coils."""
    f0 = radial_force(coils, r_target, ip_a, a_minor, beta_p=beta_p, li=li, mu0=mu0)
    b_ext, row = external_bz_at(coils, r_target, 0.0, mu0=mu0)
    b_eq = shafranov_vertical_field(r_target, a_minor, ip_a, beta_p=beta_p, li=li, mu0=mu0)
    i, j = control_indices
    sens = row[i] + row[j]
    ok = sens.abs() > 1e-30
    delta = torch.where(ok, (b_eq - b_ext) / torch.where(ok, sens, torch.ones_like(sens)),
                        torch.zeros_like(sens))
    new_currents = coils.currents.clone()
    new_currents[i] += delta
    new_currents[j] += delta
    balanced = coils._replace(currents=new_currents)
    f1 = radial_force(balanced, r_target, ip_a, a_minor, beta_p=beta_p, li=li, mu0=mu0)
    return ForceBalanceSolution(
        currents=new_currents, delta_i=delta, residual_force_n=f1,
        initial_force_n=f0, converged=f1.abs() < tolerance_n)


def solve_force_balance_newton(
    force_fn,
    i0,
    *,
    n_iter: int = 10,
    tolerance_n: float = 1e4,
    jacobian_floor: float = 1e-12,
):
    """Newton on a general (possibly nonlinear) force function of one knob,
    with the exact derivative from autograd; at most ``n_iter`` steps while
    ``|F| > tolerance_n``.  Returns ``(x, F(x), converged)`` as tensors."""
    def grad_fn(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(force_fn(x), x)
        return g

    x = torch.as_tensor(i0).detach()
    f = force_fn(x).detach()
    k = 0
    while k < n_iter and float(f.abs()) > tolerance_n:
        g = grad_fn(x)
        g_safe = torch.where(g.abs() > jacobian_floor, g,
                             torch.sign(g) * jacobian_floor + (g == 0.0) * jacobian_floor)
        x = x - f / g_safe
        f = force_fn(x).detach()
        k += 1
    return x, f, f.abs() < tolerance_n
