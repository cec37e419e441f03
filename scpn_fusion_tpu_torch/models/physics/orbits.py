"""Charged-particle orbits: guiding-centre RK4 and full-orbit Boris pusher
(port of ``scpn_fusion_tpu/models/physics/orbits.py``).

* Guiding centre (R, Z, phi, v_par): parallel streaming + combined
  grad-B/curvature drift with drift coefficient
  ``(v_par^2 + mu B / m) / (omega_c B^2)``, mirror force
  ``m dv_par/dt = -mu (b . grad)B``; RK4 steps.
* Boris pusher (x, v in Cartesian): the standard energy-conserving
  half-acceleration / rotation / half-acceleration scheme.

The JAX package runs each orbit as one ``lax.scan`` and an ensemble as a
``vmap`` of it.  The magnetic field is a callable ``b_field(r, z) -> (B_R,
B_Z, B_phi)``.  For the port's analytic field (``fast_ions.tokamak_field``)
|B| and its gradient come from the field's own forward-mode derivative,
and on a CUDA tensor :func:`run_guiding_center` is ONE launch of a
hand-written kernel (``ops/cuda_orbits.gc_orbit``, ``csrc/orbits.cu``; row
F), on a CPU tensor its plain version, the loop of :func:`gc_rk4_step`.
Any other callable takes that plain loop by design, on every device (a
kernel cannot call it), with grad |B| from ``torch.func.grad``, as JAX takes
``jax.grad``.  The Boris pusher also takes an arbitrary ``field_fn(x) -> (E,
B)`` and runs on plain ops; :func:`run_boris_ensemble` is one batch
dimension, the field evaluated per particle by ``torch.func.vmap``.

The step divides by 0-d tensors (:func:`step_constants`): on a CUDA tensor
PyTorch multiplies by the reciprocal of a Python divisor, and the kernel
divides.  The entry points that take Python numbers
(:func:`init_guiding_center`) take ``dtype`` (float32 by default; JAX takes
its float from the x64 flag) and ``device`` (``"cuda"`` by default); the
integrators follow their state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

ATOMIC_MASS_KG = 1.66053906660e-27
E_CHARGE = 1.602176634e-19


class GuidingCenterState(NamedTuple):
    r: torch.Tensor
    z: torch.Tensor
    phi: torch.Tensor
    v_par: torch.Tensor
    mu: torch.Tensor      # magnetic moment (fixed adiabatic invariant)


def init_guiding_center(b_field: Callable, *, m_amu, charge_z, e_kev, pitch_angle, r0, z0,
                        dtype=torch.float32, device="cuda") -> GuidingCenterState:
    """Initialise the guiding-centre state; mu from the local |B|."""
    del charge_z
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    m = m_amu * ATOMIC_MASS_KG
    e_j = e_kev * 1e3 * E_CHARGE
    v_tot = torch.sqrt(t(2.0 * e_j / m))
    pitch = t(pitch_angle)
    v_par = v_tot * torch.cos(pitch)
    v_perp = v_tot * torch.sin(pitch)
    r0, z0 = t(r0), t(z0)
    b_r, b_z, b_phi = b_field(r0, z0)
    b_mag = torch.sqrt(b_r**2 + b_z**2 + b_phi**2)
    mu = m * v_perp**2 / (2.0 * b_mag)
    return GuidingCenterState(r0, z0, t(0.0), v_par, mu)


def step_constants(m_amu: float, charge_z: float, dt: float, dtype, device) -> dict:
    """The constants of :func:`gc_rk4_step` as 0-d tensors of ``dtype``:
    ``m = m_amu * ATOMIC_MASS_KG``, ``q = charge_z * E_CHARGE``, ``dt``,
    ``0.5 * dt``, ``dt / 6`` and ``0.5 * m`` (the energy audit's), each
    formed in Python double and rounded once to ``dtype``, as JAX rounds a
    Python scalar that meets an array of that dtype."""
    m = m_amu * ATOMIC_MASS_KG
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in (
        ("m", m), ("q", charge_z * E_CHARGE), ("dt", dt), ("half_dt", 0.5 * dt),
        ("dt6", dt / 6.0), ("half_m", 0.5 * m))}


def _grad_b_mag(b_field: Callable, r: torch.Tensor, z: torch.Tensor):
    """(d|B|/dR, d|B|/dZ) of a generic field by ``torch.func.grad``, per
    particle (``torch.func.vmap`` over a batch), as JAX's ``jax.grad`` of
    ``b_mag_at`` inside its ``vmap``."""
    def b_mag_at(rr, zz):
        br, bz, bp = b_field(rr, zz)
        return torch.sqrt(br**2 + bz**2 + bp**2)

    grad = torch.func.grad(b_mag_at, argnums=(0, 1))
    if r.dim() == 0:
        return grad(r, z)
    g_r, g_z = torch.func.vmap(grad)(r.reshape(-1), z.reshape(-1))
    return g_r.reshape(r.shape), g_z.reshape(z.shape)


def field_with_gradient(b_field: Callable, r: torch.Tensor, z: torch.Tensor):
    """(B_R, B_Z, B_phi, |B|, d|B|/dR, d|B|/dZ) at (r, z): the analytic
    field's forward-mode derivative where it has one (``with_gradient``),
    else the call and ``torch.func.grad``."""
    if hasattr(b_field, "with_gradient"):
        return b_field.with_gradient(r, z)
    b_r, b_z, b_phi = b_field(r, z)
    b_mag = torch.sqrt(b_r**2 + b_z**2 + b_phi**2)
    return (b_r, b_z, b_phi, b_mag, *_grad_b_mag(b_field, r, z))


def _gc_eom(state, b_field: Callable, m: torch.Tensor, q: torch.Tensor):
    """(dR, dZ, dphi, dv_par)/dt of the guiding centre ``state`` = (r, z,
    phi, v_par, mu), each product and quotient in JAX's order."""
    r, z, _, v_par, mu = state
    b_r, b_z, b_phi, b_mag, db_dr, db_dz = field_with_gradient(b_field, r, z)
    omega_c = torch.div(q * b_mag, m)

    # B x grad|B| with B = (B_R, B_phi, B_Z), grad|B| = (dB_dR, 0, dB_dZ).
    bxg_r = b_phi * db_dz
    bxg_phi = b_z * db_dr - b_r * db_dz
    bxg_z = -b_phi * db_dr

    drift = torch.div(v_par * v_par + torch.div(mu * b_mag, m), omega_c * (b_mag * b_mag))
    dr = torch.div(v_par * b_r, b_mag) + drift * bxg_r
    dz = torch.div(v_par * b_z, b_mag) + drift * bxg_z
    dphi = torch.div(v_par * b_phi, r * b_mag) + torch.div(drift * bxg_phi, r)
    b_dot_grad_b = b_r * db_dr + b_z * db_dz
    dv = torch.div(-torch.div(mu, m) * b_dot_grad_b, b_mag)
    return dr, dz, dphi, dv


def gc_rk4_step(c: dict, y: tuple, mu: torch.Tensor, b_field: Callable) -> tuple:
    """One RK4 step of the guiding centre ``y`` = (r, z, phi, v_par) with
    magnetic moment ``mu`` and the constants ``c`` of :func:`step_constants`."""
    def f(yy):
        return _gc_eom((*yy, mu), b_field, c["m"], c["q"])

    def ahead(h, k):
        return tuple(yi + h * ki for yi, ki in zip(y, k))

    k1 = f(y)
    k2 = f(ahead(c["half_dt"], k1))
    k3 = f(ahead(c["half_dt"], k2))
    k4 = f(ahead(c["dt"], k3))
    return tuple(yi + c["dt6"] * (((a + 2 * b) + 2 * cc) + d)
                 for yi, a, b, cc, d in zip(y, k1, k2, k3, k4))


def gc_orbit_loop(c: dict, b_field: Callable, y0: tuple, mu: torch.Tensor, n_steps: int):
    """The step loop of one orbit: (final (r, z, phi, v_par), R trace, Z
    trace), the traces (n_steps,) of the state after each step."""
    y, rs, zs = y0, [], []
    for _ in range(n_steps):
        y = gc_rk4_step(c, y, mu, b_field)
        rs.append(y[0])
        zs.append(y[1])
    return y, torch.stack(rs), torch.stack(zs)


def run_guiding_center(state: GuidingCenterState, b_field: Callable, *, m_amu, charge_z, dt,
                       n_steps: int):
    """Integrate the guiding-centre orbit; returns (final, {"r", "z"}), the
    traces (n_steps,).  With the port's ``tokamak_field`` this is row F's
    ``gc_orbit`` (one launch on a CUDA tensor, its plain loop on a CPU one);
    any other field takes the plain loop."""
    from scpn_fusion_tpu_torch.models.physics.fast_ions import TokamakField
    from scpn_fusion_tpu_torch.ops import cuda_orbits

    c = step_constants(m_amu, charge_z, dt, state.r.dtype, state.r.device)
    y0 = (state.r, state.z, state.phi, state.v_par)
    if isinstance(b_field, TokamakField):
        y, r_tr, z_tr = cuda_orbits.gc_orbit(c, b_field, torch.stack([*y0, state.mu]), n_steps)
        y = tuple(y.unbind())
    else:
        y, r_tr, z_tr = gc_orbit_loop(c, b_field, y0, state.mu, n_steps)
    return GuidingCenterState(*y, state.mu), {"r": r_tr, "z": z_tr}


class BorisState(NamedTuple):
    x: torch.Tensor   # (..., 3) Cartesian position [m]
    v: torch.Tensor   # (..., 3) velocity [m/s]


def boris_step(state: BorisState, e_field: torch.Tensor, b_field: torch.Tensor, *, q_over_m,
               dt) -> BorisState:
    """One Boris push (half-E, B-rotation, half-E) — energy-conserving; the
    last axis is the Cartesian one, any leading axes a batch."""
    qmdt2 = q_over_m * dt / 2.0
    v_minus = state.v + qmdt2 * e_field
    t = qmdt2 * b_field
    t2 = torch.sum(t * t, dim=-1, keepdim=True)
    s = 2.0 * t / (1.0 + t2)
    v_prime = v_minus + torch.linalg.cross(v_minus, t, dim=-1)
    v_plus = v_minus + torch.linalg.cross(v_prime, s, dim=-1)
    v_new = v_plus + qmdt2 * e_field
    return BorisState(state.x + dt * v_new, v_new)


def _boris_loop(state: BorisState, field, *, q_over_m, dt, n_steps: int):
    xs, energies = [], []
    for _ in range(n_steps):
        e, b = field(state.x)
        state = boris_step(state, e, b, q_over_m=q_over_m, dt=dt)
        xs.append(state.x)
        energies.append(0.5 * torch.sum(state.v**2, dim=-1))
    return state, torch.stack(xs, dim=-2), torch.stack(energies, dim=-1)


def run_boris(state: BorisState, field_fn: Callable, *, q_over_m, dt, n_steps: int):
    """Full-orbit Boris integration: (final, {"x": (n_steps, 3), "energy":
    (n_steps,)}), on plain ops (the field is a Python callable)."""
    final, xs, energies = _boris_loop(state, field_fn, q_over_m=q_over_m, dt=dt,
                                      n_steps=n_steps)
    return final, {"x": xs, "energy": energies}


def run_boris_ensemble(states: BorisState, field_fn: Callable, *, q_over_m, dt, n_steps: int):
    """Boris integration of an ensemble (leading axis) as one batch: the
    field evaluated per particle (``torch.func.vmap``, as JAX's ``vmap``),
    the push on (n, 3) tensors; the traces (n, n_steps, 3) and (n,
    n_steps)."""
    final, xs, energies = _boris_loop(states, torch.func.vmap(field_fn), q_over_m=q_over_m,
                                      dt=dt, n_steps=n_steps)
    return final, {"x": xs, "energy": energies}
