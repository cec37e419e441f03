"""Fast-ion population physics: Monte-Carlo ensembles, orbit
classification, prompt loss, and collisional slowing-down (port of
``scpn_fusion_tpu/models/physics/fast_ions.py``).

The JAX package integrates a whole ensemble as one ``vmap(lax.scan(rk4))``
program over the guiding-centre pusher of :mod:`.orbits`, classifying each
orbit on the fly (running wall-crossing and bounce flags; lost particles
freeze at their loss state) and auditing ``E = m v_par^2/2 + mu |B|`` along
every surviving orbit.  The port runs the same population in ONE launch of
a hand-written kernel, one thread a particle with the step loop inside
(``ops/cuda_orbits.gc_ensemble``, ``csrc/orbits.cu``; row F), when the field
is the analytic :func:`tokamak_field` and the state lies on the card; on a
CPU tensor the same call is its plain version, the loop of
:func:`ensemble_step` over the particles as one batch.  Any other field
callable takes that plain loop by design, on every device (a kernel cannot
call a Python function), with grad |B| from ``torch.func.grad``.  The
statistics are plain ops on the per-particle results.

:func:`tokamak_field` returns a :class:`TokamakField`, a small callable that
gives ``(B_R, B_Z, B_phi)`` as JAX's closure does and, through
``with_gradient``, |B| with d|B|/dR and d|B|/dZ carried forward through the
same expression sequence (the kernel's).  On the magnetic axis (rm = 0) the
square root has no finite derivative and the gradient is NaN, as
``jax.grad`` of the JAX field gives there.

The draws: :func:`sample_fast_ion_birth` draws from a ``torch.Generator``
(its device; the state goes to ``device``): the Beta(2, 5) birth radius as
the 2nd smallest of 6 uniforms (``torch.distributions.Beta`` takes no
generator), the poloidal and pitch angles as scaled uniforms.  JAX's
threefry bits cannot be reproduced; :func:`_sample_fast_ion_birth` takes the
draws as tensors, and the parity tests feed it JAX's.  Functions given
Python numbers take ``dtype`` (float32 by default; JAX takes its float from
the x64 flag) and ``device`` (``"cuda"`` by default); given tensors they
follow them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors
from scpn_fusion_tpu_torch.models.physics.orbits import (
    ATOMIC_MASS_KG,
    E_CHARGE,
    GuidingCenterState,
    field_with_gradient,
    gc_rk4_step,
    step_constants,
)

__all__ = [
    "ALPHA_AMU",
    "ALPHA_BIRTH_KEV",
    "ALPHA_Z",
    "EnsembleStats",
    "coulomb_log_ei",
    "critical_velocity",
    "first_orbit_loss",
    "follow_ensemble",
    "heating_partition",
    "sample_fast_ion_birth",
    "slowing_down_time",
    "tau_spitzer_electron",
    "tokamak_field",
]

ALPHA_AMU = 4.001506
ALPHA_Z = 2
ALPHA_BIRTH_KEV = 3500.0
DT_MEAN_ION_AMU = 2.5

ELECTRON_MASS_KG = 9.1093837015e-31
EPS0 = 8.8541878128e-12
MU0 = 1.25663706212e-6


# ── analytic field ───────────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class TokamakField:
    """Analytic circular-surface tokamak field ``(R, Z) -> (B_R, B_Z,
    B_phi)``: ``B_phi = B0 R0 / R`` and a poloidal component tangent to
    circular surfaces with parabolic safety factor ``q(r) = q0 + (qa -
    q0)(r/a)^2``.  Row F takes its five parameters as constants."""

    b0: float
    r0: float
    a: float
    q0: float = 1.0
    qa: float = 3.0

    # the names of :meth:`constants`, in the order of ``csrc/orbits.cu``'s ``Const``
    CONSTANTS = ("b0r0", "r0", "b0", "a", "q0", "dq", "floor")

    def constants(self, dtype, device) -> dict:
        """The field's constants as 0-d tensors of ``dtype`` (``b0 * r0`` and
        ``qa - q0`` formed in Python double, as JAX folds them, and the
        1e-6 floor of the minor radius)."""
        return _field_constants(self, dtype, torch.device(device))

    def __call__(self, r, z):
        b_r, b_z, b_phi, *_ = self.with_gradient(r, z)
        return b_r, b_z, b_phi

    def with_gradient(self, r, z):
        """(B_R, B_Z, B_phi, |B|, d|B|/dR, d|B|/dZ): the JAX closure's
        expressions (``fast_ions.py:82-93``) with their R- and Z-derivatives
        carried alongside, d maximum(rm, floor)/d rm as JAX's (1 above, 0.5
        at a tie, 0 below)."""
        c = self.constants(r.dtype, r.device)
        b_phi = torch.div(c["b0r0"], r)
        bphi_r = -torch.div(b_phi, r)
        dr = r - c["r0"]
        rm = torch.sqrt(dr * dr + z * z)
        rm_r, rm_z = torch.div(dr, rm), torch.div(z, rm)
        rs = torch.maximum(rm, c["floor"])
        g = torch.where(rm > c["floor"], c["one"],
                        torch.where(rm == c["floor"], c["half"], c["zero"]))
        rs_r, rs_z = rm_r * g, rm_z * g
        x = torch.div(rm, c["a"])
        x_r, x_z = torch.div(rm_r, c["a"]), torch.div(rm_z, c["a"])
        qf = c["q0"] + c["dq"] * (x * x)
        tx = 2 * x
        qf_r, qf_z = c["dq"] * (tx * x_r), c["dq"] * (tx * x_z)
        num = rm * c["b0"]
        num_r, num_z = rm_r * c["b0"], rm_z * c["b0"]
        den = qf * r
        den_r, den_z = qf_r * r + qf, qf_z * r
        bp = torch.div(num, den)
        bp_r = torch.div(num_r - bp * den_r, den)
        bp_z = torch.div(num_z - bp * den_z, den)
        nb, nb_r, nb_z = -bp, -bp_r, -bp_z
        u, u_r, u_z = nb * z, nb_r * z, nb_z * z + nb
        b_r = torch.div(u, rs)
        br_r = torch.div(u_r - b_r * rs_r, rs)
        br_z = torch.div(u_z - b_r * rs_z, rs)
        w, w_r, w_z = bp * dr, bp_r * dr + bp, bp_z * dr
        b_z = torch.div(w, rs)
        bz_r = torch.div(w_r - b_z * rs_r, rs)
        bz_z = torch.div(w_z - b_z * rs_z, rs)
        b_mag = torch.sqrt((b_r * b_r + b_z * b_z) + b_phi * b_phi)
        db_dr = torch.div((b_r * br_r + b_z * bz_r) + b_phi * bphi_r, b_mag)
        db_dz = torch.div(b_r * br_z + b_z * bz_z, b_mag)
        return b_r, b_z, b_phi, b_mag, db_dr, db_dz


@functools.lru_cache(maxsize=64)
def _field_constants(f: TokamakField, dtype, device) -> dict:
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in (
        ("b0r0", f.b0 * f.r0), ("r0", f.r0), ("b0", f.b0), ("a", f.a), ("q0", f.q0),
        ("dq", f.qa - f.q0), ("floor", 1e-6), ("one", 1.0), ("half", 0.5), ("zero", 0.0))}


def tokamak_field(b0: float, r0: float, a: float, q0: float = 1.0,
                  qa: float = 3.0) -> TokamakField:
    """Analytic circular-surface tokamak field ``(R, Z) -> (B_R, B_Z,
    B_phi)``: ``B_phi = B0 R0 / R`` and a poloidal component tangent to
    circular surfaces with parabolic safety factor
    ``q(r) = q0 + (qa - q0)(r/a)^2`` — the standard test field for orbit
    studies.  It is a :class:`TokamakField`: its values follow the call's
    tensors."""
    return TokamakField(b0, r0, a, q0, qa)


# ── birth sampling ───────────────────────────────────────────────────────


def _sample_fast_ion_birth(beta: torch.Tensor, theta: torch.Tensor, pitch: torch.Tensor,
                           b_field: Callable, *, r0: float, a: float,
                           e_kev: float = ALPHA_BIRTH_KEV,
                           m_amu: float = ALPHA_AMU) -> GuidingCenterState:
    """:func:`sample_fast_ion_birth` on given draws: ``beta`` the Beta(2, 5)
    variates, ``theta`` in [0, 2 pi) and ``pitch`` in [0, pi), (n,) each."""
    rm = beta * a
    r = r0 + rm * torch.cos(theta)
    z = rm * torch.sin(theta)

    m = m_amu * ATOMIC_MASS_KG
    v_tot = torch.sqrt(torch.tensor(2.0 * e_kev * 1e3 * E_CHARGE / m, dtype=beta.dtype,
                                    device=beta.device))
    v_par = v_tot * torch.cos(pitch)
    v_perp = v_tot * torch.sin(pitch)
    b_r, b_z, b_phi = b_field(r, z)
    b_mag = torch.sqrt(b_r**2 + b_z**2 + b_phi**2)
    mu = m * v_perp**2 / (2.0 * b_mag)
    return GuidingCenterState(r, z, torch.zeros_like(r), v_par, mu)


def beta_2_5(generator: torch.Generator, n: int, dtype) -> torch.Tensor:
    """``n`` Beta(2, 5) variates, exactly: the 2nd smallest of 6 uniforms
    (the k-th of m uniforms is Beta(k, m + 1 - k)), on the generator's
    device."""
    u = torch.rand((n, 6), generator=generator, dtype=dtype, device=generator.device)
    return torch.sort(u, dim=1).values[:, 1]


def sample_fast_ion_birth(generator: torch.Generator, n: int, b_field: Callable, *, r0: float,
                          a: float, e_kev: float = ALPHA_BIRTH_KEV, m_amu: float = ALPHA_AMU,
                          dtype=torch.float32, device="cuda") -> GuidingCenterState:
    """Sample ``n`` fast-ion guiding centres: centrally peaked ``Beta(2,
    5)`` birth minor radius, uniform poloidal angle, isotropic pitch angle,
    drawn from ``generator``.  Returns a batched
    :class:`GuidingCenterState` (leading axis ``n``) on ``device``."""
    beta = beta_2_5(generator, n, dtype)
    theta = torch.rand((n,), generator=generator, dtype=dtype, device=generator.device) \
        * (2.0 * math.pi)
    pitch = torch.rand((n,), generator=generator, dtype=dtype, device=generator.device) \
        * math.pi
    return _sample_fast_ion_birth(beta.to(device), theta.to(device), pitch.to(device), b_field,
                                  r0=r0, a=a, e_kev=e_kev, m_amu=m_amu)


# ── ensemble follow + classification ─────────────────────────────────────


class EnsembleStats(NamedTuple):
    """Aggregate orbit statistics for one followed population."""

    n_passing: torch.Tensor
    n_trapped: torch.Tensor
    n_lost: torch.Tensor
    loss_fraction: torch.Tensor
    trapped_fraction: torch.Tensor      # of the CONFINED population
    energy_drift_rel_max: torch.Tensor  # over confined orbits
    final: GuidingCenterState


def ensemble_constants(m_amu: float, charge_z: float, dt: float, r_wall_in: float,
                       r_wall_out: float, z_wall: float, dtype, device) -> dict:
    """:func:`orbits.step_constants` and the walls, 0-d tensors of ``dtype``."""
    c = step_constants(m_amu, charge_z, dt, dtype, device)
    c.update({k: torch.tensor(v, dtype=dtype, device=device) for k, v in (
        ("r_in", r_wall_in), ("r_out", r_wall_out), ("z_wall", z_wall))})
    return c


def ensemble_energy(c: dict, b_field: Callable, y: tuple, mu: torch.Tensor) -> torch.Tensor:
    """``E = m v_par^2 / 2 + mu |B|`` at the state ``y`` = (r, z, phi, v_par)."""
    b_mag = field_with_gradient(b_field, y[0], y[1])[3]
    return c["half_m"] * (y[3] * y[3]) + mu * b_mag


def ensemble_step(c: dict, b_field: Callable, y: tuple, mu, lost, bounced, sign0):
    """One step of every particle (``fast_ions.py:185-197``): the RK4 step,
    the wall test on the new state, the freeze with the OLD ``lost``, then
    the bounce test on the state so taken.  Returns (y, lost, bounced)."""
    y_new = gc_rk4_step(c, y, mu, b_field)
    out = (y_new[0] > c["r_out"]) | (y_new[0] < c["r_in"]) | (torch.abs(y_new[1]) > c["z_wall"])
    y = tuple(torch.where(lost, yi, yn) for yi, yn in zip(y, y_new))
    lost = lost | out
    bounced = bounced | (~lost & (y[3] * sign0 < 0.0))
    return y, lost, bounced


def follow_ensemble(states: GuidingCenterState, b_field: Callable, *, m_amu: float,
                    charge_z: float, dt: float, n_steps: int, r_wall_in: float,
                    r_wall_out: float, z_wall: float) -> EnsembleStats:
    """Integrate every guiding centre and classify orbits.

    *Lost* if the orbit ever crosses the wall envelope (checked every step),
    *trapped* if ``v_par`` ever reverses sign (a bounce point), else
    *passing*; lost overrides trapped.  Lost particles freeze at their loss
    state.  The energy audit tracks ``E = m v_par^2/2 + mu |B|`` per
    surviving particle against its birth value.  With :func:`tokamak_field`
    this is row F's ``gc_ensemble`` (one launch on a CUDA tensor); the
    fractions are in the state's dtype.
    """
    from scpn_fusion_tpu_torch.ops import cuda_orbits

    c = ensemble_constants(m_amu, charge_z, dt, r_wall_in, r_wall_out, z_wall, states.r.dtype,
                           states.r.device)
    packed = torch.stack([states.r, states.z, states.phi, states.v_par, states.mu])
    run = (cuda_orbits.gc_ensemble if isinstance(b_field, TokamakField)
           else cuda_orbits.gc_ensemble_plain)
    return ensemble_stats(states, *run(c, b_field, packed, n_steps))


def ensemble_stats(states: GuidingCenterState, y_f, lost, bounced, drift) -> EnsembleStats:
    """The statistics of a followed population (``fast_ions.py:208-227``)
    from the per-particle results of row F or its plain twin: the final
    state (n, 4), the lost and bounced flags and the relative energy drift.
    The counts are int64, the fractions in the state's dtype."""
    dtype, device = states.r.dtype, states.r.device
    trapped = bounced & ~lost
    passing = ~bounced & ~lost
    n = states.r.shape[0]
    n_lost = torch.sum(lost)
    n_trapped = torch.sum(trapped)
    n_passing = torch.sum(passing)
    confined = torch.clamp(n - n_lost, min=1)
    final = GuidingCenterState(y_f[:, 0], y_f[:, 1], y_f[:, 2], y_f[:, 3], states.mu)
    return EnsembleStats(
        n_passing=n_passing,
        n_trapped=n_trapped,
        n_lost=n_lost,
        loss_fraction=torch.div(n_lost.to(dtype), torch.tensor(n, dtype=dtype, device=device)),
        trapped_fraction=torch.div(n_trapped.to(dtype), confined.to(dtype)),
        energy_drift_rel_max=torch.max(torch.where(lost, torch.zeros_like(drift), drift)),
        final=final,
    )


# ── prompt (first-orbit) loss ────────────────────────────────────────────


def first_orbit_loss(r0, a, ip_ma, *, e_kev: float = ALPHA_BIRTH_KEV,
                     m_amu: float = ALPHA_AMU, z: int = ALPHA_Z, dtype=None, device="cuda"):
    """Prompt-loss-zone width as a fraction of the minor radius:
    ``min(1, rho_pol / a)`` with ``rho_pol = m v / (Z e B_pol)`` and the
    edge poloidal field ``B_pol = mu0 Ip / (2 pi a)`` (an upper bound, since
    the birth profile is centrally peaked).  ``r0`` is accepted for
    signature parity but the scaling is R0-free."""
    del r0
    m = m_amu * ATOMIC_MASS_KG
    a, ip_ma, v2 = as_tensors(a, ip_ma, 2.0 * e_kev * 1e3 * E_CHARGE / m, dtype=dtype,
                              device=device)
    v = torch.sqrt(v2)
    b_pol = MU0 * (ip_ma * 1e6) / (2.0 * math.pi * a)
    rho_pol = m * v / (abs(z) * E_CHARGE * b_pol)
    return torch.minimum(torch.ones_like(rho_pol), rho_pol / a)


# ── collisional slowing-down (NRL / Stix 1972) ───────────────────────────


def coulomb_log_ei(te_kev, ne20, *, dtype=None, device="cuda"):
    """NRL electron-ion Coulomb logarithm (T_e > 10 eV):
    ``24 - ln(sqrt(n_e[cm^-3]) / T_e[eV])``."""
    te_kev, ne20 = as_tensors(te_kev, ne20, dtype=dtype, device=device)
    te_ev = te_kev * 1e3
    ne_cm3 = ne20 * 1e20 * 1e-6
    return 24.0 - torch.log(torch.sqrt(ne_cm3) / te_ev)


def critical_velocity(te_kev, ai_amu=DT_MEAN_ION_AMU, *, dtype=None, device="cuda"):
    """Stix critical velocity (electron drag == ion drag), m/s:
    ``v_c = (3 sqrt(pi)/4 · m_e/m_i)^(1/3) · sqrt(2 T_e / m_e)``."""
    te_kev, pi = as_tensors(te_kev, math.pi, dtype=dtype, device=device)
    te_j = te_kev * 1e3 * E_CHARGE
    v_te = torch.sqrt(2.0 * te_j / ELECTRON_MASS_KG)
    ratio = ELECTRON_MASS_KG / (ai_amu * ATOMIC_MASS_KG)
    return (3.0 * torch.sqrt(pi) / 4.0 * ratio) ** (1.0 / 3.0) * v_te


def tau_spitzer_electron(te_kev, ne20, *, m_amu: float = ALPHA_AMU, z: int = ALPHA_Z,
                         coulomb_log=None, dtype=None, device="cuda"):
    """Electron-drag (Spitzer) slowing-down time ``tau_se`` in seconds:
    ``3 (2 pi)^(3/2) eps0^2 m_f T_e^(3/2) / (m_e^(1/2) n_e Z^2 e^4 lnL)``."""
    te_kev, ne20, m_e = as_tensors(te_kev, ne20, ELECTRON_MASS_KG, dtype=dtype, device=device)
    lnl = (coulomb_log_ei(te_kev, ne20) if coulomb_log is None
           else torch.as_tensor(coulomb_log, dtype=te_kev.dtype, device=te_kev.device))
    te_j = te_kev * 1e3 * E_CHARGE
    m_f = m_amu * ATOMIC_MASS_KG
    n_e = ne20 * 1e20
    num = 3.0 * 2.0**1.5 * math.pi**1.5 * EPS0**2 * m_f * te_j**1.5
    den = torch.sqrt(m_e) * n_e * z**2 * E_CHARGE**4 * lnl
    return num / den


def slowing_down_time(v1, v2, v_c, tau_se, *, dtype=None, device="cuda"):
    """Time to slow from ``v1`` to ``v2``:
    ``(tau_se/3) ln[(v1^3 + v_c^3)/(v2^3 + v_c^3)]``."""
    v1, v2, v_c, tau_se = as_tensors(v1, v2, v_c, tau_se, dtype=dtype, device=device)
    return (tau_se / 3.0) * torch.log((v1**3 + v_c**3) / (v2**3 + v_c**3))


def heating_partition(v, v_c, *, dtype=None, device="cuda"):
    """(ion, electron) heating fractions at fast-ion speed ``v``:
    ``f_ion = v_c^3 / (v^3 + v_c^3)``."""
    v, v_c = as_tensors(v, v_c, dtype=dtype, device=device)
    f_ion = v_c**3 / (v**3 + v_c**3)
    return f_ion, 1.0 - f_ion
