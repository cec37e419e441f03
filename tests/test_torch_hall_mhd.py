"""Port parity: the pulsed Hall-MHD flux carrier (``models/physics/
hall_mhd_pulsed``) and the reduced Hall-MHD discovery sandbox
(``hall_mhd_discovery``), plain ops and ``torch.fft``.

In float64 on the CPU every result is within 1e-9 of JAX's (of its largest
magnitude; the carrier's source residual, rounding noise of its own
discrete equation, within 1e-12 absolutely): the four carrier cases of
``tests/test_physics_kernels.py`` (``TestHallMHD``) with their gates, the
rigid rotor feeding the carrier (``test_edge_orbits_frc.py:156-170``), the
Spitzer anchor and its agreement with ``disruption_sequence``; the
sandbox's wavenumbers, masks and current sheet, and its runs from JAX's
draws (``jax.random``, fed to the private twins) at 32^2 for 60 steps with
and without the sheet, a 2 x 2 sweep and a three-round bisection (bounds
equal to JAX's: the branches agree).  One case runs at the JAX tests' 64^2:
the unforced decay of ``test_hall_mhd_discovery.py`` (300 steps) with its
gates; the sweep and the bisection at their JAX-test sizes run on the card
(``chip_smoke.py`` (zg)).  A ramp that returns a Python float keeps the
working dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.models.physics import frc as jfrc
from scpn_fusion_tpu.models.physics import hall_mhd_discovery as jhd
from scpn_fusion_tpu.models.physics import hall_mhd_pulsed as jhp
from scpn_fusion_tpu_torch.models.physics import disruption_sequence as tds
from scpn_fusion_tpu_torch.models.physics import frc as tfrc
from scpn_fusion_tpu_torch.models.physics import hall_mhd_discovery as thd
from scpn_fusion_tpu_torch.models.physics import hall_mhd_pulsed as thp

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def _close(ours, ref, label=""):
    assert rel(ours, ref) <= TOL, (label, rel(ours, ref))


def _carrier_setup(n=65):
    rho = np.linspace(0.01, 0.5, n)
    return rho, 0.02 * np.sin(np.pi * rho / 0.5), np.zeros(n)


# label -> (params kwargs, psi0 zero?, ramp (a, b) of a + b t, dt, n_steps): the cases of
# test_physics_kernels.py TestHallMHD
CARRIER = {
    "decay": (dict(tau_psi_s=1e-3), False, (0.1, None), 1e-5, 200),
    "ramp drive": (dict(tau_psi_s=1.0), True, (0.1, 50.0), 1e-5, 100),
    "BE residual": (dict(tau_psi_s=1e-3), False, (0.1, 5.0), 1e-6, 10),
    "imex_rk2": (dict(tau_psi_s=1e-3, time_integrator="imex_rk2"), False, (0.1, 5.0), 1e-8, 50),
    "implicit_be": (dict(tau_psi_s=1e-3), False, (0.1, 5.0), 1e-8, 50),
}


def _carrier(case):
    kw, zero, (a, b), dt, steps = CARRIER[case]
    rho, psi0, j = _carrier_setup()
    psi0 = np.zeros_like(psi0) if zero else psi0
    ramp = (lambda t: a) if b is None else (lambda t: a + b * t)
    base = dict(electron_temperature_ev=50.0, r_null_m=0.3, **kw)
    ours = thp.run_hall_mhd_pulsed(thp.HallMHDPulsedParams(**base), torch.tensor(psi0),
                                   torch.tensor(rho), torch.tensor(j), ramp, dt, n_steps=steps)
    ref = jhp.run_hall_mhd_pulsed(jhp.HallMHDPulsedParams(**base), jnp.asarray(psi0),
                                  jnp.asarray(rho), jnp.asarray(j), ramp, dt, n_steps=steps)
    return ours, ref


def _carrier_same(ours, ref, case):
    (final, b_z, diags), (final_j, b_z_j, diags_j) = ours, ref
    assert final.psi.dtype == F64 and float(final.t_s) == pytest.approx(float(final_j.t_s), rel=1e-15)
    _close(final.psi, final_j.psi, case)
    _close(b_z, b_z_j, case)
    for name in diags_j._fields:
        a, b = getattr(diags, name), getattr(diags_j, name)
        if name == "source_residual_linf":
            assert np.max(np.abs(as_np(a) - np.asarray(b))) <= 1e-12, (case, name)
        elif np.any(np.asarray(b)):
            _close(a, b, (case, name))
        else:
            assert not bool(a.any()), (case, name)


@pytest.fixture(scope="module")
def carriers():
    return {case: _carrier(case) for case in CARRIER}


@pytest.mark.parametrize("case", list(CARRIER))
def test_carrier_matches_jax(carriers, case):
    _carrier_same(*carriers[case], case)


def test_carrier_gates(carriers):
    """``test_physics_kernels.py`` ``TestHallMHD``'s gates on the port."""
    rho, psi0, _ = _carrier_setup()
    final = carriers["decay"][0][0]
    ratio = float(final.psi.abs().max()) / np.max(np.abs(psi0))
    np.testing.assert_allclose(ratio, np.exp(-2.0), rtol=0.05)
    final, b_z, diags = carriers["ramp drive"][0]
    assert float(final.psi.abs().max()) > 0.0 and float(diags.hall_drive_l2[-1]) > 0.0
    assert bool(torch.isfinite(b_z).all())
    assert float(carriers["BE residual"][0][2].source_residual_linf.max()) < 1e-6
    np.testing.assert_allclose(carriers["implicit_be"][0][0].psi.numpy(),
                               carriers["imex_rk2"][0][0].psi.numpy(), rtol=1e-4, atol=1e-12)
    rho = torch.linspace(0.0, 1.0, 51, dtype=F64)
    np.testing.assert_allclose(thp.axial_field_from_flux(rho, 0.5 * rho**2).numpy(), 1.0,
                               rtol=1e-6)
    ref = jhp.axial_field_from_flux(jnp.asarray(rho.numpy()), 0.5 * jnp.asarray(rho.numpy())**2)
    _close(thp.axial_field_from_flux(rho, 0.5 * rho**2), ref)


def test_spitzer_anchor_and_cross_module():
    """eta(100 eV) against JAX's and the NRL parallel value, and the
    agreement with ``disruption_sequence.spitzer_resistivity`` at equal
    Z_eff and lnLambda (the Spitzer lane of ``run_physics_closures.py``)."""
    eta = float(thp.spitzer_resistivity_ohm_m(100.0, **CPU))
    assert eta == pytest.approx(float(jhp.spitzer_resistivity_ohm_m(jnp.asarray(100.0))), rel=TOL)
    np.testing.assert_allclose(eta, 1.65e-9 * 17.0 / 0.1**1.5, rtol=1e-6)
    np.testing.assert_allclose(eta, 0.51 * 1.03e-4 * 17.0 / 100.0**1.5, rtol=0.05)
    t_ev = torch.tensor([10.0, 100.0, 1000.0], dtype=F64)
    a = thp.spitzer_resistivity_ohm_m(t_ev, z_eff=1.5, ln_lambda=float(tds.LN_LAMBDA))
    _close(a, jhp.spitzer_resistivity_ohm_m(jnp.asarray(t_ev.numpy()), z_eff=1.5,
                                            ln_lambda=float(tds.LN_LAMBDA)))
    np.testing.assert_allclose(a.numpy(), tds.spitzer_resistivity(t_ev, z_eff=1.5).numpy(),
                               rtol=0.01)


def test_rigid_rotor_feeds_the_carrier():
    """``test_feeds_hall_mhd_carrier``: the rigid rotor's profiles (rho = 0
    skipped) through 100 carrier steps, against JAX's."""
    eq = tfrc.solve_rigid_rotor(b_external_t=0.5, separatrix_radius_m=0.3, **CPU)
    eq_j = jax.jit(lambda: jfrc.solve_rigid_rotor(b_external_t=0.5, separatrix_radius_m=0.3))()
    kw = dict(tau_psi_s=1e-3, electron_temperature_ev=50.0, r_null_m=float(eq.r_null))
    ramp = lambda t: 0.5 + 10.0 * t  # noqa: E731
    ours = thp.run_hall_mhd_pulsed(thp.HallMHDPulsedParams(**kw), eq.psi[1:], eq.rho[1:],
                                   eq.j_theta[1:], ramp, 1e-6, n_steps=100)
    ref = jhp.run_hall_mhd_pulsed(jhp.HallMHDPulsedParams(**kw), eq_j.psi[1:], eq_j.rho[1:],
                                  eq_j.j_theta[1:], ramp, 1e-6, n_steps=100)
    _carrier_same(ours, ref, "frc")
    assert bool(torch.isfinite(ours[0].psi).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_python_float_ramp_keeps_dtype(dtype):
    """A flat ramp (``lambda t: 0.1``) makes dB/dt a Python number; the
    carrier stays in the working dtype."""
    rho, psi0, j = (torch.tensor(x, dtype=dtype) for x in _carrier_setup())
    params = thp.HallMHDPulsedParams(tau_psi_s=1e-3, electron_temperature_ev=50.0, r_null_m=0.3)
    final, b_z, diags = thp.run_hall_mhd_pulsed(params, psi0, rho, j, lambda t: 0.1, 1e-5,
                                                n_steps=5)
    assert final.psi.dtype == b_z.dtype == diags.hall_drive_l2.dtype == dtype
    assert float(diags.hall_drive_l2.abs().max()) == 0.0
    with pytest.raises(ValueError):
        thp.HallMHDPulsedParams(tau_psi_s=1e-3, electron_temperature_ev=50.0, r_null_m=0.3,
                                time_integrator="rk4")


# ---- the discovery sandbox ----

def _draws(seed: int, n: int) -> torch.Tensor:
    """The two (n, n) normals of ``hall_mhd_discovery.py:51-53`` from ``PRNGKey(seed)``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (n, n)))
                                      for k in (k1, k2)]))


def test_spectral_setup_and_sheet():
    for n in (32, 64):
        ref = jax.jit(jhd._spectral_setup, static_argnums=0)(n)
        for a, b in zip(thd._spectral_setup(n, F64, "cpu"), ref):
            assert np.array_equal(a.numpy(), np.asarray(b))
    ours = thd.background_flux_k(64, 2.0, **CPU)
    ref = jax.jit(jhd.background_flux_k, static_argnums=0)(64, 2.0)
    assert np.max(np.abs(ours.numpy() - np.asarray(ref))) <= 1e-12
    psi0 = torch.fft.ifft2(ours).real.numpy()
    x = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    np.testing.assert_allclose(psi0[0, :], 2.0 * np.cos(x), atol=1e-10)
    np.testing.assert_allclose(psi0[10, :], psi0[0, :], atol=1e-10)
    assert thd.background_flux_k(32, 1.0, dtype=torch.float32, device="cpu").dtype \
        == torch.complex64


@pytest.mark.parametrize("amplitude", [0.0, 1.0])
def test_run_matches_jax(amplitude):
    s0 = thd._init_hall_mhd(_draws(1, 32))
    s0_j = jhd.init_hall_mhd(jax.random.PRNGKey(1), 32)
    for a, b in zip(s0, s0_j):
        _close(torch.view_as_real(a), np.stack([np.real(b), np.imag(b)], -1))
    tr = thd.run_hall_mhd(s0, eta=1e-4, background_amplitude=amplitude, n_steps=60, n=32)
    tr_j = jhd.run_hall_mhd(s0_j, eta=1e-4, background_amplitude=amplitude, n_steps=60, n=32)
    assert tr.final.phi_k.dtype == torch.complex128 and tr.total_energy.shape == (60,)
    _close(tr.total_energy, tr_j.total_energy, "total")
    _close(tr.zonal_energy, tr_j.zonal_energy, "zonal")
    for a, b in zip(tr.final, tr_j.final):
        _close(torch.view_as_real(a), np.stack([np.real(b), np.imag(b)], -1))
    assert bool((tr.zonal_energy <= tr.total_energy + 1e-12).all())
    again = thd.run_hall_mhd(s0, eta=1e-4, background_amplitude=amplitude, n_steps=60, n=32)
    assert torch.equal(again.total_energy, tr.total_energy)


def test_sweep_and_bisection_match_jax():
    """A 2 x 2 (eta, nu) sweep and a three-round bisection at 32^2 and 40
    steps a simulation, from JAX's draws: the grid, the growth rates and the
    bounds within 1e-9 of JAX's (every branch taken as JAX takes it)."""
    kw = dict(eta_range=(1e-5, 3e-3), nu_range=(1e-5, 1e-4), n_points=2, sim_steps=40, n=32)
    ours = thd._parameter_sweep(_draws(3, 32), **kw)
    ref = jhd.parameter_sweep(jax.random.PRNGKey(3), **kw)
    assert np.array_equal(ours[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(ours[1].numpy(), np.asarray(ref[1]))
    _close(ours[2], ref[2], "growth")
    kw = dict(eta_range=(1e-6, 1e-2), n_bisect=3, sim_steps=40, n=32)
    ours = thd._find_tearing_threshold(_draws(4, 32), **kw)
    ref = jhd.find_tearing_threshold(jax.random.PRNGKey(4), **kw)
    for name in ("lo", "hi", "threshold_eta"):
        assert ours[name].device.type == "cpu"
        _close(ours[name], ref[name], name)


def test_unforced_decay_at_64():
    """``test_unforced_run_decays_and_stays_finite`` at its 64^2 and 300
    steps from JAX's draw: within 1e-9 of JAX's energies, and its gates."""
    s0 = thd._init_hall_mhd(_draws(0, 64))
    tr = thd.run_hall_mhd(s0, n_steps=300)
    tr_j = jhd.run_hall_mhd(jhd.init_hall_mhd(jax.random.PRNGKey(0)), n_steps=300)
    _close(tr.total_energy, tr_j.total_energy, "total")
    e = tr.total_energy.numpy()
    assert np.all(np.isfinite(e)) and e[-1] < 5.0 * e.max() and e[-1] <= np.max(e[:50]) * 2.0


def test_public_functions_draw_from_a_generator():
    """The public functions draw from a ``torch.Generator``: the same seed
    gives the same state, and the private twin of those draws."""
    g = torch.Generator().manual_seed(7)
    s = thd.init_hall_mhd(torch.Generator().manual_seed(7), 16, **CPU)
    twin = thd._init_hall_mhd(torch.randn((2, 16, 16), generator=g, dtype=F64))
    assert all(torch.equal(a, b) for a, b in zip(s, twin))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            thd.init_hall_mhd(torch.Generator().manual_seed(7), 16)
