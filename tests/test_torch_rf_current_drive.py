"""Port parity: ICRH ray tracing and deposition, ECRH deposition
(``models/physics/rf_heating``) and the current-drive sources
(``models/physics/current_drive``).

In float64 on the CPU: the ray bundle (6 rays x 80 steps, the size of
``test_rays_launch_inward_and_stay_finite``) within 1e-9 of JAX's, its
frozen masks equal; its deposition within 1e-9; the dispersion and its
``torch.func.grad`` (the sigmoid and log10 gate included) within 1e-13 of
JAX's and ``jax.grad``; ECRH's float64 radial grid and deposition within
1e-9 and its float32 efficiency equal to JAX's float32 one; every source's
profiles and the mix's integrated currents within 1e-12.  The gates of
``tests/test_rf_current_drive.py`` hold for the port: the ICRH ones on the
6 x 80 bundle (JAX's tests also trace 4 x 60 and 8 x 100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.models.physics import current_drive as jc
from scpn_fusion_tpu.models.physics import rf_heating as jr
from scpn_fusion_tpu_torch.models.physics import current_drive as tc
from scpn_fusion_tpu_torch.models.physics import rf_heating as tr

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def close(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    return float(np.max(np.abs(as_np(ours) - ref))) <= tol * max(float(np.max(np.abs(ref))),
                                                                 1e-300)


@pytest.fixture(scope="module")
def bundles():
    p = jr.ICRHParams()
    return (jr.trace_icrh_rays(p, n_rays=6, n_steps=80),
            tr.trace_icrh_rays(tr.ICRHParams(), n_rays=6, n_steps=80, **CPU))


def test_ray_bundle_matches_jax(bundles):
    rj, rt = bundles
    for name in ("r", "z", "k_r", "k_z"):
        assert getattr(rt, name).shape == (6, 80)
        assert close(getattr(rt, name), getattr(rj, name)), name
    assert torch.equal(rt.frozen, torch.from_numpy(np.array(rj.frozen)))


def test_rays_launch_inward_and_stay_finite(bundles):
    _, rays = bundles
    r = as_np(rays.r)
    assert np.all(np.isfinite(r)) and np.all(np.isfinite(as_np(rays.z)))
    assert np.all(r[:, 10] < 9.0)


def test_frozen_rays_hold_last_state(bundles):
    _, rays = bundles
    frozen, r = rays.frozen.numpy(), as_np(rays.r)
    for i in range(frozen.shape[0]):
        idx = np.nonzero(frozen[i])[0]
        if idx.size > 1:
            np.testing.assert_array_equal(r[i, idx], r[i, idx[0]])


def test_a_ray_freezes_at_its_last_finite_state():
    """A launch wavenumber of 1e160 m^-1: k^2 overflows, the first step's
    state is not finite, and every ray holds its launch state, as JAX's (8
    rays x 40 steps, the masks equal and all set)."""
    pj, pt = jr.ICRHParams(k0=1e160), tr.ICRHParams(k0=1e160)
    rj = jr.trace_icrh_rays(pj, n_rays=8, n_steps=40)
    rt = tr.trace_icrh_rays(pt, n_rays=8, n_steps=40, **CPU)
    assert bool(rt.frozen.all())
    assert torch.equal(rt.frozen, torch.from_numpy(np.array(rj.frozen)))
    for name in ("r", "z", "k_r", "k_z"):
        assert close(getattr(rt, name), getattr(rj, name)), name
    assert bool(torch.all(rt.r == pt.r_antenna)) and bool(torch.all(rt.k_r == -pt.k0))


def test_power_deposition_matches_jax_and_conserves(bundles):
    rj, rt = bundles
    ref = jr.icrh_power_deposition(jr.ICRHParams(), rj, 20.0)
    ours = tr.icrh_power_deposition(tr.ICRHParams(), rt, 20.0)
    for a, b in zip(ours, ref):
        assert close(a, b)
    rho, p_dep, eff = ours
    assert p_dep.shape == (50,) and bool(torch.all(p_dep >= 0))
    assert 0.01 < float(eff) <= 1.0 and float(p_dep.sum()) > 0


@pytest.mark.parametrize("point", [(12.0, 5.0, -10.0, 0.0), (7.5, 0.4, -10.0, 2.0),
                                   (6.3, -0.2, -30.0, 5.0), (9.0, 1.0, -10.0, 0.0)])
def test_dispersion_and_its_gradient_match_jax(point):
    """The Hamiltonian and ``torch.func.grad`` of it (through ``torch.sigmoid``
    and ``log10``) against ``jax.grad``, within 1e-13 of the gradient's
    scale."""
    pj, pt = jr.ICRHParams(), tr.ICRHParams()
    d_ref = jr.icrh_dispersion(pj, *point)
    d = tr.icrh_dispersion(pt, *point, **CPU)
    assert abs(float(d) - float(d_ref)) <= 1e-13 * max(abs(float(d_ref)), 1.0)
    g_ref = np.asarray(jax.grad(lambda s: jr.icrh_dispersion(pj, s[0], s[1], s[2], s[3]))(
        jnp.asarray(point)))
    g = torch.func.grad(lambda s: tr.icrh_dispersion(pt, s[0], s[1], s[2], s[3]))(
        torch.tensor(point, dtype=F64))
    assert np.max(np.abs(g.numpy() - g_ref)) <= 1e-13 * np.max(np.abs(g_ref))


def test_resonances():
    np.testing.assert_allclose(tr.ICRHParams().b_resonance, 6.55, rtol=0.02)
    np.testing.assert_allclose(float(tr.icrh_dispersion(tr.ICRHParams(), 12.0, 5.0, -10.0, 0.0,
                                                        **CPU)), 1.0, atol=1e-3)
    np.testing.assert_allclose(tr.ECRHParams(freq_ghz=170.0, harmonic=1).resonance_radius, 5.41,
                               rtol=0.02)
    np.testing.assert_allclose(tr.ECRHParams(harmonic=2).resonance_radius,
                               2 * tr.ECRHParams(harmonic=1).resonance_radius, rtol=1e-9)


@pytest.mark.parametrize("kw", [{}, dict(launch_angle_deg=25.0, t_e_kev=4.0, n_e_m3=3e19),
                                dict(harmonic=2)])
def test_ecrh_deposition_matches_jax(kw):
    """The float64 grid and deposition within 1e-9, the float32 efficiency
    equal to JAX's (its temperature, density and angle are float32 in
    both)."""
    params = {k: kw.pop(k) for k in list(kw) if k == "harmonic"}
    pj, pt = jr.ECRHParams(**params), tr.ECRHParams(**params)
    ref = jr.ecrh_deposition(pj, **kw)
    ours = tr.ecrh_deposition(pt, **kw, **CPU)
    assert ours[0].dtype == F64 and ours[1].dtype == F64 and ours[2].dtype == torch.float32
    assert np.asarray(ref[2]).dtype == np.float32
    assert close(ours[0], ref[0]) and close(ours[1], ref[1])
    assert float(ours[2]) == float(ref[2])


def test_ecrh_gates():
    p = tr.ECRHParams()
    rho, p_dep, eff = tr.ecrh_deposition(p, p_ecrh_mw=20.0, **CPU)
    rho_res = abs(p.resonance_radius - p.r0_major) / p.a_minor
    assert abs(float(rho[int(torch.argmax(p_dep))]) - rho_res) < 0.1
    assert 0.01 <= float(eff) <= 0.9901
    angle = torch.tensor(10.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(tr.ecrh_deposition(p, launch_angle_deg=angle, **CPU)[2], angle)
    g_ref = float(jax.grad(lambda a: jr.ecrh_deposition(jr.ECRHParams(),
                                                        launch_angle_deg=a)[2])(10.0))
    assert np.isfinite(float(g)) and float(g) == pytest.approx(g_ref, rel=1e-5, abs=1e-9)


def _profiles(nr=50):
    rho = np.linspace(0.0, 1.0, nr)
    return rho, 8.0 * (1 - rho**2) ** 0.5 + 1.0, 20.0 * (1 - rho**2) + 0.5


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.tensor(a, dtype=F64) for a in arrays])


SOURCES = {
    "eccd": (jc.ECCDSource(p_mw=10.0, rho_dep=0.3, sigma_rho=0.08),
             tc.ECCDSource(p_mw=10.0, rho_dep=0.3, sigma_rho=0.08)),
    "lhcd": (jc.LHCDSource(p_mw=10.0, rho_dep=0.5, sigma_rho=0.1),
             tc.LHCDSource(p_mw=10.0, rho_dep=0.5, sigma_rho=0.1)),
    "nbi": (jc.NBISource(33.0, 1000.0, 0.2), tc.NBISource(33.0, 1000.0, 0.2)),
    "zero width": (jc.ECCDSource(5.0, 0.4, 0.0), tc.ECCDSource(5.0, 0.4, 0.0)),
}


@pytest.mark.parametrize("name", list(SOURCES))
def test_source_profiles_match_jax(name):
    src_j, src_t = SOURCES[name]
    (rho_j, ne_j, te_j), (rho_t, ne_t, te_t) = _both(*_profiles())
    assert close(src_t.j_cd(rho_t, ne_t, te_t), src_j.j_cd(rho_j, ne_j, te_j), 1e-12)
    heat = "p_heating" if name == "nbi" else "p_absorbed"
    assert close(getattr(src_t, heat)(rho_t), getattr(src_j, heat)(rho_j), 1e-12)


def test_mix_matches_jax_and_its_gates():
    """``test_mix_totals``: the integrated current with a scalar and with a
    kappa(rho) elongation (``jnp.gradient`` of the area), within 1e-12."""
    mj = jc.CurrentDriveMix(a_minor=2.0).with_source(jc.ECCDSource(10.0, 0.3, 0.08)) \
        .with_source(jc.NBISource(33.0, 1000.0, 0.2))
    mt = tc.CurrentDriveMix(a_minor=2.0).with_source(tc.ECCDSource(10.0, 0.3, 0.08)) \
        .with_source(tc.NBISource(33.0, 1000.0, 0.2))
    (rho_j, ne_j, te_j), (rho_t, ne_t, te_t) = _both(*_profiles())
    kappa = 1.4 + 0.3 * _profiles()[0] ** 2
    assert close(mt.total_j_cd(rho_t, ne_t, te_t, te_t), mj.total_j_cd(rho_j, ne_j, te_j, te_j),
                 1e-12)
    assert close(mt.total_heating_power(rho_t), mj.total_heating_power(rho_j), 1e-12)
    for el_j, el_t in ((1.0, 1.0), (1.7, 1.7), (jnp.asarray(kappa), torch.tensor(kappa))):
        ref = float(mj.total_driven_current(rho_j, ne_j, te_j, te_j, elongation=el_j))
        ours = float(mt.total_driven_current(rho_t, ne_t, te_t, te_t, elongation=el_t))
        assert abs(ours - ref) <= 1e-12 * abs(ref), (ours, ref)
    i_tot = float(mt.total_driven_current(rho_t, ne_t, te_t, te_t, elongation=1.7))
    assert np.isfinite(i_tot) and i_tot > float(mt.total_driven_current(rho_t, ne_t, te_t, te_t))
    assert bool(torch.all(mt.total_j_cd(rho_t, ne_t, te_t, te_t) >= 0))


def test_current_drive_gates():
    """``test_eccd_profile_and_current``, ``test_lhcd_more_efficient_than_eccd``
    and ``test_nbi_slowing_down_finite_f32``."""
    rho, ne, te = (torch.tensor(a, dtype=F64) for a in _profiles())
    src = tc.ECCDSource(p_mw=10.0, rho_dep=0.3, sigma_rho=0.08)
    j = src.j_cd(rho, ne, te)
    assert bool(torch.all(j >= 0)) and abs(float(rho[int(torch.argmax(j))]) - 0.3) < 0.1
    np.testing.assert_allclose(float(torch.sum(src.p_absorbed(rho)) * (rho[1] - rho[0])), 10e6,
                               rtol=0.05)
    ec = tc.ECCDSource(p_mw=10.0, rho_dep=0.5, sigma_rho=0.1)
    lh = tc.LHCDSource(p_mw=10.0, rho_dep=0.5, sigma_rho=0.1)
    assert float(lh.j_cd(rho, ne, te).max()) > 2.0 * float(ec.j_cd(rho, ne, te).max())
    nbi = tc.NBISource(p_mw=33.0, e_beam_kev=1000.0, rho_tangency=0.2)
    j32 = nbi.j_cd(rho.float(), ne.float(), te.float())
    assert j32.dtype == torch.float32 and bool(torch.all(torch.isfinite(j32)))
    assert bool(torch.all(j32 >= 0)) and float(j32.max()) > 0
    assert float(nbi.j_cd(rho, ne, 2.0 * te).max()) > float(j32.max())
    ref = np.asarray(jc.NBISource(33.0, 1000.0, 0.2).j_cd(*(jnp.asarray(a, jnp.float32)
                                                            for a in _profiles())))
    assert np.max(np.abs(j32.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tr.trace_icrh_rays(tr.ICRHParams(), n_rays=2, n_steps=2)
    with pytest.raises((AssertionError, RuntimeError)):
        tr.ecrh_deposition(tr.ECRHParams())
