"""Port parity: Hasegawa-Wakatani drift waves (``models/physics/drift_wave``),
the divertor lab (``models/physics/divertor_lab``) and the stellarator lane
(``models/physics/stellarator``).

Drift waves run in float32 / complex64 in both packages (JAX forces them):
from JAX's noise fields the initial spectrum is within 1e-6 of JAX's (of its
largest magnitude: pocketfft on both sides, in another order), the
operators equal, and 50 steps at 32^2 (and ``simulate_probes`` 20 + 30)
within 1e-5 (a few float32 roundings of the spectrum's scale, grown over
the run); ``default_probe_indices`` truncates as JAX's.  The divertor and
stellarator functions in float64 within 1e-9 of JAX's (most equal), the
vapor shield's Picard count equal.  The gates of ``test_drift_wave_esn.py``
(its drift-wave half, the drive test at 64^2), ``test_divertor_lab.py``
and the stellarator cases of ``test_equilibrium_3d.py`` hold for the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.models.physics import divertor_lab as jd
from scpn_fusion_tpu.models.physics import drift_wave as jw
from scpn_fusion_tpu.models.physics import stellarator as js
from scpn_fusion_tpu_torch.models.physics import divertor_lab as td
from scpn_fusion_tpu_torch.models.physics import drift_wave as tw
from scpn_fusion_tpu_torch.models.physics import stellarator as ts

TOL = 1e-9
F32_TOL = 1e-5
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def close(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    a = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    return float(np.max(np.abs(a - ref))) <= tol * max(float(np.max(np.abs(ref))), 1e-300)


def noise_states(key, n: int):
    """(JAX's initial state, the port's from JAX's noise fields)."""
    cfg_j, cfg_t = jw.DriftWaveConfig(n=n), tw.DriftWaveConfig(n=n)
    k_phi, k_n = jax.random.split(key)
    draws = [torch.from_numpy(np.array(jax.random.normal(k, (n, n), jnp.float32)))
             for k in (k_phi, k_n)]
    return jw.initial_state(key, cfg_j), tw._initial_state(*draws, cfg_t)


@pytest.mark.parametrize("n", [32, 64])
def test_operators_equal_jax(n):
    ref = jw._operators(jw.DriftWaveConfig(n=n))
    ours = tw._operators(tw.DriftWaveConfig(n=n), device="cpu")
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b))


def test_initial_state_matches_jax_and_is_masked():
    sj, st = noise_states(jax.random.PRNGKey(0), 32)
    assert st.phi_k.dtype == torch.complex64
    for a, b in zip(st, sj):
        assert close(a, b, 1e-6)
    mask = tw._operators(tw.DriftWaveConfig(n=32), device="cpu").mask
    assert bool(torch.all(torch.abs(st.phi_k) * (1.0 - mask) == 0.0))
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    a = tw.initial_state(g1, tw.DriftWaveConfig(n=32), device="cpu")
    b = tw.initial_state(g2, tw.DriftWaveConfig(n=32), device="cpu")
    assert torch.equal(a.phi_k, b.phi_k)


def test_steps_match_jax_and_keep_the_mean_mode():
    """50 steps at 32^2; ``test_step_preserves_mean_mode_and_boundedness``'s
    gates after the first 5."""
    sj, st = noise_states(jax.random.PRNGKey(1), 32)
    cfg_j, cfg_t = jw.DriftWaveConfig(n=32), tw.DriftWaveConfig(n=32)
    ops_j, ops_t = jw._operators(cfg_j), tw._operators(cfg_t, device="cpu")
    mean0 = complex(st.phi_k[0, 0])
    for k in range(50):
        sj, st = jw.step(sj, cfg_j, ops_j), tw.step(st, cfg_t, ops_t)
        if k == 4:
            phi, _ = tw.real_fields(st)
            assert complex(st.phi_k[0, 0]) == pytest.approx(mean0, abs=1e-6)
            assert bool(torch.isfinite(phi).all())
            assert float(torch.max(torch.abs(st.phi_k))) <= cfg_t.clamp_amp * (1 + 1e-5)
    for a, b in zip(st, sj):
        assert close(a, b, F32_TOL)
    for a, b in zip(tw.real_fields(st), jw.real_fields(sj)):
        assert close(a, b, F32_TOL)


def test_the_clamp_rescales_as_jax():
    """A spectrum above the cap (max |phi_k| 300): the step rescales it to
    100."""
    sj, st = noise_states(jax.random.PRNGKey(5), 32)
    scale = 300.0 / float(torch.max(torch.abs(st.phi_k)))
    sj = jw.DriftWaveState(sj.phi_k * scale, sj.n_k * scale)
    st = tw.DriftWaveState(st.phi_k * scale, st.n_k * scale)
    cfg_j, cfg_t = jw.DriftWaveConfig(n=32), tw.DriftWaveConfig(n=32)
    rj, rt = jw.step(sj, cfg_j), tw.step(st, cfg_t)
    assert float(torch.max(torch.abs(rt.phi_k))) == pytest.approx(100.0, rel=1e-6)
    for a, b in zip(rt, rj):
        assert close(a, b, F32_TOL)


def test_simulate_probes_matches_jax():
    sj, st = noise_states(jax.random.PRNGKey(3), 32)
    cfg_j, cfg_t = jw.DriftWaveConfig(n=32), tw.DriftWaveConfig(n=32)
    fj, pj = jw.simulate_probes(sj, cfg_j, jw.default_probe_indices(32, 16), 20, 30)
    ft, pt = tw.simulate_probes(st, cfg_t, tw.default_probe_indices(32, 16, device="cpu"), 20, 30)
    assert pt.shape == (30, 16) and pt.dtype == torch.float32
    assert close(pt, pj, F32_TOL) and close(ft.phi_k, fj.phi_k, F32_TOL)


@pytest.mark.parametrize("n,k", [(64, 16), (64, 8), (32, 16), (48, 7), (100, 16), (13, 5)])
def test_default_probe_indices_truncate_as_jax(n, k):
    ref = np.asarray(jw.default_probe_indices(n, k))
    ours = tw.default_probe_indices(n, k, device="cpu")
    assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)


def test_density_gradient_drive_pumps_fluctuations():
    """``test_density_gradient_drive_pumps_fluctuations`` at its 64^2, 800 +
    200 steps, from the test's own draw (PRNGKey(2)), which
    ``bench_config.DRIFT_WAVE_JAX_NOISE`` holds: the gate depends on the draw
    (JAX's keys 0, 1, 3 and 4 miss it)."""
    from scpn_fusion_tpu_torch.bench_config import DRIFT_WAVE_JAX_NOISE
    noise = np.load(DRIFT_WAVE_JAX_NOISE)
    k_phi, k_n = jax.random.split(jax.random.PRNGKey(2))
    assert noise.dtype == np.float32 and noise.shape == (2, 64, 64)
    for field, key in zip(noise, (k_phi, k_n)):
        assert np.array_equal(field, np.asarray(jax.random.normal(key, (64, 64), jnp.float32)))
    st = tw._initial_state(torch.from_numpy(noise[0]), torch.from_numpy(noise[1]),
                           tw.DriftWaveConfig(n=64))
    probe_idx = tw.default_probe_indices(64, 8, device="cpu")
    var = {}
    for kappa in (0.0, 2.0):
        cfg = tw.DriftWaveConfig(n=64, kappa=kappa)
        _, probes = tw.simulate_probes(st, cfg, probe_idx, warmup=800, steps=200)
        assert probes.shape == (200, 8) and bool(torch.isfinite(probes).all())
        var[kappa] = float(torch.var(probes, unbiased=False))
    assert var[2.0] > 2.0 * var[0.0]


LOAD = (80.0, 2.1, 2.5)


@pytest.mark.parametrize("kw", [dict(expansion_factor=15.0), dict(f_rad=0.9), {},
                                dict(expansion_factor=5.0, f_rad=0.3, q95=4.0)])
def test_heat_load_matches_jax(kw):
    ref = jd.divertor_heat_load(*LOAD, **kw)
    ours = td.divertor_heat_load(*LOAD, **kw, **CPU)
    for a, b in zip(ours, ref):
        assert a.dtype == F64 and float(a) == pytest.approx(float(b), rel=1e-14, abs=0.0)


@pytest.mark.parametrize("q", [1.9e9, 1e6, 3e9, 2e10])
def test_lithium_shield_matches_jax_with_its_iterations(q):
    """Loads where the Picard map converges (22-61 iterations).  Between
    ~4e7 and ~1e8 W/m^2 it does not converge in 200 and wanders, so rounding
    alone (XLA's pow is not libm's) moves its 200th iterate."""
    ref = jd.lithium_vapor_shield(q)
    ours = td.lithium_vapor_shield(q, **CPU)
    assert int(ours.iterations) == int(ref.iterations) > 0
    for a, b in zip(ours[:3], ref[:3]):
        assert float(a) == pytest.approx(float(b), rel=TOL, abs=0.0)


def test_divertor_gates():
    """``test_divertor_lab.py``'s gates on the port."""
    load = td.divertor_heat_load(*LOAD, expansion_factor=15.0, **CPU)
    np.testing.assert_allclose(float(load.lambda_q_m), 0.63e-3 * 2.5 ** (-1.19), rtol=1e-12)
    assert float(load.q_parallel) > 1e9
    assert float(load.q_target) == float(load.q_parallel) / 15.0
    assert float(load.t_upstream_ev) > float(load.t_target_ev) > 0.0
    hot = td.divertor_heat_load(*LOAD, f_rad=0.0, **CPU)
    cool = td.divertor_heat_load(*LOAD, f_rad=0.9, **CPU)
    assert float(cool.q_target) < 0.2 * float(hot.q_target)
    assert float(cool.t_target_ev) < float(hot.t_target_ev)
    w = td.tungsten_monoblock(load.q_target)
    assert bool(w.melted) and float(w.t_surface_c) > td.W_MELT_C
    li = td.lithium_vapor_shield(load.q_target)
    assert 0.5 < float(li.f_rad) <= 0.98
    assert float(li.q_surface) < 0.05 * float(load.q_target) and float(li.t_surface_c) < 2000.0
    assert int(li.iterations) > 0
    np.testing.assert_allclose(float(li.t_surface_c), 300.0 + float(li.q_surface) * 0.005 / 150.0,
                               atol=2.0)
    dp_b0, ha0 = td.mhd_pressure_loss(1.0, 1e-6, **CPU)
    dp_b, ha = td.mhd_pressure_loss(1.0, 2.5, **CPU)
    assert float(ha) > 100.0 > float(ha0) and float(dp_b) > float(dp_b0)
    assert float(td.evaporation_rate(900.0, 1.0, **CPU)) > float(td.evaporation_rate(500.0, 1.0,
                                                                                     **CPU))
    assert float(td.evaporation_rate(700.0, 9.0, **CPU)) < float(td.evaporation_rate(700.0, 0.1,
                                                                                     **CPU))
    v = torch.tensor([0.5, 2.0, 8.0, 20.0], dtype=F64)
    idx = td.flow_velocity_scan(v, *LOAD).stability_index
    assert bool(torch.all(torch.diff(idx) > 0.0))
    one = td.temhd_liquid_metal_state(2.0, *LOAD, **CPU)
    np.testing.assert_allclose(float(idx[1]), float(one.stability_index), rtol=1e-6)


def test_divertor_scan_and_monoblock_match_jax():
    v = [0.5, 2.0, 8.0, 20.0]
    for p_sol in (80.0, 20.0):
        ref = jd.flow_velocity_scan(jnp.asarray(v), p_sol, 2.1, 2.5)
        ours = td.flow_velocity_scan(torch.tensor(v, dtype=F64), p_sol, 2.1, 2.5)
        for a, b in zip(ours, ref):
            assert a.shape == (4,)
            assert (np.array_equal(a.numpy(), np.asarray(b)) if a.dtype == torch.bool
                    else close(a, b))
    for a, b in zip(td.tungsten_monoblock(1.9e9, **CPU), jd.tungsten_monoblock(1.9e9)):
        assert float(a) == float(b)
    for a, b in zip(td.mhd_pressure_loss(torch.tensor(v, dtype=F64), 2.5),
                    jd.mhd_pressure_loss(jnp.asarray(v), 2.5)):
        assert close(a, b)
    assert close(td.evaporation_rate(torch.tensor([300.0, 900.0, 4000.0], dtype=F64), 2.0),
                 jd.evaporation_rate(jnp.asarray([300.0, 900.0, 4000.0]), 2.0))


@pytest.mark.parametrize("s", [0.5, 1.0, 0.05, 0.0])
def test_stellarator_matches_jax(s):
    cj, ct = js.w7x_config(), ts.w7x_config()
    for a, b in zip(ts.stellarator_flux_surface(ct, s, n_theta=32, n_phi=40, **CPU),
                    js.stellarator_flux_surface(cj, s, n_theta=32, n_phi=40)):
        assert a.shape == (32, 40) and close(a, b)
    assert close(ts.effective_ripple(ct, s, **CPU), js.effective_ripple(cj, s))
    for t_kev, n_e19 in ((1.0, 5.0), (4.0, 5.0), (10.0, 0.5)):
        assert close(ts.stellarator_neoclassical_chi(ct, s, t_kev, n_e19, **CPU),
                     js.stellarator_neoclassical_chi(cj, s, t_kev, n_e19))


def test_stellarator_gates():
    """The stellarator cases of ``test_equilibrium_3d.py:140-170`` and the
    lanes of ``validation/run_stellarator_lane.py`` on the port."""
    cfg = ts.w7x_config()
    assert float(ts.iota_profile(cfg, 0.0, **CPU)) == pytest.approx(0.85)
    assert float(ts.iota_profile(cfg, 1.0, **CPU)) == pytest.approx(0.97)
    r, z, b = ts.stellarator_flux_surface(cfg, 0.5, n_theta=32, n_phi=40, **CPU)
    assert r.shape == (32, 40) and bool(torch.all(b > 0.0)) and float(torch.std(b[0, :])) > 1e-4
    eps_mid = float(ts.effective_ripple(cfg, 0.5, **CPU))
    assert 0.0 < eps_mid < 1.0 and float(ts.effective_ripple(cfg, 1.0, **CPU)) > eps_mid
    axi = ts.StellaratorConfig(mirror_ratio=0.0, helical_excursion=0.0)
    zero = ts.effective_ripple(axi, 0.5, **CPU)
    assert zero.dtype == F64 and float(zero) == 0.0
    t1 = float(ts.iss04_tau_e(cfg, 5.0, 2.0, **CPU))
    t2 = float(ts.iss04_tau_e(cfg, 5.0, 4.0, **CPU))
    assert t2 < t1 and t2 / t1 == pytest.approx(2.0**-0.61, rel=1e-6)
    chi_lo = float(ts.stellarator_neoclassical_chi(cfg, 0.5, 1.0, 5.0, **CPU))
    assert chi_lo > 0.0 and float(ts.stellarator_neoclassical_chi(cfg, 0.5, 4.0, 5.0,
                                                                  **CPU)) > chi_lo
    # run_stellarator_lane.py lanes 1-3
    tau = float(ts.iss04_tau_e(cfg, 8.0, 5.0, **CPU))
    iota23 = float(ts.iota_profile(cfg, 2.0 / 3.0, **CPU))
    tau_lit = (0.134 * cfg.a**2.28 * cfg.r0**0.64 * 5.0**-0.61 * 8.0**0.54 * cfg.b0**0.84
               * iota23**0.41)
    assert abs(tau - tau_lit) / tau_lit < 1e-10
    e_p = np.log(float(ts.iss04_tau_e(cfg, 8.0, 5.5, **CPU)) / tau) / np.log(1.1)
    assert abs(e_p + 0.61) < 1e-6
    axi = dataclasses.replace(cfg, mirror_ratio=0.0, helical_excursion=0.0)
    assert float(ts.effective_ripple(axi, 0.5, **CPU)) == 0.0 and 0.0 < eps_mid < 0.1
    assert 0.05 < tau < 0.5
    chi_hi = float(ts.stellarator_neoclassical_chi(cfg, 0.5, 10.0, 5.0, **CPU))
    assert abs(np.log(chi_hi / chi_lo) / np.log(10.0) - 2.5) < 0.125
    big = dataclasses.replace(cfg, mirror_ratio=cfg.mirror_ratio * 2.0)
    assert float(ts.stellarator_neoclassical_chi(big, 0.5, 1.0, 5.0, **CPU)) > chi_lo


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: tw.initial_state(torch.Generator().manual_seed(0)),
                 lambda: td.divertor_heat_load(*LOAD),
                 lambda: ts.stellarator_flux_surface(ts.w7x_config(), 0.5),
                 lambda: ts.effective_ripple(ts.w7x_config(), 0.5)):
        with pytest.raises((AssertionError, RuntimeError)):
            call()
