"""Port parity: the MHD mode models (``models/physics/mhd_modes``), the
sawtooth cycle (``sawtooth``), the stability suite (``stability_mhd``), the
ELM cycle (``elm``) and the edge events (``edge_events``).

In float64 on the CPU every result is within 1e-9 (of the largest finite
magnitude; NaNs in the same places) of JAX's: the TAE screen, Delta', the
Rutherford island (5000 steps) and locked-mode (3000) evolutions, MRTI; the
q=1 radius, the Kadomtsev crash and the sawtooth step (the no-crash NaN
branches included); the q-profile, the seven criteria and the full check,
and the eigenvalue ballooning lane (``ballooning_stability_eigen``, row B's
plain twin on the CPU); the ELM limits, crash and 3000-step limit cycle;
the pellet flight (400 ticks, three profiles), blobs and MARFE onset.  The
gates of ``tests/test_mhd_modes.py``, the stability parts of
``test_stability_scaling.py``, the eigen lane of ``test_ballooning.py:87-103``,
the ELM parts of ``test_elm_impurity.py``, the sawtooth cases of
``test_edge_orbits_frc.py`` and the pellet, blob and MARFE cases of
``test_disruption_edge_events.py`` hold for the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.models.physics import edge_events as je
from scpn_fusion_tpu.models.physics import elm as jl
from scpn_fusion_tpu.models.physics import mhd_modes as jm
from scpn_fusion_tpu.models.physics import sawtooth as jsw
from scpn_fusion_tpu.models.physics import stability_mhd as jst
from scpn_fusion_tpu_torch.models.physics import edge_events as te
from scpn_fusion_tpu_torch.models.physics import elm as tl
from scpn_fusion_tpu_torch.models.physics import mhd_modes as tm
from scpn_fusion_tpu_torch.models.physics import sawtooth as tsw
from scpn_fusion_tpu_torch.models.physics import stability_mhd as tst

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def _close(ours, ref) -> bool:
    a, b = as_np(ours), np.asarray(ref, dtype=np.float64)
    if a.shape != b.shape:
        return False
    fin = np.isfinite(b)
    if not np.array_equal(np.isnan(a), np.isnan(b)) or not np.array_equal(a[np.isinf(b)],
                                                                        b[np.isinf(b)]):
        return False
    return not fin.any() or rel(a[fin], b[fin]) <= TOL


def _same(ours, ref, label=""):
    """Every field of two result tuples (nested ones too) agrees."""
    for name, a, b in zip(ref._fields, ours, ref):
        if hasattr(b, "_fields"):
            _same(a, b, f"{label}.{name}")
        elif np.asarray(b).dtype == bool:
            assert np.array_equal(as_np(a).astype(bool), np.asarray(b)), (label, name)
        else:
            assert _close(a, b), (label, name)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


# ── MHD modes ──

def test_tae_and_mrti_match_jax_and_gates():
    f = tm.tae_frequency(5.3, 10.0, 1.5, 6.2, **CPU)
    assert _close(f, jm.tae_frequency(5.3, 10.0, 1.5, 6.2)) and 3e4 < float(f) < 3e5
    v1, v2 = (tm.alfven_speed(b, 10.0, **CPU) for b in (5.0, 10.0))
    assert _close(v1, jm.alfven_speed(5.0, 10.0)) and float(v2) == pytest.approx(2.0 * float(v1))
    for kw in (dict(beta_fast_pct=0.1, v_fast_over_va=0.8), dict(beta_fast_pct=8.0,
                                                                 v_fast_over_va=1.8)):
        base = dict(b_t=5.3, n_i_19=10.0, q=1.5, r0_m=6.2, a_m=2.0, **kw)
        ours, ref = tm.tae_stability(**base, **CPU), jm.tae_stability(**base)
        _same(ours, ref, "tae")
        assert bool(ours.unstable) == (kw["beta_fast_pct"] == 8.0)
    cases = [dict(g_eff_m_s2=1e9, k_m=100.0, b_t=0.0, n_i_19=1.0),
             dict(g_eff_m_s2=1e9, k_m=1e6, b_t=2.0, n_i_19=0.01, theta_kb_rad=0.0),
             dict(g_eff_m_s2=1e9, k_m=1e6, b_t=2.0, n_i_19=0.01, theta_kb_rad=np.pi / 2),
             dict(g_eff_m_s2=1e9, k_m=1.0, b_t=2.0, n_i_19=0.01)]
    out = []
    for kw in cases:
        ours = tm.mrti_growth_rate(**kw, **CPU)
        _same(ours, jm.mrti_growth_rate(**kw), "mrti")
        out.append(ours)
    assert float(out[0].gamma_s) == pytest.approx(np.sqrt(1e9 * 100.0), rel=1e-6)
    assert bool(out[1].stabilised) and not bool(out[2].stabilised)
    at_cut = tm.mrti_growth_rate(g_eff_m_s2=1e9, k_m=float(out[3].k_cutoff_m) * 1.01, b_t=2.0,
                                 n_i_19=0.01, **CPU)
    assert bool(at_cut.stabilised)


def _tearing_profile(width):
    rho = np.linspace(0.01, 1.0, 64)
    return rho, 1.0 + 2.5 * rho ** 2, np.exp(-(rho / width) ** 2)


def test_delta_prime_matches_jax_and_gates():
    res = {}
    for width in (0.632, 0.15, 0.4):
        rho, q, j = _tearing_profile(width)
        for m, n in ((2, 1), (3, 1), (7, 1)):
            ours = tm.delta_prime_cylindrical(_t(rho), _t(q), _t(j), 2.0, m=m, n=n)
            _same(ours, jm.delta_prime_cylindrical(jnp.asarray(rho), jnp.asarray(q),
                                                   jnp.asarray(j), 2.0, m=m, n=n), "delta'")
            res[width, m] = ours
    assert bool(res[0.632, 2].classically_unstable) and not bool(res[0.15, 2].classically_unstable)
    assert float(res[0.632, 2].r_s_m) == pytest.approx(2.0 * 0.632, rel=0.05)


def test_island_evolutions_match_jax_and_gates():
    grow_kw = dict(delta_prime=5.0, r_s_m=1.2, eta_ohm_m=1e-7, n_steps=5000, dt=1e-2)
    decay_kw = dict(delta_prime=-4.0, r_s_m=1.2, eta_ohm_m=1e-7, w0_m=0.02, n_steps=3000, dt=1e-2)
    for kw in (grow_kw, decay_kw):
        ours = tm.rutherford_island_evolution(**kw, **CPU)
        ref = jm.rutherford_island_evolution(**{k: (jnp.asarray(v) if k in (
            "delta_prime", "r_s_m", "eta_ohm_m") else v) for k, v in kw.items()})
        _same(ours, ref, "rutherford")
    grow = tm.rutherford_island_evolution(**grow_kw, **CPU)
    w = as_np(grow.w_m)
    assert w[-1] > w[0] and w[-1] == pytest.approx(float(grow.saturated_w_m), rel=0.05)
    decay = tm.rutherford_island_evolution(**decay_kw, **CPU)
    assert float(decay.w_m[-1]) < 0.02 and not bool(decay.locked_risk)
    ok_kw = dict(w_island_m=0.03, b_error_mt=0.05, omega0_hz=5000.0)
    bad_kw = dict(w_island_m=0.12, b_error_mt=5.0, omega0_hz=100.0)
    ok, bad = (tm.locked_mode_evolution(**kw, **CPU) for kw in (ok_kw, bad_kw))
    _same(ok, jm.locked_mode_evolution(**ok_kw), "locked")
    _same(bad, jm.locked_mode_evolution(**bad_kw), "locked")
    assert not bool(ok.locked) and bool(bad.locked)
    assert float(bad.omega_final) < float(ok.omega_final)


# ── sawtooth ──

def _saw_profiles(q0, n=100):
    rho = np.linspace(0.0, 1.0, n)
    return rho, q0 + 2.5 * rho ** 2, 10.0 * (1 - rho ** 2) + 0.1, 8.0 * (1 - rho ** 2) ** 0.5 + 0.5


@pytest.mark.parametrize("q0", [0.8, 0.95, 1.1, 0.5])
def test_sawtooth_matches_jax(q0):
    rho, q, t, n = _saw_profiles(q0)
    if q0 == 0.5:
        q = 0.5 + 0.3 * rho ** 2          # q < 1 everywhere: no crossing, rho_1 = rho[-1]
    shear = (np.gradient(q) / (rho[1] - rho[0])) * rho / np.maximum(q, 1e-6)
    assert _close(tsw.find_q1_radius(_t(rho), _t(q)), jsw.find_q1_radius(jnp.asarray(rho),
                                                                           jnp.asarray(q)))
    _same(tsw.kadomtsev_crash(_t(rho), _t(t), _t(n), _t(q)),
          jsw.kadomtsev_crash(*(jnp.asarray(x) for x in (rho, t, n, q))), "crash")
    for s_crit in (0.1, 1e3):
        _same(tsw.sawtooth_step(_t(rho), _t(t), _t(n), _t(q), _t(shear), s_crit),
              jsw.sawtooth_step(*(jnp.asarray(x) for x in (rho, t, n, q, shear)), s_crit), "step")


def test_sawtooth_gates():
    """The sawtooth cases of ``tests/test_edge_orbits_frc.py``; q >= 1
    everywhere gives a NaN q=1 radius and no crash."""
    rho, q, t, n = (_t(x) for x in _saw_profiles(0.8))
    np.testing.assert_allclose(float(tsw.find_q1_radius(rho, q)), np.sqrt(0.2 / 2.5), atol=0.02)
    rho1, q1, t1, n1 = (_t(x) for x in _saw_profiles(1.1))
    assert math.isnan(float(tsw.find_q1_radius(rho1, q1)))
    out = tsw.kadomtsev_crash(rho1, t1, n1, q1)
    assert not bool(out.triggered) and torch.equal(out.t_new, t1)
    out = tsw.kadomtsev_crash(rho, t, n, q)
    assert bool(out.triggered)
    t_new, n_new, q_new = as_np(out.t_new), as_np(out.n_new), as_np(out.q_new)
    assert t_new[0] < float(t[0]) and q_new[0] == pytest.approx(1.01)
    r = as_np(rho)
    mix = r < float(out.rho_mix)
    np.testing.assert_allclose(np.trapezoid(n_new[mix] * r[mix], r[mix]),
                               np.trapezoid(as_np(n)[mix] * r[mix], r[mix]), rtol=0.02)
    np.testing.assert_allclose(np.trapezoid((n_new * t_new)[mix] * r[mix], r[mix]),
                               np.trapezoid((as_np(n) * as_np(t))[mix] * r[mix], r[mix]),
                               rtol=0.02)
    drho = float(rho[1] - rho[0])
    shear = _t(np.gradient(as_np(q)) / drho) * rho / torch.clamp(q, min=1e-6)
    assert bool(tsw.sawtooth_step(rho, t, n, q, shear).triggered)


# ── stability suite ──

def _iter_profiles(n=50):
    rho = np.linspace(0.0, 1.0, n)
    return rho, 10.0 * (1 - rho ** 2) ** 0.5 + 0.5, 20.0 * (1 - rho ** 2) + 0.1


GEOM = dict(r0=6.2, a=2.0, b0=5.3, ip_ma=15.0)


def test_stability_suite_matches_jax():
    rho, ne, t = _iter_profiles()
    for shape in (dict(kappa=1.7, delta=0.33), {}):
        qp = tst.compute_q_profile(_t(rho), _t(ne), _t(t), _t(t), **GEOM, **shape)
        qp_j = jst.compute_q_profile(*(jnp.asarray(x) for x in (rho, ne, t, t)), **GEOM, **shape)
        _same(qp, qp_j, "q")
    _same(tst.mercier_stability(qp), jst.mercier_stability(qp_j), "mercier")
    _same(tst.ballooning_stability(qp), jst.ballooning_stability(qp_j), "ballooning")
    _same(tst.kruskal_shafranov_stability(qp), jst.kruskal_shafranov_stability(qp_j), "ks")
    _same(tst.troyon_beta_limit(0.025, 15.0, 2.0, 5.3, **CPU),
          jst.troyon_beta_limit(0.025, 15.0, 2.0, 5.3), "troyon")
    j_bs, j_tot = 0.2 * np.ones(50) * 1e6, np.linspace(2e6, -1e-7, 50)
    _same(tst.ntm_stability(qp, _t(j_bs), _t(j_tot), 2.0),
          jst.ntm_stability(qp_j, jnp.asarray(j_bs), jnp.asarray(j_tot), 2.0), "ntm")
    for beta_n in (2.0, 3.0, 3.6):
        _same(tst.rwm_stability(beta_n, **CPU), jst.rwm_stability(beta_n), "rwm")
    for j_edge, p_ped in ((1e4, 1e4), (1e7, 2e5)):
        _same(tst.peeling_ballooning_stability(qp, j_edge, p_ped, 6.2, 2.0, 5.3),
              jst.peeling_ballooning_stability(qp_j, j_edge, p_ped, 6.2, 2.0, 5.3), "pb")
    kw = dict(**GEOM, beta_t=0.02, j_edge=1e5, p_ped_pa=5e4)
    full = tst.run_full_stability_check(_t(rho), _t(ne), _t(t), _t(t), _t(0.1 * np.ones(50) * 1e6),
                                        _t(np.ones(50) * 1e6), **kw)
    _same(full, jst.run_full_stability_check(*(jnp.asarray(x) for x in (
        rho, ne, t, t, 0.1 * np.ones(50) * 1e6, np.ones(50) * 1e6)), **kw), "full")
    assert full.overall_stable.dtype == torch.bool


def test_stability_gates():
    """The stability parts of ``tests/test_stability_scaling.py``."""
    rho, ne, t = (_t(x) for x in _iter_profiles())
    qp = tst.compute_q_profile(rho, ne, t, t, **GEOM, kappa=1.7, delta=0.33)
    q = as_np(qp.q)
    assert np.all(np.isfinite(q)) and np.all(q > 0)
    assert 0.5 < float(qp.q_min) < 2.0 and 2.0 < float(qp.q_edge) < 6.0
    assert float(qp.q_edge) > float(qp.q_min)
    assert float(tst.compute_q_profile(rho, ne, t, t, **GEOM).shear[0]) == 0.0
    cold = tst.compute_q_profile(rho, torch.ones(50, dtype=F64), 0.5 * torch.ones(50, dtype=F64),
                                 0.5 * torch.ones(50, dtype=F64), **GEOM)
    assert bool(tst.mercier_stability(cold).all_stable)
    assert np.all(as_np(tst.ballooning_stability(qp).alpha_crit) >= 0.0)
    qp2 = tst.QProfile(qp.rho, qp.q, torch.full_like(qp.q, 0.5), torch.zeros_like(qp.q), qp.q_min,
                       qp.q_min_rho, qp.q_edge)
    np.testing.assert_allclose(as_np(tst.ballooning_stability(qp2).alpha_crit), 0.375, rtol=1e-6)
    assert bool(tst.kruskal_shafranov_stability(qp).stable) == (float(qp.q_edge) > 1.0)
    troy = tst.troyon_beta_limit(0.025, 15.0, 2.0, 5.3, **CPU)
    np.testing.assert_allclose(float(troy.beta_n), 100 * 0.025 * 2.0 * 5.3 / 15.0, rtol=1e-6)
    assert bool(troy.stable_nowall)
    r3, r2 = tst.rwm_stability(3.0, **CPU), tst.rwm_stability(2.0, **CPU)
    assert not bool(r3.stable) and float(r3.mode_growth_rate) > 0.0
    assert bool(r2.stable) and float(r2.mode_growth_rate) == 0.0
    res = tst.ntm_stability(qp, 0.2 * torch.ones_like(qp.rho) * 1e6, torch.ones_like(qp.rho) * 1e6,
                            2.0)
    assert np.all(as_np(res.w_marginal) >= 0.0)
    np.testing.assert_allclose(as_np(res.w_marginal), 0.2, rtol=1e-6)
    low = tst.peeling_ballooning_stability(qp, 1e4, 1e4, 6.2, 2.0, 5.3)
    high = tst.peeling_ballooning_stability(qp, 1e7, 2e5, 6.2, 2.0, 5.3)
    assert float(low.stability_distance) > float(high.stability_distance)


def test_eigen_lane_matches_jax_and_gate():
    """``ballooning_stability_eigen`` (``test_ballooning.py:87-103``): a
    high-alpha low-shear profile is second-stable on the eigen lane and
    unstable on the closed form; row B's plain twin on the CPU."""
    n = 7
    rho = np.linspace(0.1, 1.0, n)
    fields = (rho, np.linspace(1.0, 4.0, n), np.full(n, 0.4), np.full(n, 3.5))
    qp = tst.QProfile(*(_t(x) for x in fields), _t(1.0), _t(0.1), _t(4.0))
    qp_j = jst.QProfile(*(jnp.asarray(x) for x in fields), jnp.asarray(1.0), jnp.asarray(0.1),
                        jnp.asarray(4.0))
    res = tst.ballooning_stability_eigen(qp)
    _same(res, jst.ballooning_stability_eigen(qp_j), "eigen")
    assert as_np(res.stable).astype(bool).all()
    assert not as_np(tst.ballooning_stability(qp).stable).astype(bool).any()


# ── ELM ──

def test_elm_matches_jax_and_gates():
    for args in ((0.05, 0.1, 1.5, 3.5, 1.7, 0.33), (5.0, 0.1, 1.5, 3.5, 1.7, 0.33),
                 (0.3, 2.0, 0.4, 0.8, 1.2, 0.0)):
        assert bool(tl.pb_unstable(*args, **CPU)) == bool(jl.pb_unstable(*args))
    s = [0.0, 0.5, 1.0, 2.5, -1.0]
    assert _close(tl.ballooning_limit(_t(s)), jl.ballooning_limit(jnp.asarray(s)))
    assert _close(tl.peeling_limit(0.1, 3.5, 1.7, 0.33, **CPU),
                  jl.peeling_limit(0.1, 3.5, 1.7, 0.33))
    assert not bool(tl.pb_unstable(0.05, 0.1, 1.5, 3.5, 1.7, 0.33, **CPU))
    assert bool(tl.pb_unstable(5.0, 0.1, 1.5, 3.5, 1.7, 0.33, **CPU))
    crash = tl.elm_crash(4.0, 8.0, 10.0, loss_fraction=0.3, **CPU)
    _same(crash, jl.elm_crash(4.0, 8.0, 10.0, loss_fraction=0.3), "crash")
    np.testing.assert_allclose(float(crash.delta_w_mj), 3.0)
    assert float(crash.t_ped_after_kev) < 4.0 and float(crash.n_ped_after_1e19) < 8.0
    f = tl.elm_power_balance_frequency(100.0, 10.0, 0.3, **CPU)
    assert _close(f, jl.elm_power_balance_frequency(100.0, 10.0, 0.3))
    np.testing.assert_allclose(float(f), 100.0 / 3.0, rtol=1e-6)
    assert float(tl.elm_power_balance_frequency(100.0, 0.0, 0.3, **CPU)) == 0.0
    kw = dict(t_ped0_kev=1.0, n_ped_1e19=8.0, w_ped_mj=10.0, heat_rate_kev_s=50.0,
              alpha_per_kev=1.0, s_edge=1.5, j_edge_norm=0.1, dt=1e-3, n_steps=3000)
    trace = tl.run_elm_cycle(**kw, **CPU)
    _same(trace, jl.run_elm_cycle(**kw), "cycle")
    assert int(trace.n_crashes) >= 3
    t = as_np(trace.t_ped)
    assert np.all(np.isfinite(t)) and t.max() < 10.0


# ── edge events ──

def _pellet_profiles(n=33, t_core=10.0):
    rho = np.linspace(0, 1, n)
    return t_core * (1 - 0.9 * rho ** 2), 8.0 * (1 - 0.7 * rho ** 2)


def test_edge_events_match_jax_and_gates():
    pen = {}
    for t_core in (10.0, 25.0, 2.0):
        te_p, ne_p = _pellet_profiles(t_core=t_core)
        ours = te.pellet_ablation(te_profile_kev=_t(te_p), ne_profile_19=_t(ne_p))
        _same(ours, je.pellet_ablation(te_profile_kev=jnp.asarray(te_p),
                                       ne_profile_19=jnp.asarray(ne_p)), "pellet")
        pen[t_core] = float(ours.penetration_rho)
        if t_core == 10.0:
            assert float(ours.radius_mm[-1]) < 2.0 and float(ours.deposition.sum()) > 0.0
            assert pen[t_core] > 0.0
    assert pen[25.0] > pen[2.0]
    for size in (2.0, 10.0, 30.0):
        _same(te.blob_transport(blob_size_mm=size, **CPU), je.blob_transport(blob_size_mm=size),
              "blob")
    small, large = (te.blob_transport(blob_size_mm=s, **CPU) for s in (2.0, 30.0))
    assert float(small.v_blob_m_s) > 0.0 and float(large.v_blob_m_s) != float(small.v_blob_m_s)
    assert float(small.gamma_flux_m2_s) > 0.0
    cases = (dict(n_edge_19=1.0, te_edge_ev=50.0, ip_ma=2.0, a_m=0.6),
             dict(n_edge_19=20.0, te_edge_ev=15.0, ip_ma=2.0, a_m=0.6, impurity_fraction=0.06),
             dict(n_edge_19=1.0, te_edge_ev=50.0, ip_ma=2.0, a_m=0.6, impurity_fraction=0.1))
    low, high, dirty = (te.marfe_onset(**kw, **CPU) for kw in cases)
    for ours, kw in zip((low, high, dirty), cases):
        _same(ours, je.marfe_onset(**kw), "marfe")
    assert not bool(low.at_risk) and bool(high.at_risk)
    assert float(dirty.n_marfe_19) < float(low.n_marfe_19)


def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        for call in (lambda: tm.rutherford_island_evolution(delta_prime=1.0, r_s_m=1.0,
                                                            eta_ohm_m=1e-7, n_steps=2),
                     lambda: tm.locked_mode_evolution(w_island_m=0.1, b_error_mt=1.0,
                                                      omega0_hz=1.0, n_steps=2),
                     lambda: tl.run_elm_cycle(t_ped0_kev=1.0, n_ped_1e19=1.0, w_ped_mj=1.0,
                                              heat_rate_kev_s=1.0, alpha_per_kev=1.0, s_edge=1.0,
                                              j_edge_norm=0.1, n_steps=2)):
            with pytest.raises((AssertionError, RuntimeError)):
                call()
