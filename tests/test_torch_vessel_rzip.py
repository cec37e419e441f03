"""Port parity: vessel circuits and the RZIP vertical response, the
super-twisting sliding-mode stabiliser and the gain scheduler
(``control/{vessel_rzip, sliding_mode, gain_schedule}.py``), grouped as the
JAX package's ``tests/test_vessel_rzip.py`` groups them.

The vessel is that test's fixture (``bench_config.rzip_vessel_arrays``, held
equal to it here).  Float64 throughout: mutual inductances, the mutual
matrix, eddy-current steps and vessel flux within 1e-12; the RZIP state
space (``dM/dz`` by ``torch.func.vmap(torch.func.grad(...))`` against JAX's
``vmap(grad(...))``) within 1e-12; the growth rate, the n-index on a psi map
and the closed-loop eigenvalues of the LQR gain (a Riccati integration)
within 1e-9; the float32 SMC shot within 1e-5 (XLA may fuse a product and a
sum into one FMA), its step exactly; the float32 ITER-like waveforms within
2 ulp for the same reason, and the gain-scheduled PID over them, fed JAX's
waveform values, within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.control import gain_schedule as jg
from scpn_fusion_tpu.control import sliding_mode as jsm
from scpn_fusion_tpu.control import vessel_rzip as jv
from scpn_fusion_tpu_torch.bench_config import rzip_vessel_arrays
from scpn_fusion_tpu_torch.control import gain_schedule as tg
from scpn_fusion_tpu_torch.control import sliding_mode as tsm
from scpn_fusion_tpu_torch.control import vessel_rzip as tv

TOL = 1e-12


def _close(ours, ref, tol=TOL):
    a, b = as_np(ours), as_np(ref)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1e-300) if b.size else 1.0
    assert float(np.max(np.abs(a - b), initial=0.0)) <= tol * scale


def _vessels(with_coils=True):
    arr = rzip_vessel_arrays()
    n = None if with_coils else 8
    cols = [arr[k][:n] for k in ("r", "z", "resistance", "inductance")]
    return jv.Vessel(*(jnp.asarray(c) for c in cols)), tv.Vessel(*(torch.tensor(c) for c in cols))


def test_bench_vessel_is_the_fixture():
    import test_vessel_rzip as fixture
    jvs, _ = _vessels()
    for a, b in zip(fixture._make_vessel(with_coils=True), jvs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_mutual_inductance_and_vessel():
    for args in ((6.0, 0.0, 6.0, 0.5), (6.0, 0.5, 6.0, 0.0), (4.7, -1.0, 9.5, 2.0)):
        _close(tv.mutual_inductance(*args), jv.mutual_inductance(*args))
    jvs, tvs = _vessels(with_coils=False)
    _close(tv.mutual_matrix(tvs), jv.mutual_matrix(jvs))
    i_j, i_t = jnp.ones(8) * 100.0, torch.full((8,), 100.0, dtype=torch.float64)
    for _ in range(20):
        i_j = jv.vessel_step(jvs, i_j, jnp.ones(8) * 1e-3, 1e-3)
        i_t = tv.vessel_step(tvs, i_t, torch.full((8,), 1e-3, dtype=torch.float64), 1e-3)
    _close(i_t, i_j)
    r_obs, z_obs = np.linspace(5.0, 9.0, 10), np.linspace(-1.0, 1.0, 10)
    _close(tv.psi_vessel(tvs, i_t, torch.tensor(r_obs), torch.tensor(z_obs)),
           jv.psi_vessel(jvs, i_j, jnp.asarray(r_obs), jnp.asarray(z_obs)))


@pytest.mark.parametrize("n_index", [-1.2, 1.0])
def test_rzip_state_space(n_index):
    jvs, tvs = _vessels()
    ref = jv.build_rzip_state_space(jvs, n_wall=8, r0=6.2, ip_ma=15.0, n_index=n_index)
    ours = tv.build_rzip_state_space(tvs, n_wall=8, r0=6.2, ip_ma=15.0, n_index=n_index)
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))
    assert ours.a.shape == (12, 12) and ours.b.shape == (12, 2)
    g_ref, g = jv.vertical_growth_rate(ref), tv.vertical_growth_rate(ours)
    assert abs(g - g_ref) <= 1e-9 * abs(g_ref)
    assert tv.vertical_growth_time_ms(ours) == pytest.approx(jv.vertical_growth_time_ms(ref),
                                                             rel=1e-9)


def test_lqr_and_closed_loop():
    jvs, tvs = _vessels()
    ref_ss = jv.build_rzip_state_space(jvs, n_wall=8, r0=6.2, ip_ma=15.0, n_index=-0.4)
    ss = tv.build_rzip_state_space(tvs, n_wall=8, r0=6.2, ip_ma=15.0, n_index=-0.4)
    kw = dict(kp=100.0, kd=100.0, n_steps=3000, dt=2e-5)
    k_ref, k = jv.rzip_lqr_gain(ref_ss, **kw), tv.rzip_lqr_gain(ss, **kw)
    _close(k, k_ref, 1e-9)
    e_ref, e = jv.closed_loop_eigenvalues(ref_ss, k_ref), tv.closed_loop_eigenvalues(ss, k)
    _close(np.sort_complex(e).real, np.sort_complex(e_ref).real, 1e-9)
    _close(tv.rzip_voltage_command(k, 0.01, 0.0), jv.rzip_voltage_command(k_ref, 0.01, 0.0),
           1e-9)


def test_n_index_from_psi_map():
    r, z = np.linspace(5.0, 7.5, 101), np.linspace(-1.0, 1.0, 21)
    bz = 0.3 * (r / 6.2) ** (-1.5)
    psi_mid = np.concatenate([[0.0], np.cumsum(0.5 * (r[1:] * bz[1:] + r[:-1] * bz[:-1])
                                               * np.diff(r))])
    psi = np.tile(psi_mid, (21, 1)) * (1.0 + 0.01 * np.linspace(-1, 1, 21))[:, None]
    ref = jv.compute_n_index(jnp.asarray(psi), jnp.asarray(r), jnp.asarray(z), 6.2)
    ours = tv.compute_n_index(torch.tensor(psi), torch.tensor(r), torch.tensor(z), 6.2)
    _close(ours, ref)
    assert tv.required_feedback_gain(100.0, 0.01, 0.001) == pytest.approx(1.1)
    with pytest.raises(ValueError):
        tv.required_feedback_gain(-1.0, 0.01, 0.001)


def test_smc_shot():
    p_j = jsm.SMCParams(alpha=50.0, beta=30.0, c=0.05, u_max=200.0)
    p_t = tsm.SMCParams(alpha=50.0, beta=30.0, c=0.05, u_max=200.0)
    kw = dict(z0=0.02, dz0=0.0, gamma=20.0, control_gain=500.0, dt=1e-4, n_steps=1500)
    ref = jsm.run_smc_vertical.__wrapped__(p_j, **kw)
    ours = tsm.run_smc_vertical(p_t, **kw, device="cpu")
    assert ours.z.dtype == torch.float32
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name), 1e-5)
    u, v = tsm.smc_step(tsm.SMCParams(alpha=100.0, beta=50.0, u_max=5.0),
                        *(torch.tensor(x, dtype=torch.float64) for x in (0.0, 1.0, 0.0)),
                        1e-3)
    u_j, v_j = jsm.smc_step(jsm.SMCParams(alpha=100.0, beta=50.0, u_max=5.0),
                            *(jnp.asarray(x) for x in (0.0, 1.0, 0.0)), 1e-3)
    assert float(u) == float(u_j) and float(v) == float(v_j)
    assert tsm.lyapunov_certificate(5.0, 3.0, 2.0) and not tsm.lyapunov_certificate(1.0, 3.0, 2.0)
    assert tsm.estimate_convergence_time(5.0, 3.0, 2.0, 0.04) == \
        jsm.estimate_convergence_time(5.0, 3.0, 2.0, 0.04)


def _banks():
    kp = np.full((jg.N_REGIMES, 2), 1.0)
    kp[jg.H_MODE_FLAT] = 3.0
    x_ref = np.zeros((jg.N_REGIMES, 2))
    x_ref[jg.H_MODE_FLAT] = 2.0
    x_ref[jg.DISRUPTION_MITIGATION] = -1.0
    cols = (kp, np.full_like(kp, 0.1), np.full_like(kp, 0.01), x_ref)
    return jg.GainBank(*(jnp.asarray(c) for c in cols)), tg.GainBank(*(torch.tensor(c)
                                                                      for c in cols))


@pytest.mark.parametrize("history_len", [5, 1])
def test_gain_schedule_over_the_baseline_waveforms(history_len):
    """600 s of the ITER-like waveforms at 2 s a step: ramp-up, flat top
    with an H-mode heating staircase, ramp-down, and a disruption alarm."""
    th_j, th_t = jg.DetectorThresholds(history_len=history_len), \
        tg.DetectorThresholds(history_len=history_len)
    bank_j, bank_t = _banks()
    st_j = jg.init_schedule_state(2, history_len, jnp.float64)
    st_t = tg.init_schedule_state(2, history_len, torch.float64, "cpu")
    wf_j, wf_t = jg.iter_baseline_waveforms(), tg.iter_baseline_waveforms(device="cpu")
    dt = 2.0
    regimes = set()
    for k in range(300):
        t = dt * k
        ip = [float(wf_j["ip_ma"](t)), float(wf_j["ip_ma"](t + dt))]
        # float32 knots: XLA may fuse the interpolation into an FMA (1 ulp)
        _close(torch.stack([wf_t["ip_ma"](t), wf_t["ip_ma"](t + dt)]), np.array(ip), 2.4e-7)
        x = np.array([ip[0] * 0.98, float(wf_j["n_e_19"](t))]) / 10.0
        kw = dict(dip_dt=(ip[1] - ip[0]) / dt, tau_e=0.5 + float(wf_j["p_aux_mw"](t)) / 25.0,
                  p_disrupt=0.9 if 560.0 <= t < 580.0 else 0.0)
        u_j, st_j = jg.schedule_step(th_j, bank_j, st_j, jnp.asarray(x), t, dt, **kw)
        u_t, st_t = tg.schedule_step(th_t, bank_t, st_t, torch.tensor(x), t, dt, **kw)
        _close(u_t, u_j)
        for name in st_j._fields:
            _close(getattr(st_t, name), getattr(st_j, name))
        regimes.add(int(st_t.regime))
    assert {jg.RAMP_UP, jg.H_MODE_FLAT, jg.RAMP_DOWN, jg.DISRUPTION_MITIGATION} <= regimes
