"""Port parity: ``control/rmf.py``, ``control/hil.py``,
``control/hil_sensors.py`` and ``control/control_room.py``.

In float64 on the CPU the RMF spin-up (20,000 ticks) and the phase-locked
loop (5,000 and 8,000 ticks, its lock time included) are within 1e-9 of
JAX, and the ADC / DAC converters equal JAX on JAX's own draws
(``_read_adc`` takes the normals ``jax.random.normal`` gives).  The control
room is float32 in both packages: on JAX's draws (the four draws of every
step, split as the JAX session splits its key) the port's z traces are
within 1e-5 of max |z| and its density frames within 1e-5 absolute (the
float32 2x2 Kalman products may round apart).  The gates of
``tests/test_rmf.py``, ``test_hil_sensors.py``, ``test_control_room.py``
and the HIL part of ``test_plasma_controllers.py`` hold for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import control_room as jcr
from scpn_fusion_tpu.control import hil_sensors as jhs
from scpn_fusion_tpu.control import rmf as jrmf
from scpn_fusion_tpu_torch.control import control_room as tcr
from scpn_fusion_tpu_torch.control import hil as thil
from scpn_fusion_tpu_torch.control import hil_sensors as ths
from scpn_fusion_tpu_torch.control import rmf as trmf

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
ROOM_TOL = 1e-5


# ── RMF spin-up and phase lock ──

@pytest.mark.parametrize("kw", [dict(), dict(b_rmf_mt=8.0), dict(b_rmf_mt=0.05,
                                                                friction_rate=2e5)])
def test_spinup_matches_jax(kw):
    ref, ours = jrmf.run_rmf_spinup(jrmf.RMFParams(**kw)), trmf.run_rmf_spinup(
        trmf.RMFParams(**kw), **CPU)
    for name in ("omega_e_hz", "sync_fraction", "drive_efficiency"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    assert bool(ours.synchronised) == bool(ref.synchronised)


@pytest.mark.parametrize("pll, kw", [(dict(), dict(rotation_hz=95e3, antenna_hz0=100e3)),
                                     (dict(n_steps=8000), dict(rotation_hz=95e3,
                                                               freq_drift_hz_s=2e5)),
                                     (dict(kp_hz_per_rad=0.0, ki_hz_per_rad_s=0.0),
                                      dict(rotation_hz=95e3, antenna_hz0=100e3))])
def test_phase_lock_matches_jax(pll, kw):
    ref = jrmf.run_phase_lock(jrmf.PLLParams(**pll), **kw)
    ours = trmf.run_phase_lock(trmf.PLLParams(**pll), **kw, **CPU)
    assert rel(ours.phase_error, ref.phase_error) <= TOL
    assert rel(ours.antenna_freq_hz, ref.antenna_freq_hz) <= TOL
    assert bool(ours.locked) == bool(ref.locked)
    assert float(ours.lock_time_s) == float(ref.lock_time_s)


class TestRMFGates:
    def test_strong_rmf_synchronises(self):
        tr = trmf.run_rmf_spinup(trmf.RMFParams(b_rmf_mt=8.0), **CPU)
        assert bool(tr.synchronised), float(tr.sync_fraction)
        om = tr.omega_e_hz.numpy()
        assert om[-1] > om[0]
        assert np.all(np.diff(om) >= -1e-6)

    def test_weak_rmf_slips(self):
        tr = trmf.run_rmf_spinup(trmf.RMFParams(b_rmf_mt=0.05, friction_rate=2e5), **CPU)
        assert not bool(tr.synchronised)
        assert float(tr.sync_fraction) < 0.5

    def test_sync_fraction_monotone_in_amplitude(self):
        fracs = [float(trmf.run_rmf_spinup(trmf.RMFParams(b_rmf_mt=b, n_steps=10000),
                                           **CPU).sync_fraction) for b in (0.2, 1.0, 4.0)]
        assert fracs[0] <= fracs[1] <= fracs[2]

    def test_locks_onto_offset_rotation(self):
        tr = trmf.run_phase_lock(trmf.PLLParams(), rotation_hz=95e3, antenna_hz0=100e3, **CPU)
        assert bool(tr.locked)
        assert float(tr.lock_time_s) < 0.05
        assert abs(float(tr.antenna_freq_hz[-1]) - 95e3) < 2e3

    def test_tracks_drifting_rotation(self):
        tr = trmf.run_phase_lock(trmf.PLLParams(n_steps=8000), rotation_hz=95e3,
                                 freq_drift_hz_s=2e5, **CPU)
        assert bool(tr.locked)
        assert abs(float(tr.antenna_freq_hz[-1]) - (95e3 + 2e5 * 8000 * 1e-5)) < 5e3

    def test_unlocked_without_gain(self):
        tr = trmf.run_phase_lock(trmf.PLLParams(kp_hz_per_rad=0.0, ki_hz_per_rad_s=0.0),
                                 rotation_hz=95e3, antenna_hz0=100e3, **CPU)
        assert not bool(tr.locked)


# ── ADC / DAC ──

@pytest.mark.parametrize("noise", [0.0, 0.5, 2.0])
def test_adc_matches_jax_on_jax_draws(noise):
    cfg_j, cfg_t = jhs.AdcConfig(noise_rms_lsb=noise), ths.AdcConfig(noise_rms_lsb=noise)
    v = np.linspace(-1.8, 1.8, 257)
    key = jax.random.PRNGKey(11)
    ref = jhs.read_adc(jnp.asarray(v), key, cfg_j)
    normals = np.asarray(jax.random.normal(key, v.shape))
    assert np.array_equal(ths._read_adc(torch.tensor(v), torch.tensor(normals), cfg_t).numpy(),
                          np.asarray(ref))
    b = np.array([3.7, -9.9, 12.0, 0.0])
    ref_b = jhs.read_magnetic_probe(jnp.asarray(b), key, cfg_j)
    nb = np.asarray(jax.random.normal(key, b.shape))
    assert rel(ths._read_magnetic_probe(torch.tensor(b), torch.tensor(nb), cfg_t), ref_b) <= 1e-15


def test_dac_and_converter_loop_match_jax():
    g = np.random.default_rng(6)
    cmds = g.uniform(-15.0, 15.0, (120, 4))
    cmds[10:20, 1] = np.nan
    cmds[50, 2] = np.inf
    sj, oj = jhs.converter_loop(jnp.asarray(cmds), dt_us=0.05)
    st, ot = ths.converter_loop(torch.tensor(cmds), dt_us=0.05)
    assert rel(ot, oj) == 0.0 and rel(st.last_voltage, sj.last_voltage) == 0.0
    assert np.array_equal(st.faults.numpy(), np.asarray(sj.faults))
    sj, kj = jhs.write_coil_current(jhs.dac_init(), jnp.asarray(20.0), dt_us=0.1)
    st, kt = ths.write_coil_current(ths.dac_init(**CPU), torch.tensor(20.0, dtype=F64), dt_us=0.1)
    assert rel(kt, kj) == 0.0


class TestConverterGates:
    def test_quantisation_grid(self):
        cfg = ths.AdcConfig(noise_rms_lsb=0.0)
        v = ths.read_adc(torch.linspace(-1.4, 1.4, 64, dtype=F64), torch.Generator(), cfg)
        codes = (v.numpy() - cfg.v_min) / cfg.lsb_voltage
        np.testing.assert_allclose(codes, np.round(codes), atol=1e-3)

    def test_clip_to_range(self):
        cfg = ths.AdcConfig(noise_rms_lsb=0.0)
        v = ths.read_adc(torch.tensor([99.0, -99.0], dtype=F64), torch.Generator(), cfg)
        np.testing.assert_allclose(v.numpy(), [cfg.v_max, cfg.v_min], atol=2 * cfg.lsb_voltage)

    def test_noise_statistics(self):
        cfg = ths.AdcConfig(noise_rms_lsb=2.0)
        v = ths.read_adc(torch.zeros(20000, dtype=F64), torch.Generator().manual_seed(1), cfg)
        rms = float(torch.std(v))
        assert 0.75 * 2.0 * cfg.lsb_voltage < rms < 1.25 * 2.2 * cfg.lsb_voltage

    def test_probe_scale_roundtrip(self):
        cfg = ths.AdcConfig(noise_rms_lsb=0.0)
        b = ths.read_magnetic_probe(torch.tensor(3.7, dtype=F64), torch.Generator(), cfg)
        assert abs(float(b) - 3.7) < 0.01

    def test_slew_limit(self):
        st = ths.dac_init(**CPU)
        st, out = ths.write_dac(st, torch.tensor(10.0, dtype=F64), dt_us=0.1,
                                cfg=ths.DacConfig(slew_rate_v_per_us=50.0))
        assert abs(float(out) - 5.0) < 1e-6
        st, out = ths.write_dac(st, torch.tensor(10.0, dtype=F64), dt_us=0.1)
        assert abs(float(out) - 10.0) < 1e-6

    def test_nonfinite_fail_safe_hold(self):
        st = ths.dac_init(**CPU)
        st, out1 = ths.write_dac(st, torch.tensor(2.0, dtype=F64), dt_us=1.0)
        st, out2 = ths.write_dac(st, torch.tensor(float("nan"), dtype=F64), dt_us=1.0)
        assert float(out2) == float(out1) and int(st.faults) == 1
        st, out3 = ths.write_dac(st, torch.tensor(float("inf"), dtype=F64), dt_us=1.0)
        assert float(out3) == float(out1) and int(st.faults) == 2

    def test_range_clamp_and_coil_scale(self):
        st, out = ths.write_dac(ths.dac_init(**CPU), torch.tensor(500.0, dtype=F64), dt_us=100.0)
        assert float(out) == 10.0
        st, ka = ths.write_coil_current(ths.dac_init(**CPU), torch.tensor(20.0, dtype=F64),
                                        dt_us=100.0)
        assert abs(float(ka) - 20.0) < 1e-5

    def test_vectorised_channels(self):
        x = np.linspace(0, 8, 50)
        cmds = torch.tensor(np.stack([x, np.full(50, np.nan), -x], axis=1))
        state, out = ths.converter_loop(cmds)
        assert out.shape == (50, 3)
        assert int(state.faults[1]) == 50
        np.testing.assert_allclose(out[:, 1].numpy(), 0.0)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out[:, 0].numpy(), -out[:, 2].numpy(), atol=1e-6)


# ── HIL latency harness ──

def test_latency_report_shape_and_first_leaf():
    def step(x):
        return x * 1.0001 + 0.1

    rep = thil.measure_dispatch_latency(step, (torch.ones(8),), n_warmup=2, n_samples=30)
    assert rep.p50_us > 0.0 and rep.p99_us >= rep.p95_us >= rep.p50_us
    assert thil.control_rate_hz(rep) > 0.0 and rep.n_samples == 30
    pipe = thil.measure_dispatch_latency(step, (torch.ones(8),), n_warmup=2, n_samples=60,
                                         pipelined=True)
    assert pipe.n_samples == 3 and pipe.mean_us > 0.0
    leaf = torch.zeros(2)
    assert thil.first_tensor(({"b": 1, "a": (None, leaf)}, torch.ones(1))) is leaf
    assert set(rep.to_dict()) == {"p50_us", "p95_us", "p99_us", "mean_us", "n_samples"}


def test_fused_throughput_beats_dispatch():
    """1000 ticks of the affine step in one call (its closed form, one
    vectorised program) cost far less a tick than one dispatched step."""
    a, b = 1.0001, 0.1

    def fused(x):
        k = torch.arange(1000, dtype=x.dtype)
        return x * a ** 1000 + b * torch.sum(a ** k)

    x, loop = torch.ones(8, dtype=F64), torch.ones(8, dtype=F64)
    for _ in range(1000):
        loop = loop * a + b
    assert torch.allclose(fused(x), loop, rtol=1e-12)
    rep_fused = thil.measure_fused_throughput(fused, (x,), n_ticks=1000, n_repeats=3)
    rep_disp = thil.measure_dispatch_latency(lambda y: y * a + b, (x,), n_warmup=2,
                                             n_samples=30)
    assert rep_fused.mean_us < rep_disp.mean_us


# ── control room ──

def _jax_draws(seed, steps, size):
    """The four draws of every step, as ``run_control_room_session`` splits
    its key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)

    def one(subkey):
        kd_dist, kd_kick, kd_meas, kd_noise = jax.random.split(subkey, 4)
        return (jax.random.normal(kd_dist, (), jnp.float32),
                jax.random.uniform(kd_kick, (), jnp.float32),
                jax.random.normal(kd_meas, (), jnp.float32),
                jax.random.normal(kd_noise, (size, size), jnp.float32))

    return tcr.ControlRoomDraws(*(torch.tensor(np.asarray(d)) for d in jax.vmap(one)(keys)))


@pytest.mark.parametrize("seed, steps, size, psi", [(42, 200, 60, False), (2, 250, 16, False),
                                                    (1, 40, 16, True)])
def test_control_room_matches_jax_on_jax_draws(seed, steps, size, psi):
    kernel = None
    if psi:
        x = np.linspace(-1, 1, size)
        xx, yy = np.meshgrid(x, x)
        kernel = (xx + 0.5) ** 2 + yy ** 2
    ref_tr, ref_sum = jcr.run_control_room_session(
        steps=steps, size=size, seed=seed, psi_kernel=None if kernel is None
        else jnp.asarray(kernel))
    tr, summ = tcr._run_control_room_session(
        steps=steps, size=size, dropout_every=20, draws=_jax_draws(seed, steps, size),
        psi_kernel=None if kernel is None else torch.tensor(kernel))
    scale = float(np.max(np.abs(np.asarray(ref_tr.z_true))))
    for name in ("z_true", "z_measured", "z_filtered", "top_action", "bottom_action"):
        dev = float(np.max(np.abs(getattr(tr, name).numpy() - np.asarray(getattr(ref_tr, name)))))
        assert dev <= ROOM_TOL * max(scale, 1.0), (name, dev)
    assert np.array_equal(tr.dropout.numpy(), np.asarray(ref_tr.dropout))
    assert float(np.max(np.abs(tr.density.numpy() - np.asarray(ref_tr.density)))) <= ROOM_TOL
    for key, val in ref_sum.items():
        assert abs(float(summ[key]) - float(val)) <= ROOM_TOL * max(scale, 1.0), key


class TestControlRoomGates:
    def test_vde_is_stabilised(self):
        trace, summary = tcr.run_control_room_session(steps=200, size=24, seed=42, device="cpu")
        assert float(summary["max_abs_z"]) < 1.5
        assert float(summary["mean_abs_z"]) < 0.5
        assert bool((trace.top_action > 0.0).any()) and bool((trace.bottom_action > 0.0).any())

    def test_stable_across_seeds(self):
        for seed in (0, 1, 2, 3, 7):
            _, s = tcr.run_control_room_session(steps=250, size=16, seed=seed, device="cpu")
            assert float(s["max_abs_z"]) < 1.5, seed

    def test_estimator_beats_raw_measurement(self):
        _, summary = tcr.run_control_room_session(steps=300, size=16, seed=7, device="cpu")
        assert float(summary["estimator_rmse"]) < float(summary["measurement_rmse"])

    def test_density_frames_shape_and_range(self):
        trace, _ = tcr.run_control_room_session(steps=12, size=20, seed=0, device="cpu")
        dens = trace.density.numpy()
        assert dens.shape == (12, 20, 20)
        assert dens.min() >= 0.0
        assert 0.5 < dens.max() <= 1.3

    def test_push_pull_actions_exclusive(self):
        trace, _ = tcr.run_control_room_session(steps=100, size=16, seed=3, device="cpu")
        top, bot = trace.top_action.numpy(), trace.bottom_action.numpy()
        assert np.all(top * bot == 0.0)
        assert np.all((top >= 0) & (top <= 1) & (bot >= 0) & (bot <= 1))

    def test_kernel_psi_lane(self):
        """The density follows the supplied map's topology.  The argmax of a
        flat-topped core under 5% noise depends on the draw, so the gate runs
        on JAX's draws of its seed (the port's own draws of seed 1 put it 3
        rows off)."""
        size = 16
        x = torch.linspace(-1, 1, size)
        xx, yy = torch.meshgrid(x, x, indexing="xy")
        psi = (xx + 0.5) ** 2 + yy ** 2
        trace, _ = tcr._run_control_room_session(steps=4, size=size, dropout_every=20,
                                                 psi_kernel=psi, draws=_jax_draws(1, 4, size))
        dens = trace.density[-1].numpy()
        core = np.unravel_index(np.argmax(dens), dens.shape)
        truth = np.unravel_index(np.argmin(psi.numpy()), (size, size))
        assert abs(core[0] - truth[0]) <= 1 and abs(core[1] - truth[1]) <= 1

    def test_deterministic(self):
        t1, _ = tcr.run_control_room_session(steps=50, size=16, seed=9, device="cpu")
        t2, _ = tcr.run_control_room_session(steps=50, size=16, seed=9, device="cpu")
        assert torch.equal(t1.z_true, t2.z_true)

    def test_report_png_and_gif(self, tmp_path):
        trace, _ = tcr.run_control_room_session(steps=8, size=16, seed=2, device="cpu")
        png, gif = tmp_path / "report.png", tmp_path / "room.gif"
        res = tcr.render_control_room_report(trace, str(png), path_gif=str(gif), gif_stride=4)
        assert res["report_saved"] and png.stat().st_size > 0
        assert res["animation_saved"] and gif.stat().st_size > 0


def test_entry_points_need_the_card():
    with pytest.raises((RuntimeError, AssertionError)):
        trmf.run_phase_lock(trmf.PLLParams(n_steps=2))
    with pytest.raises((RuntimeError, AssertionError)):
        tcr.run_control_room_session(steps=2, size=16)
