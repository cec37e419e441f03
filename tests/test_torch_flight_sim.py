"""Port parity: the PID step, the actuator and the reduced flight-sim lane
(``control/{pid, actuator, flight_sim}.py``).

The same numpy-seeded inputs go through the JAX functions and the port's
in float64: 200 ticks of PID + actuator (delay line, slew, saturation, with
NaN and inf commands among them) and the reduced lane's 200-tick shot at
1 kHz, each within 1e-12; the sub-grid axis estimate on seeded fields; and
the entry points run on the card by default.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rng

from scpn_fusion_tpu.control import actuator as ja
from scpn_fusion_tpu.control import flight_sim as jf
from scpn_fusion_tpu.control import pid as jp
from scpn_fusion_tpu_torch.control import actuator as ta
from scpn_fusion_tpu_torch.control import flight_sim as tf
from scpn_fusion_tpu_torch.control import pid as tp

TOL = 1e-12


def _close(ours, ref, tol=TOL):
    a, b = as_np(ours), as_np(ref)
    scale = max(float(np.max(np.abs(b))), 1e-300) if b.size else 1.0
    assert a.shape == b.shape
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    ok = np.isfinite(b)
    assert float(np.max(np.abs(a[ok] - b[ok]), initial=0.0)) <= tol * scale


@pytest.mark.parametrize("delay_steps", [0, 3])
def test_pid_and_actuator_200_ticks(delay_steps):
    g = rng(10 + delay_steps)
    errors = g.normal(0.0, 2.0, 200)
    errors[[17, 90]] = np.nan
    errors[[41, 150]] = np.inf
    gains = (1.3, 0.4, 0.2)
    params = dict(tau_s=0.02, dt_s=1e-3, u_min=-3.0, u_max=3.0, rate_limit=500.0,
                  delay_steps=delay_steps)
    jg = jp.PIDGains(*[jnp.float64(v) for v in gains])
    tg = tp.PIDGains(*[torch.tensor(v, dtype=torch.float64) for v in gains])
    jpar, tpar = ja.ActuatorParams(**params), ta.ActuatorParams(**params)
    js, ts = jp.pid_init(jnp.float64), tp.pid_init(torch.float64, "cpu")
    jas, tas = ja.actuator_init(jpar, jnp.float64), ta.actuator_init(tpar, torch.float64, "cpu")
    j_out, t_out = [], []
    for e in errors:
        js, jc = jp.pid_step(jg, js, jnp.float64(e))
        ts, tc = tp.pid_step(tg, ts, torch.tensor(e, dtype=torch.float64))
        # the PID's command, or the non-finite error itself, so that the
        # actuator's fail-safe sees non-finite commands
        jas, ju = ja.actuator_step(jpar, jas, jc if np.isfinite(e) else jnp.float64(e))
        tas, tu = ta.actuator_step(tpar, tas, tc if np.isfinite(e)
                                   else torch.tensor(e, dtype=torch.float64))
        j_out.append((jc, ju))
        t_out.append((tc, tu))
    for i in range(2):
        _close(torch.stack([t[i] for t in t_out]), np.asarray([j[i] for j in j_out]))
    for name in js._fields:
        _close(getattr(ts, name), getattr(js, name))
    for name in jas._fields:
        _close(getattr(tas, name), getattr(jas, name))
    assert int(tas.faults) == int(jas.faults) == 4


@pytest.mark.parametrize("kp", [2.0, 0.0])
def test_reduced_shot_200_ticks(kp):
    """The 10 kHz lane's semantics at 1 kHz for 0.2 s (200 ticks); kp = 0
    with the other gains zero drifts into disruption."""
    kw = dict(control_hz=1000.0, shot_duration_s=0.2)
    if kp == 0.0:
        kw.update(pid_r_kp=0.0, pid_r_ki=0.0, pid_r_kd=0.0, pid_z_kp=0.0, pid_z_ki=0.0,
                  pid_z_kd=0.0, disruption_limit_m=0.1)
    jparams = jf.FlightSimParams(**kw)
    tparams = tf.FlightSimParams(**dataclasses.asdict(jparams))
    j_tr, j_m = jf.run_shot_reduced(jparams, dtype=jnp.float64)
    t_tr, t_m = tf.run_shot_reduced(tparams, dtype=torch.float64, device="cpu")
    assert t_tr.r.shape == (200,)
    for name in j_tr._fields:
        _close(getattr(t_tr, name), getattr(j_tr, name))
    assert j_m.keys() == t_m.keys()
    for key in j_m:
        _close(t_m[key], j_m[key])
    assert bool(t_tr.disrupted.any()) == (kp == 0.0)


def test_reduced_shot_traced_gains():
    jparams = jf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.2)
    gains = rng(3).uniform(0.0, 3.0, 6)
    j_tr, _ = jf.run_shot_reduced_gains(jparams, jnp.asarray(gains), dtype=jnp.float64)
    t_tr, _ = tf.run_shot_reduced_gains(tf.FlightSimParams(**dataclasses.asdict(jparams)),
                                        torch.tensor(gains), dtype=torch.float64)
    for name in j_tr._fields:
        _close(getattr(t_tr, name), getattr(j_tr, name))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subgrid_axis(seed):
    g = rng(seed)
    r, z = np.linspace(2.0, 10.0, 17), np.linspace(-4.0, 4.0, 21)
    rr, zz = np.meshgrid(r, z)
    r0, z0 = g.uniform(3.0, 9.0), g.uniform(-3.0, 3.0)
    psi = -((rr - r0) ** 2) - 0.7 * (zz - z0) ** 2 + 0.01 * g.standard_normal(rr.shape)
    if seed == 2:
        psi[0, 0] = psi.max() + 1.0     # the maximum on the edge: no parabolic step
    d_r, d_z = r[1] - r[0], z[1] - z[0]
    ref = jf.subgrid_axis(jnp.asarray(psi), jnp.asarray(r), jnp.asarray(z), d_r, d_z)
    ours = tf.subgrid_axis(torch.tensor(psi), torch.tensor(r), torch.tensor(z), d_r, d_z)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_default_device_is_the_card():
    """With no ``device`` the lanes run on CUDA; without a card they raise
    instead of falling back to the CPU."""
    from scpn_fusion_tpu_torch.bench_config import bench_config

    params = tf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.002)
    calls = (lambda: tf.run_shot_reduced(params), lambda: tp.pid_init(),
             lambda: ta.actuator_init(ta.ActuatorParams(tau_s=0.1, dt_s=0.01)),
             lambda: tf.run_shot_full(bench_config(17), shot_steps=1))
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
