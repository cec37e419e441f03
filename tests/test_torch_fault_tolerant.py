"""Port parity: fault-tolerant control and the EKF
(``control/{fault_tolerant, estimator}.py``).

The JAX tests' seeded Jacobian (``tests/test_fault_tolerant.py``) and filter
(``tests/test_estimator_hinf.py``) go through both packages in float64: the
reconfigured allocation gain, the fault-state updates, the stuck-coil
compensation, the controllability check (``torch.linalg.svdvals``), the
sensor-fault injector, whole faulted shots (coil losses, a stuck coil, and
JAX's ``vmap`` over fault scenarios, which the port runs one scenario at a
time), each within 1e-9 (the allocation solves a system of condition ~1e6);
and 200 EKF ticks within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.control import estimator as je
from scpn_fusion_tpu.control import fault_tolerant as jft
from scpn_fusion_tpu_torch.control import estimator as te
from scpn_fusion_tpu_torch.control import fault_tolerant as tft

TOL = 1e-9
F64 = torch.float64


def _close(ours, ref, tol=TOL):
    a, b = as_np(ours), as_np(ref)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1e-300) if b.size else 1.0
    assert float(np.max(np.abs(a - b), initial=0.0)) <= tol * scale


def _jacobian(n_s=4, n_c=6, seed=0):
    j = np.random.default_rng(seed).standard_normal((n_s, n_c))
    return jnp.asarray(j), torch.tensor(j)


def _states(faults):
    """The same fault history applied in both packages."""
    js, ts = jft.init_fault_state(6, 4, jnp.float64), tft.init_fault_state(6, 4, F64, "cpu")
    for kind, idx, *val in faults:
        if kind in (tft.ACTUATOR_LOSS, tft.ACTUATOR_STUCK):
            js = jft.apply_actuator_fault(js, idx, kind, *val)
            ts = tft.apply_actuator_fault(ts, idx, kind, *val)
        else:
            js = jft.apply_sensor_fault(js, idx, kind)
            ts = tft.apply_sensor_fault(ts, idx, kind)
    for name in js._fields:
        _close(getattr(ts, name), getattr(js, name), 0.0)
    return js, ts


FAULTS = {
    "nominal": [],
    "lost": [(tft.ACTUATOR_LOSS, 2)],
    "stuck_and_dropout": [(tft.ACTUATOR_STUCK, 0, 1.0), (tft.SENSOR_DROPOUT, 1),
                          (tft.SENSOR_NOISE, 3), (tft.ACTUATOR_LOSS, -1)],
    "majority_lost": [(tft.ACTUATOR_LOSS, c) for c in (0, 1, 2, 3)],
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_allocation_and_checks(case):
    jj, tj = _jacobian()
    js, ts = _states(FAULTS[case])
    _close(tft.reconfig_gain(tj, ts), jft.reconfig_gain(jj, js))
    err = np.array([0.3, -0.2, 0.1, 0.0])
    _close(tft.ft_step(tj, ts, torch.tensor(err)), jft.ft_step(jj, js, jnp.asarray(err)))
    assert bool(tft.controllability_ok(tj, ts)) == bool(jft.controllability_ok(jj, js))
    assert bool(tft.controllability_ok(tj, ts)) == (case != "majority_lost")


def test_injector_and_shutdown():
    sig = np.array([1.0, 2.0, 3.0])
    for t, idx, kind, sev in ((5.0, 1, tft.SENSOR_DROPOUT, 1.0), (5.0, 2, tft.SENSOR_DRIFT, 0.5),
                              (1.0, 1, tft.SENSOR_DROPOUT, 1.0)):
        _close(tft.inject_sensor_fault(t, torch.tensor(sig), 3.0, idx, kind, sev),
               jft.inject_sensor_fault(t, jnp.asarray(sig), 3.0, idx, kind, sev), 0.0)
    assert torch.equal(tft.graceful_shutdown(6, device="cpu"), torch.zeros(6))


SHOTS = {
    "two_losses": dict(fault_times=[50, 80, -1], fault_kinds=[3, 3, 0],
                       fault_indices=[0, 3, -1]),
    "stuck": dict(fault_times=[60, -1, -1], fault_kinds=[4, 0, 0], fault_indices=[2, -1, -1],
                  fault_values=[3.0, 0.0, 0.0], n_steps=250),
    "sensors": dict(fault_times=[20, 40, 90], fault_kinds=[0, 1, 3], fault_indices=[1, 2, 5],
                    n_steps=120),
}


@pytest.mark.parametrize("case", sorted(SHOTS))
def test_whole_shot(case):
    jj, tj = _jacobian()
    target = np.array([1.0, -0.5, 0.3, 0.8])
    kw = dict(SHOTS[case])
    n_steps = kw.pop("n_steps", 200)
    ref = jft.run_fault_tolerant_shot(jj, jnp.asarray(target), n_steps=n_steps,
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
    ours = tft.run_fault_tolerant_shot(tj, torch.tensor(target), n_steps=n_steps,
                                       **{k: torch.tensor(v) for k, v in kw.items()})
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))
    assert torch.equal(ours.controllable, torch.from_numpy(np.array(ref.controllable)))


def test_vmapped_shots_one_at_a_time():
    """``tests/test_fault_tolerant.py``'s ``vmap`` over which coil is lost:
    the port runs each scenario and matches JAX's batched results."""
    jj, tj = _jacobian()
    target = np.array([1.0, -0.5, 0.3, 0.8])

    def shot(idx):
        return jft.run_fault_tolerant_shot(
            jj, jnp.asarray(target), fault_times=jnp.asarray([40, -1, -1]),
            fault_kinds=jnp.asarray([jft.ACTUATOR_LOSS, 0, 0]),
            fault_indices=jnp.stack([idx, -1, -1]), n_steps=120).error_norm

    ref = np.asarray(jax.jit(jax.vmap(shot))(jnp.arange(6)))
    for idx in range(6):
        ours = tft.run_fault_tolerant_shot(
            tj, torch.tensor(target), fault_times=torch.tensor([40, -1, -1]),
            fault_kinds=torch.tensor([tft.ACTUATOR_LOSS, 0, 0]),
            fault_indices=torch.tensor([idx, -1, -1]), n_steps=120).error_norm
        _close(ours, ref[idx])


def test_ekf_200_ticks():
    x0 = np.array([6.0, 0.1, 0.0, 0.0, 15.0, 10.0])
    p0, q, r = np.eye(6) * 0.1, np.eye(6) * 1e-4, np.eye(4) * 1e-3
    js = je.ekf_init(jnp.asarray(x0), jnp.asarray(p0))
    ts = te.ekf_init(torch.tensor(x0), torch.tensor(p0))
    noise = np.random.default_rng(0).standard_normal(200)
    true_r = 6.0
    for k in range(200):
        true_r += 0.2 * 0.01
        z = np.array([true_r + 0.01 * noise[k], 0.1, 15.0, 10.0])
        js = je.ekf_step(js, jnp.asarray(z), jnp.asarray(q), jnp.asarray(r), 0.01)
        ts = te.ekf_step(ts, torch.tensor(z), torch.tensor(q), torch.tensor(r), 0.01)
    _close(ts.x, js.x, 1e-12)
    _close(ts.p, js.p, 1e-12)
    assert abs(float(ts.x[0]) - true_r) < 0.02 and 0.05 < float(ts.x[2]) < 0.4
    _close(te.measurement_matrix(device="cpu"), je.measurement_matrix(jnp.float64), 0.0)
