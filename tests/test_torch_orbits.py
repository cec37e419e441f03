"""Port parity: the guiding-centre orbit and the Boris pusher
(``models/physics/orbits``; row F's orbit twin ``ops/cuda_orbits.gc_orbit_plain``).

In float64 on the CPU: ``init_guiding_center`` equals JAX's; a 2000-step
orbit in ``fast_ions.tokamak_field`` (the row-F path's plain twin) and a
500-step orbit in the lambda field of ``TestOrbits`` (the plain loop with
``torch.func.grad``) have traces and final states within 1e-9 of JAX's (of
each coordinate's largest magnitude); 1000 Boris steps, and a 4-particle
ensemble of 200, within 1e-9.  ``TestOrbits`` (``test_edge_orbits_frc.py:
79-133``) holds for the port: the lambda-field energy audit at 1000 steps
(JAX's test: 20,000), the Boris gyration at its 5000 steps, the E x B drift
at 8000 steps (JAX's test: 40,000; its drift gate is 5%, the gyration's
residue ~1e-3 of the drift at 8000).  The plain twin is the loop of
``orbits.gc_rk4_step``, and ``run_guiding_center`` on a CPU tensor launches
no kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.models.physics import fast_ions as jf
from scpn_fusion_tpu.models.physics import orbits as jo
from scpn_fusion_tpu_torch.models.physics import fast_ions as tf
from scpn_fusion_tpu_torch.models.physics import orbits as to
from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops import cuda_orbits as co

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
FIELD_J = jf.tokamak_field(5.3, 6.2, 2.0)
FIELD_T = tf.tokamak_field(5.3, 6.2, 2.0)
Q_OVER_M = 1.602176634e-19 / (2.0 * 1.66053906660e-27)


def lambda_field(r, z, b0=5.3, r0=6.2):
    """``TestOrbits._tokamak_field``: works on JAX arrays and on tensors."""
    return -0.1 * z, 0.1 * (r - r0), b0 * r0 / r


def close(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    return float(np.max(np.abs(as_np(ours) - ref))) <= tol * float(np.max(np.abs(ref)))


GC = dict(m_amu=2.0, charge_z=1, e_kev=80.0, pitch_angle=0.4, r0=6.8, z0=0.0)


@pytest.fixture(scope="module")
def tokamak_orbits():
    sj = jo.init_guiding_center(FIELD_J, **GC)
    st = to.init_guiding_center(FIELD_T, **GC, **CPU)
    kw = dict(m_amu=2.0, charge_z=1, dt=1e-8, n_steps=2000)
    return (sj, st, jo.run_guiding_center(sj, FIELD_J, **kw),
            to.run_guiding_center(st, FIELD_T, **kw))


def test_init_guiding_center_matches_jax(tokamak_orbits):
    sj, st, _, _ = tokamak_orbits
    for ours, ref in zip(st, sj):
        assert ours.dtype == F64 and ours.dim() == 0
        assert abs(float(ours) - float(ref)) <= 1e-15 * max(abs(float(ref)), 1e-300)


def test_tokamak_field_orbit_matches_jax(tokamak_orbits):
    """2000 steps through the row-F path's plain twin."""
    _, _, (fj, trj), (ft, trt) = tokamak_orbits
    assert trt["r"].shape == (2000,) and trt["z"].shape == (2000,)
    assert close(trt["r"], trj["r"]) and close(trt["z"], trj["z"])
    for ours, ref in zip(ft, fj):
        assert close(ours, ref)


def test_orbit_path_launches_no_kernel_on_the_cpu(tokamak_orbits):
    _, st, _, (ft, trt) = tokamak_orbits
    cb.reset_launch_counts()
    c = to.step_constants(2.0, 1, 1e-8, F64, "cpu")
    y, r_tr, z_tr = co.gc_orbit(c, FIELD_T, torch.stack(list(st)), 50)
    assert sum(cb.CALLS.values()) == 0 and cb.kernel_launches() == 0
    assert torch.equal(r_tr, trt["r"][:50]) and torch.equal(z_tr, trt["z"][:50])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_orbit_plain_twin_is_the_module_step_loop(dtype):
    st = to.init_guiding_center(FIELD_T, **GC, dtype=dtype, device="cpu")
    c = to.step_constants(2.0, 1, 1e-8, dtype, "cpu")
    fin, r_tr, z_tr = co.gc_orbit_plain(c, FIELD_T, torch.stack(list(st)), 40)
    y = (st.r, st.z, st.phi, st.v_par)
    rs = []
    for _ in range(40):
        y = to.gc_rk4_step(c, y, st.mu, FIELD_T)
        rs.append(y[0])
    assert torch.equal(fin, torch.stack(y)) and torch.equal(r_tr, torch.stack(rs))
    assert fin.dtype == dtype


@pytest.fixture(scope="module")
def lambda_orbits():
    sj = jo.init_guiding_center(lambda_field, **GC)
    st = to.init_guiding_center(lambda_field, **GC, **CPU)
    kw = dict(m_amu=2.0, charge_z=1, dt=1e-8)
    return (jo.run_guiding_center(sj, lambda_field, n_steps=500, **kw),
            to.run_guiding_center(st, lambda_field, n_steps=1000, **kw))


def test_lambda_field_orbit_matches_jax(lambda_orbits):
    """The plain loop with grad |B| by ``torch.func.grad``: its first 500
    steps against JAX's 500-step orbit."""
    (fj, trj), (_, trt) = lambda_orbits
    assert close(trt["r"][:500], trj["r"]) and close(trt["z"][:500], trj["z"])


def test_guiding_center_conserves_energy(lambda_orbits):
    """``TestOrbits.test_guiding_center_conserves_energy`` at 1000 of its
    20,000 steps."""
    _, (final, tr) = lambda_orbits
    r = as_np(tr["r"])
    assert np.all(np.isfinite(r)) and np.all((r > 4.0) & (r < 9.0))
    m = 2.0 * 1.66053906660e-27
    br, bz, bphi = lambda_field(float(final.r), float(final.z))
    b_mag = np.sqrt(br**2 + bz**2 + bphi**2)
    e_final = 0.5 * m * float(final.v_par) ** 2 + float(final.mu) * b_mag
    np.testing.assert_allclose(e_final, 80.0e3 * 1.602176634e-19, rtol=0.02)


def _boris(n_steps, e, b, v0, dt):
    field_j = lambda x: (jnp.asarray(e), jnp.asarray(b))  # noqa: E731
    ej, bj = torch.tensor(e, dtype=F64), torch.tensor(b, dtype=F64)
    field_t = lambda x: (ej, bj)  # noqa: E731
    sj = jo.BorisState(jnp.zeros(3), jnp.asarray(v0))
    st = to.BorisState(torch.zeros(3, dtype=F64), torch.tensor(v0, dtype=F64))
    return (jo.run_boris(sj, field_j, q_over_m=Q_OVER_M, dt=dt, n_steps=n_steps),
            to.run_boris(st, field_t, q_over_m=Q_OVER_M, dt=dt, n_steps=n_steps))


def test_boris_step_matches_jax():
    g = np.random.default_rng(19)
    x, v, e, b = (g.standard_normal(3) * s for s in (1.0, 1e6, 1e4, 3.0))
    ref = jo.boris_step(jo.BorisState(jnp.asarray(x), jnp.asarray(v)), jnp.asarray(e),
                        jnp.asarray(b), q_over_m=Q_OVER_M, dt=1e-9)
    ours = to.boris_step(to.BorisState(torch.tensor(x), torch.tensor(v)), torch.tensor(e),
                         torch.tensor(b), q_over_m=Q_OVER_M, dt=1e-9)
    for a, r in zip(ours, ref):
        assert close(a, r, 1e-14)


def test_boris_gyration_matches_jax_and_conserves_energy():
    """``test_boris_gyration_conserves_energy_exactly`` at its 5000 steps;
    the first 1000 positions within 1e-9 of JAX's."""
    (fj, trj), (ft, trt) = _boris(5000, [0.0, 0.0, 0.0], [0.0, 0.0, 5.0], [1e6, 0.0, 0.0], 1e-9)
    assert trt["x"].shape == (5000, 3) and trt["energy"].shape == (5000,)
    assert close(trt["x"][:1000], np.asarray(trj["x"])[:1000])
    assert close(trt["energy"], trj["energy"])
    en = as_np(trt["energy"])
    np.testing.assert_allclose(en, en[0], rtol=1e-6)
    x = as_np(trt["x"])
    np.testing.assert_allclose(0.5 * (x[:, 0].max() - x[:, 0].min()), 1e6 / (Q_OVER_M * 5.0),
                               rtol=0.01)


def test_boris_exb_drift():
    """``test_boris_exb_drift`` at 8000 of its 40,000 steps."""
    st = to.BorisState(torch.zeros(3, dtype=F64), torch.zeros(3, dtype=F64))
    e, b = torch.tensor([0.0, 1e4, 0.0], dtype=F64), torch.tensor([0.0, 0.0, 2.0], dtype=F64)
    final, _ = to.run_boris(st, lambda x: (e, b), q_over_m=Q_OVER_M, dt=5e-9, n_steps=8000)
    np.testing.assert_allclose(float(final.x[0]) / (5e-9 * 8000), 1e4 / 2.0, rtol=0.05)


def test_boris_ensemble_is_one_batch_as_jax_vmap():
    """4 particles x 200 steps in a field that depends on the position: the
    traces (4, 200, 3) and (4, 200) within 1e-9 of JAX's ``vmap``."""
    def field_j(x):
        return jnp.asarray([0.0, 1e3 * x[0], 0.0]), jnp.asarray([0.0, 0.0, 2.0 + x[1]])

    def field_t(x):
        zero = torch.zeros_like(x[0])
        return torch.stack([zero, 1e3 * x[0], zero]), torch.stack([zero, zero, 2.0 + x[1]])

    g = np.random.default_rng(7)
    x0, v0 = g.standard_normal((4, 3)) * 0.1, g.standard_normal((4, 3)) * 1e5
    fj, trj = jo.run_boris_ensemble(jo.BorisState(jnp.asarray(x0), jnp.asarray(v0)), field_j,
                                    q_over_m=Q_OVER_M, dt=1e-9, n_steps=200)
    ft, trt = to.run_boris_ensemble(to.BorisState(torch.tensor(x0), torch.tensor(v0)), field_t,
                                    q_over_m=Q_OVER_M, dt=1e-9, n_steps=200)
    assert trt["x"].shape == (4, 200, 3) and trt["energy"].shape == (4, 200)
    assert close(trt["x"], trj["x"]) and close(trt["energy"], trj["energy"])
    assert close(ft.v, fj.v)


def test_init_guiding_center_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        to.init_guiding_center(FIELD_T, **GC)
