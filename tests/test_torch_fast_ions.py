"""Port parity: the fast-ion ensemble (``models/physics/fast_ions``; row F's
plain twin ``ops/cuda_orbits.gc_ensemble_plain``) and the analytic field.

In float64 on the CPU, with JAX's draws fed to ``_sample_fast_ion_birth``:
the births equal JAX's; a 32-particle population followed 300 steps has its
final state within 1e-9 of JAX's (of each coordinate's largest magnitude),
equal passing, trapped and lost counts and the same fractions; the field's
forward-mode d|B|/dR and d|B|/dZ are within 1e-13 of ``jax.grad`` and of
``torch.func.grad`` off the axis, NaN on it as JAX's.  The formulary's
gates of ``tests/test_fast_ions.py`` hold for the port (its ensemble gates:
``test_torch_fast_ions_gates.py``).  The plain twin is the loop of
``ensemble_step``; an input that requires a gradient raises; row F's
argument block and constants list the C source's.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, c_struct_fields, ctypes_fields

from scpn_fusion_tpu.models.physics import fast_ions as jf
from scpn_fusion_tpu_torch.models.physics import fast_ions as tf
from scpn_fusion_tpu_torch.ops import cuda_orbits as co

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
R0, A, B0 = 6.2, 2.0, 5.3
WALLS = dict(r_wall_in=R0 - A - 0.5, r_wall_out=R0 + A + 0.5, z_wall=A + 0.5)
KW = dict(m_amu=jf.ALPHA_AMU, charge_z=jf.ALPHA_Z, dt=1e-8, **WALLS)
FIELD_J = jf.tokamak_field(B0, R0, A)    # one closure: each new one recompiles
FIELD_T = tf.tokamak_field(B0, R0, A)
SOURCE = Path(__file__).resolve().parent.parent / "scpn_fusion_tpu_torch" / "csrc" / "orbits.cu"


def jax_draws(key, n: int):
    """The draws ``sample_fast_ion_birth`` makes from ``key``: Beta(2, 5),
    theta and pitch, as float64 tensors."""
    k_r, k_th, k_pitch = jax.random.split(key, 3)
    beta = jax.random.beta(k_r, 2.0, 5.0, (n,))
    theta = jax.random.uniform(k_th, (n,), minval=0.0, maxval=2.0 * jnp.pi)
    pitch = jax.random.uniform(k_pitch, (n,), minval=0.0, maxval=jnp.pi)
    return [torch.from_numpy(np.array(x, dtype=np.float64)) for x in (beta, theta, pitch)]


def births(key, n: int, a: float):
    return (jf.sample_fast_ion_birth(key, n, FIELD_J, r0=R0, a=a),
            tf._sample_fast_ion_birth(*jax_draws(key, n), FIELD_T, r0=R0, a=a))


@pytest.mark.parametrize("point", [(6.9, 0.3), (5.0, -1.2), (7.5, 1.9), (6.2 + 5e-7, 0.0),
                                   (6.2, 4e-7)])
def test_field_gradient_matches_jax_grad_and_autograd(point):
    """Off the axis (also inside the 1e-6 floor of the minor radius, where
    the floor's derivative is 0) the forward-mode derivative is JAX's."""
    fj, ft = FIELD_J, FIELD_T
    r, z = point
    ref = np.asarray(jax.grad(lambda rz: jnp.sqrt(sum(b**2 for b in fj(rz[0], rz[1]))))(
        jnp.array([r, z])))
    rt, zt = torch.tensor(r, dtype=F64), torch.tensor(z, dtype=F64)
    *b, b_mag, g_r, g_z = ft.with_gradient(rt, zt)
    auto = torch.func.grad(lambda rr, zz: torch.sqrt(sum(x**2 for x in ft(rr, zz))),
                           argnums=(0, 1))(rt, zt)
    scale = float(np.max(np.abs(ref)))
    for ours, want in ((g_r, ref[0]), (g_z, ref[1]), (auto[0], ref[0]), (auto[1], ref[1])):
        assert abs(float(ours) - want) <= 1e-13 * scale, (float(ours), want)
    for ours, want in zip((*b, b_mag), (*fj(r, z), jnp.sqrt(sum(x**2 for x in fj(r, z))))):
        assert abs(float(ours) - float(want)) <= 1e-15 * B0


def test_field_gradient_on_the_axis_is_nan_as_jax():
    """At rm = 0 the square root has no finite derivative: JAX's gradient is
    NaN in both components, and so is the port's (|B| itself is B0)."""
    fj, ft = FIELD_J, FIELD_T
    ref = np.asarray(jax.grad(lambda rz: jnp.sqrt(sum(b**2 for b in fj(rz[0], rz[1]))))(
        jnp.array([R0, 0.0])))
    out = ft.with_gradient(torch.tensor(R0, dtype=F64), torch.tensor(0.0, dtype=F64))
    assert np.all(np.isnan(ref)) and bool(torch.isnan(out[4])) and bool(torch.isnan(out[5]))
    assert float(out[3]) == B0


def test_beta_2_5_moments():
    """The 2nd smallest of 6 uniforms is Beta(2, 5): mean 2/7, variance
    10/392 (200,000 draws: 6 standard errors)."""
    x = tf.beta_2_5(torch.Generator().manual_seed(5), 200_000, F64).numpy()
    var = 10.0 / 392.0
    assert abs(x.mean() - 2.0 / 7.0) < 6.0 * np.sqrt(var / x.size)
    assert abs(x.var() - var) < 6.0 * np.sqrt(2.0 / x.size) * var
    assert 0.0 < x.min() and x.max() < 1.0


def test_births_from_jax_draws_equal_jax():
    sj, st = births(jax.random.PRNGKey(0), 64, A)
    for ours, ref in zip(st, sj):
        np.testing.assert_allclose(as_np(ours), np.asarray(ref), rtol=1e-14, atol=0.0)


def test_birth_prior_shape():
    """``test_birth_prior_shape`` on the port's own draws (2048 particles)."""
    ft = tf.tokamak_field(B0, R0, A)
    s = tf.sample_fast_ion_birth(torch.Generator().manual_seed(1), 2048, ft, r0=R0, a=A, **CPU)
    rm = np.hypot(as_np(s.r) - R0, as_np(s.z))
    assert rm.max() < A and np.median(rm) < 0.45 * A
    v_par = as_np(s.v_par)
    assert (v_par > 0).mean() > 0.35 and (v_par < 0).mean() > 0.35
    br, bz, bp = ft(s.r, s.z)
    b_mag = np.sqrt(as_np(br)**2 + as_np(bz)**2 + as_np(bp)**2)
    m = tf.ALPHA_AMU * 1.66053906660e-27
    e_kev = (0.5 * m * v_par**2 + as_np(s.mu) * b_mag) / 1.602176634e-19 / 1e3
    np.testing.assert_allclose(e_kev, tf.ALPHA_BIRTH_KEV, rtol=1e-6)


@pytest.fixture(scope="module")
def followed_small():
    sj, st = births(jax.random.PRNGKey(3), 32, A)
    fj, ft = FIELD_J, FIELD_T
    return (jf.follow_ensemble(sj, fj, n_steps=300, **KW),
            tf.follow_ensemble(st, ft, n_steps=300, **KW), st)


def test_follow_ensemble_matches_jax(followed_small):
    """32 particles x 300 steps: the final state within 1e-9, the counts
    equal, the fractions and the energy audit JAX's (float64)."""
    rj, rt, _ = followed_small
    for ours, ref in zip(rt.final, rj.final):
        ref = np.asarray(ref)
        assert np.max(np.abs(as_np(ours) - ref)) <= TOL * np.max(np.abs(ref))
    for name in ("n_passing", "n_trapped", "n_lost"):
        assert int(getattr(rt, name)) == int(getattr(rj, name)), name
    assert int(rt.n_trapped) > 0
    for name in ("loss_fraction", "trapped_fraction"):
        ours = getattr(rt, name)
        assert ours.dtype == F64 and np.asarray(getattr(rj, name)).dtype == np.float64
        assert float(ours) == float(getattr(rj, name)), name
    assert abs(float(rt.energy_drift_rel_max) - float(rj.energy_drift_rel_max)) <= 1e-6 * float(
        rj.energy_drift_rel_max)


def test_follow_ensemble_is_deterministic(followed_small):
    _, rt, st = followed_small
    again = tf.follow_ensemble(st, tf.tokamak_field(B0, R0, A), n_steps=300, **KW)
    assert int(again.n_lost) == int(rt.n_lost)
    assert torch.equal(again.final.r, rt.final.r)


def test_walls_lose_and_freeze_as_jax():
    """Walls 0.6 m from the axis: particles are lost, frozen at their loss
    state; counts and final states equal JAX's (16 particles x 300 steps)."""
    sj, st = births(jax.random.PRNGKey(11), 16, 1.9)
    fj, ft = FIELD_J, FIELD_T
    kw = dict(m_amu=jf.ALPHA_AMU, charge_z=jf.ALPHA_Z, dt=1e-8, n_steps=300,
              r_wall_in=R0 - 0.6, r_wall_out=R0 + 0.6, z_wall=0.6)
    rj, rt = jf.follow_ensemble(sj, fj, **kw), tf.follow_ensemble(st, ft, **kw)
    assert int(rt.n_lost) == int(rj.n_lost) > 0
    assert int(rt.n_trapped) == int(rj.n_trapped)
    for ours, ref in zip(rt.final, rj.final):
        ref = np.asarray(ref)
        assert np.max(np.abs(as_np(ours) - ref)) <= TOL * np.max(np.abs(ref))


def test_first_orbit_loss_scaling():
    lo = float(tf.first_orbit_loss(R0, A, 15.0, **CPU))
    hi = float(tf.first_orbit_loss(R0, A, 3.0, **CPU))
    assert lo < hi <= 1.0
    hot = float(tf.first_orbit_loss(R0, A, 15.0, e_kev=2 * tf.ALPHA_BIRTH_KEV, **CPU))
    assert hot > lo
    for ip in (2.0, 5.0, 15.0):
        ref = float(jf.first_orbit_loss(R0, A, ip))
        assert abs(float(tf.first_orbit_loss(R0, A, ip, **CPU)) - ref) <= 1e-14 * ref
    m = tf.ALPHA_AMU * 1.66053906660e-27
    v = np.sqrt(2 * tf.ALPHA_BIRTH_KEV * 1e3 * 1.602176634e-19 / m)
    b_pol = 1.25663706212e-6 * 15e6 / (2 * np.pi * A)
    np.testing.assert_allclose(lo, min(1.0, m * v / (tf.ALPHA_Z * 1.602176634e-19 * b_pol) / A),
                               rtol=1e-12)


def test_slowing_down_formulary():
    """``test_slowing_down_formulary``'s gates, and each function within
    1e-12 of JAX's."""
    lnl = float(tf.coulomb_log_ei(20.0, 1.0, **CPU))
    assert 15.0 < lnl < 20.0
    tau = float(tf.tau_spitzer_electron(20.0, 1.0, **CPU))
    assert 0.6 < tau < 1.5 and 0.2 < float(tf.tau_spitzer_electron(10.0, 1.0, **CPU)) < 0.5
    v_c = float(tf.critical_velocity(20.0, **CPU))
    m = tf.ALPHA_AMU * 1.66053906660e-27
    v_birth = np.sqrt(2 * tf.ALPHA_BIRTH_KEV * 1e3 * 1.602176634e-19 / m)
    assert v_birth > v_c
    f_i, f_e = tf.heating_partition(v_birth, v_c, **CPU)
    assert float(f_e) > 0.5 > float(f_i) and np.isclose(float(f_i) + float(f_e), 1.0)
    f_i2, f_e2 = tf.heating_partition(0.5 * v_c, v_c, **CPU)
    assert float(f_i2) > 0.5 > float(f_e2)
    t1 = float(tf.slowing_down_time(v_birth, v_c, v_c, tau, **CPU))
    t2 = float(tf.slowing_down_time(v_birth, 2.0 * v_c, v_c, tau, **CPU))
    assert 0.0 < t2 < t1 < 3.0 * tau
    te = torch.linspace(5.0, 25.0, 16, dtype=F64)
    taus = tf.tau_spitzer_electron(te, torch.full((16,), 1.0, dtype=F64))
    assert taus.shape == (16,) and bool(torch.all(torch.diff(taus) > 0))
    pairs = ((tf.coulomb_log_ei(20.0, 1.0, **CPU), jf.coulomb_log_ei(20.0, 1.0)),
             (tf.critical_velocity(20.0, **CPU), jf.critical_velocity(20.0)),
             (tf.tau_spitzer_electron(20.0, 1.0, **CPU), jf.tau_spitzer_electron(20.0, 1.0)),
             (tf.slowing_down_time(v_birth, v_c, v_c, tau, **CPU),
              jf.slowing_down_time(v_birth, v_c, v_c, tau)),
             (tf.heating_partition(v_birth, v_c, **CPU)[0], jf.heating_partition(v_birth, v_c)[0]),
             (taus, jf.tau_spitzer_electron(jnp.linspace(5.0, 25.0, 16), jnp.full((16,), 1.0))))
    for ours, ref in pairs:
        ref = np.asarray(ref)
        assert np.max(np.abs(as_np(ours) - ref)) <= 1e-12 * np.max(np.abs(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_twin_is_the_module_step_loop(dtype):
    """``gc_ensemble_plain`` equals the loop of ``fast_ions.ensemble_step``
    written out here, bit for bit (16 particles x 60 steps, walls that lose
    some)."""
    ft = tf.tokamak_field(B0, R0, A)
    st = tf.sample_fast_ion_birth(torch.Generator().manual_seed(2), 16, ft, r0=R0, a=1.9,
                                  dtype=dtype, device="cpu")
    c = tf.ensemble_constants(jf.ALPHA_AMU, jf.ALPHA_Z, 1e-7, R0 - 1.2, R0 + 1.2, 1.2, dtype,
                              "cpu")
    y_f, lost, bounced, drift = co.gc_ensemble_plain(c, ft, torch.stack(list(st)), 60)
    y = (st.r, st.z, st.phi, st.v_par)
    e0 = tf.ensemble_energy(c, ft, y, st.mu)
    flags = (torch.zeros(16, dtype=torch.bool), torch.zeros(16, dtype=torch.bool))
    for _ in range(60):
        y, *flags = tf.ensemble_step(c, ft, y, st.mu, *flags, torch.sign(st.v_par))
    assert torch.equal(y_f, torch.stack(y, dim=1))
    assert torch.equal(lost, flags[0]) and torch.equal(bounced, flags[1]) and bool(lost.any())
    assert torch.equal(drift, torch.abs(tf.ensemble_energy(c, ft, y, st.mu) - e0) / e0)
    assert y_f.dtype == dtype


def test_a_generic_field_takes_the_plain_loop():
    """A lambda field (no forward-mode derivative): grad |B| by
    ``torch.func.grad``, the same statistics as JAX's (8 x 100)."""
    def field_j(r, z):
        return -0.1 * z, 0.1 * (r - R0), B0 * R0 / r

    sj, st = births(jax.random.PRNGKey(4), 8, 1.0)
    kw = dict(m_amu=jf.ALPHA_AMU, charge_z=jf.ALPHA_Z, dt=1e-8, n_steps=100, **WALLS)
    rj = jf.follow_ensemble(sj, field_j, **kw)
    rt = tf.follow_ensemble(st, field_j, **kw)
    for ours, ref in zip(rt.final, rj.final):
        ref = np.asarray(ref)
        assert np.max(np.abs(as_np(ours) - ref)) <= TOL * np.max(np.abs(ref))
    assert int(rt.n_trapped) == int(rj.n_trapped)


def test_row_f_refuses_gradients_and_host_tensors():
    ft = tf.tokamak_field(B0, R0, A)
    c = tf.ensemble_constants(jf.ALPHA_AMU, jf.ALPHA_Z, 1e-8, **WALLS, dtype=F64, device="cpu")
    state = torch.ones((5, 4), dtype=F64, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        co.gc_ensemble(c, ft, state, 3)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        co.gc_orbit(c, ft, state[:, 0], 3)
    consts = co.kernel_constants(c, ft, walls=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        co.check_inputs("gc_ensemble", consts, state.detach(), 5)
    with pytest.raises(TypeError, match="tokamak_field"):
        co.kernel_constants(c, lambda r, z: (r, z, r), walls=True)


def test_argument_block_and_constants_list_the_c_source():
    src = SOURCE.read_text()
    assert ctypes_fields(co._Args) == c_struct_fields(src, "OrbitArgs")
    body = re.search(r"enum Const \{(.*?)\};", src, re.S).group(1)
    names = [item.split("=")[0].strip() for item in re.sub(r"//[^\n]*", "", body).split(",")]
    names = [n for n in names if n and not n.startswith("kN")]
    want = [*co.STEP, *tf.TokamakField.CONSTANTS, *co.WALLS]
    assert [n.lower() for n in names] == ["k" + w.replace("_", "") for w in want]


def test_bare_calls_need_the_card():
    """The entry points of Python numbers default to ``device="cuda"``."""
    ft = tf.tokamak_field(B0, R0, A)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tf.sample_fast_ion_birth(torch.Generator().manual_seed(0), 4, ft, r0=R0, a=A)
    with pytest.raises((AssertionError, RuntimeError)):
        tf.first_orbit_loss(R0, A, 15.0)
