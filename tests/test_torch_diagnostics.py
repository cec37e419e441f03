"""Port parity: synthetic diagnostics (``models/diagnostics/forward``) and
tomography (``models/diagnostics/tomography``).

float64 on the CPU, on numpy-seeded chords and the analytic plasma of
``tests/test_diagnostics_surrogates.py``.  The channel families (batched
gathers over chord and sample) within 1e-13 of JAX, nearest indices equal
(``torch.round`` and ``jnp.round`` both round half to even, exercised on
exact half-step points), the magnetic probes within 1e-13.  The geometry
matrix within 1e-15 (the port multiplies a chord's sample length by an
exact sample count; JAX's einsum adds the lengths one by one) and bit-equal
from run to run; the three reconstructions at 500 iterations within 1e-11
(ridge: a dense solve of an ill-conditioned system), each passing the JAX
test's peak and correlation gates on the port's own geometry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, to_torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.diagnostics import forward as jf
from scpn_fusion_tpu.models.diagnostics import tomography as jt
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.diagnostics import forward as tf
from scpn_fusion_tpu_torch.models.diagnostics import tomography as tt

F64 = torch.float64
RES, R_MIN, R_MAX, Z_MIN, Z_MAX = 16, 4.0, 8.5, -3.0, 3.0


def plasma(n: int = 65):
    jg = JGrid.from_bounds(n, n, 4.0, 8.4, -2.2, 2.2, dtype=np.float64)
    tg = TGrid.from_bounds(n, n, 4.0, 8.4, -2.2, 2.2, dtype=F64, device="cpu")
    rr, zz = np.asarray(jg.RR), np.asarray(jg.ZZ)
    rho2 = ((rr - 6.2) / 2.0) ** 2 + (zz / 2.0) ** 2
    ne = 8e19 * np.maximum(1 - rho2, 0.0)
    te = 15.0 * np.maximum(1 - rho2, 0.0) + 0.1
    return jg, tg, ne, te


def random_chords(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    ends = [np.stack([rng.uniform(3.8, 8.6, n), rng.uniform(-2.4, 2.4, n)], 1) for _ in range(2)]
    return np.stack(ends, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_channels_match_jax(seed):
    jg, tg, ne, te = plasma()
    chords = random_chords(seed)
    pts = np.concatenate([chords[:, 0], [[6.2, 0.0], [4.0 + 0.5 * jg.dR, 0.5 * jg.dZ]]])
    kw = dict(volume_element_m3=jg.dR * jg.dZ * 2 * np.pi * 6.2)
    ref = jf.generate_forward_channels(
        ne_m3=jnp.asarray(ne), te_kev=jnp.asarray(te), neutron_source=jnp.asarray(ne * 1e-9),
        grid=jg, chords=jnp.asarray(chords), thomson_points=jnp.asarray(pts),
        ece_channels=jnp.asarray(pts[:, 0]), **kw)
    ours = tf.generate_forward_channels(
        ne_m3=to_torch(ne), te_kev=to_torch(te), neutron_source=to_torch(ne * 1e-9), grid=tg,
        chords=to_torch(chords), thomson_points=to_torch(pts), ece_channels=to_torch(pts[:, 0]),
        **kw)
    for name, a, b in zip(ref._fields, ours, ref):
        assert rel(a, b) <= 1e-13, name
    vals = to_torch(4.0 + (np.arange(9) + 0.5) * jg.dR)     # exact half steps
    assert np.array_equal(tf._nearest_indices(4.0, jg.dR, 65, vals).numpy(),
                          np.asarray(jf._nearest_indices(4.0, jg.dR, 65, jnp.asarray(vals.numpy()))))
    ti, vrot = tf.cxrs_ion_diagnostics(to_torch(te), to_torch(3.0 * te), tg, to_torch(chords))
    rti, rvrot = jf.cxrs_ion_diagnostics(jnp.asarray(te), jnp.asarray(3.0 * te), jg,
                                         jnp.asarray(chords))
    assert rel(ti, rti) <= 1e-13 and rel(vrot, rvrot) <= 1e-13
    assert rel(tf.line_integral_nearest(to_torch(te), tg, to_torch(chords), samples=513),
               jf.line_integral_nearest(jnp.asarray(te), jg, jnp.asarray(chords),
                                        samples=513)) <= 1e-13


def test_forward_gates_of_the_jax_tests():
    """``tests/test_diagnostics_surrogates.py``'s forward gates on the port."""
    _, tg, ne, te = plasma()
    chords = to_torch(np.array([[[4.0, 0.0], [8.4, 0.0]], [[4.0, 1.8], [8.4, 1.8]]]))
    field = torch.ones(tg.shape, dtype=F64)
    assert abs(float(tf.line_integral_nearest(field, tg, chords[:1])[0]) - 4.4) <= 0.02 * 4.4
    ph = tf.interferometer_phase_shift(to_torch(ne), tg, chords)
    assert float(ph[0]) > float(ph[1]) > 0.0
    assert rel(tf.interferometer_phase_shift(2.0 * to_torch(ne), tg, chords), 2.0 * ph) <= 1e-12
    ece = tf.ece_radiometer_temperature(to_torch(te), tg, to_torch(np.array([6.2, 7.8])))
    assert float(ece[0]) > float(ece[1]) and abs(float(ece[0]) - 15.1) <= 0.05 * 15.1
    ti, vr = tf.cxrs_ion_diagnostics(to_torch(te), torch.full(tg.shape, 100.0, dtype=F64), tg,
                                     chords[:1], beam_r_center=6.2, beam_width=0.1)
    assert abs(float(vr[0]) - 100.0) <= 1e-6 * 100.0 and abs(float(ti[0]) - 15.1) <= 0.05 * 15.1
    src = torch.full((16, 16), 1e14, dtype=F64)
    r1 = float(tf.neutron_count_rate(src, volume_element_m3=0.01))
    assert r1 > 0 and np.isclose(float(tf.neutron_count_rate(2 * src, volume_element_m3=0.01)),
                                 2 * r1)


def test_magnetic_probes_match_jax():
    jg, tg, _, _ = plasma()
    rng = np.random.default_rng(2)
    psi = rng.normal(size=(65, 65)).cumsum(0).cumsum(1) * 1e-2 + 0.5 * np.asarray(jg.ZZ) ** 2
    pts = np.stack([rng.uniform(4.1, 8.3, 9), rng.uniform(-2.1, 2.1, 9)], 1)
    ours = tf.synthetic_magnetic_probes(to_torch(psi), tg, to_torch(pts))
    ref = jf.synthetic_magnetic_probes(jnp.asarray(psi), jg, jnp.asarray(pts))
    for a, b in zip(ours, ref):
        assert rel(a, b) <= 1e-13
    zz = tg.ZZ
    psi_p, b_r, _ = tf.synthetic_magnetic_probes(0.5 * zz**2, tg,
                                                 to_torch(np.array([[6.0, 1.0], [6.0, -1.0]])))
    assert np.allclose(psi_p.numpy(), 0.5, atol=2e-3)
    assert np.allclose(b_r.numpy(), [-1.0 / 6.0, 1.0 / 6.0], rtol=1e-3)


def geometry_pair():
    s1, e1 = jt.fan_chords(13.0, 0.0, n_chords=24, r_target=2.5, z_span=4.5, dtype=jnp.float64)
    r_hits = np.linspace(4.5, 8.0, 24)
    s2 = np.stack([r_hits, np.full(24, 4.0)], 1)
    e2 = np.stack([r_hits, np.full(24, -4.0)], 1)
    starts, ends = np.concatenate([np.asarray(s1), s2]), np.concatenate([np.asarray(e1), e2])
    ts1, te1 = tt.fan_chords(13.0, 0.0, n_chords=24, r_target=2.5, z_span=4.5, dtype=F64,
                             device="cpu")
    assert torch.equal(ts1, to_torch(s1)) and rel(te1, e1) <= 1e-15   # eager jnp.linspace
    ref = jt.build_geometry_matrix(jnp.asarray(starts), jnp.asarray(ends), R_MIN, R_MAX, Z_MIN,
                                   Z_MAX, res=RES, n_samples=120)
    ours = tt.build_geometry_matrix(to_torch(starts), to_torch(ends), R_MIN, R_MAX, Z_MIN, Z_MAX,
                                    res=RES, n_samples=120)
    return ref, ours, (starts, ends)


def phantom():
    r, z = np.linspace(R_MIN, R_MAX, RES), np.linspace(Z_MIN, Z_MAX, RES)
    rr, zz = np.meshgrid(r, z)
    return np.exp(-((rr - 6.2) ** 2 + zz**2) / 0.8).reshape(-1)


def test_geometry_matrix_matches_jax_and_is_deterministic():
    ref, ours, (starts, ends) = geometry_pair()
    assert ours.shape == (48, RES * RES) and bool((ours >= 0).all())
    assert rel(ours, ref) <= 1e-15
    again = tt.build_geometry_matrix(to_torch(starts), to_torch(ends), R_MIN, R_MAX, Z_MIN,
                                     Z_MAX, res=RES, n_samples=120)
    assert torch.equal(again, ours)
    assert int((ours.sum(dim=1) > 0).sum()) >= 40
    outside = tt.build_geometry_matrix(to_torch(np.array([[20.0, 10.0]])),
                                       to_torch(np.array([[25.0, 12.0]])), R_MIN, R_MAX, Z_MIN,
                                       Z_MAX, res=RES)
    assert float(outside.sum()) == 0.0
    assert torch.equal(tt._laplacian_operator(5, F64, "cpu"),
                       to_torch(jt._laplacian_operator(5, jnp.float64)))


@pytest.mark.parametrize("method", ["nnls", "sart", "ridge"])
def test_reconstruction_matches_jax(method):
    ref_a, ours_a, _ = geometry_pair()
    signals = np.asarray(ref_a) @ phantom()
    ref = jt.reconstruct(ref_a, jnp.asarray(signals), res=RES, lambda_reg=0.01, method=method,
                         n_iters=500)
    ours = tt.reconstruct(to_torch(ref_a), to_torch(signals), res=RES, lambda_reg=0.01,
                          method=method, n_iters=500)
    assert rel(ours, ref) <= 1e-11
    # the JAX test's gates on the port's own geometry
    img = tt.reconstruct(ours_a, ours_a @ to_torch(phantom()), res=RES, lambda_reg=0.01,
                         method=method, n_iters=500).numpy()
    assert img.shape == (RES, RES) and np.all(img >= 0)
    truth = phantom().reshape(RES, RES)
    interior = img[1:-1, 1:-1]
    pk_t = np.unravel_index(truth[1:-1, 1:-1].argmax(), interior.shape)
    pk_r = np.unravel_index(interior.argmax(), interior.shape)
    assert abs(pk_t[0] - pk_r[0]) <= 2 and abs(pk_t[1] - pk_r[1]) <= 2
    assert np.corrcoef(truth.reshape(-1), img.reshape(-1))[0, 1] > 0.6


def test_reconstruction_sanitises_bad_signals():
    _, a, _ = geometry_pair()
    signals = a @ to_torch(phantom())
    signals[0], signals[1], signals[2] = float("nan"), -5.0, float("inf")
    img = tt.reconstruct(a, signals, res=RES, method="ridge")
    assert bool(torch.isfinite(img).all()) and bool((img >= 0).all())
    with pytest.raises(ValueError, match="unknown method"):
        tt.reconstruct(a, signals, res=RES, method="bogus")


def test_entry_points_default_to_cuda():
    with pytest.raises((RuntimeError, AssertionError)):
        tt.fan_chords(13.0, 0.0, n_chords=4, r_target=2.5, z_span=4.5)
