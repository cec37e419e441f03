"""Port parity: the HEAT-ML shadow surrogate (``models/surrogates/heat_shadow.py``)
and the QLKNN pipeline (``models/surrogates/qlknn.py``).

In float64: the reference law, the feature map, the Cholesky ridge fit's
predictions, the collisionality, the profile features and the analytic
targets within 1e-12 of JAX's (the fitted weights within 1e-6: the normal
equations square the basis' condition number).  The parameter scan on JAX's
float32 uniforms within 1e-6.  ``_train_qlknn`` on JAX's uniforms, initial
weights and minibatch indices (float32, as JAX trains it) within 1e-4 of
``train_qlknn``'s parameters after 20 steps.  The JAX tests' gates hold for
the port: the heat-shadow fit's held-out RMSE < 5%, the QLKNN fit's
relative RMSE < 0.25.  Converted models (``interop.qlknn_model``) give
JAX's fluxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mlp_train import jax_batch_indices
from torch_parity import rel, rng

from scpn_fusion_tpu.models.surrogates import heat_shadow as jhs
from scpn_fusion_tpu.models.surrogates import mlp as jm
from scpn_fusion_tpu.models.surrogates import qlknn as jq
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.surrogates import heat_shadow as ths
from scpn_fusion_tpu_torch.models.surrogates import qlknn as tq

TOL = 1e-12
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


# ── heat shadow ──────────────────────────────────────────────────────────


def test_shadow_dataset_and_reference_law_match_jax():
    ref = jhs.generate_shadow_dataset(7, 300)
    got = ths.generate_shadow_dataset(7, 300, **CPU)
    assert np.array_equal(got.features.numpy(), np.asarray(ref.features))
    assert rel(got.shadow_fraction, ref.shadow_fraction) <= TOL
    assert rel(ths._feature_map(got.features), jhs._feature_map(ref.features)) <= TOL


def test_shadow_fit_matches_jax():
    ds = jhs.generate_shadow_dataset(42, 2048)
    w_ref = jhs.fit_shadow_surrogate(ds.features, ds.shadow_fraction)
    feats = torch.from_numpy(np.array(ds.features))
    w = ths.fit_shadow_surrogate(feats, torch.from_numpy(np.array(ds.shadow_fraction)))
    assert rel(w, w_ref) <= 1e-6
    hold = jhs.generate_shadow_dataset(99, 512)
    x_hold = torch.from_numpy(np.array(hold.features))
    assert rel(ths.predict_shadow_fraction(w, x_hold),
               jhs.predict_shadow_fraction(w_ref, hold.features)) <= 1e-9
    q = ths.predict_divertor_flux(w, 1e7, x_hold)
    assert rel(q, jhs.predict_divertor_flux(w_ref, 1e7, hold.features)) <= 1e-9


def test_shadow_fit_meets_the_jax_gate():
    w = ths.fit_synthetic(seed=42, samples=2048, **CPU)
    hold = ths.generate_shadow_dataset(99, 512, **CPU)
    assert ths.rmse_percent(hold.shadow_fraction,
                            ths.predict_shadow_fraction(w, hold.features)) < 5.0


def test_shadow_shapes_and_errors():
    w = ths.fit_synthetic(samples=256, **CPU)
    one = ths.predict_shadow_fraction(w, torch.tensor([2.0, 1.3, 70.0, 10.0, 1.7, 0.3, -1.7],
                                                      dtype=F64))
    assert one.shape == (1,) and 0.0 <= float(one[0]) <= 0.85
    with pytest.raises(ValueError, match="Expected shape"):
        ths.predict_shadow_fraction(w, torch.ones((4, 5), dtype=F64))
    with pytest.raises(ValueError, match="samples must be"):
        ths.generate_shadow_dataset(0, 4, **CPU)
    with pytest.raises(ValueError, match="row count"):
        ths.fit_shadow_surrogate(torch.ones((10, 7), dtype=F64), torch.ones(9, dtype=F64))
    with pytest.raises(ValueError, match="same shape"):
        ths.rmse_percent(np.ones(3), np.ones(4))
    assert ths.rmse_percent(np.ones(10), np.ones(10)) == 0.0


# ── QLKNN ────────────────────────────────────────────────────────────────


def _profiles():
    r = np.linspace(0.2, 2.0, 33)
    te = 3.0 * np.exp(-r / 0.6)
    ti = 2.5 * np.exp(-r / 0.7)
    q = 1.0 + 2.0 * (r / 2.0) ** 2
    ne = 5.0 * (1.0 - (r / 2.2) ** 2)
    return te, ti, ne, q, r


def test_collisionality_and_profile_features_match_jax():
    te, ti, ne, q, r = _profiles()
    t = [torch.from_numpy(a) for a in (te, ti, ne, q, r)]
    ref = jq.electron_collisionality_star(jnp.asarray(ne), jnp.asarray(te), jnp.asarray(q), 6.2,
                                          jnp.asarray(r / 6.2), 1.7)
    got = tq.electron_collisionality_star(t[2], t[0], t[3], 6.2, t[4] / 6.2, 1.7)
    assert rel(got, ref) <= TOL
    ref = jq.qlknn_features_from_profiles(*(jnp.asarray(a) for a in (te, ti, ne, q, r)),
                                          r0=6.2, a=2.0, b0=5.3)
    got = tq.qlknn_features_from_profiles(*t, r0=6.2, a=2.0, b0=5.3)
    assert got.shape == (33, 10)
    for j in range(10):
        assert rel(got[:, j], ref[:, j]) <= TOL, j
    with pytest.raises(ValueError, match="R0"):
        tq.electron_collisionality_star(t[2], t[0], t[3], -1.0, t[4])
    with pytest.raises(ValueError, match="same shape"):
        tq.qlknn_features_from_profiles(t[0][:5], *t[1:], r0=6.2, a=2.0, b0=5.3)


def test_analytic_targets_and_scan_match_jax():
    key = jax.random.PRNGKey(2)
    u = jax.random.uniform(key, (512, 10), jnp.float32)
    scan = tq._parameter_scan(torch.from_numpy(np.array(u)))
    assert scan.dtype == torch.float32
    assert rel(scan, jq.generate_parameter_scan(key, 512)) <= 1e-6
    x = rng(5).uniform(jq.FEATURE_BOUNDS[:, 0], jq.FEATURE_BOUNDS[:, 1], (400, 10))
    got = tq.analytic_targets(torch.from_numpy(x))
    ref = jq.analytic_targets(jnp.asarray(x))
    for j in range(3):
        assert rel(got[:, j], ref[:, j]) <= TOL, j
    with pytest.raises(ValueError, match="shape"):
        tq.analytic_targets(torch.ones((4, 9), dtype=F64))


def test_train_qlknn_matches_jax_on_its_draws():
    key = jax.random.PRNGKey(4)
    n, hidden, n_steps = 512, (16, 16), 20
    ref = jq.train_qlknn(key, n_samples=n, hidden=hidden, n_steps=n_steps)
    k_data, k_init, k_train = jax.random.split(key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(k_data, (n, 10), jnp.float32)))
    p0 = interop.mlp_params(jm.init_mlp(k_init, (10, *hidden, 3)), device="cpu")
    got = tq._train_qlknn(u, p0, jax_batch_indices(k_train, n_steps, 256, n))
    for name in ("x_mean", "x_std", "y_scale"):
        assert rel(getattr(got, name), getattr(ref, name)) <= 1e-5, name
    for a, b in zip([*got.params.weights, *got.params.biases], jax.tree.leaves(ref.params)):
        assert rel(a, b) <= 1e-4


def test_train_qlknn_meets_the_jax_gate():
    model = tq.train_qlknn(torch.Generator().manual_seed(1), n_samples=4096, hidden=(48, 48),
                           n_steps=1500, device="cpu")
    x_test = tq.generate_parameter_scan(torch.Generator().manual_seed(2), 1024, device="cpu")
    y_true = tq.analytic_targets(x_test).numpy()
    y_pred = tq.predict_fluxes(model, x_test).numpy()
    assert np.all(y_pred >= 0.0)
    err = np.sqrt(np.mean((y_pred - y_true) ** 2)) / max(np.sqrt(np.mean(y_true**2)), 1e-9)
    assert err < 0.25, err


def test_converted_model_gives_jax_fluxes():
    ref_model = jq.train_qlknn(jax.random.PRNGKey(3), n_samples=512, hidden=(16, 16), n_steps=5)
    model = interop.qlknn_model(ref_model, device="cpu")
    te, ti, ne, q, r = _profiles()
    # float64 profiles: in float32 the collisionality's e^4 underflows in
    # both packages (nu* is NaN)
    ref = jq.fluxes_from_profiles(ref_model, *(jnp.asarray(a) for a in (te, ti, ne, q, r)),
                                  r0=6.2, a=2.0, b0=5.3)
    got = tq.fluxes_from_profiles(model, *(torch.from_numpy(a) for a in (te, ti, ne, q, r)),
                                  r0=6.2, a=2.0, b0=5.3)
    assert got.shape == (33, 3) and bool(torch.isfinite(got).all())
    assert rel(got, ref) <= 1e-9
    back = interop.qlknn_model(model, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back[1:], model[1:]))


def test_default_device_is_the_card():
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    calls = (lambda: ths.generate_shadow_dataset(0, 16).features,
             lambda: ths.fit_synthetic(samples=64),
             lambda: tq.generate_parameter_scan(torch.Generator().manual_seed(0), 8),
             lambda: tq.train_qlknn(torch.Generator().manual_seed(0), n_samples=16,
                                    hidden=(4,), n_steps=1).x_mean)
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
