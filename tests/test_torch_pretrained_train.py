"""Port parity: the artifact trainers and loaders of
``models/surrogates/pretrained.py`` and the equilibrium surrogate's training
half (``models/surrogates/equilibrium_surrogate.py``).

``_train_transport_surrogate`` on JAX's initial weights and minibatch
indices (float32, as JAX trains it) writes JAX's normalisers and weights
within 1e-4 and its held-out rel-L2 within 1e-4 relative; each package loads
the other's artifact.  The port's own trainer meets the JAX test's gate
(rel-L2 < 0.0943) at that test's size.  ``_pca``'s basis equals JAX's up to
one sign a component; ``_train_equilibrium_surrogate`` on JAX's basis,
initial weights and indices is within 1e-9 of JAX's in float64.
``train_equilibrium_artifact`` at 17^2 solves the training configuration as
JAX does (the mean of its float32 psi maps within 1e-4 of JAX's,
span-relative) and writes an artifact both packages load with the same
predictions.  The
closure loader gives JAX's fluxes in float64 normalisers within 1e-6 (its
MLP is float32); a tampered NPZ refuses to load.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mlp_train import jax_batch_indices
from torch_parity import rel, rng, span_rel

from scpn_fusion_tpu.models.surrogates import equilibrium_surrogate as jes
from scpn_fusion_tpu.models.surrogates import mlp as jm
from scpn_fusion_tpu.models.surrogates import pretrained as jp
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.surrogates import equilibrium_surrogate as tes
from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp

F64 = torch.float64


def _transport_x(n: int = 50) -> np.ndarray:
    g = np.random.default_rng(1)
    return np.stack([g.uniform(2, 10, n), g.uniform(2, 10, n), g.uniform(0, 5, n),
                     g.uniform(1, 4, n), g.uniform(0, 2, n), g.uniform(0.5, 2, n),
                     g.uniform(0.05, 0.8, n)], axis=1)


def test_teacher_and_inputs_equal_jax():
    x = tp._sample_inputs(200, np.random.default_rng(3))
    assert np.array_equal(x, jp._sample_inputs(200, np.random.default_rng(3)))
    assert np.array_equal(tp._teacher_fluxes(x), jp._teacher_fluxes(x))


def test_transport_trainer_matches_jax_on_its_draws(tmp_path):
    kw = dict(n_train=512, n_test=128, seed=2)
    ref = jp.train_transport_surrogate(n_steps=20, hidden=(16, 16), out_dir=tmp_path / "jax",
                                       **kw)
    key = jax.random.PRNGKey(2)
    p0 = interop.mlp_params(jm.init_mlp(key, (7, 16, 16, 3)), device="cpu")
    got = tp._train_transport_surrogate(
        p0, jax_batch_indices(jax.random.fold_in(key, 1), 20, 512, 512),
        out_dir=tmp_path / "port", **kw)
    assert abs(got["test_rel_l2"] - ref["test_rel_l2"]) <= 1e-4 * ref["test_rel_l2"]
    assert {k: v for k, v in got.items() if k not in ("sha256", "test_rel_l2")} == \
        {k: v for k, v in ref.items() if k not in ("sha256", "test_rel_l2")}
    with np.load(tmp_path / "jax" / "neural_transport.npz") as a, \
            np.load(tmp_path / "port" / "neural_transport.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and rel(b[k], a[k]) <= 1e-4, k
    x = _transport_x()
    for d_in, d_out in (("jax", "port"), ("port", "jax")):
        predict_j, _ = jp.load_transport_surrogate(weights_dir=tmp_path / d_in)
        predict_t, _ = tp.load_transport_surrogate(weights_dir=tmp_path / d_in, dtype=F64,
                                                   device="cpu")
        assert rel(predict_t(torch.from_numpy(x)), predict_j(jnp.asarray(x))) <= 1e-6, d_in


def test_transport_trainer_meets_the_jax_gates_on_its_draw(tmp_path):
    """``tests/test_pretrained.py``'s artifact on the port, from that test's
    draw (JAX's initial weights and minibatch indices for seed 0): 10,000
    samples, 3000 steps, held-out rel-L2 < 0.0943, its loaded predictions
    within 0.15 of the teacher and non-negative.  The second gate depends on
    the draw in both packages (JAX's own seeds 1 and 2 miss it, at 0.173 and
    0.184); the first holds for the port's seeds 0-4."""
    key = jax.random.PRNGKey(0)
    p0 = interop.mlp_params(jm.init_mlp(key, (7, 64, 64, 3)), device="cpu")
    metrics = tp._train_transport_surrogate(
        p0, jax_batch_indices(jax.random.fold_in(key, 1), 3000, 512, 10_000),
        n_train=10_000, n_test=1000, out_dir=tmp_path)
    assert metrics["test_rel_l2"] < 0.0943
    predict, loaded = tp.load_transport_surrogate(weights_dir=tmp_path, device="cpu")
    assert loaded["sha256"] == metrics["sha256"]
    x = _transport_x()
    pred = predict(torch.from_numpy(x)).numpy()
    truth = tp._teacher_fluxes(x)
    assert np.linalg.norm(pred - truth) / np.linalg.norm(truth) < 0.15
    assert np.all(pred >= 0.0)


def test_transport_trainer_draws_from_its_seed(tmp_path):
    kw = dict(n_train=64, n_test=16, hidden=(4,), n_steps=3, device="cpu")
    a = tp.train_transport_surrogate(out_dir=tmp_path / "a", **kw)
    b = tp.train_transport_surrogate(out_dir=tmp_path / "b", **kw)
    c = tp.train_transport_surrogate(out_dir=tmp_path / "c", seed=1, **kw)
    assert a == b and a["sha256"] != c["sha256"]
    assert a["hidden"] == [4] and a["artifact"] == "neural_transport"


def test_committed_transport_closure_matches_jax():
    predict_j, metrics = jp.load_transport_surrogate()
    predict_t, metrics_t = tp.load_transport_surrogate(dtype=F64, device="cpu")
    assert metrics_t == metrics and metrics["test_rel_l2"] < 0.0943
    x = _transport_x()
    # the float32 MLP sums in another order in each package
    assert rel(predict_t(torch.from_numpy(x)), predict_j(jnp.asarray(x))) <= 1e-6
    one = predict_t(torch.tensor([8.0, 6.0, 2.0, 2.0, 1.0, 1.0, 0.1], dtype=F64))
    assert one.shape == (1, 3) and bool(torch.isfinite(one).all())


@pytest.mark.parametrize("name", ["neural_transport", "neural_equilibrium"])
def test_tampered_npz_refuses(tmp_path, name):
    for ext in (".npz", ".metrics.json"):
        shutil.copy(tp.WEIGHTS_DIR / f"{name}{ext}", tmp_path / f"{name}{ext}")
    npz = tmp_path / f"{name}.npz"
    npz.write_bytes(npz.read_bytes() + b"corrupt")
    load = (tp.load_transport_surrogate if name == "neural_transport"
            else tp.load_equilibrium_artifact)
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        load(weights_dir=tmp_path, device="cpu")
    (tmp_path / f"{name}.metrics.json").unlink()
    with pytest.raises(FileNotFoundError):
        load(weights_dir=tmp_path, device="cpu")


def _psi_batch(n=40, nz=9, nr=9):
    g = rng(7)
    inputs = g.uniform(0.5, 1.5, (n, 6))
    zz, rr = np.meshgrid(np.linspace(-1, 1, nz), np.linspace(-1, 1, nr), indexing="ij")
    basis = np.stack([np.exp(-(rr - 0.2 * k) ** 2 - zz**2) for k in range(6)])
    psi = np.einsum("nk,kzr->nzr", inputs, basis) + 0.01 * g.standard_normal((n, nz, nr))
    return inputs, psi


def test_pca_matches_jax_up_to_sign():
    _, psi = _psi_batch()
    flat = psi.reshape(40, -1)
    comp, mean = tes._pca(torch.from_numpy(flat), 5)
    comp_r, mean_r = jes._pca(jnp.asarray(flat), 5)
    assert rel(mean, mean_r) <= 1e-12
    for a, b in zip(comp.numpy(), np.asarray(comp_r)):
        assert min(np.max(np.abs(a - b)), np.max(np.abs(a + b))) <= 1e-9


def test_equilibrium_surrogate_training_matches_jax_on_its_basis():
    inputs, psi = _psi_batch()
    key = jax.random.PRNGKey(4)
    ref = jes.train_equilibrium_surrogate(jnp.asarray(inputs), jnp.asarray(psi), key,
                                          n_modes=4, hidden=(8, 8), n_steps=30)
    p0 = interop.mlp_params(jm.init_mlp(key, (6, 8, 8, 4), dtype=jnp.float64), device="cpu")
    got = tes._train_equilibrium_surrogate(
        torch.from_numpy(np.array(ref.components)), torch.from_numpy(np.array(ref.psi_mean)),
        torch.from_numpy(inputs), torch.from_numpy(psi), p0,
        jax_batch_indices(jax.random.fold_in(key, 1), 30, 40, 40))
    for name in ("x_mean", "x_std", "coeff_scale"):
        assert rel(getattr(got, name), getattr(ref, name)) <= 1e-12, name
    for a, b in zip([*got.mlp.weights, *got.mlp.biases], jax.tree.leaves(ref.mlp)):
        assert rel(a, b) <= 1e-9
    x = torch.from_numpy(inputs[3])
    assert rel(got.predict(x), ref.predict(jnp.asarray(inputs[3]))) <= 1e-9
    own = tes.train_equilibrium_surrogate(torch.from_numpy(inputs), torch.from_numpy(psi),
                                          torch.Generator().manual_seed(0), n_modes=4,
                                          hidden=(8, 8), n_steps=30)
    assert own.predict(x).shape == (9, 9) and own.shape == (9, 9)


def test_equilibrium_artifact_at_17(tmp_path):
    """The trainer at 17^2 on three training solves and one held out, in both
    packages (the same coil currents: both draw them with numpy): the port's
    configuration is JAX's, its psi maps' mean within 1e-4 of JAX's
    (span-relative; float32 solves) and its PCA basis JAX's up to one sign a
    component (within 1e-3); each package loads the other's artifact with the
    same predictions."""
    import dataclasses

    kw = dict(n_train=3, n_test=1, grid_n=17, n_modes=2, n_steps=10)
    cfg = tp.equilibrium_training_config(17)
    assert dataclasses.asdict(interop_config_back(cfg)) == dataclasses.asdict(cfg)
    ref = jp.train_equilibrium_artifact(out_dir=tmp_path / "jax", **kw)
    got = tp.train_equilibrium_artifact(out_dir=tmp_path / "port", device="cpu", **kw)
    assert {k: v for k, v in got.items() if k not in ("sha256", "test_rel_l2")} == \
        {k: v for k, v in ref.items() if k not in ("sha256", "test_rel_l2")}
    with np.load(tmp_path / "jax" / "neural_equilibrium.npz") as a, \
            np.load(tmp_path / "port" / "neural_equilibrium.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert span_rel(b["psi_mean"], a["psi_mean"]) <= 1e-4
        for c_t, c_j in zip(b["components"], a["components"]):
            assert min(np.max(np.abs(c_t - c_j)), np.max(np.abs(c_t + c_j))) <= 1e-3
        x = a["x_mean"] * 1.05
    for d in ("jax", "port"):
        sur_j, metrics_j = jp.load_equilibrium_artifact(weights_dir=tmp_path / d)
        sur_t, metrics_t = tp.load_equilibrium_artifact(weights_dir=tmp_path / d, device="cpu")
        assert metrics_t == metrics_j and sur_t.shape == (17, 17)
        assert rel(sur_t.predict(torch.from_numpy(x)), sur_j.predict(jnp.asarray(x))) <= 1e-5


def interop_config_back(cfg):
    """The JAX package's ``ReactorConfig`` of the port's ``cfg``."""
    import dataclasses

    from scpn_fusion_tpu.core.config import config_from_dict
    return config_from_dict(dataclasses.asdict(cfg))


def test_default_device_is_the_card(tmp_path):
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    calls = (lambda: tp.load_transport_surrogate()[0](torch.zeros((1, 7), device="cuda")),
             lambda: tp.train_transport_surrogate(n_train=16, n_test=8, hidden=(4,), n_steps=1,
                                                  out_dir=tmp_path)
             and torch.zeros(1, device="cuda"),
             lambda: tp.train_equilibrium_artifact(n_train=2, n_test=1, grid_n=9, n_modes=1,
                                                   n_steps=1, out_dir=tmp_path)
             and torch.zeros(1, device="cuda"))
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_package_exports_every_jax_name():
    import types

    import scpn_fusion_tpu.models.surrogates as jax_pkg
    import scpn_fusion_tpu_torch.models.surrogates as port_pkg

    names = [n for n, v in vars(jax_pkg).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    assert len(names) == 26
    missing = [n for n in names if not hasattr(port_pkg, n)]
    assert not missing, missing
