"""Port parity: the Fourier Neural Operator (``models/surrogates/fno.py``) and
the FNO turbulence artifact (``pretrained.train_fno_turbulence`` /
``load_fno_turbulence``).

JAX's float32 parameters come across through ``interop.fno_params``.  The
spectral convolution and the forward pass are within 1e-5 of JAX's (the
complex64 FFTs and mode sums run in another order), also where the four
corners overlap (the later corner wins, as in JAX's ``.at[].set`` order).
``_train_fno`` on JAX's minibatch indices is within 1e-4 of ``train_fno``'s
parameters after 5 steps with the constant and with the cosine schedule; two
chained segments (the Adam state carried) equal one run bit for bit.  The
committed artifact predicts fresh fields through both loaders within 1e-4
and meets the JAX test's gate; an artifact the port writes loads in JAX and
gives the port's predictions; a tampered NPZ refuses to load.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mlp_train import jax_batch_indices
from torch_parity import rel, rng

from scpn_fusion_tpu.models.surrogates import fno as jf
from scpn_fusion_tpu.models.surrogates import pretrained as jp
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.surrogates import fno as tf
from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp

TOL = 1e-5


def _params(width=8, modes=4, n_layers=2, seed=0):
    ref = jf.init_fno(jax.random.PRNGKey(seed), width=width, modes=modes, n_layers=n_layers)
    return ref, interop.fno_params(ref, device="cpu")


@pytest.mark.parametrize("grid,modes", [(16, 4), (8, 5)])
def test_spectral_conv_and_forward_match_jax(grid, modes):
    ref, ours = _params(modes=modes)
    h = rng(1).standard_normal((grid, grid, 8)).astype(np.float32)
    got = tf._spectral_conv(torch.from_numpy(h), ours.spectral[0])
    assert got.dtype == torch.float32
    assert rel(got, jf._spectral_conv(jnp.asarray(h), ref.spectral[0])) <= TOL
    x = rng(2).standard_normal((3, grid, grid, 1)).astype(np.float32)
    one = tf.fno_apply(ours, torch.from_numpy(x[0]))
    assert rel(one, jf.fno_apply(ref, jnp.asarray(x[0]))) <= TOL
    batch = tf.fno_apply_batched(ours, torch.from_numpy(x))
    assert rel(batch, jf.fno_apply_batched(ref, jnp.asarray(x))) <= TOL
    assert rel(batch[0], one) <= 1e-6


def test_float64_spectral_path_is_complex64():
    """A float64 FNO's spectral path runs in complex64, as JAX's does."""
    ref = jf.init_fno(jax.random.PRNGKey(3), width=4, modes=3, n_layers=1, dtype=jnp.float64)
    ours = interop.fno_params(ref, device="cpu")
    x = rng(3).standard_normal((8, 8, 1))
    got = tf.fno_apply(ours, torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert rel(got, jf.fno_apply(ref, jnp.asarray(x))) <= TOL


def test_fno_apply_keeps_the_jax_contract():
    _, ours = _params()
    with pytest.raises(ValueError):
        tf.fno_apply(ours, torch.zeros((1, 8, 8, 1)))
    with pytest.raises(ValueError):
        tf.fno_apply_batched(ours, torch.zeros((8, 8, 1)))
    ref, _ = _params()
    with pytest.raises(ValueError):
        jf.fno_apply(ref, jnp.zeros((1, 8, 8, 1)))


def _pairs(n=12, grid=8):
    g = rng(4)
    x = g.standard_normal((n, grid, grid, 1)).astype(np.float32)
    y = np.roll(x, 1, axis=1) * 0.5 + 0.1 * g.standard_normal(x.shape).astype(np.float32)
    return x, y


@pytest.mark.parametrize("schedule", ["const", "cosine"])
def test_train_fno_matches_jax_on_its_indices(schedule):
    ref0, ours0 = _params(width=6, modes=3)
    x, y = _pairs()
    key = jax.random.PRNGKey(7)
    ref = jf.train_fno(ref0, jnp.asarray(x), jnp.asarray(y), key, n_steps=5, batch_size=4,
                       lr=3e-3, schedule=schedule, total_steps=8)
    got = tf._train_fno(ours0, torch.from_numpy(x), torch.from_numpy(y),
                        jax_batch_indices(key, 5, 4, 12), lr=3e-3, schedule=schedule,
                        total_steps=8)
    assert rel(got.loss_history, ref.loss_history) <= 1e-4
    for a, b in zip(tf.fno_leaves(got.params), jax.tree.leaves(ref.params)):
        assert rel(a, b) <= 1e-4
    assert got.opt_state[2] == 5


def test_chained_segments_equal_one_run():
    _, ours0 = _params(width=6, modes=3)
    x, y = (torch.from_numpy(a) for a in _pairs())
    idx = torch.from_numpy(rng(5).integers(0, 12, (7, 4)))
    whole = tf._train_fno(ours0, x, y, idx, lr=3e-3, schedule="cosine", total_steps=7)
    first = tf._train_fno(ours0, x, y, idx[:4], lr=3e-3, schedule="cosine", total_steps=7)
    second = tf._train_fno(first.params, x, y, idx[4:], lr=3e-3, schedule="cosine",
                           total_steps=7, opt_state=first.opt_state)
    assert all(torch.equal(a, b) for a, b in zip(tf.fno_leaves(whole.params),
                                                 tf.fno_leaves(second.params)))
    assert torch.equal(whole.loss_history, torch.cat([first.loss_history,
                                                      second.loss_history]))
    assert tf.cosine_lr(1.0, 7, 0) == 1.0 and tf.cosine_lr(1.0, 7, 9) == pytest.approx(1 / 300)


def test_committed_artifact_through_both_loaders():
    predict_j, metrics = jp.load_fno_turbulence()
    predict_t, metrics_t = tp.load_fno_turbulence(device="cpu")
    assert metrics_t == metrics and metrics["width"] == 32 and metrics["n_layers"] == 4
    g = np.random.default_rng(99)
    grid = int(metrics["grid"])
    x = np.stack([tp._gene_like_field(grid, r, g) for r in ("ITG", "TEM", "ETG")])
    y = np.stack([tp._periodic_streamfunction(f) for f in x])
    xs = x[..., None].astype(np.float32)
    got = predict_t(torch.from_numpy(xs)).numpy()
    assert rel(got, predict_j(jnp.asarray(xs))) <= 1e-4
    scale = metrics["y_scale"]
    err = np.linalg.norm(got[..., 0] - y / scale) / np.linalg.norm(y / scale)
    assert err < 2.0 * metrics["test_rel_l2"] + 0.05


def test_helpers_equal_jax():
    for regime in ("ITG", "TEM", "ETG"):
        a = tp._gene_like_field(32, regime, np.random.default_rng(1))
        b = jp._gene_like_field(32, regime, np.random.default_rng(1))
        assert np.array_equal(a, b)
        assert np.array_equal(tp._periodic_streamfunction(a), jp._periodic_streamfunction(b))


def test_port_artifact_loads_in_jax(tmp_path):
    metrics = tp.train_fno_turbulence(n_train=6, n_test=3, grid=16, width=4, modes=3,
                                      n_layers=2, n_steps=3, out_dir=tmp_path, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fno_turbulence.metrics.json",
                                                          "fno_turbulence.npz"]
    assert 0.0 < metrics["test_rel_l2"] < 10.0 and metrics["n_layers"] == 2
    predict_j, metrics_j = jp.load_fno_turbulence(weights_dir=tmp_path)
    predict_t, _ = tp.load_fno_turbulence(weights_dir=tmp_path, device="cpu")
    assert metrics_j == metrics
    x = rng(6).standard_normal((2, 16, 16, 1)).astype(np.float32)
    assert rel(predict_t(torch.from_numpy(x)), predict_j(jnp.asarray(x))) <= TOL


def test_tampered_npz_refuses(tmp_path):
    for ext in (".npz", ".metrics.json"):
        shutil.copy(tp.WEIGHTS_DIR / f"fno_turbulence{ext}", tmp_path / f"fno_turbulence{ext}")
    blob = bytearray((tmp_path / "fno_turbulence.npz").read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (tmp_path / "fno_turbulence.npz").write_bytes(bytes(blob))
    with pytest.raises(RuntimeError, match="checksum"):
        tp.load_fno_turbulence(weights_dir=tmp_path, device="cpu")


def test_interop_round_trip():
    ref, ours = _params(n_layers=3)
    leaves = [np.asarray(a) for a in jax.tree.leaves(ref)]
    again = interop.fno_params(leaves, 3, device="cpu")
    back = interop.fno_params(ours, device="cpu")
    assert len(tf.fno_leaves(again)) == 2 + 5 * 3 + 4
    for a, b, c in zip(tf.fno_leaves(again), tf.fno_leaves(back), leaves):
        assert np.array_equal(a.numpy(), c) and torch.equal(a, b)


def test_init_fno_draws_from_the_generator():
    p = tf.init_fno(torch.Generator().manual_seed(0), width=8, modes=4, n_layers=2,
                    device="cpu")
    q = tf.init_fno(torch.Generator().manual_seed(0), width=8, modes=4, n_layers=2,
                    device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tf.fno_leaves(p), tf.fno_leaves(q)))
    assert [tuple(a.shape) for a in tf.fno_leaves(p)] == [
        tuple(np.shape(a)) for a in jax.tree.leaves(_params()[0])]


def test_default_device_is_the_card(tmp_path):
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    calls = (lambda: tf.init_fno(torch.Generator().manual_seed(0), width=4, modes=2,
                                 n_layers=1).lift_w,
             lambda: tp.load_fno_turbulence()[0](torch.zeros((1, 64, 64, 1), device="cuda")),
             lambda: tp.train_fno_turbulence(n_train=3, n_test=3, grid=8, width=4, modes=2,
                                             n_layers=1, n_steps=1, out_dir=tmp_path)
             and torch.zeros(1, device="cuda"))
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
