"""Port parity: the causal-transformer disruption predictor
(``control/disruption_seq.py``) at its published width (d_model 32, 4
heads, feed-forward 64, 2 layers).

Float64 throughout.  The forward pass (``seq_logits`` / ``seq_risk`` /
``shot_scores``) on JAX's initial parameters within 1e-9; 8 AdamW steps of
``train_seq_predictor`` from JAX's initial parameters on JAX's minibatch
indices (the draws rule), with and without ``pos_end``: the loss history and
every parameter within 1e-9, the normalisation statistics untouched.  The
written-out AdamW with its decay mask is held to ``optax.adamw`` chained
with ``optax.masked(set_to_zero)`` at 1e-14, and the loss to
``optax.sigmoid_binary_cross_entropy`` at 1e-14.  The numpy cohort
generators are the JAX package's, source and output.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import rel, rng

from scpn_fusion_tpu.control import disruption_seq as js
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import disruption_seq as ts

TOL = 1e-9


def _cohort(n=12, t_len=40, seed=3):
    shots, clean, noisy, onsets = js.generate_hard_cohort(
        js.CohortConfig(n_shots=n, t_len=t_len, label_flip=0.2), seed)
    return shots.astype(np.float64), clean, noisy, onsets


def jax_indices(key, n_steps, batch, n):
    idx = jax.vmap(lambda k: jax.random.randint(jax.random.fold_in(key, k), (batch,), 0, n))(
        jnp.arange(n_steps))
    return torch.from_numpy(np.array(idx)).long()


def test_forward_matches_jax():
    shots, *_ = _cohort()
    key = jax.random.PRNGKey(1)
    p = js.init_seq_predictor(key, 3, 40, dtype=jnp.float64)
    p = p._replace(x_mean=jnp.asarray([0.1, -0.2, 0.05]), x_std=jnp.asarray([1.1, 0.9, 1.3]))
    ours = interop.seq_predictor_params(p, device="cpu")
    ref = jax.vmap(lambda s: js.seq_logits(p, s))(jnp.asarray(shots))
    assert rel(ts.seq_logits(ours, torch.from_numpy(shots)), ref) <= TOL
    assert rel(ts.seq_risk(ours, torch.from_numpy(shots[0])), js.seq_risk(p, shots[0])) <= TOL
    assert rel(ts.shot_scores(ours, torch.from_numpy(shots), settle=6),
                js.shot_scores(p, jnp.asarray(shots), settle=6)) <= TOL


@pytest.mark.parametrize("with_pos_end", [False, True])
def test_training_matches_jax(with_pos_end):
    shots, _, noisy, onsets = _cohort()
    n_steps, batch = 8, 4
    key = jax.random.PRNGKey(7)
    pos_end = np.where(onsets >= 0, np.minimum(onsets + 30, 39), 40) if with_pos_end else None
    ref = js.train_seq_predictor(jnp.asarray(shots), jnp.asarray(noisy), jnp.asarray(onsets), key,
                                 n_steps=n_steps, batch_size=batch,
                                 pos_end=None if pos_end is None else jnp.asarray(pos_end))
    p0 = interop.seq_predictor_params(js.init_seq_predictor(key, 3, 40, dtype=jnp.float64),
                                      device="cpu")
    ours = ts._train_seq_predictor(
        torch.from_numpy(shots), torch.from_numpy(noisy), torch.from_numpy(onsets), p0,
        jax_indices(key, n_steps, batch, 12),
        pos_end=None if pos_end is None else torch.from_numpy(pos_end))
    assert rel(ours.loss_history, ref.loss_history) <= TOL
    for a, b in zip(ts.flatten(ours.params)[0], ts.flatten(ref.params)[0]):
        assert rel(a, b) <= TOL
    assert rel(ours.params.x_mean, ref.params.x_mean) <= TOL
    assert rel(ours.params.x_std, ref.params.x_std) <= TOL


def test_adamw_with_masks_matches_optax():
    g = rng(11)
    params = {"w": g.standard_normal((4, 3)), "b": g.standard_normal(3),
              "stat": g.standard_normal(3)}
    decay = {"w": True, "b": False, "stat": False}
    opt = optax.chain(
        optax.adamw(3e-3, weight_decay=1e-2, mask=decay),
        optax.masked(optax.set_to_zero(), {"w": False, "b": False, "stat": True}))
    ref = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(ref)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    mom = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in ours.items()}
    for k in range(6):
        grads = {n: g.standard_normal(v.shape) for n, v in params.items()}
        upd, state = opt.update({n: jnp.asarray(v) for n, v in grads.items()}, state, ref)
        ref = optax.apply_updates(ref, upd)
        for n in ("w", "b"):
            step, mu, nu = ts._adamw_update(torch.from_numpy(grads[n]), ours[n], *mom[n], k, 3e-3,
                                            1e-2, decay[n])
            mom[n] = (mu, nu)
            ours[n] = ours[n] + step
        for n in params:
            assert np.max(np.abs(ours[n].numpy() - np.asarray(ref[n]))) <= 1e-14, n


def test_bce_matches_optax():
    g = rng(12)
    logits = g.standard_normal(200) * 8
    labels = (g.random(200) > 0.5).astype(np.float64)
    ref = optax.sigmoid_binary_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    ours = ts.sigmoid_binary_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert np.max(np.abs(ours.numpy() - np.asarray(ref))) <= 1e-14


@pytest.mark.parametrize("name", ["generate_hard_cohort", "generate_training_family",
                                  "CohortConfig", "roc_auc"])
def test_numpy_parts_are_the_sources(name):
    assert inspect.getsource(getattr(ts, name)) == inspect.getsource(getattr(js, name))


def test_cohorts_and_auc_equal():
    for cfg in (js.TRAIN_CONFIG, js.TEST_CONFIG):
        t_cfg = ts.CohortConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        for a, b in zip(ts.generate_hard_cohort(t_cfg, 5), js.generate_hard_cohort(cfg, 5)):
            assert np.array_equal(a, b)
    assert ts.TRAIN_CONFIGS == tuple(ts.CohortConfig(**vars(c)) for c in js.TRAIN_CONFIGS)
    assert ts.TEST_CONFIG == ts.CohortConfig(**vars(js.TEST_CONFIG))
    fam_t = ts.generate_training_family(7)
    fam_j = js.generate_training_family(7)
    assert all(np.array_equal(a, b) for a, b in zip(fam_t, fam_j))
    g = rng(1)
    scores, labels = np.round(g.random(40), 1), (g.random(40) > 0.5).astype(float)
    assert ts.roc_auc(scores, labels) == js.roc_auc(scores, labels)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert ts.init_seq_predictor(torch.Generator(), 3, 10).pos.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ts.init_seq_predictor(torch.Generator(), 3, 10)
