"""Port parity: federated disruption-predictor training
(``control/federated.py``).

JAX's ``train_federated`` fixes float32 (its generator's data and
``init_mlp``'s default), so the rounds are held in float64 through the JAX
package's ``_run_federation`` on the same float64 data and weights, with
JAX's draws (every (round, client, epoch) ``permutation`` and every
(round, client, leaf) DP normal, rebuilt from its key) fed to the port's
``_run_federation``: the global weights and the per-round losses and
accuracies within 1e-9, for FedAvg, FedProx and FedAvg with the DP clip and
noise (whose updates stay inside the clip's norm here).  The DP norm is
summed in float32 in both packages, as JAX does, so an update that is
clipped agrees to float32 rounding of that norm: ``dp_clip_and_noise`` on
updates five times past the clip is held at 1e-6.  The client
data generator is the JAX package's (equal arrays).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import federated as jf
from scpn_fusion_tpu.models.surrogates import mlp as jm
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import federated as tf

SMALL = dict(machines=("diiid", "jet", "cmod"), n_samples=128, hidden=(16, 8), local_epochs=2,
             batch_size=32, n_rounds=3)


def jax_draws(cfg, key, n_leaves_shapes):
    """JAX's permutations (rounds, M, epochs, n) and DP normals (one
    (rounds, M, *leaf) array per leaf) from ``_run_federation``'s key."""
    m = len(cfg.machines)
    perms, noise = [], [[] for _ in n_leaves_shapes]
    for k_r in jax.random.split(key, cfg.n_rounds):
        keys = jax.random.split(k_r, m + 1)
        perms.append([[np.asarray(jax.random.permutation(ek, cfg.n_samples))
                       for ek in jax.random.split(ck, cfg.local_epochs)] for ck in keys[:-1]])
        per_client = [[np.asarray(jax.random.normal(lk, shape, jnp.float64))
                       for lk, shape in zip(jax.random.split(dk, len(n_leaves_shapes)),
                                            n_leaves_shapes)]
                      for dk in jax.random.split(keys[-1], m)]
        for j in range(len(n_leaves_shapes)):
            noise[j].append(np.stack([pc[j] for pc in per_client]))
    return (torch.from_numpy(np.asarray(perms)).long(),
            [torch.from_numpy(np.stack(z)) for z in noise])


@pytest.mark.parametrize("variant", ["fedavg", "fedprox", "dp"])
def test_rounds_match_jax(variant):
    cfg_kw = dict(SMALL, aggregation="fedprox" if variant == "fedprox" else "fedavg",
                  dp_enabled=variant == "dp")
    jcfg, tcfg = jf.FederatedConfig(**cfg_kw), tf.FederatedConfig(**cfg_kw)
    xs_np, ys_np = tf.client_datasets(tcfg, seed=3)
    xs, ys = xs_np.astype(np.float64), ys_np.astype(np.float64)
    key = jax.random.PRNGKey(3)
    params = jm.init_mlp(key, (tf.N_FEATURES, *jcfg.hidden, 1), dtype=jnp.float64)
    weights = np.full((3,), float(jcfg.n_samples))
    run_key = jax.random.fold_in(key, 1)
    gp_j, tr_j = jf._run_federation(jcfg, params, jnp.asarray(xs), jnp.asarray(ys),
                                    jnp.asarray(weights), run_key)
    perms, noise = jax_draws(jcfg, run_key, [w.shape for w in jax.tree.leaves(params)])
    gp_t, tr_t = tf._run_federation(tcfg, interop.mlp_params(params, device="cpu"),
                                    torch.from_numpy(xs), torch.from_numpy(ys),
                                    torch.from_numpy(weights), perms,
                                    noise if variant == "dp" else None)
    tol = 1e-9
    for a, b in zip([*gp_t.weights, *gp_t.biases], jax.tree.leaves(gp_j)):
        assert rel(a, b) <= tol
    assert rel(tr_t.loss, tr_j.loss) <= tol
    assert rel(tr_t.global_loss, tr_j.global_loss) <= tol
    n_rows = xs.shape[0] * xs.shape[1]     # the accuracies count the same correct rows
    assert np.array_equal(np.round(tr_t.accuracy.double().numpy() * n_rows),
                          np.round(np.asarray(tr_j.accuracy, np.float64) * n_rows))


def test_dp_clip_and_noise_matches_jax():
    rng = np.random.default_rng(4)
    update = [rng.standard_normal((6, 4)) * 3, rng.standard_normal(4) * 3]
    key = jax.random.PRNGKey(9)
    ref = jf.dp_clip_and_noise([jnp.asarray(u) for u in update], 5.0, 1e-3, key)
    noise = [torch.from_numpy(np.array(jax.random.normal(k, u.shape, jnp.float64)))
             for k, u in zip(jax.random.split(key, 2), update)]
    ours = tf.dp_clip_and_noise([torch.from_numpy(u) for u in update], 5.0, 1e-3, noise)
    for a, b in zip(ours, ref):
        assert rel(a, b) <= 1e-6


def test_client_data_equal_jax():
    for i, m in enumerate(("diiid", "aug")):
        x_t, y_t = tf.generate_disruption_data(m, 100, 0.3, seed=5 + i)
        x_j, y_j = jf.generate_disruption_data(m, 100, 0.3, seed=5 + i)
        assert np.array_equal(x_t, np.asarray(x_j)) and np.array_equal(y_t, np.asarray(y_j))
    with pytest.raises(ValueError, match="unknown machine"):
        tf.generate_disruption_data("iter", 10, 0.3, 0)
    with pytest.raises(ValueError):
        tf.FederatedConfig(aggregation="gossip")


def test_predict_risk_matches_jax():
    params = jm.init_mlp(jax.random.PRNGKey(1), (6, 8, 1), dtype=jnp.float64)
    feats = np.random.default_rng(2).standard_normal((7, 6))
    assert rel(tf.predict_disruption_risk(interop.mlp_params(params, device="cpu"),
                                           torch.from_numpy(feats)),
                jf.predict_disruption_risk(params, jnp.asarray(feats))) <= 1e-12


def test_default_device_is_the_card():
    cfg = tf.FederatedConfig(**dict(SMALL, n_rounds=1, local_epochs=1))
    if torch.cuda.is_available():
        assert tf.train_federated(cfg)[0].weights[0].is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tf.train_federated(cfg)
