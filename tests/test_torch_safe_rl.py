"""Port parity: the shielded tokamak environment and Lagrangian PPO
(``control/safe_rl.py``).

Float64.  The draws rule: the JAX package threads a key through its
environment state; every draw of a batch of episodes -- the reset's uniform
and normal, the plant's three normals a step (the key chain of
``env_step``) and the policy's exploration normals (``split(fold_in(key,
1), T)``) -- is rebuilt from JAX's keys and fed to the port's private
twins.  ``_collect_batch`` against ``collect_batch`` (every rollout field
within 1e-9, clamp events and halts equal), and three primal-dual
iterations of ``_train`` against ``train``: the policy, the multipliers and
every history entry within 1e-9, the integer counts equal.  The shield
clamps each gated channel as JAX does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import safe_rl as jr
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import safe_rl as tr

P_J, P_T = jr.TokamakEnvParams(), tr.TokamakEnvParams()
CFG = dict(batch_episodes=4, max_episode_steps=30)


def episode_draws(key, n_steps):
    k1, k2 = jax.random.split(key)
    u, n = jax.random.uniform(k1, ()), jax.random.normal(k2, ())
    chain, plant = key, []
    for _ in range(n_steps):
        chain, kn = jax.random.split(chain)
        plant.append(jax.random.normal(kn, (3,)))
    act = jax.vmap(lambda k: jax.random.normal(k, (3,)))(
        jax.random.split(jax.random.fold_in(key, 1), n_steps))
    return u, n, jnp.stack(plant), act


def batch_draws(key, cfg) -> tr.EpisodeDraws:
    eps = [episode_draws(k, cfg.max_episode_steps)
           for k in jax.random.split(key, cfg.batch_episodes)]
    return tr.EpisodeDraws(*(torch.from_numpy(np.stack([np.asarray(e[i]) for e in eps]))
                             for i in range(4)))


def test_collect_batch_matches_jax():
    key = jax.random.PRNGKey(4)
    params = jr.init_policy(jax.random.PRNGKey(1))._replace(
        b=jnp.asarray([0.3, -0.2, 0.1]))
    lambdas = jnp.asarray([0.5, 0.2, 0.1])
    jcfg, tcfg = jr.PPOConfig(**CFG), tr.PPOConfig(**CFG)
    ref = jr.collect_batch(P_J, jcfg, params, lambdas, key)
    ours = tr._collect_batch(P_T, tcfg, interop.policy_params(params, device="cpu"),
                             torch.from_numpy(np.array(lambdas)), batch_draws(key, jcfg))
    for f in ("obs", "actions", "log_probs", "rewards", "costs", "mask"):
        assert rel(getattr(ours, f), getattr(ref, f)) <= 1e-9, f
    assert np.array_equal(ours.clamp_events.numpy(), np.asarray(ref.clamp_events))
    assert np.array_equal(ours.halted.numpy(), np.asarray(ref.halted))


def test_train_matches_jax():
    n_it, seed = 3, 0
    jcfg, tcfg = jr.PPOConfig(**CFG), tr.PPOConfig(**CFG)
    p_j, lam_j, hist_j = jr.train(P_J, jcfg, n_iterations=n_it, seed=seed)
    key = jax.random.PRNGKey(seed)
    p0 = interop.policy_params(jr.init_policy(jax.random.fold_in(key, 0)), device="cpu")
    draws = [batch_draws(jax.random.fold_in(key, it + 1), jcfg) for it in range(n_it)]
    p_t, lam_t, hist_t = tr._train(P_T, tcfg, p0, draws)
    for f in ("w", "b", "log_std"):
        assert rel(getattr(p_t, f), getattr(p_j, f)) <= 1e-9, f
    assert np.max(np.abs(lam_t.numpy() - np.asarray(lam_j))) <= 1e-9 * max(
        1.0, float(np.max(np.abs(np.asarray(lam_j)))))
    for a, b in zip(hist_t, hist_j):
        assert a["iteration"] == b["iteration"] and a["clamp_events"] == b["clamp_events"]
        assert a["halt_rate"] == b["halt_rate"]
        assert abs(a["mean_return"] - b["mean_return"]) <= 1e-9 * abs(b["mean_return"])
        for x, y in zip(a["mean_cost"] + a["lambdas"], b["mean_cost"] + b["lambdas"]):
            assert abs(x - y) <= 1e-9 * max(abs(y), 1e-12)


@pytest.mark.parametrize("gates", [(True, True, True), (False, False, False),
                                   (True, False, True)])
def test_shield_matches_jax(gates):
    action = np.asarray([0.7, -0.4, 0.3])
    allowed_j = dict(zip(("heating", "current", "vertical"), (jnp.asarray(g) for g in gates)))
    allowed_t = dict(zip(("heating", "current", "vertical"), (torch.tensor(g) for g in gates)))
    a_j, n_j = jr.shield_action(jnp.asarray(action), allowed_j)
    a_t, n_t = tr.shield_action(torch.from_numpy(action), allowed_t)
    assert np.array_equal(a_t.numpy(), np.asarray(a_j)) and int(n_t) == int(n_j)


def test_default_device_is_the_card():
    cfg = tr.PPOConfig(batch_episodes=2, max_episode_steps=3)
    if torch.cuda.is_available():
        assert tr.train(P_T, cfg, n_iterations=1)[0].w.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tr.train(P_T, cfg, n_iterations=1)
