"""Port parity: the SOC sandpile + soft-Q learner (``control/soc_learning.py``).

Float64 (JAX x64).  The draws rule: each step's exploration uniform, random
action and drive-noise uniform are rebuilt from JAX's keys (``split(key,
n_steps)``, then ``split(k, 3)``) and fed to ``_run_soc_learning``.  300
steps (the JAX tests' size) of the default configuration and of two others
(greedy, random): the traces, the summary and the Q-table within 1e-9; the
greedy actions the Q-table picks are equal.  The sandpile step and the
soft-Q update alone on seeded inputs within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import soc_learning as js
from scpn_fusion_tpu_torch.control import soc_learning as ts

F64 = torch.float64


def jax_draws(key, n_steps, n_actions=3) -> ts.SOCDraws:
    def one(k):
        k_eps, k_act, k_noise = jax.random.split(k, 3)
        return (jax.random.uniform(k_eps, ()), jax.random.randint(k_act, (), 0, n_actions),
                jax.random.uniform(k_noise, ()))

    u, a, n = jax.vmap(one)(jax.random.split(key, n_steps))
    return ts.SOCDraws(*(torch.from_numpy(np.array(x)) for x in (u, a, n)))


@pytest.mark.parametrize("epsilon", [0.1, 0.0, 1.0])
def test_learning_run_matches_jax(epsilon):
    key = jax.random.PRNGKey(7)
    tr_j, s_j, q_j = js.run_soc_learning(key, n_steps=300, qcfg=js.SoftQConfig(epsilon=epsilon))
    tr_t, s_t, q_t = ts._run_soc_learning(jax_draws(key, 300),
                                          qcfg=ts.SoftQConfig(epsilon=epsilon), dtype=F64)
    for f in tr_j._fields:
        assert rel(getattr(tr_t, f), getattr(tr_j, f)) <= 1e-9, f
    for k in s_j:
        assert abs(float(s_t[k]) - float(s_j[k])) <= 1e-9 * max(abs(float(s_j[k])), 1e-12), k
    assert rel(q_t, q_j) <= 1e-9
    assert np.array_equal(q_t.argmax(-1).numpy(), np.asarray(jnp.argmax(q_j, -1)))


def test_sandpile_and_update_match_jax():
    cfg = js.CoupledSandpileConfig()
    z = np.random.default_rng(1).uniform(0, 9, cfg.size)
    out_j = js.coupled_sandpile_step(cfg, jnp.asarray(z), jnp.asarray(0.3), jnp.asarray(0.2))
    out_t = ts.coupled_sandpile_step(ts.CoupledSandpileConfig(), torch.from_numpy(z),
                                     torch.tensor(0.3, dtype=F64), torch.tensor(0.2, dtype=F64))
    for a, b in zip(out_t, out_j):
        assert rel(a, b) <= 1e-12
    q = np.random.default_rng(2).standard_normal((5, 5, 3))
    qc = js.SoftQConfig(alpha=0.5)
    ref = js.soft_q_update(qc, jnp.asarray(q), (jnp.int32(1), jnp.int32(2)), jnp.int32(1),
                           (jnp.int32(3), jnp.int32(0)), jnp.asarray(1.5))
    ours = ts.soft_q_update(ts.SoftQConfig(alpha=0.5), torch.from_numpy(q),
                            (torch.tensor(1), torch.tensor(2)), torch.tensor(1),
                            (torch.tensor(3), torch.tensor(0)), torch.tensor(1.5, dtype=F64))
    assert rel(ours, ref) <= 1e-12
    s = ts.discretize_state(ts.SoftQConfig(), torch.tensor(500.0), torch.tensor(9.0))
    assert (int(s[0]), int(s[1])) == (4, 4)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert ts.run_soc_learning(torch.Generator(), n_steps=2)[0].flow.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ts.run_soc_learning(torch.Generator(), n_steps=2)
