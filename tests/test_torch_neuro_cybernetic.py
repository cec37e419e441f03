"""Port parity: the push-pull spiking-population shot
(``control/neuro_cybernetic.py``).

JAX runs the shot in float32 (its populations' and positions' fixed
dtype).  The draws rule: each tick's membrane noise, four populations of 50
normals (``split(fold_in(key_t, 0 or 1))`` then ``split`` per push-pull
pair), is rebuilt from JAX's keys and fed to
``_run_neuro_cybernetic_shot``.  Deterministic and stochastic streams, 200
ticks: the spike counts (so every firing decision) and the interlock flags
equal tick by tick, the traces and metrics within 1e-6 relative (float32
arithmetic in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.control import neuro_cybernetic as jn
from scpn_fusion_tpu_torch.control import neuro_cybernetic as tn


def jax_noise(key, n_ticks, stochastic=False, n=50) -> torch.Tensor:
    def one(key_t):
        kr, kz = jax.random.split(jax.random.fold_in(key_t, 1 if stochastic else 0))
        out = []
        for k in (kr, kz):
            kp, kn = jax.random.split(k)
            out += [jax.random.normal(kp, (n,), jnp.float32),
                    jax.random.normal(kn, (n,), jnp.float32)]
        return jnp.stack(out)

    return torch.from_numpy(np.array(jax.vmap(one)(jax.random.split(key, n_ticks))))


@pytest.mark.parametrize("stochastic", [False, True])
def test_shot_matches_jax(stochastic):
    key = jax.random.PRNGKey(3)
    tr_j, m_j = jn.run_neuro_cybernetic_shot(key, n_ticks=200, stochastic=stochastic)
    tr_t, m_t = tn._run_neuro_cybernetic_shot(jax_noise(key, 200, stochastic))
    assert np.array_equal(tr_t.position_allowed.numpy(), np.asarray(tr_j.position_allowed))
    assert np.array_equal(np.round(tr_t.spike_rate.numpy() * 4000),
                          np.round(np.asarray(tr_j.spike_rate) * 4000))
    for f in tr_j._fields:
        a, b = as_np(getattr(tr_t, f)), as_np(getattr(tr_j, f))
        assert np.max(np.abs(a - b)) <= 1e-6 * max(np.max(np.abs(b)), 1.0), f
    for k in m_j:
        assert abs(float(m_t[k]) - float(m_j[k])) <= 1e-6 * max(abs(float(m_j[k])), 1.0), k


def test_pool_step_polarity_and_params():
    p = tn.LIFPoolParams()
    assert p.alpha == jn.LIFPoolParams().alpha
    with pytest.raises(ValueError):
        tn.LIFPoolParams(n_neurons=0)
    st = tn.pool_init(p, device="cpu")
    noise = torch.zeros(50)
    for _ in range(30):
        st, cmd, _ = tn.pool_step(p, st, torch.tensor(0.5), noise, noise)
    assert float(cmd) > 0.0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tn.run_neuro_cybernetic_shot(torch.Generator(), n_ticks=2)[0].r.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tn.run_neuro_cybernetic_shot(torch.Generator(), n_ticks=2)
