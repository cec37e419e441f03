"""Port parity: the surrogates' MLP training loop
(``models/surrogates/mlp.py``: ``init_mlp``, ``train_mlp``).

The draws rule: JAX's initial weights come across through
``interop.mlp_params`` and its minibatch indices, ``randint(fold_in(key, k),
(batch,), 0, n)`` for every step, are fed to the port's ``_train_mlp``.  In
float64: the loss history and the parameters after the same steps within
1e-9 relative.  The written-out Adam (``control/mpc._adam_update``) is held
to ``optax.adam`` at 1e-14 over several steps.  ``init_mlp`` draws He
normals from a ``torch.Generator``, and its default device is the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import rel, rng

from scpn_fusion_tpu.models.surrogates import mlp as jm
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control.mpc import _adam_update
from scpn_fusion_tpu_torch.models.surrogates import mlp as tm

TOL = 1e-9


def jax_batch_indices(key, n_steps: int, batch: int, n: int) -> torch.Tensor:
    idx = jax.vmap(lambda k: jax.random.randint(jax.random.fold_in(key, k), (batch,), 0, n))(
        jnp.arange(n_steps))
    return torch.from_numpy(np.array(idx)).long()


@pytest.mark.parametrize("sizes,n_steps,batch", [((4, 16, 16, 2), 60, 32), ((3, 8, 1), 40, 50)])
def test_train_mlp_matches_jax(sizes, n_steps, batch):
    g = rng(3)
    x = g.standard_normal((200, sizes[0]))
    y = np.tanh(x @ g.standard_normal((sizes[0], sizes[-1])))
    key = jax.random.PRNGKey(5)
    p0 = jm.init_mlp(key, sizes, dtype=jnp.float64)
    fit_key = jax.random.fold_in(key, 1)
    ref = jm.train_mlp(p0, jnp.asarray(x), jnp.asarray(y), fit_key, n_steps=n_steps,
                       batch_size=batch, lr=3e-3)
    ours = tm._train_mlp(interop.mlp_params(p0, device="cpu"), torch.from_numpy(x),
                         torch.from_numpy(y), jax_batch_indices(fit_key, n_steps, batch, 200),
                         lr=3e-3)
    assert rel(ours.loss_history, ref.loss_history) <= TOL
    for a, b in zip(tm.leaves(ours.params), jax.tree.leaves(ref.params)):
        assert rel(a, b) <= TOL
    assert float(ours.loss_history[-1]) < float(ours.loss_history[0])


def test_adam_update_matches_optax():
    g = rng(4)
    p = g.standard_normal((5, 3))
    opt = optax.adam(1e-2)
    state = opt.init(jnp.asarray(p))
    ours = torch.from_numpy(p.copy())
    mu, nu, count = torch.zeros_like(ours), torch.zeros_like(ours), 0
    ref = jnp.asarray(p)
    for k in range(7):
        grad = g.standard_normal((5, 3))
        upd, state = opt.update(jnp.asarray(grad), state, ref)
        ref = optax.apply_updates(ref, upd)
        step, mu, nu, count = _adam_update(torch.from_numpy(grad), mu, nu, count, 1e-2)
        ours = ours + step
        assert np.max(np.abs(ours.numpy() - np.asarray(ref))) <= 1e-14


def test_init_mlp_draws_he_normals():
    gen = torch.Generator().manual_seed(0)
    p = tm.init_mlp(gen, (400, 300, 1), dtype=torch.float64, device="cpu")
    assert [tuple(w.shape) for w in p.weights] == [(400, 300), (300, 1)]
    assert all(float(b.abs().max()) == 0.0 for b in p.biases)
    assert abs(float(p.weights[0].std()) - np.sqrt(2.0 / 400)) < 0.01 * np.sqrt(2.0 / 400)
    again = tm.init_mlp(torch.Generator().manual_seed(0), (400, 300, 1), dtype=torch.float64,
                        device="cpu")
    assert torch.equal(again.weights[0], p.weights[0])


def test_mlp_apply_promotes_like_jax():
    """A float64 input through float32 weights is computed in float64, as
    JAX's ``h @ w`` promotes."""
    g = rng(6)
    key = jax.random.PRNGKey(2)
    p32 = jm.init_mlp(key, (3, 8, 2))
    x = g.standard_normal((10, 3))
    ref = jm.mlp_apply(p32, jnp.asarray(x))
    ours = tm.mlp_apply(interop.mlp_params(p32, device="cpu"), torch.from_numpy(x))
    assert ours.dtype == torch.float64 and np.asarray(ref).dtype == np.float64
    assert rel(ours, ref) <= 1e-12


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tm.init_mlp(torch.Generator(), (2, 3)).weights[0].is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tm.init_mlp(torch.Generator(), (2, 3))
