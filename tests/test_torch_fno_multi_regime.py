"""Port parity: the multi-regime FNO training pairs and trainer
(``models/surrogates/fno_multi_regime.py``).

JAX's draws (the regime indices of ``jax.random.choice``, the parameter
uniforms and the three normal fields, from ``split(key, 5)``) go to the
port's twin: the sampled parameters and the pairs within 1e-12 of JAX's in
float64 (the ``"xy"`` wavenumber grid; an ``"ij"`` grid would swap kx and
ky in omega).  ``_train_fno_multi_regime`` on JAX's pairs, initial
parameters and minibatch indices gives JAX's validation rel-L2 within 1e-4.
The JAX tests' properties and its learnability gate (val rel-L2 < 0.5) hold
for the port's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mlp_train import jax_batch_indices
from torch_parity import rel

from scpn_fusion_tpu.models.surrogates import fno as jf
from scpn_fusion_tpu.models.surrogates import fno_multi_regime as jmr
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.surrogates import fno_multi_regime as tmr

TOL = 1e-12
F64 = torch.float64


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_draws(key, n: int, grid: int, probs=(1 / 3, 1 / 3, 1 / 3)):
    """The draws ``generate_multi_regime_pairs`` makes from ``key``."""
    k_reg, k_par, k_field, k_fr, k_fi = jax.random.split(key, 5)
    idx = jax.random.choice(k_reg, 3, (n,), p=jnp.asarray(probs) / sum(probs))
    u = jax.random.uniform(k_par, (n, 5))
    shape = (n, grid, grid)
    return (t(idx).long(), t(u), *(t(jax.random.normal(k, shape)) for k in (k_field, k_fr, k_fi)))


def test_sampled_parameters_match_jax():
    idx = jnp.asarray([0, 1, 2, 0, 2] * 20)
    key = jax.random.PRNGKey(0)
    ref = jmr.sample_regime_params(key, idx)
    got = tmr._sample_regime_params(t(jax.random.uniform(key, (100, 5))), t(idx).long())
    for k in ref:
        assert rel(got[k], ref[k]) <= TOL, k


@pytest.mark.parametrize("n,grid", [(16, 32), (6, 64)])
def test_pairs_match_jax_on_its_draws(n, grid):
    key = jax.random.PRNGKey(1)
    x_r, y_r, idx_r = jmr.generate_multi_regime_pairs(key, n_samples=n, grid_size=grid)
    x, y, idx = tmr._multi_regime_pairs(*jax_draws(key, n, grid))
    assert np.array_equal(idx.numpy(), np.asarray(idx_r))
    assert x.dtype == y.dtype == F64 and x.shape == (n, grid, grid)
    assert rel(x, x_r) <= TOL and rel(y, y_r) <= TOL


def test_pairs_properties():
    g = torch.Generator().manual_seed(4)
    x, y, idx = tmr.generate_multi_regime_pairs(g, n_samples=8, grid_size=64, dtype=F64,
                                                device="cpu")
    assert bool(torch.isfinite(x).all())
    yk = np.fft.fft2(y.numpy())
    k1 = np.fft.fftfreq(64) * 64
    kx, ky = np.meshgrid(k1, k1)
    far = kx**2 + ky**2 > 30.0**2
    assert (np.abs(yk[:, far]) ** 2).sum() / (np.abs(yk) ** 2).sum() < 1e-3
    _, _, only = tmr.generate_multi_regime_pairs(torch.Generator().manual_seed(2),
                                                 n_samples=512, grid_size=8,
                                                 regime_probs=(1.0, 0.0, 0.0), device="cpu")
    assert bool((only == 0).all())
    x2, y2, _ = tmr.generate_multi_regime_pairs(torch.Generator().manual_seed(4), n_samples=8,
                                                grid_size=64, dtype=F64, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    params = tmr.sample_regime_params(torch.Generator().manual_seed(0), idx, dtype=F64)
    for i, name in enumerate(tmr.REGIME_NAMES):
        for k, (lo, hi) in tmr.SPARC_REGIMES[name].items():
            vals = params[k][idx == i]
            assert bool((vals >= lo).all() and (vals <= hi).all()), (name, k)


def test_trainer_matches_jax_on_its_draws():
    key = jax.random.PRNGKey(3)
    n, grid, modes, width, n_layers, n_steps = 32, 8, 3, 4, 1, 10
    _, val_ref, idx_ref = jmr.train_fno_multi_regime(key, n_samples=n, grid_size=grid,
                                                     modes=modes, width=width,
                                                     n_layers=n_layers, n_steps=n_steps)
    k_data, k_val, k_init, k_train = jax.random.split(key, 4)
    x, y, idx = tmr._multi_regime_pairs(*jax_draws(k_data, n, grid))
    xv, yv, _ = tmr._multi_regime_pairs(*jax_draws(k_val, 8, grid))
    p0 = interop.fno_params(jf.init_fno(k_init, width=width, modes=modes, n_layers=n_layers),
                            device="cpu")
    _, val = tmr._train_fno_multi_regime(x, y, xv, yv, p0,
                                         jax_batch_indices(k_train, n_steps, 8, n))
    assert np.array_equal(idx.numpy(), np.asarray(idx_ref))
    assert abs(val - val_ref) <= 1e-4 * val_ref


def test_trainer_meets_the_jax_gate():
    _, val, idx = tmr.train_fno_multi_regime(torch.Generator().manual_seed(3), n_samples=128,
                                             grid_size=32, modes=8, width=16, n_steps=400,
                                             device="cpu")
    assert val < 0.5, val
    assert idx.shape == (128,)


def test_default_device_is_the_card():
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    calls = (lambda: tmr.generate_multi_regime_pairs(torch.Generator().manual_seed(0),
                                                     n_samples=2, grid_size=8)[0],
             lambda: tmr.train_fno_multi_regime(torch.Generator().manual_seed(0), n_samples=8,
                                                grid_size=8, modes=2, width=4, n_layers=1,
                                                n_steps=1)[0].lift_w)
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
