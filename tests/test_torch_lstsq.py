"""Port parity: bounded Tikhonov least squares (``ops/lstsq``).

The port's projected FISTA against ``scpn_fusion_tpu.ops.lstsq`` on the CPU
in float64, on the seeded cases of ``tests/test_free_boundary.py:21-68``:
solutions within 1e-10 of the JAX solution (relative to its largest entry),
and the torch-autograd gradient through ``bounded_lstsq`` (its SVD warm
start included) within 1e-8 of ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rng, to_torch

from scpn_fusion_tpu.ops import lstsq as jls
from scpn_fusion_tpu_torch.ops import lstsq as tls

TOL = 1e-10


def rel(ours, ref) -> float:
    a, b = as_np(ours), as_np(ref)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_unbounded_matches_jax():
    g = rng(0)
    a, b = g.standard_normal((20, 6)), g.standard_normal(20)
    big = np.full(6, 1e30)
    ref = jls.bounded_lstsq(jnp.asarray(a), jnp.asarray(b), jnp.asarray(-big), jnp.asarray(big))
    ours = tls.bounded_lstsq(to_torch(a), to_torch(b), to_torch(-big), to_torch(big))
    assert ours.dtype == torch.float64
    assert rel(ours, ref) <= TOL
    assert rel(tls._svd_lstsq(to_torch(a), to_torch(b)), np.linalg.lstsq(a, b, rcond=None)[0]) \
        <= TOL


@pytest.mark.parametrize("x0", [False, True])
def test_bounded_matches_jax(x0):
    """Active bounds, 2000 FISTA steps, from the SVD warm start or a given x0."""
    g = rng(1)
    a, b = g.standard_normal((30, 5)), 3.0 * g.standard_normal(30)
    lb, ub = -0.5 * np.ones(5), 0.5 * np.ones(5)
    start = 0.1 * np.arange(5) if x0 else None
    ref = jls.bounded_lstsq(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lb), jnp.asarray(ub),
                            None if start is None else jnp.asarray(start), n_iter=2000)
    ours = tls.bounded_lstsq(to_torch(a), to_torch(b), to_torch(lb), to_torch(ub),
                             None if start is None else to_torch(start), n_iter=2000)
    assert rel(ours, ref) <= TOL
    assert np.all(np.abs(as_np(ours)) <= 0.5)


def test_rank_deficient_warm_start_matches_jax():
    """A repeated column: the cutoff drops the zero singular value as JAX does."""
    g = rng(4)
    a = g.standard_normal((12, 4))
    a[:, 3] = a[:, 1]
    b = g.standard_normal(12)
    ref = jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(b))[0]
    assert rel(tls._svd_lstsq(to_torch(a), to_torch(b)), ref) <= TOL


@pytest.mark.parametrize("prior", [False, True])
def test_tikhonov_augmented_system(prior):
    g = rng(2)
    m, target = g.standard_normal((4, 12)), g.standard_normal(12)
    big = np.full(4, 1e30)
    p = g.standard_normal(4) if prior else None
    ref = jls.tikhonov_coil_lstsq(jnp.asarray(m.T), jnp.asarray(target), 1e-3,
                                  jnp.asarray(-big), jnp.asarray(big),
                                  None if p is None else jnp.asarray(p))
    ours = tls.tikhonov_coil_lstsq(to_torch(m.T), to_torch(target), 1e-3,
                                   to_torch(-big), to_torch(big),
                                   None if p is None else to_torch(p))
    assert rel(ours, ref) <= TOL


def test_gradient_matches_jax_grad():
    g = rng(3)
    a = g.standard_normal((10, 3))
    b = g.standard_normal(10)
    big = np.full(3, 1e30)

    def loss_j(bb):
        x = jls.bounded_lstsq(jnp.asarray(a), bb, jnp.asarray(-big), jnp.asarray(big), n_iter=100)
        return jnp.sum(x**2)

    ref = jax.grad(loss_j)(jnp.asarray(b))
    bt = to_torch(b).requires_grad_(True)
    x = tls.bounded_lstsq(to_torch(a), bt, to_torch(-big), to_torch(big), n_iter=100)
    (x**2).sum().backward()
    assert np.all(np.isfinite(as_np(bt.grad)))
    assert rel(bt.grad, ref) <= 1e-8
