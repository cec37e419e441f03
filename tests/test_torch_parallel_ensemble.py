"""``parallel/ensemble.solve_equilibrium_batch`` of the port against its own
standalone solves and the JAX package's batch (the cases of
``tests/test_parallel_2d_ensemble.py``, float64, 33^2).

Element b equals the batch of one on its inputs at 1e-12 with the same
iteration count, and JAX's batch at 1e-10 with the same counts and flags.
The straggler case: ``test_torch_parallel_ensemble_straggler.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.parallel.ensemble import solve_equilibrium_batch as jbatch
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch
from tests.test_fixed_boundary import make_cfg
from tests.torch_parity import as_np

F64 = torch.float64


def case(method="multigrid", **kw):
    """(JAX config, port config, f64 CPU grid, base effective currents)."""
    ref_cfg = make_cfg(method, n=33, **kw)
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    grid = Grid.from_config(cfg, dtype=F64, device="cpu")
    base = torch.tensor([c.current * c.turns for c in cfg.coils], dtype=F64)
    return ref_cfg, cfg, grid, base


def span_dev(a, b) -> float:
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a - b))) / float(b.max() - b.min())


@pytest.fixture(scope="module")
def three():
    ref_cfg, cfg, grid, base = case(max_iter=200)
    batch = torch.stack([base, 1.1 * base, 0.9 * base])
    i_t = torch.tensor([15.0, 15.0, 12.0], dtype=F64)
    return ref_cfg, cfg, grid, batch, i_t, solve_equilibrium_batch(cfg, grid, batch, i_t)


def test_batch_matches_single_solve(three):
    _, cfg, grid, batch, i_t, out = three
    assert out.psi.shape == (3, 33, 33)
    assert bool(out.converged.all())
    one = solve_equilibrium_batch(cfg, grid, batch[:1], i_t[:1])
    assert int(one.iterations[0]) == int(out.iterations[0])
    assert span_dev(out.psi[0], one.psi[0]) < 1e-12


def test_batch_matches_jax(three):
    ref_cfg, _, _, batch, i_t, out = three
    jg = JGrid.from_config(ref_cfg, dtype=np.float64)
    psi, conv, iters = jbatch(ref_cfg, jg, jnp.asarray(as_np(batch)), jnp.asarray(as_np(i_t)))
    np.testing.assert_array_equal(as_np(out.converged), np.asarray(conv))
    np.testing.assert_array_equal(as_np(out.iterations), np.asarray(iters))
    for e in range(3):
        assert span_dev(out.psi[e], np.asarray(psi[e])) < 1e-10, e
