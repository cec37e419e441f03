"""The straggler case of ``tests/test_parallel_2d_ensemble.py`` on the port's
``parallel/ensemble.solve_equilibrium_batch`` (float64, 33^2).

The batched Picard loop freezes an element once it has converged (JAX's
guarded while-body), so each element follows its standalone trajectory:
beside a straggler that keeps the loop going, every element equals the
port's standalone solve with its inputs at 1e-12 with the same iteration
count, and the batch equals JAX's batch (counts equal, 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.parallel.ensemble import solve_equilibrium_batch as jbatch
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import solve_equilibrium
from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch
from tests.test_torch_parallel_ensemble import F64, case, span_dev
from tests.torch_parity import as_np


def test_batch_freeze_guard_with_straggler():
    ref_cfg, cfg, grid, base = case(max_iter=300)
    batch = torch.stack([base, base])
    i_t = torch.tensor([15.0, 2.0], dtype=F64)
    out = solve_equilibrium_batch(cfg, grid, batch, i_t)
    assert bool(out.converged.all())
    it = as_np(out.iterations)
    assert it[0] != it[1], "need a genuine straggler for this test"
    for e in range(2):
        single = solve_equilibrium(cfg, i_target=float(i_t[e]), dtype=F64, device="cpu")
        assert single.iterations == int(it[e])
        assert span_dev(out.psi[e], single.psi) < 1e-12, e

    psi, conv, iters = jbatch(ref_cfg, JGrid.from_config(ref_cfg, dtype=np.float64),
                              jnp.asarray(as_np(batch)), jnp.asarray(as_np(i_t)))
    np.testing.assert_array_equal(it, np.asarray(iters))
    assert bool(np.all(np.asarray(conv)))
    for e in range(2):
        assert span_dev(out.psi[e], np.asarray(psi[e])) < 1e-10, e
