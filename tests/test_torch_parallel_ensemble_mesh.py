"""``parallel/ensemble.solve_equilibrium_batch`` over a 4-shard mesh (the
case of ``tests/test_parallel_2d_ensemble.py``, 8 elements, float64,
33^2): the batch is cut into one chunk a shard, the chunks are stepped in
lockstep (every running chunk queues its iteration before the one host read)
until each reaches its own end, and the result equals the unsharded batch
(counts equal, 1e-12).
"""

import numpy as np
import torch

from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch
from scpn_fusion_tpu_torch.parallel.halo import make_z_mesh
from tests.test_torch_parallel_ensemble import F64, case, span_dev
from tests.torch_parity import as_np


def test_batch_sharded_over_mesh():
    _, cfg, grid, base = case(max_iter=150)
    batch = torch.linspace(0.9, 1.1, 8, dtype=F64)[:, None] * base[None, :]
    i_t = 15.0 * torch.ones(8, dtype=F64)
    out = solve_equilibrium_batch(cfg, grid, batch, i_t,
                                  mesh=make_z_mesh(4, axis="batch", device="cpu"))
    assert out.psi.shape == (8, 33, 33)
    assert bool(torch.isfinite(out.psi).all())
    whole = solve_equilibrium_batch(cfg, grid, batch, i_t)
    np.testing.assert_array_equal(as_np(out.iterations), as_np(whole.iterations))
    for e in range(8):
        assert span_dev(out.psi[e], whole.psi[e]) < 1e-12, e
