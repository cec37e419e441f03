"""``parallel/sharded_mg2d.py`` of the port against the JAX package and the
port's single-device V-cycle: every tiling of 8 CPU shards (1x8, 2x4, 4x2,
8x1) reproduces the single-device cycle (float32 at the JAX test's 5e-6,
float64 at 1e-12) and JAX's tiled cycle, and the tiled linear solve is
residual-gated.  The problem is ``tests/test_torch_parallel_sharded_mg.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.parallel import sharded_mg2d as jmg2d
from scpn_fusion_tpu_torch.ops.multigrid import vcycle
from scpn_fusion_tpu_torch.parallel import halo2d
from scpn_fusion_tpu_torch.parallel.mesh import Mesh
from scpn_fusion_tpu_torch.parallel.sharded_mg2d import sharded_mg_solve_2d, sharded_vcycle_2d
from tests.test_torch_parallel_sharded_mg import _problem
from tests.torch_parity import as_np


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_tiled_vcycle_matches_single_device_and_jax(shape):
    """Every tiling reproduces the single-device V-cycle: float32 at the JAX
    test's 5e-6 and float64 at 1e-12; JAX's tiled cycle at 1e-12 in float64."""
    mesh = Mesh.of(["cpu"] * 8, ("tz", "tr"), shape)
    for dtype, bar in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
        g, _, src, psi0 = _problem(65, dtype, noise=False)
        ref = vcycle(psi0, src, g.R, g.dR, g.dZ)
        out = sharded_vcycle_2d(psi0, src, g.R, 1.0, mesh=mesh, d_r=g.dR, d_z=g.dZ)
        span = float(ref.max() - ref.min())
        assert float((out - ref).abs().max()) / span < bar, dtype
    jg = JGrid.from_bounds(65, 65, 2.0, 10.0, -4.0, 4.0, dtype=np.float64)
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(shape), ("tz", "tr"))
    jout = jmg2d.sharded_vcycle_2d(jnp.asarray(as_np(psi0)), jnp.asarray(as_np(src)), jg.R,
                                   jnp.asarray(1.0, jnp.float64), mesh=jmesh, d_r=jg.dR,
                                   d_z=jg.dZ)
    assert float(np.max(np.abs(as_np(out) - np.asarray(jout)))) / span < 1e-12


def test_tiled_mg_solve_is_residual_gated():
    g, exact, src, psi0 = _problem(65, torch.float32, noise=False)
    p, res, k = sharded_mg_solve_2d(psi0, src, g.R, mesh=halo2d.make_2d_mesh(8, device="cpu"),
                                    d_r=g.dR, d_z=g.dZ, tol=1e-4, max_cycles=40)
    assert float(res) < 1e-4
    assert int(k) < 40
    span = float(exact.max() - exact.min())
    assert float((p - exact).abs().max()) / span < 1e-4
