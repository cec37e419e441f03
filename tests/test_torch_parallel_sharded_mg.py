"""``parallel/sharded_mg.py`` and ``sharded_mg2d.py`` of the port against the
JAX package and the port's single-device V-cycle.

The manufactured problem of ``tests/test_sharded_mg.py`` (a Gaussian flux,
its exact GS* source, numpy-seeded noise inside the ring): one distributed
V-cycle equals the single-device cycle at 1e-12 on 1/2/4/8 Z slabs (65 rows
take the padding path) with the Dirichlet ring bit-equal, and JAX's sharded
cycle at 1e-12; the residual-gated solve stops below its gate and reports
the residual an independent recomputation gives.  The 2D tilings hold the
JAX test's float32 bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.parallel import halo as jhalo
from scpn_fusion_tpu.parallel import sharded_mg as jmg
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.ops.multigrid import vcycle
from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet, gs_operator, gs_residual
from scpn_fusion_tpu_torch.parallel.halo import make_z_mesh
from scpn_fusion_tpu_torch.parallel.sharded_mg import sharded_mg_solve, sharded_vcycle
from tests.torch_parity import as_np


def _problem(n=65, dtype=torch.float64, noise=True):
    g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=dtype, device="cpu")
    exact = torch.exp(-((g.RR - 6.0) ** 2 + g.ZZ**2) / 3.0)
    src = gs_operator(exact, g.R, g.dR, g.dZ)
    if noise:
        eps = 0.05 * np.random.default_rng(3).standard_normal(g.shape)
        eps[0, :] = eps[-1, :] = 0.0
        eps[:, 0] = eps[:, -1] = 0.0
        psi0 = exact + torch.from_numpy(eps).to(dtype)
    else:
        psi0 = apply_dirichlet(torch.zeros_like(exact), exact)
    return g, exact, src, psi0


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_vcycle_matches_single_device_and_jax(n_shards):
    g, _, src, psi0 = _problem(65)
    ref = vcycle(psi0, src, g.R, g.dR, g.dZ)
    out = sharded_vcycle(psi0, src, g.R, 1.0, mesh=make_z_mesh(n_shards, device="cpu"),
                         axis="z", d_r=g.dR, d_z=g.dZ)
    span = float(ref.abs().max())
    assert float((out - ref).abs().max()) / span < 1e-12
    for ring in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        assert torch.equal(out[ring], psi0[ring])
    jg = JGrid.from_bounds(65, 65, 2.0, 10.0, -4.0, 4.0, dtype=np.float64)
    jout = jmg.sharded_vcycle(jnp.asarray(as_np(psi0)), jnp.asarray(as_np(src)), jg.R,
                              jnp.asarray(1.0, jnp.float64), mesh=jhalo.make_z_mesh(n_shards),
                              axis="z", d_r=jg.dR, d_z=jg.dZ)
    assert float(np.max(np.abs(as_np(out) - np.asarray(jout)))) / span < 1e-12


def test_sharded_mg_solve_converges_to_its_residual_gate():
    g, exact, src, psi0 = _problem(65)
    tol = 1e-9
    psi_f, res, k = sharded_mg_solve(psi0, src, g.R, mesh=make_z_mesh(8, device="cpu"),
                                     axis="z", d_r=g.dR, d_z=g.dZ, tol=tol, max_cycles=60)
    assert float(res) < tol
    assert 0 < int(k) < 60
    r = gs_residual(psi_f, src, g.R, g.dR, g.dZ)
    rms = float(torch.sqrt((r * r).sum() / ((g.NZ - 2) * (g.NR - 2))))
    np.testing.assert_allclose(rms, float(res), rtol=1e-6)
    span = float(exact.max() - exact.min())
    assert float((psi_f - exact).abs().max()) / span < 1e-5
