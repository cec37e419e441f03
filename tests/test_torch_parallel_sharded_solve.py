"""``parallel/sharded_solve.py`` and ``sharded_mg2d.solve_equilibrium_sharded_2d``
of the port: the Anderson-MG-Picard equilibrium with a sharded elliptic
step, on CPU shards, against the port's single-device solve and the JAX
package's (the bars of ``tests/test_sharded_mg.py`` and
``tests/test_sharded_mg2d.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.models.equilibrium import solve_equilibrium as jsolve
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import solve_equilibrium
from scpn_fusion_tpu_torch.parallel import halo2d
from scpn_fusion_tpu_torch.parallel.halo import make_z_mesh
from scpn_fusion_tpu_torch.parallel.sharded_mg2d import solve_equilibrium_sharded_2d
from scpn_fusion_tpu_torch.parallel.sharded_solve import (
    solve_equilibrium_sharded,
    solve_equilibrium_sharded_fmg,
)
from tests.test_sharded_mg import _anderson_cfg
from tests.torch_parity import as_np

F64 = torch.float64


def _cfg(n):
    return interop.config_from_asdict(dataclasses.asdict(_anderson_cfg(n)))


def _dev(a, b) -> float:
    a, b = as_np(a).astype(np.float64), as_np(b).astype(np.float64)
    return float(np.max(np.abs(a - b))) / float(b.max() - b.min())


@pytest.fixture(scope="module")
def single_65():
    ref = solve_equilibrium(_cfg(65), dtype=F64, device="cpu")
    assert ref.converged
    return ref


@pytest.fixture(scope="module")
def sharded_65():
    return {n: solve_equilibrium_sharded(_cfg(65), make_z_mesh(n, device="cpu"), dtype=F64)
            for n in (2, 8)}


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_equilibrium_converges_with_parity(n_shards, single_65, sharded_65):
    res = sharded_65[n_shards]
    assert res.converged
    assert res.iterations == single_65.iterations
    assert _dev(res.psi, single_65.psi) < 1e-10


def test_sharded_equilibrium_matches_jax(sharded_65):
    ref = jsolve(_anderson_cfg(65), dtype=jnp.float64)
    assert sharded_65[8].iterations == int(ref.iterations)
    assert _dev(sharded_65[8].psi, ref.psi) < 1e-10


def test_shard_count_invariance(sharded_65):
    assert _dev(sharded_65[8].psi, sharded_65[2].psi) < 1e-10


def test_sharded_fmg_cascade_converges_and_matches():
    cfg = _cfg(129)
    res, info = solve_equilibrium_sharded_fmg(cfg, make_z_mesh(8, device="cpu"),
                                              min_coarse=65, dtype=F64)
    assert [lv["n"] for lv in info] == [65, 129]
    assert all(lv["converged"] for lv in info)
    ref = solve_equilibrium(cfg, dtype=F64, device="cpu")
    assert _dev(res.psi, ref.psi) < 1e-3
    assert info[-1]["iterations"] <= ref.iterations


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_tiled_equilibrium_matches_single_device(n_shards):
    """The JAX test's float32 bar (1e-4 span-relative); the tiled solve's
    iteration count equals the single solve's."""
    cfg = _cfg(65)
    ref = solve_equilibrium(cfg, dtype=torch.float32, device="cpu")
    res = solve_equilibrium_sharded_2d(cfg, halo2d.make_2d_mesh(n_shards, device="cpu"),
                                       dtype=torch.float32)
    assert ref.converged and res.converged
    assert res.iterations == ref.iterations
    assert _dev(res.psi, ref.psi) < 1e-4
