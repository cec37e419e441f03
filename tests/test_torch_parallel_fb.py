"""``parallel/sharded_fb.py`` of the port: the free-boundary forward with the
inner elliptic step Z-slab sharded over 1 and 2 CPU shards, against the
port's single-device forward (the bars of ``tests/test_sharded_fb.py``:
outer iterations equal, 1e-8 span-relative) and JAX's sharded forward on 2
virtual devices.  4 and 8 shards: ``test_torch_parallel_fb_wide.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.parallel.halo import make_z_mesh as jmesh
from scpn_fusion_tpu.parallel.sharded_fb import solve_free_boundary_sharded as jsharded
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import solve_free_boundary
from scpn_fusion_tpu_torch.parallel.halo import make_z_mesh
from scpn_fusion_tpu_torch.parallel.sharded_fb import solve_free_boundary_sharded
from tests.test_fixed_boundary import make_cfg
from tests.torch_parity import as_np

SHARDS = (1, 2)


def fb_case(shards):
    """(JAX config, the port's single-device forward, {shards: sharded forward})."""
    ref_cfg = make_cfg("multigrid", max_iter=600)
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    kw = dict(max_outer_iter=10, tol=1e-5, mu0_green=1.0, dtype=torch.float64)
    single = solve_free_boundary(cfg, device="cpu", **kw)
    assert single.converged
    sharded = {n: solve_free_boundary_sharded(cfg, mesh=make_z_mesh(n, device="cpu"), **kw)
               for n in shards}
    return ref_cfg, cfg, single, sharded


def span_dev(a, b) -> float:
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a - b))) / float(b.max() - b.min())


@pytest.fixture(scope="module")
def case():
    return fb_case(SHARDS)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_fb_matches_single_device(n_shards, case):
    _, _, single, sharded = case
    res = sharded[n_shards]
    assert res.converged
    assert res.outer_iterations == single.outer_iterations
    assert span_dev(res.psi, single.psi) < 1e-8


def test_sharded_fb_shard_count_invariance(case):
    _, _, _, sharded = case
    assert span_dev(sharded[2].psi, sharded[1].psi) < 1e-10


def test_sharded_fb_coil_currents_passthrough(case):
    _, cfg, _, sharded = case
    expected = np.asarray([c.current for c in cfg.coils], np.float64)
    np.testing.assert_array_equal(as_np(sharded[2].coil_currents), expected)


def test_sharded_fb_matches_jax(case):
    ref_cfg, _, _, sharded = case
    ref = jsharded(ref_cfg, mesh=jmesh(2), max_outer_iter=10, tol=1e-5, mu0_green=1.0,
                   dtype=jnp.float64)
    assert sharded[2].outer_iterations == int(ref.outer_iterations)
    assert span_dev(sharded[2].psi, ref.psi) < 1e-8
