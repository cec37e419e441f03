"""``parallel/halo.py``, ``halo2d.py``, ``mesh.py`` and ``plan.py`` of the
port against the JAX package.

The Z-slab and 2D-tile sweeps run on CPU shards of the port's
single-controller mesh and on JAX's 8 virtual CPU devices
(``tests/conftest.py``), on the same numpy-seeded fields: both equal the
monolithic sweep at 1e-12 (the reference's tile == monolithic invariant) and
each other.  ``plan.py`` is a copy of the JAX module, held equal line for
line.
"""

import difflib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.parallel import halo as jhalo
from scpn_fusion_tpu.parallel import halo2d as jhalo2d
from scpn_fusion_tpu.parallel import plan as jplan
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.ops import stencil as st
from scpn_fusion_tpu_torch.parallel import halo, halo2d, plan
from scpn_fusion_tpu_torch.parallel.mesh import Mesh
from tests.torch_parity import as_np

ROOT = Path(__file__).resolve().parent.parent
SHARDS = [1, 2, 4, 8]


def test_plan_is_a_copy_of_its_source():
    """The copy differs from its source in no line."""
    ours = (ROOT / "scpn_fusion_tpu_torch/parallel/plan.py").read_text().splitlines()
    ref = (ROOT / "scpn_fusion_tpu/parallel/plan.py").read_text().splitlines()
    blocks = [(ref[i1:i2], ours[j1:j2]) for tag, i1, i2, j1, j2 in
              difflib.SequenceMatcher(None, ref, ours, autojunk=False).get_opcodes()
              if tag != "equal"]
    assert blocks == []


@pytest.mark.parametrize("args", [(10, 7, 3, 2, 1), (8, 6, 2, 3, 1), (12, 5, 4, 1, 2)])
def test_plan_builds_the_jax_plan(args):
    n_r, n_t, ranks_r, ranks_t, h = args
    ours = plan.build_decomposition(n_r, n_t, radial_ranks=ranks_r, toroidal_ranks=ranks_t,
                                    halo=h)
    ref = jplan.build_decomposition(n_r, n_t, radial_ranks=ranks_r, toroidal_ranks=ranks_t,
                                    halo=h)
    assert repr(ours) == repr(ref)
    state = np.random.default_rng(3).standard_normal((n_r, n_t, 3, 2, 2))
    assert repr(plan.invariant_metrics(ours, state)) == repr(jplan.invariant_metrics(ref, state))
    with pytest.raises(plan.PlanError, match="cannot split"):
        plan.build_decomposition(3, 3, radial_ranks=5, toroidal_ranks=1)


def _fields(nr: int, nz: int):
    g = Grid.from_bounds(nr, nz, 2.0, 10.0, -4.0, 4.0, dtype=torch.float64, device="cpu")
    jg = JGrid.from_bounds(nr, nz, 2.0, 10.0, -4.0, 4.0, dtype=np.float64)
    rng = np.random.default_rng(0)
    psi, src = rng.standard_normal(g.shape), rng.standard_normal(g.shape)
    return g, jg, psi, src


def _monolithic(g, psi, src, sweeps=5, omega=1.6):
    out = torch.from_numpy(psi)
    for _ in range(sweeps):
        out = st.sor_step(out, torch.from_numpy(src), g.R, g.dR, g.dZ, omega)
    return out


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_sor_matches_monolithic_and_jax(n_shards):
    g, jg, psi, src = _fields(65, 64)
    out, res = halo.sharded_sor_solve(
        torch.from_numpy(psi), torch.from_numpy(src), g.R, 1.6,
        mesh=halo.make_z_mesh(n_shards, device="cpu"), axis="z", d_r=g.dR, d_z=g.dZ,
        n_sweeps=5, nz_total=g.NZ)
    ref, ref_res = jhalo.sharded_sor_solve(
        jnp.asarray(psi), jnp.asarray(src), jg.R, jnp.asarray(1.6),
        mesh=jhalo.make_z_mesh(n_shards), axis="z", d_r=jg.dR, d_z=jg.dZ, n_sweeps=5,
        nz_total=jg.NZ)
    np.testing.assert_allclose(as_np(out), as_np(_monolithic(g, psi, src)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=1e-12, atol=1e-12)
    assert float(res) > 0.0
    np.testing.assert_allclose(float(res), float(ref_res), rtol=1e-12)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_tiled_sor_matches_monolithic_and_jax(n_shards):
    pz, pr = halo2d.optimal_process_grid(n_shards)
    g, jg, psi, src = _fields(16 * pr, 16 * pz)
    out, res = halo2d.sharded_sor_solve_2d(
        torch.from_numpy(psi), torch.from_numpy(src), g.R, 1.6,
        mesh=halo2d.make_2d_mesh(n_shards, device="cpu"), d_r=g.dR, d_z=g.dZ, n_sweeps=5,
        nz_total=g.NZ, nr_total=g.NR)
    ref, ref_res = jhalo2d.sharded_sor_solve_2d(
        jnp.asarray(psi), jnp.asarray(src), jg.R, jnp.asarray(1.6),
        mesh=jhalo2d.make_2d_mesh(n_shards), d_r=jg.dR, d_z=jg.dZ, n_sweeps=5,
        nz_total=jg.NZ, nr_total=jg.NR)
    np.testing.assert_allclose(as_np(out), as_np(_monolithic(g, psi, src)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(res), float(ref_res), rtol=1e-12)


@pytest.mark.parametrize("n", range(1, 17))
def test_optimal_process_grid_is_jax(n):
    assert halo2d.optimal_process_grid(n) == jhalo2d.optimal_process_grid(n)


def test_meshes_of_the_jax_shapes():
    z = halo.make_z_mesh(4, axis="batch", device="cpu")
    assert z.shape == {"batch": 4} and z.size == 4
    m = halo2d.make_2d_mesh(8, device="cpu")
    assert m.shape == dict(jhalo2d.make_2d_mesh(8).shape)
    assert m.axis_names == ("tz", "tr")


def test_a_mesh_of_more_cards_than_the_host_has_raises():
    """As JAX's ``make_z_mesh`` raises for more devices than the backend has
    (here: no card at all, or fewer than asked for)."""
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        halo.make_z_mesh(n)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        halo2d.make_2d_mesh(n)
    with pytest.raises(ValueError, match="do not fill"):
        Mesh.of(["cpu"] * 3, ("tz", "tr"), (2, 2))
