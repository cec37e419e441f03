"""Port parity: ``parallel/gk_shard.py``, the 5D GK run with its collectives
written out over a (kx, ky, mu) mesh of CPU shards.

At the JAX test's size (``tests/test_gk_spatial_shard.py:33-38``: 8 x 8 x 8 x
6 x 8, 6 steps, complex128) each sharded run on the (v) = 8, (sy, v) = (2,
4) and (sx, sy, v) = (2, 2, 2) / (1, 2, 4) meshes, from JAX's initial state,
matches JAX's monolithic ``run_nonlinear_gk`` within the JAX test's gates
(f 1e-10 of max |f|; the trace rtol 1e-9, atol 1e-13) and the port's own
monolithic run within 1e-12 (the electromagnetic two-species case:
``test_torch_gk_shard_ensemble.py``, which holds this file's time down).  The
tile velocity moments and field solve equal the monolithic ones within
1e-12, the pencil bracket is ``torch.equal`` to ``exb_bracket`` (and the
twisted theta planes to ``ballooning_planes``), the divisibility guards
raise as JAX's do, and each shard holds an eighth of the state's bytes.
JAX's sharded programs are not run here: ``tests/test_gk_spatial_shard.py``
holds them to the same monolithic run.
"""

import numpy as np
import pytest
import torch
from torch_parity import crel as rel

from scpn_fusion_tpu.models.gyrokinetics import nonlinear as jnl
from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as tnl
from scpn_fusion_tpu_torch.parallel import gk_shard as gs

BASE = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=6, n_mu=8, n_steps=6, save_interval=3,
            nonlinear=True, collisions=True, dtype="complex128")
JAX_TOL = 1e-10      # tests/test_gk_spatial_shard.py: f against the monolithic run
PORT_TOL = 1e-12     # against the port's own monolithic run
MESHES = {
    "v=8": lambda: gs.velocity_mesh(8, device="cpu"),
    "sy,v=2,4": lambda: gs.spatial_velocity_mesh(2, 4, device="cpu"),
    "sx,sy,v=2,2,2": lambda: gs.spatial_mesh_3d(2, 2, 2, device="cpu"),
    "sx,sy,v=1,2,4": lambda: gs.spatial_mesh_3d(1, 2, 4, device="cpu"),
}
RUNS = {"v": gs.run_nonlinear_gk_sharded, "sy": gs.run_nonlinear_gk_spatial_sharded,
        "sx": gs.run_nonlinear_gk_spatial_sharded_3d}


def _reference(kw, seed):
    """JAX's monolithic run from its seeded state, the port's from the same
    state, and that state as a port GKState."""
    jc = jnl.NonlinearGKConfig(**{**BASE, **kw})
    jg = jnl.build_grids(jc)
    st = jnl.init_state(jc, jg, seed=seed)
    j_final, j_trace = jnl._run_compiled(jc, jg, st)
    tc = tnl.NonlinearGKConfig(**{**BASE, **kw})
    state = tnl.GKState(torch.from_numpy(np.array(st.f)), torch.tensor(0.0, dtype=torch.float64))
    t_final, t_trace = tnl.run_nonlinear_gk(tc, state=state, device="cpu")
    return tc, state, (np.asarray(j_final.f), [np.asarray(x) for x in j_trace]), \
        (t_final.f, t_trace)


@pytest.fixture(scope="module")
def base():
    return _reference({}, 5)


def _check_run(ref, mesh):
    tc, state, (j_f, j_trace), (t_f, t_trace) = ref
    final, trace = RUNS[mesh.axis_names[0]](tc, mesh, state=state)
    assert rel(final.f, j_f) < JAX_TOL
    assert rel(final.f, t_f) <= PORT_TOL
    for ours, jx, mono in zip(trace[1:], j_trace[1:], t_trace[1:]):
        np.testing.assert_allclose(ours.numpy(), jx, rtol=1e-9, atol=1e-13)
        assert rel(ours, mono) <= PORT_TOL
    np.testing.assert_allclose(trace.times.numpy(), j_trace[0], rtol=1e-12)
    return final


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_run_matches_monolithic(base, name):
    final = _check_run(base, MESHES[name]())
    assert len(final.shards) == 8 and final.f.shape == (2, 8, 8, 8, 6, 8)


@pytest.mark.parametrize("kw", [dict(collision_model="conservative", zonal_damping_rate=0.1),
                                dict(kinetic_electrons=True, cfl_adapt=False)],
                         ids=["conservative-zonal", "kinetic-fixed-dt"])
def test_variants_match_the_port_monolithic_run(kw):
    """The conservative collision moments' psum over 'v', zonal damping on
    the ky = 0 shards, a fixed dt: the port's sharded run against its
    monolithic one from the port's draw."""
    cfg = tnl.NonlinearGKConfig(**{**BASE, "n_steps": 4, "save_interval": 2, **kw})
    mono, t_mono = tnl.run_nonlinear_gk(cfg, seed=3, device="cpu")
    final, trace = gs.run_nonlinear_gk_spatial_sharded_3d(
        cfg, gs.spatial_mesh_3d(2, 2, 2, device="cpu"), seed=3)
    assert rel(final.f, mono.f) <= PORT_TOL
    for ours, ref in zip(trace, t_mono):
        assert rel(ours, ref) <= PORT_TOL


def _run_of(cfg, mesh, f):
    g = tnl.build_grids(cfg, device="cpu")
    layout = gs._Layout.of(mesh)
    return g, gs._ShardedRun(cfg, g, layout), list(gs._shard_f(f, layout))


@pytest.mark.parametrize("name", ["sy,v=2,4", "sx,sy,v=2,2,2"])
def test_tile_moments_and_field_solve_match_monolithic(base, name):
    """The reference's tile invariant: the tiles' velocity moment and phi
    (partial sums, psum over 'v') equal the monolithic ones within 1e-12."""
    tc, state, _, _ = base
    mesh = MESHES[name]()
    g, run, fs = _run_of(tc, mesh, state.f)
    lay = run.layout
    phi = gs.ShardedGKState(tuple(t[None, :, :, :, None, None] for t in run.field(fs)),
                            state.time, lay)
    n_ion = gs.ShardedGKState(tuple(t[None, :, :, :, None, None] for t in
                                    run._vmoment([f[0] for f in fs], lambda gs_: 1.0)),
                              state.time, lay)
    # gathered along mu, index 0 of the last dim is the v = 0 shards' copy
    assert rel(phi.f[0, :, :, :, 0, 0], tnl.field_solve(tc, g, state.f)) <= 1e-12
    assert rel(n_ion.f[0, :, :, :, 0, 0], tnl.velocity_moment(state.f[0], 1.0, g)) <= 1e-12
    # and every shard of a (kx, ky) tile holds the same values
    assert all(torch.equal(phi.shards[s], phi.shards[s - s % lay.n_v])
               for s in range(len(phi.shards)))


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4), (4, 2, 1), (2, 4, 1)])
def test_pencil_bracket_and_twist_equal_the_monolithic_ones(base, shape):
    """The pencil transposes move values only: the sharded bracket is
    ``torch.equal`` to ``exb_bracket`` on the whole f, and the gathered,
    twisted boundary planes to ``ballooning_planes``."""
    tc, state, _, _ = base
    mesh = gs.spatial_mesh_3d(*shape, device="cpu")
    g, run, fs = _run_of(tc, mesh, state.f)
    phi = tnl.field_solve(tc, g, state.f)
    phis = [t.contiguous() for xb in phi.chunk(shape[0], 0) for yb in xb.chunk(shape[1], 1)
            for t in [yb] * shape[2]]
    act = [f[:1] for f in fs]
    got = gs.ShardedGKState(tuple(run.bracket(phis, act)), state.time, run.layout).f
    assert torch.equal(got, tnl.exb_bracket(g, phi, state.f[:1]))
    tw = gs.ShardedGKState(tuple(run.twisted(act)), state.time, run.layout).f
    assert torch.equal(tw, tnl.ballooning_planes(g, state.f[:1]))


def test_divisibility_guards():
    cfg = tnl.NonlinearGKConfig(**{**BASE, "n_ky": 6})
    with pytest.raises(ValueError, match="not divisible"):
        gs.run_nonlinear_gk_spatial_sharded(cfg, gs.spatial_velocity_mesh(4, 2, device="cpu"))
    with pytest.raises(ValueError, match="n_kx.*not divisible"):
        gs.run_nonlinear_gk_spatial_sharded_3d(tnl.NonlinearGKConfig(**{**BASE, "n_kx": 6}),
                                               gs.spatial_mesh_3d(4, 2, 1, device="cpu"))
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        gs.run_nonlinear_gk_sharded(tnl.NonlinearGKConfig(n_mu=6),
                                    gs.velocity_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        gs._run_gk_ensemble_sharded(tnl.NonlinearGKConfig(**BASE),
                                    gs.ensemble_mesh(2, 4, device="cpu"),
                                    torch.zeros((2, 8, 8, 8, 6, 8), dtype=torch.complex128),
                                    torch.zeros((3, 2, 8, 8, 8, 6, 8), dtype=torch.complex128))


@pytest.mark.parametrize("name", ["sy,v=2,4", "sx,sy,v=2,2,2"])
def test_each_shard_holds_an_eighth_of_the_state(base, name):
    tc, state, _, _ = base
    mesh = MESHES[name]()
    shard = gs.shard_state_spatial(state, mesh) if name.startswith("sy") \
        else gs.shard_state_spatial_3d(state, mesh)
    ev = gs.per_device_state_bytes(shard)
    assert ev["n_shards"] == 8 and ev["reduction_factor"] == 8.0
    assert ev["bytes_per_device"] * 8 == ev["monolithic_bytes"] == state.f.numel() * 16
    assert torch.equal(shard.f, state.f)
    assert gs.spatial_state_sharding_3d(mesh) == (None, "sx", "sy", None, None, "v")


def test_mesh_constructors_default_to_the_card():
    """Entry points take ``device="cuda"`` by default: without a card the
    constructors raise; with ``device="cpu"`` they give CPU shards."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        gs.spatial_mesh_3d(2, 2, 2)
    mesh = gs.ensemble_mesh(2, 4, device="cpu")
    assert mesh.shape == {"data": 2, "v": 4} and mesh.size == 8
