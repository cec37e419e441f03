"""The Python side of the two one-launch kernels, on the CPU.

``csrc/vcycle_fused.cu`` keeps every level of a V-cycle in the shared memory
of one thread-block cluster, laid out by ``ops/cuda_mg.vcycle_launch_plan``
and handed over as ``vcycle_plan_struct``; ``csrc/source.cu`` takes the
solve's constants packed once by ``ops/cuda_source.pack_source_params``.
The kernels run only on a CUDA device (``chip_smoke.py`` holds them against
their plain and staged versions there); what is checked here is everything
they are given: the layout, the level constants, the packed parameters, and
that a solve packs them once.
"""

import math

import numpy as np
import pytest
import torch
from torch_parity import BENCH_SOLVER, config_dict, span_rel

from scpn_fusion_tpu_torch.core.config import config_from_dict
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium import fixed_boundary as tfb
from scpn_fusion_tpu_torch.models.equilibrium.profiles import (
    ProfileCoeffs,
    profile_coeffs_from_physics,
)
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_source
from scpn_fusion_tpu_torch.ops.cuda_stencil import level_scalars

SIZES = (5, 9, 17, 33, 65, 129, 257)


@pytest.mark.parametrize("min_grid", [3, 5, 9])
@pytest.mark.parametrize("n", SIZES)
def test_vcycle_launch_plan_layout(n, min_grid):
    """Levels as ``level_plan``; blocks in order without overlap, within one
    CTA's 227 KB; every row of every level held by exactly one CTA."""
    plan = cuda_mg.vcycle_launch_plan(n, min_grid)
    assert list(plan.levels) == cuda_mg.level_plan(n, min_grid)
    assert plan.n_cta == (8 if n >= 129 else 1)
    assert plan.smem_bytes <= 227 * 1024 == cuda_mg.SMEM_LIMIT
    end = 0
    for lv, m in enumerate(plan.levels):
        assert plan.offsets[lv] == end
        end += 2 * plan.rows[lv] * m + 2 * m
        banded = plan.scope[lv] == cuda_mg.SCOPE_CLUSTER
        assert banded == (m >= 129)
        if not banded:
            assert plan.scope[lv] == (cuda_mg.SCOPE_WARP if m <= 17 else cuda_mg.SCOPE_BLOCK)
            assert plan.band_shift[lv] == 31 and plan.rows[lv] == m
        held = np.zeros(m, dtype=int)
        for rank in range(plan.n_cta):
            lo, hi = plan.band(lv, rank)
            assert 0 <= lo <= hi <= m and hi - lo <= plan.rows[lv]
            held[lo:hi] += 1
            if banded:
                # the owner the kernel computes for a row: i >> shift, capped
                assert all(min(i >> plan.band_shift[lv], plan.n_cta - 1) == rank
                           for i in range(lo, hi))
        assert (held == 1).all()
    assert plan.smem_bytes == 4 * end
    # levels narrow from the cluster to one block to one warp, never back
    assert list(plan.scope) == sorted(plan.scope, reverse=True)


def test_vcycle_launch_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="up to 257"):
        cuda_mg.vcycle_launch_plan(513, 5)
    with pytest.raises(ValueError, match="min_grid >= 3"):
        cuda_mg.vcycle_launch_plan(257, 2)
    with pytest.raises(ValueError, match="2\\^k\\+1"):
        cuda_mg.vcycle_launch_plan(100, 5)


@pytest.mark.parametrize("n,min_grid,pre,post", [(257, 5, 1, 2), (129, 5, 3, 3), (17, 3, 1, 2)])
def test_vcycle_plan_struct_holds_the_staged_launchers_constants(n, min_grid, pre, post):
    """Per level the constants are ``level_scalars`` of the doubled spacings,
    rounded to float32 as a ``c_float`` argument rounds them."""
    d_r, d_z = 8.0 / (n - 1), 7.5 / (n - 1)
    st = cuda_mg.vcycle_plan_struct(n, min_grid, d_r, d_z, 1.0, pre, post, 50)
    plan = cuda_mg.vcycle_launch_plan(n, min_grid)
    assert (st.n_levels, st.n_cta, st.pre, st.post, st.coarse_sweeps, st.smem_bytes) == \
        (len(plan.levels), plan.n_cta, pre, post, 50, plan.smem_bytes)
    assert st.omega == 1.0
    for lv, m in enumerate(plan.levels):
        assert st.n[lv] == m and 2 << st.log_half[lv] == m - 1
        assert (st.band_shift[lv], st.scope[lv], st.rows[lv], st.off[lv]) == \
            (plan.band_shift[lv], plan.scope[lv], plan.rows[lv], plan.offsets[lv])
        want = level_scalars(d_r * 2.0**lv, d_z * 2.0**lv)
        got = (st.inv_dr2[lv], st.a_ns[lv], st.a_c[lv], st.inv_ac[lv])
        assert got == tuple(float(np.float32(v)) for v in want)
        assert st.dr[lv] == float(np.float32(d_r * 2.0**lv))
    assert cuda_mg.vcycle_plan_struct(n, min_grid, d_r, d_z, 1.0, pre, post, 50) is st


def _source_problem(n=33, seed=5):
    g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    blob = torch.exp(-(((g.RR - 6.0) / 2.0) ** 2 + (g.ZZ / 2.0) ** 2))
    psi = 3.0 * blob + 0.01 * torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32)
    mask = (g.ZZ < g.Z_min * 0.5).to(torch.float32).contiguous()
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=torch.float32).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=torch.float32).unbind())
    return g, psi, mask, vals, p_c, ff_c


@pytest.mark.parametrize("i_target", [12.5, torch.tensor(12.5, dtype=torch.float64)])
def test_pack_source_params_values(i_target):
    """The nine values the plain version uses, in the kernel's order, f32."""
    _, psi, _, vals, p_c, ff_c = _source_problem()
    params = cuda_source.pack_source_params(p_c, ff_c, i_target)
    assert params.packed.dtype == torch.float32 and params.packed.shape == (9,)
    assert params.packed.device == psi.device
    want = np.concatenate([vals.astype(np.float32), np.float32([12.5])])
    assert np.array_equal(params.packed.numpy(), want)
    assert params.p_coeffs is p_c and params.ff_coeffs is ff_c
    assert float(params.i_target) == 12.5
    # plain Python numbers pack as well, onto the tensor they are packed for
    floats = cuda_source.pack_source_params(ProfileCoeffs(*map(float, vals[:4])),
                                            ProfileCoeffs(*map(float, vals[4:])), 12.5,
                                            like=psi)
    assert torch.equal(floats.packed, params.packed)


@pytest.mark.parametrize("h_mode", [False, True])
def test_packed_and_unpacked_source_calls_agree(h_mode):
    g, psi, mask, _, p_c, ff_c = _source_problem()
    i_t = torch.tensor(12.5, dtype=torch.float32)
    kw = dict(d_r=g.dR, d_z=g.dZ, mu0=1.0, h_mode=h_mode, with_scalars=True)
    src_a, scal_a = cuda_source.fused_topology_source(psi, g.R, mask, p_c, ff_c, i_t, **kw)
    params = cuda_source.pack_source_params(p_c, ff_c, i_t, like=psi)
    src_b, scal_b = cuda_source.fused_topology_source(psi, g.R, mask, params, **kw)
    assert torch.equal(src_a, src_b)
    assert all(torch.equal(a, b) for a, b in zip(scal_a, scal_b))
    assert bool(torch.isfinite(src_a).all()) and float(src_a.abs().max()) > 0.0
    with pytest.raises(TypeError, match="take the place"):
        cuda_source.fused_topology_source(psi, g.R, mask, params, ff_c, i_t, **kw)


def test_solver_packs_the_source_parameters_once_a_solve(monkeypatch):
    """With the kernels selected, the Picard loop packs once before its first
    iteration and hands the same packed parameters to every source call."""
    cfg = config_from_dict(config_dict(33, **BENCH_SOLVER, use_pallas=True))
    grid = Grid.from_config(cfg, dtype=torch.float32, device="cpu")
    psi_bc = vacuum_psi_from_config(grid, cfg).to(torch.float32)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, torch.float32, torch.device("cpu"))
    packs, sources = [], []
    pack, source = cuda_source.pack_source_params, cuda_source.fused_topology_source

    def counting_pack(*args, **kw):
        packs.append(pack(*args, **kw))
        return packs[-1]

    def counting_source(psi, r_1d, mask, params, *rest, **kw):
        sources.append(params)
        return source(psi, r_1d, mask, params, *rest, **kw)

    monkeypatch.setattr(cuda_source, "pack_source_params", counting_pack)
    monkeypatch.setattr(cuda_source, "fused_topology_source", counting_source)

    def solve(use_pallas):
        return tfb.solve_fixed_boundary_impl(
            grid, psi_bc, psi_bc, torch.tensor(15.0), p_c, ff_c, 1e-4, math.inf, 1.0, 1.6,
            solver_method="anderson_mg", max_iter=200, h_mode=False, inner_sweeps=1,
            anderson_m=4, mu0=1.0, use_gs_criterion=False, use_pallas=use_pallas,
            mg_pre_smooth=1, mg_post_smooth=2)

    res = solve(True)
    assert res.converged and res.iterations >= 3
    assert len(packs) == 1
    assert len(sources) == res.iterations and all(p is packs[0] for p in sources)
    # the plain route packs nothing, and lands on the same equilibrium
    ref = solve(False)
    assert len(packs) == 1 and len(sources) == res.iterations
    assert ref.converged and abs(ref.iterations - res.iterations) <= 1
    assert span_rel(res.psi, ref.psi) <= 1e-3
