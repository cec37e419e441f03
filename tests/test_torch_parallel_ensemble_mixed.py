"""``parallel/ensemble.solve_equilibrium_batch_mixed``, the batch over a
4-shard mesh, and the batched kernel wrappers' CPU twins.

The mixed batch (f64 master iterate, f32 defect-correction V-cycle) holds
the JAX test's bars: element 0 within 1e-5 of the batch of one, and of the
full-f64 batch.  On the CPU the batched wrappers of kernels 2 and 3 run their plain twins:
element b equals the unbatched wrapper on element b.
"""

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import _anderson_mix
from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_source
from scpn_fusion_tpu_torch.parallel.ensemble import (
    solve_equilibrium_batch,
    solve_equilibrium_batch_mixed,
)
from tests.test_torch_parallel_ensemble import F64, case, span_dev
from tests.torch_parity import as_np


def test_batch_mixed_matches_single_and_full_f64():
    _, cfg, grid, base = case("anderson_mg", max_iter=300, anderson_depth=4, inner_sweeps=1)
    batch = torch.stack([base, 1.1 * base, 0.9 * base])
    i_t = torch.tensor([15.0, 15.0, 12.0], dtype=F64)
    out = solve_equilibrium_batch_mixed(cfg, grid, batch, i_t)
    assert bool(out.converged.all())
    assert out.gs_residual_best.shape == (3,) and bool(torch.isfinite(out.gs_residual_best).all())
    one = solve_equilibrium_batch_mixed(cfg, grid, batch[:1], i_t[:1])
    assert bool(one.converged[0])
    assert span_dev(out.psi[0], one.psi[0]) < 1e-5
    full = solve_equilibrium_batch(cfg, grid, batch, i_t)
    assert bool(full.converged.all())
    assert span_dev(out.psi[0], full.psi[0]) < 1e-5


def test_batched_anderson_mix_is_the_single_mix():
    rng = np.random.default_rng(7)
    psi_buf = torch.from_numpy(rng.standard_normal((3, 4, 9, 9)))
    f_buf = torch.from_numpy(rng.standard_normal((3, 4, 9, 9)))
    for n_valid in (3, 4):
        for f32 in (False, True):
            out = _anderson_mix(psi_buf, f_buf, n_valid, f32)
            for b in range(3):
                ref = _anderson_mix(psi_buf[b], f_buf[b], n_valid, f32)
                np.testing.assert_allclose(as_np(out[b]), as_np(ref), rtol=0, atol=1e-12)


def test_batched_source_twin_is_the_unbatched_source():
    g = Grid.from_bounds(33, 33, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(11)
    psi = torch.from_numpy(rng.standard_normal((4, 33, 33)).astype(np.float32))
    mask = (g.ZZ < g.Z_min * 0.5).to(torch.float32).contiguous()
    vals = torch.from_numpy((0.3 + rng.random(8)).astype(np.float32))
    p_c, ff_c = ProfileCoeffs(*vals[:4].unbind()), ProfileCoeffs(*vals[4:].unbind())
    i_t = torch.tensor([15.0, 2.0, 9.0, 15.0])
    params = cuda_source.pack_source_params_batched(p_c, ff_c, i_t, like=psi)
    assert params.packed.shape == (4, 9)
    np.testing.assert_array_equal(as_np(params.packed[:, 8]), as_np(i_t))
    for h_mode in (False, True):
        out, sc = cuda_source.fused_topology_source_batched(
            psi, g.R, mask, params, d_r=g.dR, d_z=g.dZ, mu0=1.0, h_mode=h_mode,
            with_scalars=True)
        for b in range(4):
            ref, ref_sc = cuda_source.fused_topology_source(
                psi[b], g.R, mask, p_c, ff_c, i_t[b], d_r=g.dR, d_z=g.dZ, mu0=1.0,
                h_mode=h_mode, with_scalars=True)
            assert torch.equal(out[b], ref)
            assert int(sc.x_index[b]) == int(ref_sc.x_index)


def test_batched_vcycle_twin_is_the_unbatched_vcycle():
    g = Grid.from_bounds(33, 33, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(12)
    psi = torch.from_numpy(rng.standard_normal((3, 33, 33)).astype(np.float32))
    src = torch.from_numpy(rng.standard_normal((3, 33, 33)).astype(np.float32))
    out = cuda_mg.fused_coarse_vcycle_batched(psi, src, g.R, g.dR, g.dZ, 1.0, pre_smooth=1,
                                              post_smooth=2)
    for b in range(3):
        ref = cuda_mg.fused_coarse_vcycle(psi[b], src[b], g.R, g.dR, g.dZ, 1.0, pre_smooth=1,
                                          post_smooth=2)
        assert torch.equal(out[b], ref)


def test_batched_entries_are_bound():
    """The C signatures the wrappers call through (the library itself is
    built on the card)."""
    sig = cb._SIGNATURES
    assert len(sig["scpn_fused_source_batched"]) == 19
    assert len(sig["scpn_fused_vcycle_batched"]) == 8
    assert sig["scpn_fused_source_batched"][4:8] == [cb._I] * 4
