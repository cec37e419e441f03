"""Port parity: the multigrid kernels' plain versions against Pallas.

``ops/cuda_mg.{fused_coarse_vcycle, fine_presmooth_restrict,
fine_prolong_smooth}`` on CPU tensors (their plain versions, compacted
levels) against ``scpn_fusion_tpu/ops/pallas_mg.py`` in interpret mode
(embedded levels) at the sizes of ``tests/test_pallas_mg.py``, and a composed
257^2 V-cycle against the JAX XLA ``_vcycle_impl``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import fields, ring_equal, span_rel, to_torch

from scpn_fusion_tpu.ops import multigrid as jmg
from scpn_fusion_tpu.ops import pallas_mg
from scpn_fusion_tpu_torch.ops import cuda_mg
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl


def _problem(n, seed):
    r = np.asarray(jnp.linspace(2.0, 10.0, n, dtype=jnp.float32))
    dr = float(r[1] - r[0])
    psi, src = fields(seed, (n, n), dtype=np.float32)
    return psi, src, r, dr


def _t(x):
    return to_torch(x, np.float32)


@pytest.mark.parametrize("n,pre,post", [(17, 3, 3), (65, 3, 3), (129, 3, 3), (65, 1, 2)])
def test_fused_coarse_vcycle_plain_matches_pallas(n, pre, post):
    psi, src, r, dr = _problem(n, seed=n + pre)
    ref = pallas_mg.fused_coarse_vcycle(jnp.asarray(psi), jnp.asarray(src), jnp.asarray(r),
                                        dr, dr, 1.0, pre_smooth=pre, post_smooth=post,
                                        interpret=True)
    ours = cuda_mg.fused_coarse_vcycle(_t(psi), _t(src), _t(r), dr, dr, 1.0,
                                       pre_smooth=pre, post_smooth=post)
    assert span_rel(ours, ref) <= 1e-6
    assert ring_equal(ours, psi)


def test_level_plan_and_shape_rule():
    assert cuda_mg.level_plan(129, 5) == pallas_mg._level_plan(129, 5)
    assert cuda_mg.level_plan(5, 5) == [5]
    psi = torch.zeros((64, 64))
    with pytest.raises(ValueError, match="2\\^k\\+1"):
        cuda_mg.fused_coarse_vcycle(psi, psi, torch.linspace(2, 10, 64), 0.1, 0.1, 1.0)


@pytest.mark.parametrize("n,pre", [(65, 3), (129, 1)])
def test_fine_presmooth_restrict_plain_matches_pallas(n, pre):
    psi, src, r, dr = _problem(n, seed=7)
    ref_p, ref_d = pallas_mg.fine_presmooth_restrict(
        jnp.asarray(psi), jnp.asarray(src), jnp.asarray(r), dr, dr, 1.0, pre_smooth=pre,
        interpret=True)
    ours_p, ours_d = cuda_mg.fine_presmooth_restrict(_t(psi), _t(src), _t(r), dr, dr, 1.0,
                                                     pre_smooth=pre)
    assert span_rel(ours_p, ref_p) <= 1e-6
    assert span_rel(ours_d, ref_d) <= 1e-6
    assert ring_equal(ours_p, psi)
    assert ring_equal(ours_d, np.zeros(ours_d.shape, np.float32))


# post = 0 checks the prolongation alone: with omega = 1 the first red
# half-sweep overwrites every red point (even-even and odd-odd), which would
# hide an error in those phases of the correction.
@pytest.mark.parametrize("n,post", [(65, 3), (129, 2), (65, 0)])
def test_fine_prolong_smooth_plain_matches_pallas(n, post):
    psi, src, r, dr = _problem(n, seed=11)
    nc = (n + 1) // 2
    e = np.random.default_rng(13).standard_normal((nc, nc)).astype(np.float32)
    e[0, :] = e[-1, :] = e[:, 0] = e[:, -1] = 0.0
    ref = pallas_mg.fine_prolong_smooth(jnp.asarray(psi), jnp.asarray(src), jnp.asarray(e),
                                        jnp.asarray(r), dr, dr, 1.0, post_smooth=post,
                                        interpret=True)
    ours = cuda_mg.fine_prolong_smooth(_t(psi), _t(src), _t(e), _t(r), dr, dr, 1.0,
                                       post_smooth=post)
    assert span_rel(ours, ref) <= 1e-6
    assert ring_equal(ours, psi)


def test_composed_257_vcycle_matches_xla():
    """Fine legs at 257^2 + the coarse V-cycle below == XLA _vcycle_impl."""
    n = 257
    psi, src, r, dr = _problem(n, seed=17)
    ref = jmg.vcycle(jnp.asarray(psi), jnp.asarray(src), jnp.asarray(r), dr, dr,
                     omega=1.0, pre_smooth=1, post_smooth=2)
    psi_s, d_c = cuda_mg.fine_presmooth_restrict(_t(psi), _t(src), _t(r), dr, dr, 1.0,
                                                 pre_smooth=1)
    e_c = cuda_mg.fused_coarse_vcycle(torch.zeros_like(d_c), d_c, _t(r)[::2], dr * 2, dr * 2,
                                      1.0, pre_smooth=1, post_smooth=2)
    ours = cuda_mg.fine_prolong_smooth(psi_s, _t(src), e_c, _t(r), dr, dr, 1.0, post_smooth=2)
    assert span_rel(ours, ref) <= 1e-5
    assert ring_equal(ours, psi)
    # the kernel route of _vcycle_impl at 257^2 is the fused coarse cycle
    whole = _vcycle_impl(_t(psi), _t(src), _t(r), dr, dr, 1.0, 1, 2, 5, 50, True)
    assert span_rel(whole, ref) <= 1e-5
