"""Port parity: multigrid transfers and the V-cycle on the plain ops.

``scpn_fusion_tpu_torch.ops.multigrid`` against ``scpn_fusion_tpu.ops
.multigrid`` (XLA path, ``use_pallas=False``) in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import fields, ring_equal, span_rel, to_torch

from scpn_fusion_tpu.ops import multigrid as jmg
from scpn_fusion_tpu_torch.ops import multigrid as tmg


def _problem(n, seed):
    r = np.asarray(jnp.linspace(2.0, 10.0, n, dtype=jnp.float64))
    dr = float(r[1] - r[0])
    psi, src = fields(seed, (n, n))
    return psi, src, r, dr


@pytest.mark.parametrize("n", [17, 65, 129])
def test_restrict_and_prolong_f64(n):
    fine, coarse = fields(n, (n, n))[0], fields(n + 1, ((n + 1) // 2, (n + 1) // 2))[0]
    assert span_rel(tmg.restrict_full_weight(to_torch(fine)),
                    jmg.restrict_full_weight(jnp.asarray(fine))) <= 1e-12
    assert span_rel(tmg.prolongate_bilinear(to_torch(coarse), n, n),
                    jmg.prolongate_bilinear(jnp.asarray(coarse), n, n)) <= 1e-12


def test_restrict_and_prolong_non_square_f64():
    fine = fields(5, (33, 20))[0]
    assert span_rel(tmg.restrict_full_weight(to_torch(fine)),
                    jmg.restrict_full_weight(jnp.asarray(fine))) <= 1e-12
    coarse = fields(6, (17, 10))[0]
    assert span_rel(tmg.prolongate_bilinear(to_torch(coarse), 33, 20),
                    jmg.prolongate_bilinear(jnp.asarray(coarse), 33, 20)) <= 1e-12


@pytest.mark.parametrize("pre,post", [(3, 3), (1, 2)])
@pytest.mark.parametrize("n", [17, 65, 129])
def test_vcycle_f64(n, pre, post):
    """vcycle == the JAX XLA vcycle (f64, <= 1e-12), ring preserved."""
    psi, src, r, dr = _problem(n, seed=n + pre)
    ref = jmg.vcycle(jnp.asarray(psi), jnp.asarray(src), jnp.asarray(r), dr, dr,
                     omega=1.0, pre_smooth=pre, post_smooth=post)
    ours = tmg.vcycle(to_torch(psi), to_torch(src), to_torch(r), dr, dr,
                      omega=1.0, pre_smooth=pre, post_smooth=post)
    assert span_rel(ours, ref) <= 1e-12
    assert ring_equal(ours, psi)


def test_mg_solve_f64():
    psi, src, r, dr = _problem(33, seed=2)
    ref = jmg.mg_solve(jnp.asarray(psi), jnp.asarray(src), jnp.asarray(r), dr, dr,
                       n_cycles=3, pre_smooth=1, post_smooth=2)
    ours = tmg.mg_solve(to_torch(psi), to_torch(src), to_torch(r), dr, dr,
                        n_cycles=3, pre_smooth=1, post_smooth=2)
    assert span_rel(ours, ref) <= 1e-12


def test_kernel_route_non_square_uses_plain_ladder():
    """A non-square grid with kernels on runs the plain transfer ladder with
    the SOR kernel's smoothing (its plain version here), as JAX runs XLA
    ops with the Pallas smoother there."""
    nz, nr = 33, 20
    r = np.asarray(jnp.linspace(2.0, 10.0, nr, dtype=jnp.float32))
    dr = float(r[1] - r[0])
    psi, src = fields(9, (nz, nr), dtype=np.float32)
    ours = tmg.vcycle(to_torch(psi, np.float32), to_torch(src, np.float32),
                      to_torch(r, np.float32), dr, dr, pre_smooth=1, post_smooth=2,
                      use_pallas=True)
    ref = jmg.vcycle(jnp.asarray(psi), jnp.asarray(src), jnp.asarray(r), dr, dr,
                     pre_smooth=1, post_smooth=2)
    assert span_rel(ours, ref) <= 1e-5
    assert ring_equal(ours, psi)


def test_tiled_sizes_have_no_kernel_route_yet():
    """1025^2 .. 4097^2 with kernels on raise NotImplementedError (ROADMAP
    Queue 2, kernels 6 and 7); without kernels they would take the ladder."""
    n = 1025
    psi = torch.zeros((n, n))
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tmg.vcycle(psi, psi, torch.linspace(2.0, 10.0, n), 0.01, 0.01, use_pallas=True)
