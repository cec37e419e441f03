"""Port parity: the soft (differentiable) axis and X-point fluxes of
``models/equilibrium/topology.py``.

On the CPU in float64 against the JAX package on numpy-seeded fields: the
values and their gradients (autograd against ``jax.grad``) within 1e-12
relative, and the port's ``hypot`` equal to ``jnp.hypot`` with a zero (not
NaN) gradient where both legs vanish.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel, rng

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium import topology as jt
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.equilibrium import topology as tt

TOL = 1e-12


def _field(seed, n):
    """A smooth peaked field with noise, on a 2..10 x -4..4 grid."""
    jg = JGrid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=np.float64)
    rr, zz = np.asarray(jg.RR), np.asarray(jg.ZZ)
    psi = np.exp(-((rr - 6.0) ** 2 + zz ** 2) / 3.0) + 0.01 * rng(seed).standard_normal(rr.shape)
    tg = TGrid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float64, device="cpu")
    return jg, tg, psi


@pytest.mark.parametrize("seed,n", [(0, 17), (1, 33), (2, 65)])
@pytest.mark.parametrize("temperature", [50.0, 5.0])
def test_soft_fluxes_and_gradients_match_jax(seed, n, temperature):
    jg, tg, psi = _field(seed, n)

    def j_x(p):
        return jt.soft_x_point_flux(p, jg.ZZ, jg.dR, jg.dZ, jg.Z_min, temperature)

    def t_x(p):
        return tt.soft_x_point_flux(p, tg.ZZ, tg.dR, tg.dZ, tg.Z_min, temperature)

    for j_fn, t_fn in ((lambda p: jt.soft_axis_flux(p, temperature),
                        lambda p: tt.soft_axis_flux(p, temperature)), (j_x, t_x)):
        ref_v, ref_g = jax.value_and_grad(j_fn)(jnp.asarray(psi))
        p = torch.tensor(psi, requires_grad=True)
        ours = t_fn(p)
        (grad,) = torch.autograd.grad(ours, p)
        assert rel(ours, ref_v) <= TOL
        assert rel(grad, ref_g) <= TOL


def test_hypot_matches_jax_with_a_finite_gradient_at_zero():
    a = np.array([0.0, 3.0, -4.0, 1e-300, 0.0, np.inf])
    b = np.array([0.0, 4.0, 3.0, 0.0, -2.0, 1.0])
    ours = tt.hypot(torch.tensor(a), torch.tensor(b))
    assert np.array_equal(as_np(ours), np.asarray(jnp.hypot(a, b)))
    x = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tt.hypot(x, torch.zeros(3, dtype=torch.float64)).sum(), x)
    assert torch.equal(g, torch.zeros(3, dtype=torch.float64))
