"""Port parity: the predictive forward's IFT gradients, SOR branch.

On the CPU in float64 on ``tests/test_differentiable.py``'s 33 x 33 model
(four coils, eight SOR sweeps at omega 1.5 a Picard step, relaxation 0.2):
``solve_predictive_diff``, ``axis_sensitivity`` (every leaf of theta) and
the coil gradient of ``mean(psi^2) * 1e12`` against the JAX package and
``jax.grad`` (jitted for the coil gradient), within 1e-9 relative; and ``optimize_coil_currents_diff``
(two steps on a 17 x 17 model) against the JAX call, within 1e-9 relative.
The V-cycle branch is held in ``tests/test_torch_differentiable_vcycle*.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import rel

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium import differentiable as jd
from scpn_fusion_tpu.models.equilibrium.topology import soft_axis_flux
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import differentiable as td

TOL = 1e-9
COIL_R, COIL_Z = (3.6, 9.4, 9.4, 3.6), (3.8, 2.2, -2.2, -3.8)
THETA = dict(coil_currents=[2e6, 4e6, 4e6, 2e6], p_coeffs=[1.0, 0.1, 0.1, 1.5], ip_target=1.5e7)


def models(n, **kw):
    """(JAX model, port model): the port's carries the JAX coil table."""
    grid = JGrid(NR=n, NZ=n, R_min=4.0, R_max=9.0, Z_min=-4.0, Z_max=4.0,
                 dtype=np.dtype("float64"))
    ref = jd.build_predictive_model(grid, COIL_R, COIL_Z, **kw)
    fields = {**ref._asdict(), "grid": dataclasses.asdict(grid)}
    return ref, interop.predictive_model(fields, dtype=torch.float64, device="cpu")


def thetas():
    ref = jd.PredictiveTheta(**{k: jnp.asarray(v) for k, v in THETA.items()})
    return ref, interop.predictive_theta(THETA, dtype=torch.float64, device="cpu")


def coil_gradients(ref_model, model, kw):
    ref_theta, theta = thetas()

    def ref_loss(c):
        psi = jd.solve_predictive_diff(ref_model, ref_theta._replace(coil_currents=c), **kw)
        return jnp.mean(psi * psi) * 1e12

    c = theta.coil_currents.clone().requires_grad_(True)
    psi = td.solve_predictive_diff(model, theta._replace(coil_currents=c), **kw)
    (ours,) = torch.autograd.grad((psi * psi).mean() * 1e12, c)
    return ours, jax.jit(jax.grad(ref_loss))(ref_theta.coil_currents)


def test_forward_and_gradients_match_jax():
    ref_model, model = models(33)
    ref_theta, theta = thetas()
    kw = dict(n_fwd=60, n_bwd=60)
    assert rel(td.solve_predictive_diff(model, theta, **kw),
               jd.solve_predictive_diff(ref_model, ref_theta, **kw)) <= 1e-12
    ours = td.axis_sensitivity(model, theta, **kw)
    ref = jd.axis_sensitivity(ref_model, ref_theta, **kw)
    for name in ref._fields:
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    assert rel(*coil_gradients(ref_model, model, kw)) <= TOL


def test_optimize_coil_currents_matches_jax():
    ref_model, model = models(17)
    ref_theta, theta = thetas()
    kw = dict(n_fwd=30, n_bwd=30)
    target = 1.1 * float(soft_axis_flux(jd.solve_predictive_diff(ref_model, ref_theta, **kw)))
    ref = jd.optimize_coil_currents_diff(ref_model, ref_theta, jnp.asarray(target), lr=5e4,
                                         n_steps=2, **kw)
    ours = td.optimize_coil_currents_diff(model, theta, torch.tensor(target, dtype=torch.float64),
                                          lr=5e4, n_steps=2, **kw)
    assert rel(ours.coil_currents, ref.coil_currents) <= TOL
    assert rel(ours.coil_currents, theta.coil_currents) > 1e-4   # the trim moved them
