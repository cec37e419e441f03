"""Port parity: ``axis_sensitivity`` on the V-cycle branch.

On the CPU in float64 on the 33 x 33 model of ``tests/test_differentiable.py``
with ``use_vcycle`` (one plain V-cycle a Picard step, relaxation 0.5): every
leaf of d(axis flux)/d(theta) against ``jax.grad`` of the JAX package
(jitted: one compile of the forward and adjoint loops), within 1e-9
relative.  The coil gradient of ``mean(psi^2)`` is held in
``tests/test_torch_differentiable_vcycle_coil.py``.
"""

import jax
from test_torch_differentiable_sor import TOL, models, thetas
from torch_parity import rel

from scpn_fusion_tpu.models.equilibrium import differentiable as jd
from scpn_fusion_tpu_torch.models.equilibrium import differentiable as td

KW = dict(n_fwd=40, n_bwd=40)


def test_axis_sensitivity_matches_jax():
    ref_model, model = models(33, relax=0.5, use_vcycle=True)
    ref_theta, theta = thetas()
    ref = jax.jit(lambda th: jd.axis_sensitivity(ref_model, th, **KW))(ref_theta)
    ours = td.axis_sensitivity(model, theta, **KW)
    for name in ref._fields:
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
