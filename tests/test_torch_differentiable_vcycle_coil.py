"""Port parity: the coil gradient of ``mean(psi^2) * 1e12`` (the loss of
``validation/run_adjoint_fd.py``) on the V-cycle branch.

On the CPU in float64 on the 33 x 33 model of ``tests/test_differentiable.py``
with ``use_vcycle`` (relaxation 0.5): the IFT gradient against ``jax.grad``
of the JAX package, within 1e-9 relative.
"""

from test_torch_differentiable_sor import TOL, coil_gradients, models
from test_torch_differentiable_vcycle import KW
from torch_parity import rel


def test_coil_gradient_matches_jax():
    ref_model, model = models(33, relax=0.5, use_vcycle=True)
    assert rel(*coil_gradients(ref_model, model, KW)) <= TOL
