"""The float64 and mixed lanes of the port's ``free_boundary_forward`` held
to JAX's ``solve_free_boundary`` at 65^2 with the lanes' settings (see
``tests/test_torch_campaigns_fb.py``): outer and inner iteration counts
equal, psi within 1e-9 of its span."""

import pytest
import torch

from scpn_fusion_tpu_torch.validation import run_free_boundary_forward as fbf
from tests.test_torch_campaigns_fb import check_forward_against_jax


@pytest.mark.parametrize("mixed", [0, 2], ids=["f64-lane", "mixed-lane"])
def test_forward_against_jax(mixed):
    check_forward_against_jax(fbf.F64_129[1], mixed)


def test_chain_scales_the_currents():
    """chain(k): element i at the machine's currents x (1 + 0.003 i)."""
    fwd = fbf.Forward(33, "cpu", torch.float64, 16, 1e-4)
    sums, iters, conv = fwd.chain(2)
    one = fwd.solve(fwd.coils0.currents * (1.0 + 0.003))
    assert all(conv) and iters[1] == one.outer_iterations
    assert sums[1] == float(one.psi.sum())
