"""Port parity: the host-side attribution lanes of
``models/equilibrium/reconstruction.py`` on the SPARC file.

On the CPU in float64 against the JAX package: ``attribution_prediction``,
``operator_residual``, ``flux_function_floor`` and
``flux_function_floor_field`` within 1e-9 relative; ``delta_star_np`` and
``metrics`` equal.
"""

import numpy as np
import pytest
from test_torch_reconstruction import cases
from test_torch_reconstruction_refit import TOL

from scpn_fusion_tpu.models.equilibrium import reconstruction as jrc
from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as trc


def test_attribution_lanes_match_jax():
    ref_case, case = cases()
    assert trc.attribution_prediction(case, device="cpu") == pytest.approx(
        jrc.attribution_prediction(ref_case), rel=TOL)
    for ours, ref in ((trc.operator_residual(case, device="cpu"),
                       jrc.operator_residual(ref_case)),
                      (trc.flux_function_floor_field(case, device="cpu"),
                       jrc.flux_function_floor_field(ref_case))):
        assert ours.keys() == ref.keys()
        for key in ref:
            assert ours[key] == pytest.approx(ref[key], rel=TOL), key
    assert trc.flux_function_floor(case) == jrc.flux_function_floor(ref_case)
    assert np.array_equal(trc.delta_star_np(case.psi, case.r, 0.1, 0.2),
                          jrc.delta_star_np(ref_case.psi, ref_case.r, 0.1, 0.2))
    assert trc.metrics(case, case.psi * 1.01) == jrc.metrics(ref_case, ref_case.psi * 1.01)
