"""Port parity: ``refit_profiles`` of ``models/equilibrium/reconstruction.py``
on the SPARC file.

On the CPU in float64 against the JAX package, at three outer iterations of
four V-cycles (the eight basis responses solved in one ``vmap`` of
``mg_solve`` in both): every returned number and array within 1e-9 relative.
The attribution lanes are held in
``tests/test_torch_reconstruction_attribution.py``.
"""

import numpy as np
from test_torch_reconstruction import cases

from scpn_fusion_tpu.models.equilibrium import reconstruction as jrc
from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as trc

TOL = 1e-9


def close(a, b) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) <= TOL * max(float(np.max(np.abs(b))), 1e-300)


def test_refit_profiles_matches_jax():
    ref_case, case = cases()
    kw = dict(n_outer=3, n_cycles=4)
    ref = jrc.refit_profiles(ref_case, **kw)
    ours = trc.refit_profiles(case, device="cpu", **kw)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert close(ours[key], value), key
    assert ours["outer_iterations"] == 3

