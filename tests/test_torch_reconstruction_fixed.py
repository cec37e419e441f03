"""Port parity: ``reconstruct`` at a fixed iteration count on the SPARC file.

On the CPU in float64 against the JAX package: the validation's settings
(``run_real_shot_accuracy.py``: Anderson(8), 4 x 4 sub-cell source
averaging) with ``tol_rel`` 0 and ``max_iter`` 6, so both run exactly six
iterations: psi within 1e-9 span-relative and every metric within 1e-9
relative.
"""

from test_torch_reconstruction import assert_same_run, cases

from scpn_fusion_tpu.models.equilibrium import reconstruction as jrc
from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as trc


def test_fixed_count_subcell_reconstruction_matches_jax():
    ref_case, case = cases()
    kw = dict(subcell=4, anderson_m=8, max_iter=6, tol_rel=0.0)
    assert_same_run(trc.reconstruct(case, device="cpu", **kw), jrc.reconstruct(ref_case, **kw),
                    iterations=6)
