"""Port parity: the cold start and the Picard outer loop of ``reconstruct``
on the SPARC file.

On the CPU in float64 against the JAX package: ``init="external"`` (the
external-source-only start: 60 plain V-cycles from the ring-padded zero
field) with ``accel="picard"`` (omega 0.5), shell pinning at psi_N 0.95,
``tol_rel`` 0 and ``max_iter`` 5: the same five iterations, psi within 1e-9
span-relative and every metric within 1e-9 relative.
"""

from test_torch_reconstruction import assert_same_run, cases

from scpn_fusion_tpu.models.equilibrium import reconstruction as jrc
from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as trc


def test_cold_start_picard_matches_jax():
    ref_case, case = cases(model_psin_max=0.95)
    kw = dict(init="external", accel="picard", max_iter=5, tol_rel=0.0)
    assert_same_run(trc.reconstruct(case, device="cpu", **kw), jrc.reconstruct(ref_case, **kw),
                    iterations=5)
