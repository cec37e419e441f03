"""Port parity: the real-shot reconstruction (``models/equilibrium/
reconstruction.py``) on the public SPARC L-mode equilibrium in
``fuzz/seeds/geqdsk`` (129 x 129).

On the CPU in float64 against the JAX package: ``prepare_case`` field for
field (the same COCOS flip, source convention, X-point flag and plasma
mask; arrays equal to 1e-15 relative); and one converged ``reconstruct``
(Anderson(8), subcell 1, ``tol_rel`` 1e-9): the same iteration count, psi
within 1e-9 span-relative, every metric within 1e-9 relative.  The
fixed-count runs (tol 0) are held in ``tests/test_torch_reconstruction_*.py``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
from torch_parity import span_rel

from scpn_fusion_tpu.io.geqdsk import read_geqdsk as j_read
from scpn_fusion_tpu.models.equilibrium import reconstruction as jrc
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.io.geqdsk import read_geqdsk as t_read
from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as trc

SPARC = Path(__file__).resolve().parent.parent / "fuzz" / "seeds" / "geqdsk" / "sparc_lmode_hv.geqdsk"
METRICS = ("deep_rms_rel_span", "deep_max_rel_span", "plasma_rms_rel_span", "axis_value_rel_err",
           "global_max_rel_span", "full_domain_rms_rel_span", "nrmse_range")


def cases(**kw):
    """(JAX case, port case) of the SPARC file."""
    return jrc.prepare_case(j_read(SPARC), **kw), trc.prepare_case(t_read(SPARC), **kw)


def assert_same_run(ours, ref, iterations=None):
    assert ours["iterations"] == ref["iterations"]
    if iterations is not None:
        assert ours["iterations"] == iterations
    assert span_rel(ours["psi_fit"], ref["psi_fit"]) <= 1e-9
    for key in METRICS:
        assert ours[key] == pytest.approx(ref[key], rel=1e-9), key


@pytest.mark.parametrize("model_psin_max", [1.0, 0.95])
def test_prepare_case_matches_jax(model_psin_max):
    ref, ours = cases(model_psin_max=model_psin_max)
    assert ref.flipped and not ref.has_x_point       # what this file exercises
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            if b.dtype == bool:
                assert np.array_equal(a, b), f.name
            else:
                scale = max(float(np.max(np.abs(b))), 1e-300)
                assert float(np.max(np.abs(a - b))) <= 1e-15 * scale, f.name
        elif isinstance(b, float) and np.isfinite(b):
            assert a == pytest.approx(b, rel=1e-15), f.name
        else:
            assert a == b, f.name
    assert interop.recon_case(dataclasses.asdict(ref)).source_convention == ref.source_convention


def test_converged_reconstruction_matches_jax():
    ref_case, case = cases()
    ref = jrc.reconstruct(ref_case, subcell=1, max_iter=200)
    ours = trc.reconstruct(case, subcell=1, max_iter=200, device="cpu")
    assert_same_run(ours, ref, iterations=26)
    assert ours["final_step"] < 1e-9 * case.span
