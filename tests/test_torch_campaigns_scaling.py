"""The port's ``resolution_scaling`` campaign on the CPU.

The committed ``validation/reports/resolution_scaling.json`` was made on the
TPU; off it the JAX script reports its five lanes blocked under their
off-TPU names, and so does the port off a CUDA device.  The lanes'
cascades run through the port's ``solve_equilibrium_fmg`` and
``solve_equilibrium_mixed_fmg``; their arithmetic is held to the JAX
package's same entry points at 257^2 (the card runs 513^2-4097^2) with the
script's arguments.  The float32 cascade runs in float64 on both sides:
per-level iteration counts equal and psi within 1e-9 of its span.  The
mixed cascade keeps its float32 levels and its float32 V-cycle defect
correction on both sides, whose XLA and torch roundings differ: there the
counts are equal and psi is held within ``MIXED_TOL`` of its span (the
float64 GS-residual criterion, 3e-5, bounds how far two converged iterates
may lie apart; measured 2.8e-8).  ``test_torch_campaigns_scaling_script.py``
holds the entry point to the script's own hand-written cascade.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu_torch.validation import run_resolution_scaling as rs
from scpn_fusion_tpu_torch.validation._lanes import NO_CARD

MIXED_TOL = 1e-7


def test_cpu_run_blocks_every_lane(tmp_path):
    assert rs.main(device="cpu", out_dir=tmp_path) == 0
    report = json.loads((tmp_path / "resolution_scaling.json").read_text())
    assert report["overall_status"] == "blocked"
    assert [(lane["name"], lane["status"], lane["notes"]) for lane in report["lanes"]] == [
        (name, "blocked", NO_CARD) for name in ("anchor_513", "capability_1025",
                                                "capability_2049", "capability_4097",
                                                "on_scaling")]


def jax_cascade(n_fine, mixed):
    """The JAX package's entry point that the port's lane calls, at
    ``n_fine`` with the script's configuration: ``solve_equilibrium_fmg`` in
    float64, or ``solve_equilibrium_mixed_fmg`` (the script's GS gate)."""
    from scpn_fusion_tpu.core.config import config_from_dict
    from scpn_fusion_tpu.models.equilibrium.fixed_boundary import solve_equilibrium_fmg
    from scpn_fusion_tpu.models.equilibrium.mixed_precision import solve_equilibrium_mixed_fmg
    from scpn_fusion_tpu_torch.bench_config import BENCH_SOLVER, config_dict

    cfg = config_from_dict(config_dict(n_fine, **BENCH_SOLVER,
                                       gs_residual_threshold=rs.GS_THRESHOLD if mixed else 0.0))
    if mixed:
        res, info = solve_equilibrium_mixed_fmg(cfg, coarse_tol=rs.COARSE_TOL, min_coarse=129,
                                                i_target=15.0, n_refine=2)
    else:
        res, info = solve_equilibrium_fmg(cfg, coarse_tol=rs.COARSE_TOL, min_coarse=129,
                                          i_target=15.0, dtype=jnp.float64)
    return res, [(d["n"], int(d["iterations"]), bool(d["converged"])) for d in info]


@pytest.mark.parametrize("mixed", [False, True], ids=["f32-cascade", "mixed-cascade"])
def test_cascade_against_jax(mixed):
    ref, ref_info = jax_cascade(257, mixed)
    ours, info = rs.Cascade(257, "cpu", mixed=mixed, dtype=torch.float64).solve()
    assert [(d["n"], d["iterations"], d["converged"]) for d in info] == ref_info
    p = np.asarray(ref.psi)
    dev = float(np.max(np.abs(ours.psi.numpy() - p))) / float(p.max() - p.min())
    assert dev <= (MIXED_TOL if mixed else 1e-9)
    if mixed:
        assert float(ours.gs_residual_best) < rs.GS_THRESHOLD
