"""Port parity: the free-boundary solve with the wall response and with the
mixed-precision inner solve (``models/equilibrium/free_boundary``).

Kept apart from ``tests/test_torch_free_boundary.py`` (whose helpers it uses)
so each file stays short.  On the CPU against the JAX package: at 33^2 under
the free-boundary forward's solver, ``use_wall_response`` in float64 (the
same outer and inner counts, psi within 1e-9 span-relative, currents within
1e-8) and ``mixed_n_refine=2`` (float64 master iterate, float32 V-cycles with
the float32 Anderson Gram: the same counts and psi within 1e-6 span-relative,
the bar ``tests/test_torch_mixed_precision.py`` holds a mixed solve to), and
the float32 request of the mixed solve raising ``ValueError``.
"""

import pytest
import torch
from test_torch_free_boundary import assert_parity, solve_both
from torch_parity import free_boundary_cfgs

from scpn_fusion_tpu_torch.models.equilibrium import free_boundary as tfb


def test_wall_response_matches_jax():
    """The plasma's wall flux in the ring: at 33^2 the outer loop settles into
    a two-cycle (max |dpsi| 3.16 on every step) on both sides, so the run ends
    at ``max_outer_iter`` unconverged, at the same phase."""
    _, ref, ours = solve_both(33, "wall_response", max_outer_iter=16, tol=1e-4,
                              use_wall_response=True)
    assert_parity(ref, ours)
    assert bool(torch.isfinite(ours.psi).all())


def test_mixed_matches_jax():
    _, ref, ours = solve_both(33, "mixed", max_outer_iter=16, tol=1e-4,
                              anderson_gram_f32=True, mixed_n_refine=2)
    assert bool(ref.converged)
    assert_parity(ref, ours, psi_tol=1e-6)


def test_mixed_needs_float64():
    _, cfg = free_boundary_cfgs(17)
    with pytest.raises(ValueError, match="float64"):
        tfb.solve_free_boundary(cfg, mixed_n_refine=1, dtype=torch.float32, device="cpu")
