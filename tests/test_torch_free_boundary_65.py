"""Port parity: the free-boundary solve at 65^2 with fixed currents.

Kept apart from ``tests/test_torch_free_boundary.py`` (whose helpers it uses)
so each file stays short.  On the CPU in float64 against the JAX package,
under the free-boundary forward's solver: at 65^2 the inner V-cycle is one
level deeper than at 33^2 and each inner solve takes more iterations.  The
same outer and last inner iteration counts as JAX, psi within 1e-9
span-relative and the coil currents within 1e-8 relative.
"""

from test_torch_free_boundary import assert_parity, solve_both


def test_fixed_currents_65_match_jax():
    _, ref, ours = solve_both(65, "fixed_currents", max_outer_iter=16, tol=1e-4)
    assert bool(ref.converged)
    assert_parity(ref, ours)
