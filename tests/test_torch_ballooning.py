"""Port parity: the ballooning solver (``models/physics/ballooning.py``) and
row B's plain twin (``ops/cuda_ballooning.newcomb_min_xi_plain``).

In float64 on the CPU, min xi of every field line -- circular s-alpha and
Miller-shaped, at 400-800 RK4 steps and one map at the default 4000 -- is
within 1e-9 (of the largest |min xi|) of JAX's vmapped ``_integrate_newcomb``,
and the stability maps are equal (a point may differ only where |min xi| <=
1e-9, and the test names it); the Miller coefficient tables, the
second-stability scan's band edges and helpers, ``marginal_alpha``,
``miller_marginal_alpha`` and the bootstrap path agree with JAX.  The plain
twin equals, bit for bit, the straightforward loop of the module's
right-hand sides (coefficients computed at every call); theta is folded at
the half-way points +-pi, 3 pi as ``jnp.round`` folds it (half to even); a
diverging line's min is NaN (unstable), as ``jnp.minimum`` gives it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.models.physics import ballooning as jb
from scpn_fusion_tpu_torch.models.physics import ballooning as tb
from scpn_fusion_tpu_torch.ops import cuda_ballooning as cb

TOL = 1e-9
F64 = torch.float64
DIIID = dict(r0=1.67, a=0.67, rho=0.95, kappa=1.74, delta=0.3, q=5.7)
THETA_MAX = 20.0 * math.pi


def _jax_min_xi(op, s, alpha, n_steps, tables=None):
    s, alpha = jnp.asarray(s), jnp.asarray(alpha)
    if op == "circular":
        fn = lambda sv, av: jb._ballooning_min_xi(sv, av, THETA_MAX, n_steps)  # noqa: E731
    else:
        fn = lambda sv, av: jb._miller_min_xi(sv, av, *tables, THETA_MAX, n_steps)  # noqa: E731
    return np.asarray(jax.vmap(fn)(s, alpha))


def _assert_maps_agree(ours, ref, label):
    """min xi within TOL of the scale; equal signs except where |min xi| <= TOL."""
    assert rel(ours, ref) <= TOL, (label, rel(ours, ref))
    ours, ref = as_np(ours), np.asarray(ref)
    differ = (ours > 0.0) != (ref > 0.0)
    near = np.abs(ref) <= TOL * np.max(np.abs(ref))
    assert not (differ & ~near).any(), (label, np.nonzero(differ & ~near))
    assert not differ.any(), (label, "differs only near zero at", np.nonzero(differ))


def _lines(s, alphas):
    s_b, a_b = np.broadcast_arrays(np.asarray(s, float)[:, None], np.asarray(alphas, float)[None])
    return s_b.ravel().copy(), a_b.ravel().copy()


def test_circular_min_xi_matches_jax():
    s, a = _lines([0.1, 0.5, 1.0, 2.0, 3.0], np.linspace(0.0, 6.0, 13))
    ours = tb._ballooning_min_xi(torch.tensor(s), torch.tensor(a), THETA_MAX, 600)
    _assert_maps_agree(ours, _jax_min_xi("circular", s, a, 600), "circular 600 steps")


def test_circular_default_steps_matches_jax():
    """One map at the default 4000 steps: the traversal points of
    ``tests/test_ballooning.py:26-32`` and two more shears."""
    s, a = _lines([0.5, 1.5], [0.1, 0.8, 3.5])
    ours = tb._ballooning_min_xi(torch.tensor(s), torch.tensor(a))
    _assert_maps_agree(ours, _jax_min_xi("circular", s, a, 4000), "circular 4000 steps")
    st = tb.ballooning_stable(0.5, torch.tensor([0.1, 0.8, 3.5], dtype=F64))
    assert st.tolist() == np.asarray(jb.ballooning_stable(0.5, jnp.asarray([0.1, 0.8, 3.5]))
                                     ).tolist() == [True, False, True]


@pytest.mark.parametrize("geometry", [DIIID, dict(r0=3.0, a=1.0, rho=0.9, kappa=1.8,
                                                  delta=-0.4, q=3.0)])
def test_miller_tables_and_min_xi_match_jax(geometry):
    tabs_j = jb._miller_coefficients(**geometry, n_theta=256)
    theta_t, coef_t = tb._miller_coefficients(**geometry, n_theta=256, dtype=F64, device="cpu")
    assert rel(theta_t, tabs_j[0]) <= 1e-15
    for k in range(6):
        assert rel(coef_t[:, k], tabs_j[k + 1]) <= 1e-13, k
    alphas = np.linspace(0.0, 8.0, 17)
    s, a = _lines([0.5, 1.0, 2.04], alphas)
    ours = tb._miller_min_xi(torch.tensor(s), torch.tensor(a), (theta_t, coef_t), THETA_MAX, 500)
    _assert_maps_agree(ours, _jax_min_xi("miller", s, a, 500, tabs_j), "miller 500 steps")


def _rhs_loop(op, s, alpha, tables, n_steps):
    """The straightforward loop: each right-hand side computes its own
    coefficients from theta, as the JAX ``rhs(theta, y)`` closures do."""
    coefficients, rhs = tb.OPERATORS[op]
    h = THETA_MAX / n_steps
    thetas = tb.step_thetas(THETA_MAX, n_steps, s.dtype, s.device)

    def f(theta, u1, u2):
        return rhs(coefficients(tables, theta), s, alpha, u1, u2)

    u1, u2 = torch.ones_like(s), torch.zeros_like(s)
    m = torch.ones((), dtype=s.dtype)
    for i in range(n_steps):
        t0, t1, t2 = thetas[i]
        k1 = f(t0, u1, u2)
        k2 = f(t1, u1 + 0.5 * h * k1[0], u2 + 0.5 * h * k1[1])
        k3 = f(t1, u1 + 0.5 * h * k2[0], u2 + 0.5 * h * k2[1])
        k4 = f(t2, u1 + h * k3[0], u2 + h * k3[1])
        u1 = u1 + (h / 6.0) * (k1[0] + 2.0 * k2[0] + 2.0 * k3[0] + k4[0])
        u2 = u2 + (h / 6.0) * (k1[1] + 2.0 * k2[1] + 2.0 * k3[1] + k4[1])
        m = torch.minimum(m, u1)
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["circular", "miller"])
def test_plain_twin_equals_module_rhs_loop(op, dtype):
    s, a = _lines([0.3, 1.0, 2.5], [0.0, 0.7, 2.0, 5.0])
    s, a = torch.tensor(s, dtype=dtype), torch.tensor(a, dtype=dtype)
    tables = (tb._miller_coefficients(**DIIID, n_theta=64, dtype=dtype, device="cpu")
              if op == "miller" else None)
    ours = cb.newcomb_min_xi(op, s, a, tables, THETA_MAX, 300)
    assert ours.dtype == dtype
    assert torch.equal(ours, _rhs_loop(op, s, a, tables, 300))


def test_half_way_wrap_rounds_to_even():
    """theta / 2 pi at k + 1/2 folds as ``jnp.round`` does (half to even):
    pi stays pi, 3 pi goes to -pi, -pi stays -pi, 5 pi goes to pi."""
    theta = np.array([math.pi, -math.pi, 3.0 * math.pi, -3.0 * math.pi, 5.0 * math.pi,
                      0.5 * math.pi, 2.5 * math.pi])
    ref = np.asarray(theta - 2.0 * jnp.pi * jnp.round(jnp.asarray(theta) / (2.0 * jnp.pi)))
    ours = tb.wrap_theta(torch.tensor(theta)).numpy()
    assert np.array_equal(ours, ref)
    half = np.abs(theta[:5] / (2.0 * math.pi) - np.round(theta[:5] / (2.0 * math.pi))) == 0.5
    assert half.all()                     # the first five are exactly half-way
    assert ours[0] == math.pi and ours[2] == -math.pi     # ties to even, not away from zero
    # and the shaped coefficients there are JAX's
    tabs_j = jb._miller_coefficients(**DIIID, n_theta=256)
    tables = tb._miller_coefficients(**DIIID, n_theta=256, dtype=F64, device="cpu")
    for t in theta:
        c = tb.miller_coefficients(tables, torch.tensor(t))[2]
        wrapped = t - 2.0 * jnp.pi * jnp.round(t / (2.0 * jnp.pi))
        ref_c = [float(jnp.interp(wrapped, tabs_j[0], tab)) for tab in tabs_j[1:]]
        assert rel(c, ref_c) <= 1e-15, t


def test_diverging_line_gives_nan_min_and_unstable():
    """A line whose right-hand side overflows (s = 0, alpha = 1e20): NaN min
    on the plain path as ``jnp.minimum`` propagates it in JAX, so the point
    is unstable."""
    s, a = np.array([0.5, 0.0]), np.array([0.5, 1e20])
    ours = tb._ballooning_min_xi(torch.tensor(s), torch.tensor(a), THETA_MAX, 200)
    ref = _jax_min_xi("circular", s, a, 200)
    assert np.isnan(ref[1]) and torch.isnan(ours[1])
    assert rel(ours[:1], ref[:1]) <= TOL
    st = tb.ballooning_stable(torch.tensor(s), torch.tensor(a), n_steps=200)
    assert st.tolist() == [bool(ref[0] > 0.0), False]


def test_scan_band_edges_and_helpers_match_jax():
    s_vals = np.linspace(0.2, 2.0, 6)
    ref = jb.second_stability_scan(jnp.asarray(s_vals), alpha_max=5.0, n_alpha=24, n_steps=600)
    ours = tb.second_stability_scan(torch.tensor(s_vals), alpha_max=5.0, n_alpha=24, n_steps=600)
    assert np.array_equal(ours.stable_map.numpy(), np.asarray(ref.stable_map))
    assert rel(ours.alpha, ref.alpha) == 0.0
    assert np.array_equal(ours.alpha_crit_first.numpy(), np.asarray(ref.alpha_crit_first))
    np.testing.assert_array_equal(ours.alpha_crit_second.numpy(),
                                  np.asarray(ref.alpha_crit_second))
    assert np.array_equal(ours.second_access.numpy(), np.asarray(ref.second_access))
    for shat in (0.2, 0.73, 1.1, 2.0, 2.5):
        assert rel(ours.alpha_crit_at(shat), ref.alpha_crit_at(shat)) <= 1e-15
        assert bool(ours.has_second_stability_at(shat)) == bool(ref.has_second_stability_at(shat))


def test_marginal_alpha_matches_jax():
    ref = float(jb.marginal_alpha(1.0, alpha_hi=2.0, n_bisect=12, n_steps=400))
    ours = float(tb.marginal_alpha(1.0, alpha_hi=2.0, n_bisect=12, n_steps=400, dtype=F64,
                                   device="cpu"))
    assert abs(ours - ref) <= TOL * abs(ref)


def test_miller_marginal_and_bootstrap_path_match_jax():
    geo = dict(DIIID, n_steps=500)
    ref = float(jb.miller_marginal_alpha(2.04, alpha_hi=8.0, n_grid=33, **geo))
    ours = float(tb.miller_marginal_alpha(2.04, alpha_hi=8.0, n_grid=33, dtype=F64,
                                          device="cpu", **geo))
    assert ours == ref
    for c_bs in (0.0, 1.5, 3.0):
        r = jb.bootstrap_path_alpha_crit(2.04, c_bs, alpha_hi=16.0, n_grid=33, **geo)
        o = tb.bootstrap_path_alpha_crit(2.04, c_bs, alpha_hi=16.0, n_grid=33, dtype=F64,
                                         device="cpu", **geo)
        assert float(o.alpha_crit) == float(r.alpha_crit), c_bs
        assert bool(o.second_access) == bool(r.second_access), c_bs


def test_entry_points_default_to_the_card():
    with pytest.raises((RuntimeError, AssertionError)):
        tb.ballooning_stable(0.5, 0.8, n_steps=10)
    with pytest.raises((RuntimeError, AssertionError)):
        tb.marginal_alpha(1.0, n_steps=10, n_bisect=1)
