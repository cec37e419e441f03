"""Port parity: H-infinity synthesis and the robust controllers
(``control/{hinf, robust}.py``).

The plants of the JAX tests (``tests/test_estimator_hinf.py``,
``tests/test_robust.py``) go through the JAX functions and the port's in
float64, each within 1e-9 of its scale (the Riccati integrations run
thousands of RK4 steps of small matrix products, whose BLAS rounding differs
between the two): the CARE integrator (also batched), the central H-inf
design at two gammas and over a batch of gammas, the gamma bisection (the
same answer), a closed-loop ``hinf_step`` rollout, mu-synthesis, the
structured mu bound and its D-K iteration, the gamma-grid bound (the first
feasible gamma, which ``torch.argmax`` cannot take from a bool tensor) and
the RWM feedback design.  ``eigvals`` answers NaN for a non-finite matrix,
as ``jnp.linalg.eigvals`` does, without handing it to LAPACK.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.control import hinf as jh
from scpn_fusion_tpu.control import robust as jr
from scpn_fusion_tpu_torch.control import hinf as th
from scpn_fusion_tpu_torch.control import robust as tr

TOL = 1e-9


def _close(ours, ref, tol=TOL):
    a, b = as_np(ours), as_np(ref)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1e-300) if b.size else 1.0
    assert float(np.max(np.abs(a - b), initial=0.0)) <= tol * scale


def _pair(*mats):
    return [jnp.asarray(np.asarray(m, np.float64)) for m in mats], \
        [torch.tensor(np.asarray(m, np.float64)) for m in mats]


def _hinf_plant():
    # Unstable 2-state plant (vertical-instability-like), tests/test_estimator_hinf.py
    return _pair([[0.0, 1.0], [4.0, 0.0]], [[0.1], [0.0]], [[0.0], [1.0]],
                 [[1.0, 0.0], [0.0, 0.1]], [[1.0, 0.0]])


def test_care_ode_and_its_batch():
    (a, b, q), (ta, tb, tq) = _pair([[0.0, 1.0], [-2.0, -3.0]], [[0.0], [1.0]], np.eye(2))
    ref = jh.solve_care_ode(a, b @ b.T, q, dt=0.005, n_steps=3000)
    ours = th.solve_care_ode(ta, tb @ tb.T, tq, dt=0.005, n_steps=3000)
    _close(ours, ref)
    scales = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)[:, None, None]
    batch = th.solve_care_ode(ta, tb @ tb.T * scales, tq, dt=0.005, n_steps=3000)
    assert batch.shape == (3, 2, 2)
    _close(batch[1], ref)
    _close(batch[2], jh.solve_care_ode(a, b @ b.T * 2.0, q, dt=0.005, n_steps=3000))


@pytest.mark.parametrize("gamma", [50.0, 20.0])
def test_synthesize_hinf(gamma):
    jp, tp = _hinf_plant()
    ref = jh.synthesize_hinf(*jp, gamma)
    ours = th.synthesize_hinf(*tp, gamma)
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))
    assert bool(ours.robust_feasible) == bool(ref.robust_feasible)


def test_synthesize_hinf_over_a_batch_of_gammas():
    jp, tp = _hinf_plant()
    gammas = torch.tensor([1.2, 5.0, 50.0], dtype=torch.float64)
    ours = th.synthesize_hinf(*tp, gammas, riccati_steps=1000)
    assert ours.x.shape == (3, 2, 2) and ours.robust_feasible.shape == (3,)
    for i, g in enumerate(gammas.tolist()):
        ref = jh.synthesize_hinf(*jp, g, riccati_steps=1000)
        for name in ("x", "y", "f", "l", "spectral_radius_xy"):
            _close(getattr(ours, name)[i], getattr(ref, name))
        assert bool(ours.robust_feasible[i]) == bool(ref.robust_feasible)


def test_gamma_bisection():
    jp, tp = _hinf_plant()
    kw = dict(gamma_hi=50.0, n_bisect=5, riccati_steps=1500)
    assert th.find_optimal_gamma(*tp, **kw) == jh.find_optimal_gamma(*jp, **kw)


def test_closed_loop_rollout():
    jp, tp = _hinf_plant()
    ref_g, g = jh.synthesize_hinf(*jp, 20.0), th.synthesize_hinf(*tp, 20.0)
    a, _, b2, _, c2 = jp
    ta, _, tb2, _, tc2 = tp
    x_j, s_j = jnp.asarray([0.3, 0.0]), jh.HInfState(jnp.zeros(2))
    x_t, s_t = torch.tensor([0.3, 0.0], dtype=torch.float64), th.HInfState(torch.zeros(
        2, dtype=torch.float64))
    for _ in range(400):
        s_j, u_j = jh.hinf_step(ref_g, a, b2, c2, s_j, c2 @ x_j, 1e-3)
        x_j = x_j + 1e-3 * (a @ x_j + b2 @ u_j)
        s_t, u_t = th.hinf_step(g, ta, tb2, tc2, s_t, tc2 @ x_t, 1e-3)
        x_t = x_t + 1e-3 * (ta @ x_t + tb2 @ u_t)
    _close(x_t, x_j)
    _close(s_t.x_hat, s_j.x_hat)


def test_eigvals_of_a_non_finite_matrix():
    m = torch.tensor([[[np.nan, 1.0], [2.0, 3.0]], [[0.0, 1.0], [-2.0, -3.0]]],
                     dtype=torch.float64)
    ev = th.eigvals(m)
    assert bool(torch.isnan(ev[0]).all())
    assert sorted(ev[1].real.tolist()) == [-2.0, -1.0]


def test_mu_synthesis():
    (a, b, c), (ta, tb, tc) = _pair([[0.5, 1.0], [0.0, -2.0]], [[0.0], [1.0]], np.eye(2))
    ref = jr.mu_synthesis(a, b, c, n_dk_iters=2)
    ours = tr.mu_synthesis(ta, tb, tc, n_dk_iters=2)
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))


def test_hinf_norm_bound_takes_the_first_feasible_gamma():
    (a, b, c), (ta, tb, tc) = _pair([[-1.0, 0.5], [0.0, -2.0]], [[0.0], [1.0]], np.eye(2))
    grid = np.array([0.05, 0.1, 3.0, 0.2, 5.0, 10.0])     # feasibility is not monotone here
    ref = jr._hinf_norm_bound(a, b, c, gammas=jnp.asarray(grid))
    ours = tr._hinf_norm_bound(ta, tb, tc, gammas=torch.tensor(grid))
    assert float(ours) == float(ref) == 3.0
    none = tr._hinf_norm_bound(ta, tb, tc, gammas=torch.tensor([0.01, 0.02]))
    assert float(none) == float(jr._hinf_norm_bound(a, b, c, gammas=jnp.asarray([0.01, 0.02])))


def test_structured_mu_bound():
    struct_j = jr.StructuredUncertainty((jr.UncertaintyBlock("d1", 1, 0.1),
                                         jr.UncertaintyBlock("d2", 1, 0.1)))
    struct_t = tr.StructuredUncertainty((tr.UncertaintyBlock("d1", 1, 0.1),
                                         tr.UncertaintyBlock("d2", 1, 0.1)))
    (m,), (tm,) = _pair([[1.0, 10.0], [0.0, 1.0]])
    _close(tr.mu_upper_bound(tm), jr.mu_upper_bound(m))
    _close(tr.mu_upper_bound(tm, struct_t, n_steps=300, lr=0.3),
           jr.mu_upper_bound(m, struct_j, n_steps=300, lr=0.3))
    with pytest.raises(ValueError, match="match"):
        tr.mu_upper_bound(torch.eye(3, dtype=torch.float64), struct_t)
    for bad in (lambda: tr.UncertaintyBlock("d1", 0, 0.1),
                lambda: tr.UncertaintyBlock("d1", 1, -0.5),
                lambda: tr.UncertaintyBlock("d1", 1, 0.1, "weird"),
                lambda: tr.StructuredUncertainty(())):
        with pytest.raises(ValueError):
            bad()


def test_dk_iteration_structured():
    (a, b, c), (ta, tb, tc) = _pair([[0.5, 1.0], [0.0, -2.0]], [[0.0], [1.0]], np.eye(2))
    blocks = (("mode", 1, 0.2), ("wall", 1, 0.2))
    ref = jr.dk_iteration_structured(
        a, b, c, jr.StructuredUncertainty(tuple(jr.UncertaintyBlock(*x) for x in blocks)),
        n_dk_iters=2)
    ours = tr.dk_iteration_structured(
        ta, tb, tc, tr.StructuredUncertainty(tuple(tr.UncertaintyBlock(*x) for x in blocks)),
        n_dk_iters=2)
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))


def test_rwm_feedback():
    ref = jr.rwm_feedback_design(jr.build_rwm_plant(), q_weight=500.0)
    plant = tr.build_rwm_plant(device="cpu")
    for name in ("a", "b", "c"):
        _close(getattr(plant, name), getattr(jr.build_rwm_plant(), name), 0.0)
    ours = tr.rwm_feedback_design(plant, q_weight=500.0)
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))
    assert bool(ours.stabilised)
