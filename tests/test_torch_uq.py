"""Port parity: uncertainty quantification (``models/uq/{pce, mc}``).

float64 on the CPU.  Randomness: the port's entry points draw from a
``torch.Generator``; the tests run their private twins on JAX's draws (the
normals of ``PRNGKey(seed)``, split as JAX splits it; the LHS jitter and
permutations of its split keys).  PCE: the multi-index and Hermite table
equal, the coefficients, predictions and Sobol indices within 1e-12
(``torch.linalg.svd``'s singular vectors may differ from LAPACK's in sign,
which the pseudo-inverse does not see, so ``u`` and ``v`` are never
compared).  MC: medians, sigmas and percentile bands within 1e-12, at an odd
and an even sample count (``jnp.median`` averages an even count's middle
pair, ``torch.median`` would return the lower one) and with the default
``ddof=0`` spread.  The JAX tests' gates hold on the port's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, to_torch

from scpn_fusion_tpu.models.uq import mc as jm
from scpn_fusion_tpu.models.uq import pce as jp
from scpn_fusion_tpu_torch.core import stats
from scpn_fusion_tpu_torch.models.uq import mc as tm
from scpn_fusion_tpu_torch.models.uq import pce as tp

F64 = torch.float64
ITER = dict(i_p_ma=15.0, b_t=5.3, p_heat_mw=50.0, n_e_19=10.1, r_major=6.2, aspect=3.1,
            kappa=1.7)


def np_of(x):
    return np.asarray(x)


def test_multi_index_and_hermite_equal_jax():
    for d, p in ((2, 2), (3, 2), (4, 3), (1, 5)):
        assert tp.total_order_multi_index(d, p) == jp.total_order_multi_index(d, p)
    x = np.linspace(-3.0, 3.0, 13)
    assert np.array_equal(tp.hermite_table(to_torch(x), 4).numpy(),
                          np_of(jp.hermite_table(jnp.asarray(x), 4)))
    s = np.random.default_rng(0).normal(size=(9, 3))
    mi = tp.total_order_multi_index(3, 3)
    assert rel(tp.design_matrix(to_torch(s), mi), jp.design_matrix(jnp.asarray(s), mi)) <= 1e-15


@pytest.mark.parametrize("n, d, order", [(400, 2, 2), (500, 3, 2), (60, 2, 3)])
def test_fit_predict_sobol_match_jax(n, d, order):
    x = np_of(jax.random.normal(jax.random.PRNGKey(n), (n, d)))
    y = np.stack([2.0 + 0.5 * x[:, 0] + 1.5 * (x[:, -1] ** 2 - 1.0) + 0.3 * x[:, 0] * x[:, -1],
                  5.0 * x[:, 0] + 0.5 * x[:, -1]], axis=1)
    ref = jp.fit_pce(jnp.asarray(x), jnp.asarray(y), order=order)
    ours = tp.fit_pce(to_torch(x), to_torch(y), order=order)
    assert ours.multi_index == ref.multi_index
    assert rel(ours.coefficients, ref.coefficients) <= 1e-12
    xt = np.random.default_rng(1).normal(size=(50, d))
    assert rel(tp.predict_pce(ours, to_torch(xt)), jp.predict_pce(ref, jnp.asarray(xt))) <= 1e-12
    assert rel(tp.predict_pce(ours, to_torch(xt[0])), jp.predict_pce(ref, jnp.asarray(xt[0]))) \
        <= 1e-12
    assert rel(tp.sobol_first_order(ours), jp.sobol_first_order(ref)) <= 1e-12


def test_pce_gates_and_validation():
    """``tests/test_uq.py``'s PCE gates on the port's own normals."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((500, 3), generator=g, dtype=F64)
    model = tp.fit_pce(x, (5.0 * x[:, 0] + 0.5 * x[:, 2])[:, None], order=2)
    s = tp.sobol_first_order(model).numpy()
    assert s.shape == (3,) and s[0] > 0.9 and s[1] < 0.05 and abs(s.sum() - 1.0) <= 0.05
    with pytest.raises(ValueError):
        tp.fit_pce(torch.zeros(3, 2, dtype=F64), torch.zeros(4, 1, dtype=F64), 1)
    with pytest.raises(ValueError):
        tp.fit_pce(torch.tensor([[np.nan, 0.0]], dtype=F64), torch.zeros(1, 1, dtype=F64), 1)


def test_latin_hypercube_on_jax_draws():
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 6)
    jitter = np.stack([np_of(jax.random.uniform(keys[2 * d], (100,))) for d in range(3)])
    perms = np.stack([np_of(jax.random.permutation(keys[2 * d + 1], 100)) for d in range(3)])
    ours = tp._latin_hypercube(to_torch(jitter), torch.from_numpy(perms).long())
    assert rel(ours, jp.latin_hypercube(key, 100, 3)) <= 1e-15    # XLA: a product by 1/n
    pts = tp.latin_hypercube(torch.Generator().manual_seed(3), 100, 3, dtype=F64,
                             device="cpu").numpy()
    assert pts.shape == (100, 3) and np.all((pts >= 0) & (pts <= 1))
    for d in range(3):
        assert len(np.unique(np.floor(pts[:, d] * 100).astype(int))) == 100


@pytest.mark.parametrize("n, seed", [(4000, 0), (501, 7), (10000, 3)])
def test_quantify_uncertainty_on_jax_draws(n, seed):
    ref = jm.quantify_uncertainty(jm.PlasmaScenario(**ITER), n_samples=n, seed=seed)
    z = np_of(jax.random.normal(jax.random.PRNGKey(seed), (n, 9)))
    ours = tm._quantify_uncertainty(tm.PlasmaScenario(**ITER), to_torch(z))
    assert ours.n_samples == ref.n_samples == n
    for name in ref._fields[:-1]:
        assert rel(getattr(ours, name), getattr(ref, name)) <= 1e-12, name


def test_quantify_full_chain_on_jax_draws():
    n, seed = 3000, 1
    ref = jm.quantify_full_chain(jm.PlasmaScenario(**ITER), jm.EquilibriumUncertainty(),
                                 jm.TransportUncertainty(), n_samples=n, seed=seed)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    draws = [jax.random.normal(k1, (n, 9))] + [jax.random.normal(k, (n,)) for k in (k2, k3, k4)]
    ours = tm._quantify_full_chain(tm.PlasmaScenario(**ITER), tm.EquilibriumUncertainty(),
                                   tm.TransportUncertainty(), *(to_torch(d) for d in draws))
    for name in ref._fields[:-1]:
        assert rel(getattr(ours, name), getattr(ref, name)) <= 1e-12, name


def test_median_and_std_follow_jax():
    """The even-count median averages the middle pair; the spread is ddof=0."""
    x = np.array([3.0, 1.0, 4.0, 1.5, 9.0, 2.6])
    assert float(stats.median(to_torch(x))) == float(jnp.median(jnp.asarray(x))) == 2.8
    assert float(torch.median(to_torch(x))) == 2.6          # what the port avoids
    assert float(stats.median(to_torch(x[:5]))) == float(jnp.median(jnp.asarray(x[:5])))
    assert np.isnan(float(stats.median(to_torch(np.array([1.0, np.nan, 2.0])))))
    assert rel(tm._std(to_torch(x)), jnp.std(jnp.asarray(x))) <= 1e-15
    z = np.zeros((6, 9))
    z[:, 0] = np.linspace(-1.0, 1.0, 6)
    ours = tm._quantify_uncertainty(tm.PlasmaScenario(**ITER), to_torch(z))
    coeffs = torch.as_tensor(tm.IPB98_CENTRAL) + to_torch(z) * torch.as_tensor(tm.IPB98_SIGMA)
    srt = torch.sort(torch.clamp(tm.ipb98_tau_e(tm.PlasmaScenario(**ITER), coeffs),
                                 min=1e-6)).values
    assert float(ours.tau_e) == float((srt[2] + srt[3]) * 0.5)


def test_scaling_and_power_match_jax():
    s_j, s_t = jm.PlasmaScenario(**ITER), tm.PlasmaScenario(**ITER)
    c = np.asarray(jm.IPB98_CENTRAL)
    assert rel(tm.ipb98_tau_e(s_t, to_torch(c)), jm.ipb98_tau_e(s_j, jnp.asarray(c))) <= 1e-14
    tau = float(tm.ipb98_tau_e(s_t, to_torch(c)))
    assert 4.0 < tau < 6.5
    assert rel(tm.fusion_power_from_tau(s_t, 3.7, dtype=F64, device="cpu"),
               jm.fusion_power_from_tau(s_j, 3.7)) <= 1e-13
    assert np.array_equal(tm.ipb98_covariance(), jm.ipb98_covariance())


def test_mc_gates_on_port_draws():
    """``tests/test_uq.py``'s MC gates on the port's own draws."""
    s = tm.PlasmaScenario(**ITER)
    res = tm.quantify_uncertainty(s, n_samples=4000, seed=0, dtype=F64, device="cpu")
    tau_p = res.tau_e_percentiles.numpy()
    assert res.n_samples == 4000 and np.all(np.diff(tau_p) >= 0)
    assert tau_p[0] < float(res.tau_e) < tau_p[-1]
    assert float(res.tau_e_sigma) > 0 and float(res.q_sigma) > 0
    again = tm.quantify_uncertainty(s, n_samples=4000, seed=0, dtype=F64, device="cpu")
    assert torch.equal(again.tau_e, res.tau_e)
    base = tm.quantify_uncertainty(s, n_samples=3000, seed=1, dtype=F64, device="cpu")
    full = tm.quantify_full_chain(s, n_samples=3000, seed=1, dtype=F64, device="cpu")
    assert float(full.tau_e_sigma) > float(base.tau_e_sigma)
    bands = full.q_bands.numpy()
    assert bands[0] <= bands[1] <= bands[2]
    assert np.all(np.isfinite(full.psi_nrmse_bands.numpy()))


def test_entry_points_default_to_cuda():
    s = tm.PlasmaScenario(**ITER)
    for run in (lambda: tm.quantify_uncertainty(s, n_samples=10),
                lambda: tm.quantify_full_chain(s, n_samples=10),
                lambda: tm.fusion_power_from_tau(s, 3.7),
                lambda: tp.latin_hypercube(torch.Generator().manual_seed(0), 4, 2)):
        with pytest.raises((RuntimeError, AssertionError)):
            run()
