"""Port parity: the QL closure, the local Maxwell evolution and the hybrid
surrogate+GK lane (``models/gyrokinetics/{ql_closure, maxwell_evolution,
hybrid}.py``).

The QL closure's branches, spectrum and fluxes match JAX on seeded local
parameters (one point and a batch of them) within 1e-12, and the whole
profile (``tests/test_ql_closure.py:75-104``'s) equals JAX's ``vmap``; the
Maxwell evolution's diagnostics match within 1e-12 (its round-off residuals
and energy drift within 1e-12 absolutely) from the same numpy draws, and
its evidence record says the same; the hybrid lane's OOD statistics,
scheduler plans (every strategy; the top-``budget`` indices equal,
``jax.lax.top_k``'s ties toward the lower index included), corrector,
learner and report match within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import crel as rel
from torch_parity import rng

from scpn_fusion_tpu.models.gyrokinetics import hybrid as jhy
from scpn_fusion_tpu.models.gyrokinetics import maxwell_evolution as jmx
from scpn_fusion_tpu.models.gyrokinetics import ql_closure as jql
from scpn_fusion_tpu_torch.models.gyrokinetics import hybrid as thy
from scpn_fusion_tpu_torch.models.gyrokinetics import maxwell_evolution as tmx
from scpn_fusion_tpu_torch.models.gyrokinetics import ql_closure as tql

TOL = 1e-12


def _params(seed, n=None):
    g = rng(seed)
    size = () if n is None else (n,)
    vals = dict(r_l_ti=g.uniform(0.0, 12.0, size), r_l_te=g.uniform(0.0, 40.0, size),
                r_l_ne=g.uniform(0.0, 6.0, size), q=g.uniform(0.8, 4.0, size),
                s_hat=g.uniform(0.1, 2.0, size), te_ti=g.uniform(0.5, 2.0, size),
                z_eff=g.uniform(1.0, 2.5, size), nu_star=g.uniform(0.0, 1.0, size),
                epsilon=g.uniform(0.05, 0.35, size))
    return (jql.QLLocalParams(**{k: jnp.asarray(v) for k, v in vals.items()}),
            tql.QLLocalParams(**{k: torch.as_tensor(v, dtype=torch.float64)
                                 for k, v in vals.items()}))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("include_etg", [False, True])
def test_ql_spectrum_and_fluxes_match(seed, include_etg):
    pj, pt = _params(seed)
    sj = jql.compute_spectrum(pj, 16, include_etg)
    st = tql.compute_spectrum(pt, 16, include_etg)
    for name in sj._fields:
        assert rel(getattr(st, name), getattr(sj, name)) <= TOL, name
    for a, b in zip(tql.quasilinear_fluxes(pt, st), jql.quasilinear_fluxes(pj, sj)):
        assert rel(a, b) <= TOL


def test_ql_batch_equals_points():
    pj, pt = _params(5, n=6)
    st = tql.compute_spectrum(pt, 16, True)
    flux = tql.quasilinear_fluxes(pt, st)
    assert st.gamma.shape == (6, 32) and flux.chi_i.shape == (6,)
    for i in range(6):
        pi = jql.QLLocalParams(*(x[i] for x in pj))
        ref = jql.quasilinear_fluxes(pi, jql.compute_spectrum(pi, 16, True))
        for a, b in zip(flux, ref):
            assert rel(a[i], b) <= TOL


def test_ql_profile_matches_jax():
    nr = 12
    rho = np.linspace(0.0, 1.0, nr)
    te = 10.0 * (1.0 - 0.9 * rho ** 2)
    ne = 8.0 * (1.0 - 0.6 * rho ** 2)
    q = 1.0 + 2.5 * rho ** 2
    s_hat = np.full(nr, 1.0)
    a, r0, b0 = 2.0, 6.2, 5.3
    dr = float(rho[1] - rho[0]) * a
    dte, dne = np.gradient(te, dr), np.gradient(ne, dr)
    cols = (rho, te, te, ne, q, s_hat, dte, dte, dne)
    for etg in (False, True):
        ref = jql.QLTransportModel(n_modes=16, include_etg=etg).evaluate_profile(
            *[jnp.asarray(c) for c in cols], r0, a, b0)
        ours = tql.QLTransportModel(n_modes=16, include_etg=etg).evaluate_profile(
            *[torch.from_numpy(c) for c in cols], r0, a, b0)
        for x, y in zip(ours, ref):
            assert x.shape == (nr,) and rel(x, y) <= TOL
        assert float(ours[0][0]) == pytest.approx(0.01)
    nu = tql.infer_nu_star(6.2, torch.from_numpy(q), torch.from_numpy(te), torch.from_numpy(ne),
                           torch.from_numpy(np.maximum(rho * a / r0, 1e-3)))
    nu_ref = jql.infer_nu_star(6.2, jnp.asarray(q), jnp.asarray(te), jnp.asarray(ne),
                               jnp.asarray(np.maximum(rho * a / r0, 1e-3)))
    assert rel(nu, nu_ref) <= TOL


@pytest.mark.parametrize("cfg", [{}, dict(n_steps=64, dt=2e-13), dict(n_kx=6, n_ky=10, seed=5)],
                         ids=["default", "mif-frc", "seeded"])
def test_maxwell_evolution_matches(cfg):
    jc, tc = jmx.MaxwellEvolutionConfig(**cfg), tmx.MaxwellEvolutionConfig(**cfg)
    ref = jmx.run_local_maxwell_evolution(jc)
    ours = tmx.run_local_maxwell_evolution(tc, device="cpu")
    for name in ref._fields:
        a, b = getattr(ours, name), getattr(ref, name)
        if "residual" in name or "drift" in name:       # round-off: absolute
            assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= TOL, name
        else:
            assert rel(a, b) <= TOL, name
    ev, ev_ref = tmx.to_evidence(ours, tc), jmx.to_evidence(ref, jc)
    assert ev["status"] == ev_ref["status"] == "accepted_local_source_free_maxwell_evolution"
    assert ev.keys() == ev_ref.keys() and ev["saved_steps"] == ev_ref["saved_steps"]


def test_maxwell_draws_and_guards_match():
    g1, g2 = np.random.default_rng(23), np.random.default_rng(23)
    a = tmx._random_complex_modes(g1, (4, 5), 1e-9, device="cpu")
    b = jmx._random_complex_modes(g2, (4, 5), 1e-9)
    assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="Courant"):
        tmx.run_local_maxwell_evolution(tmx.MaxwellEvolutionConfig(dt=1e-9), device="cpu")
    with pytest.raises(ValueError, match="two kx"):
        tmx.run_local_maxwell_evolution(tmx.MaxwellEvolutionConfig(n_kx=1), device="cpu")


@pytest.fixture(scope="module")
def ood():
    x = rng(0).standard_normal((500, 10)) * 0.5 + 1.0
    return jhy.fit_ood(jnp.asarray(x)), thy.fit_ood(torch.from_numpy(x))


def test_ood_matches(ood):
    jp, tp = ood
    for name in jp._fields:
        assert rel(getattr(tp, name), getattr(jp, name)) <= 1e-11, name
    x = rng(1).standard_normal((50, 10)) * 0.9 + 1.0
    x[3] = 25.0
    e = np.abs(rng(2).standard_normal(50)) * 0.3
    ref = jhy.ood_check(jnp.asarray(x), jp, ensemble_std=jnp.asarray(e))
    ours = thy.ood_check(torch.from_numpy(x), tp, ensemble_std=torch.from_numpy(e))
    assert np.array_equal(ours.is_ood.numpy(), np.asarray(ref.is_ood))
    assert np.array_equal(ours.range_violation.numpy(), np.asarray(ref.range_violation))
    assert rel(ours.mahalanobis, ref.mahalanobis) <= 1e-11
    assert rel(ours.confidence, ref.confidence) <= 1e-11
    assert float(thy.mahalanobis_distance(tp.mean, tp)[0]) < 1e-6


def _same_plan(ours, ref):
    assert ours.indices.dtype == torch.int32
    assert np.array_equal(ours.indices.numpy(), np.asarray(ref.indices))
    assert np.array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert np.array_equal(ours.reasons.numpy(), np.asarray(ref.reasons))
    assert bool(ours.any_requested) == bool(ref.any_requested)


@pytest.mark.parametrize("strategy", ["periodic", "adaptive", "critical_region"])
@pytest.mark.parametrize("step", [4, 5])
def test_scheduler_matches(strategy, step):
    rho = np.linspace(0.0, 1.0, 32)
    chi = np.ones(32)
    prev = chi.copy()
    prev[20] = 10.0
    prev[9] = 0.2
    ood_mask = np.zeros(32, bool)
    ood_mask[7] = True
    cfg_kw = dict(strategy=strategy, budget=4, period=5)
    ref = jhy.schedule_spot_checks(jhy.SchedulerConfig(**cfg_kw), jnp.asarray(step),
                                   jnp.asarray(rho), jnp.asarray(chi), jnp.asarray(prev),
                                   ood_mask=jnp.asarray(ood_mask))
    ours = thy.schedule_spot_checks(thy.SchedulerConfig(**cfg_kw), torch.tensor(step),
                                    torch.from_numpy(rho), torch.from_numpy(chi),
                                    torch.from_numpy(prev), ood_mask=torch.from_numpy(ood_mask))
    _same_plan(ours, ref)


def test_top_k_breaks_ties_toward_the_lower_index():
    """Every anchor scores 1 and the rest 0: the budget's slots go by
    index, as ``jax.lax.top_k`` orders ties."""
    score = np.asarray([0.0, 1.0, 0.0, 2.0, 1.0, 1.0, 0.0, 2.0, 1.0, 0.0, 1.0])
    for k in (1, 3, 5, 8, 11):
        vals, idx = thy.top_k(torch.from_numpy(score), k)
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(score), k)
        assert np.array_equal(idx.numpy(), np.asarray(ref_idx))
        assert np.array_equal(vals.numpy(), np.asarray(ref_vals))
    # a plan whose budget cuts through tied anchors
    rho = np.linspace(0.0, 1.0, 40)
    cfg = dict(strategy="critical_region", budget=7, pedestal_rho=0.9, axis_rho=0.1)
    ref = jhy.schedule_spot_checks(jhy.SchedulerConfig(**cfg), jnp.asarray(0),
                                   jnp.asarray(rho), jnp.ones(40), jnp.ones(40))
    ours = thy.schedule_spot_checks(thy.SchedulerConfig(**cfg), 0, torch.from_numpy(rho),
                                    torch.ones(40, dtype=torch.float64),
                                    torch.ones(40, dtype=torch.float64))
    _same_plan(ours, ref)


def test_corrector_matches():
    rho = np.linspace(0.0, 1.0, 20)
    g = rng(7)
    spot_rho = np.asarray([0.8, 0.3, 0.55, 0.1])
    gk = g.uniform(0.5, 2.0, (4, 3))
    surr = g.uniform(0.5, 2.0, (4, 3))
    for valid in ([True, False, True, True], [False] * 4, [True] * 4):
        valid = np.asarray(valid)
        ref = jhy.corrector_update(jhy.init_corrector(20), jnp.asarray(rho),
                                   jnp.asarray(spot_rho), jnp.asarray(valid), jnp.asarray(gk),
                                   jnp.asarray(surr))
        ours = thy.corrector_update(thy.init_corrector(20, device="cpu"), torch.from_numpy(rho),
                                    torch.from_numpy(spot_rho), torch.from_numpy(valid),
                                    torch.from_numpy(gk), torch.from_numpy(surr))
        for a, b in zip(ours, ref):
            assert rel(a, b) <= TOL
        chi = torch.linspace(1.0, 2.0, 20, dtype=torch.float64)
        for a, b in zip(thy.corrector_apply(ours, chi, chi, chi),
                        jhy.corrector_apply(ref, jnp.asarray(chi.numpy()),
                                            jnp.asarray(chi.numpy()), jnp.asarray(chi.numpy()))):
            assert rel(a, b) <= TOL


def test_learner_matches():
    g = rng(8)
    x = g.standard_normal((12, 10))
    y = x @ g.standard_normal((10, 3)) + 0.5
    js, ts = jhy.init_learner(capacity=8), thy.init_learner(capacity=8, device="cpu")
    for i in range(12):      # wraps around the ring buffer
        js = jhy.learner_add(js, jnp.asarray(x[i]), jnp.asarray(y[i]))
        ts = thy.learner_add(ts, torch.from_numpy(x[i]), torch.from_numpy(y[i]))
    assert int(ts.count) == int(js.count) == 12
    assert np.array_equal(ts.x_buf.numpy(), np.asarray(js.x_buf))
    js, ts = jhy.learner_refit(js), thy.learner_refit(ts)
    assert rel(ts.weights, js.weights) <= 1e-10
    assert rel(thy.learner_predict(ts, torch.from_numpy(x[:3])),
               jhy.learner_predict(js, jnp.asarray(x[:3]))) <= 1e-10


def test_report_matches():
    jr, tr = jhy.init_report(), thy.init_report(device="cpu")
    g = rng(9)
    corr_j = jhy.init_corrector(6)._replace(alpha_chi_i=jnp.linspace(0.8, 1.3, 6))
    corr_t = thy.init_corrector(6, device="cpu")._replace(
        alpha_chi_i=torch.from_numpy(np.asarray(corr_j.alpha_chi_i)))
    for step in range(4):
        valid = g.uniform(size=3) < 0.6
        ood_flags = g.uniform(size=6) < 0.2
        gk = g.uniform(0.0, 2.0, 3)
        gk[0] = 1e-12
        surr = g.uniform(0.0, 2.0, 3)
        kw = dict(corrector=(corr_j, corr_t)) if step % 2 else {}
        jr = jhy.report_add_step(jr, spot_valid=jnp.asarray(valid), ood_flags=jnp.asarray(ood_flags),
                                 gk_chi_i=jnp.asarray(gk), surr_chi_i=jnp.asarray(surr),
                                 corrector=kw["corrector"][0] if kw else None)
        tr = thy.report_add_step(tr, spot_valid=torch.from_numpy(valid),
                                 ood_flags=torch.from_numpy(ood_flags),
                                 gk_chi_i=torch.from_numpy(gk), surr_chi_i=torch.from_numpy(surr),
                                 corrector=kw["corrector"][1] if kw else None)
    assert thy.report_to_dict(tr) == jhy.report_to_dict(jr)
    for a, b in zip(tr, jr):
        assert rel(a, b) <= TOL
