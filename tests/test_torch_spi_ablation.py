"""Port parity: the multi-fragment SPI ablation solver
(``models/physics/spi_ablation``).

JAX draws the fragment cloud from a threefry key; the test draws the same
three normal samples with ``jax.random`` and feeds them to the port's
``_spi_init``, and the cloud to ``_run_spi_injection`` /
``_spi_quantity_sweep``.  In float64 on the CPU the cloud, the per-step
deposition, mass and active count, and the summaries are within 1e-9 of
JAX's (600 steps of the JAX test's 64 fragments; the sweep of three
inventories over 500 steps); ``time_90pct_ms`` is float32 and equal.  Two
fragments in one rho cell sum in the scatter-add.  The gates of
``tests/test_spi_ablation.py`` hold for the port's own draws (a
``torch.Generator``), the coupling into the disruption sequence included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.models.physics import spi_ablation as js
from scpn_fusion_tpu_torch.models.physics import spi_ablation as ts
from scpn_fusion_tpu_torch.models.physics.disruption_sequence import (
    DisruptionParams, run_disruption_sequence,
)

TOL = 1e-9
F64 = torch.float64
NE19 = torch.tensor(np.linspace(8.0, 2.0, 33))
TE = torch.tensor(np.linspace(8.0, 0.05, 33))
NE19_J, TE_J = jnp.linspace(8.0, 2.0, 33), jnp.linspace(8.0, 0.05, 33)
KW = dict(n_fragments=64, injector_pos=(8.4, 0.0, 0.0), velocity_mps=500.0)
CFG, CFG_J = ts.SpiConfig(**KW), js.SpiConfig(**KW)


def jax_draws(cfg, key) -> ts.SpiDraws:
    """The normal samples of ``js.spi_init(cfg, key)`` (``:113-121``)."""
    n = int(cfg.n_fragments)
    k_dir, k_spd, k_pos = jax.random.split(key, 3)
    return ts.SpiDraws(*(torch.tensor(np.asarray(jax.random.normal(k, shape)))
                         for k, shape in ((k_dir, (n, 3)), (k_spd, (n,)), (k_pos, (n, 3)))))


def jax_cloud(seed: int) -> ts.FragmentState:
    return ts._spi_init(CFG, jax_draws(CFG, jax.random.PRNGKey(seed)), dtype=F64, device="cpu")


def test_init_matches_jax():
    ours = jax_cloud(0)
    ref = js.spi_init(CFG_J, jax.random.PRNGKey(0))
    for name, a, b in zip(ref._fields, ours, ref):
        assert a.dtype == F64 and rel(a, b) <= TOL, name


@pytest.fixture(scope="module")
def runs():
    ours = ts._run_spi_injection(CFG, jax_cloud(1), NE19, TE, dt_s=5e-5, n_steps=600)
    ref = js.run_spi_injection(CFG_J, jax.random.PRNGKey(1), NE19_J, TE_J, dt_s=5e-5,
                               n_steps=600)
    return ours, ref


def test_injection_matches_jax(runs):
    (trace, summary), (trace_j, summary_j) = runs
    assert trace.deposition_m3s.shape == (600, 33) and trace.n_active.dtype == torch.int32
    for name, a, b in zip(trace_j._fields, trace, trace_j):
        assert rel(a, b) <= TOL, name
    for name in ("assimilated_particles", "assimilated_fraction", "delta_ne20_volavg"):
        assert rel(getattr(summary, name), getattr(summary_j, name)) <= TOL, name
    assert summary.time_90pct_ms.dtype == torch.float32
    assert float(summary.time_90pct_ms) == float(summary_j.time_90pct_ms)


def test_quantity_sweep_matches_jax():
    masses = [0.002, 0.01, 0.03]
    ours = ts._spi_quantity_sweep(CFG, jax_cloud(4), torch.tensor(masses, dtype=F64), NE19, TE,
                                  dt_s=5e-5, n_steps=500)
    ref = js.spi_quantity_sweep(CFG_J, jax.random.PRNGKey(4), jnp.asarray(masses), NE19_J, TE_J,
                                dt_s=5e-5, n_steps=500)
    for name in ("assimilated_particles", "assimilated_fraction", "delta_ne20_volavg"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    assert ours.time_90pct_ms.dtype == torch.float32
    assert np.array_equal(ours.time_90pct_ms.numpy(), np.asarray(ref.time_90pct_ms))
    assim = as_np(ours.assimilated_particles)
    assert assim.shape == (3,) and np.all(np.diff(assim) > 0.0)   # test_quantity_sweep_monotone
    assert np.all(as_np(ours.delta_ne20_volavg) > 0.0)


def test_two_fragments_in_one_cell_sum():
    """The deposition's scatter-add: two fragments binned to one rho cell add."""
    pos = torch.tensor([[7.0, 0.0, 0.1], [7.0, 0.0, -0.1], [8.0, 0.0, 0.0]], dtype=F64)
    vel = torch.tensor([[-10.0, 0.0, 0.0]] * 3, dtype=F64)
    state = ts.FragmentState(pos, vel, torch.full((3,), 1e-4, dtype=F64))
    st_j = js.FragmentState(*(jnp.asarray(x.numpy()) for x in state))
    (s1, dep), (s1_j, dep_j) = (ts.spi_step(state, ne19_prof=NE19, te_kev_prof=TE, dt_s=1e-4,
                                            cfg=CFG),
                                js.spi_step(st_j, ne19_prof=NE19_J, te_kev_prof=TE_J, dt_s=1e-4,
                                            cfg=CFG_J))
    assert rel(dep, dep_j) <= TOL and rel(s1.mass_kg, s1_j.mass_kg) <= TOL
    assert int((dep > 0).sum()) == 2        # fragments 0 and 1 share a cell


def test_spi_gates():
    """``tests/test_spi_ablation.py`` on the port's own draws."""
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    st = ts.spi_init(CFG, gen(0), dtype=F64, device="cpu")
    assert st.pos_m.shape == (64, 3) and st.mass_kg.shape == (64,)
    np.testing.assert_allclose(float(torch.sum(st.mass_kg)), CFG.total_mass_kg, rtol=1e-6)
    assert float(torch.mean(st.vel_mps[:, 0])) < -300.0
    assert 300.0 < float(torch.mean(torch.linalg.vector_norm(st.vel_mps, dim=1))) < 700.0

    trace, summary = ts.run_spi_injection(CFG, gen(1), NE19, TE, dt_s=5e-5, n_steps=600)
    ledger = float(trace.mass_total_kg[-1]) + float(summary.assimilated_particles) * ts.M_NEON_KG
    np.testing.assert_allclose(ledger, CFG.total_mass_kg, rtol=1e-5)
    assert 0.0 < float(summary.assimilated_fraction) <= 1.0
    dep = as_np(trace.deposition_m3s)
    assert np.all(np.isfinite(dep)) and np.all(dep >= 0.0) and dep.shape == (600, 33)
    assert float(summary.assimilated_particles) > 0.0

    trace, summary = ts.run_spi_injection(CFG, gen(3), NE19, torch.full_like(TE, 0.001),
                                          dt_s=5e-5, n_steps=200)
    assert float(summary.assimilated_particles) == 0.0
    np.testing.assert_allclose(as_np(trace.mass_total_kg), CFG.total_mass_kg, rtol=1e-6)

    dead = ts.FragmentState(torch.tensor([[6.2, 0.0, 0.0]], dtype=F64),
                            torch.zeros((1, 3), dtype=F64), torch.zeros(1, dtype=F64))
    st2, dep = ts.spi_step(dead, ne19_prof=NE19, te_kev_prof=TE, dt_s=1e-4, cfg=CFG)
    assert float(st2.mass_kg[0]) == 0.0 and float(torch.sum(dep)) == 0.0

    sweep = ts.spi_quantity_sweep(CFG, gen(4), torch.tensor([0.002, 0.01, 0.03], dtype=F64),
                                  NE19, TE, dt_s=5e-5, n_steps=500)
    assert np.all(np.diff(as_np(sweep.assimilated_particles)) > 0.0)

    _, summary = ts.run_spi_injection(CFG, gen(5), NE19, TE, dt_s=5e-5, n_steps=600)
    _, base = run_disruption_sequence(DisruptionParams(), dtype=F64, device="cpu")
    _, mitig = run_disruption_sequence(DisruptionParams(),
                                       spi_ne20_injected=float(summary.delta_ne20_volavg),
                                       spi_time_ms=0.3, dtype=F64, device="cpu")
    assert float(mitig.i_re_final_ma) <= float(base.i_re_final_ma) + 1e-9

    t1, _ = ts.run_spi_injection(CFG, gen(6), NE19, TE, n_steps=100)
    t2, _ = ts.run_spi_injection(CFG, gen(6), NE19, TE, n_steps=100)
    assert torch.equal(t1.mass_total_kg, t2.mass_total_kg)


def test_config_validation_and_default_device():
    for kw in (dict(n_fragments=0), dict(total_mass_kg=-1.0), dict(dispersion=-0.1)):
        with pytest.raises(ValueError):
            ts.SpiConfig(**kw)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            ts.spi_init(CFG)
