"""Port parity: the scenario machinery and the integrated shot
(``control/scenario.py``, ``models/physics/integrated_scenario.py``).

In float64 against JAX: Paschen breakdown, the Townsend avalanche, the
burn-through and the startup verdict; waveform interpolation (``jnp.interp``)
at seeded times inside, on and outside the breakpoints; the volt-second
budget and the consumption monitor; and the integrated shot on
``standard_shot_schedule()`` (840 ticks: L-H, dynamic burn, flux budget)
with every trace and the report within 1e-10 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rng

from scpn_fusion_tpu.control import scenario as js
from scpn_fusion_tpu.models.physics import integrated_scenario as jis
from scpn_fusion_tpu_torch.control import scenario as ts
from scpn_fusion_tpu_torch.models.physics import integrated_scenario as tis

CPU = dict(device="cpu")


def _close(ours, ref, tol=1e-10, what=""):
    a, b = as_np(ours), np.asarray(ref, np.float64)
    assert a.shape == b.shape, what
    assert np.array_equal(np.isfinite(a), np.isfinite(b)), what
    ok = np.isfinite(b)
    scale = max(float(np.max(np.abs(b[ok]), initial=0.0)), 1e-300)
    assert float(np.max(np.abs(a[ok] - b[ok]), initial=0.0)) <= tol * scale, what


def test_startup_physics_matches_jax():
    p = np.asarray([0.0, 1e-4, 3e-3, 0.05, 2.0])
    _close(ts.paschen_breakdown_voltage(torch.tensor(p)), js.paschen_breakdown_voltage(
        jnp.asarray(p)), what="paschen")
    assert ts.optimal_prefill_pressure() == pytest.approx(js.optimal_prefill_pressure(),
                                                          rel=1e-15)
    kw = dict(v_loop=10.0, p_pa=5e-3, r0_m=6.2)
    for a, b, what in zip(ts.townsend_avalanche(**kw, **CPU), js.townsend_avalanche(**kw),
                          js.AvalancheTrace._fields):
        _close(a, b, what=what)
    kw_bt = dict(v_loop=10.0, r0_m=6.2, a_m=2.0)
    for a, b, what in zip(ts.burn_through(**kw_bt, **CPU), js.burn_through(**kw_bt),
                          js.BurnThroughTrace._fields):
        _close(a, b, what=what)
    kw_su = dict(v_loop=12.0, p_pa=5e-3, r0_m=6.2, a_m=2.0)
    for a, b, what in zip(ts.run_startup_sequence(**kw_su, **CPU),
                          js.run_startup_sequence(**kw_su), js.StartupResult._fields):
        _close(a, b, what=what)


def test_waveforms_and_budget_match_jax():
    j_sched, t_sched = js.standard_shot_schedule(), ts.standard_shot_schedule()
    times = np.concatenate([rng(1).uniform(-10.0, 450.0, 64),
                            np.asarray([0.0, 60.0, 150.0, 360.0, 420.0])])
    ref, ours = j_sched.evaluate(jnp.asarray(times)), t_sched.evaluate(torch.tensor(times))
    for name in ref:
        _close(ours[name], ref[name], tol=1e-15, what=name)
    assert t_sched.duration == j_sched.duration and t_sched.validate() == j_sched.validate()
    budget_kw = dict(phi_cs_vs=280.0, l_plasma_uh=7.0, r0_m=6.2)
    jb, tb = js.FluxBudget(**budget_kw), ts.FluxBudget(**budget_kw)
    ip = torch.tensor([0.5, 8.0, 15.0], dtype=torch.float64)
    for name in ("inductive_flux", "resistive_flux", "remaining_flux"):
        _close(getattr(tb, name)(ip), getattr(jb, name)(jnp.asarray(ip.numpy())), what=name)
    _close(tb.max_flattop_duration(ip, torch.tensor(0.08, dtype=torch.float64), 0.3),
           jb.max_flattop_duration(jnp.asarray(ip.numpy()), 0.08, 0.3))
    t = np.linspace(0.0, 400.0, 81)
    ip_t, v = 15.0 * np.minimum(t / 60.0, 1.0), 0.5 + 0.01 * t
    for a, b, what in zip(ts.monitor_flux_consumption(tb, torch.tensor(t), torch.tensor(ip_t),
                                                      torch.tensor(v)),
                          js.monitor_flux_consumption(jb, jnp.asarray(t), jnp.asarray(ip_t),
                                                      jnp.asarray(v)),
                          js.FluxConsumptionTrace._fields):
        _close(a, b, what=what)


@pytest.mark.parametrize("phi_cs_vs", [280.0, 105.0])
def test_integrated_shot_matches_jax(phi_cs_vs):
    """The standard shot; at 105 V s the budget runs out."""
    budget = dict(phi_cs_vs=phi_cs_vs, l_plasma_uh=7.0, r0_m=6.2)
    j_tr, j_rep = jis.run_shot(js.standard_shot_schedule(), js.FluxBudget(**budget))
    t_tr, t_rep = tis.run_shot(ts.standard_shot_schedule(), ts.FluxBudget(**budget), **CPU)
    assert t_tr.t_s.shape == (840,)
    for name in j_tr._fields:
        _close(getattr(t_tr, name), getattr(j_tr, name), what=name)
    for name in j_rep._fields:
        _close(getattr(t_rep, name), getattr(j_rep, name), what=name)
    assert bool(t_rep.flux_exhausted) == (phi_cs_vs < 200.0)
    assert dataclasses.asdict(tis.ScenarioMachine()) == dataclasses.asdict(jis.ScenarioMachine())


def test_default_device_is_the_card():
    """With no ``device`` the shot and the startup physics run on CUDA;
    without a card they raise instead of falling back to the CPU."""
    budget = ts.FluxBudget(phi_cs_vs=280.0, l_plasma_uh=7.0)
    calls = (lambda: tis.run_shot(ts.standard_shot_schedule(flattop_s=1.0, ramp_s=1.0), budget),
             lambda: ts.burn_through(v_loop=10.0, r0_m=6.2, a_m=2.0, n_steps=2))
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
