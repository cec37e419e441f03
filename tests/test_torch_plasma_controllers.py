"""Port parity: the physics-facing controllers
(``control/plasma_controllers.py``) and the stellarator control contracts
(``control/stellarator_contracts.py``).

In float64 on the CPU the density, burn and detachment controllers (single
steps and closed loops, the NaN fail-safe included), the 200-tick
detachment loop, ``sensor_vote`` (an odd and an even count of finite
readings: ``jnp.nanmedian`` averages the middle pair, ``torch.nanmedian``
would take the lower one) and ``reallocate_actuators`` are within 1e-9 of
JAX; the gates of ``tests/test_plasma_controllers.py`` and the contract
gates of ``tests/test_equilibrium_3d.py:171-208`` hold for the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import plasma_controllers as jpc
from scpn_fusion_tpu.control import stellarator_contracts as jsc
from scpn_fusion_tpu_torch.control import plasma_controllers as tpc
from scpn_fusion_tpu_torch.control import stellarator_contracts as tsc

TOL = 1e-9
F64 = torch.float64


def t(x):
    return torch.tensor(x, dtype=F64)


def test_density_loop_matches_jax():
    pj, pt = jpc.DensityControllerParams(), tpc.DensityControllerParams()
    sj, st = jpc.DensityControllerState(jnp.asarray(0.0)), tpc.DensityControllerState(t(0.0))
    nj, nt = jnp.asarray(2.0), t(2.0)
    for k in range(120):
        target = 8.0 if k < 80 else 20.0
        sj, puff_j = jpc.density_controller_step(pj, sj, nj, target, 2.0, 1.0, 0.05)
        st, puff_t = tpc.density_controller_step(pt, st, nt, target, 2.0, 1.0, 0.05)
        nj, nt = jpc.density_plant_step(nj, puff_j, pj, 0.05), tpc.density_plant_step(nt, puff_t,
                                                                                      pt, 0.05)
        assert rel(puff_t, puff_j) <= TOL and rel(nt, nj) <= TOL
    _, puff = tpc.density_controller_step(pt, st, t(float("nan")), 8.0, 15.0, 2.0, 0.05)
    _, puff_j = jpc.density_controller_step(pj, sj, jnp.asarray(jnp.nan), 8.0, 15.0, 2.0, 0.05)
    assert rel(puff, puff_j) <= TOL and np.isfinite(float(puff))


def test_burn_loop_matches_jax():
    pj, pt = jpc.BurnControllerParams(p_aux_max_mw=50.0), tpc.BurnControllerParams(
        p_aux_max_mw=50.0)
    sj = jpc.BurnControllerState(jnp.asarray(0.0), jnp.asarray(0.0))
    st = tpc.BurnControllerState(t(0.0), t(0.0))
    temps = np.random.default_rng(4).uniform(1.0, 25.0, 80)
    for k, temp in enumerate(temps):
        target = 20.0 if k % 30 else float("nan")
        sj, cj = jpc.burn_controller_step(pj, sj, temp, target, 0.1)
        st, ct = tpc.burn_controller_step(pt, st, temp, target, 0.1)
        assert rel(ct, cj) <= TOL and rel(st.integral, sj.integral) <= TOL


@pytest.mark.parametrize("p_sol, n_u, q_target, n_steps", [(100.0, 3.0, 5.0, 200),
                                                           (5.0, 3.0, 50.0, 200),
                                                           (60.0, 8.0, 3.0, 120)])
def test_detachment_loop_matches_jax(p_sol, n_u, q_target, n_steps):
    pj = jpc.DetachmentControllerParams(q_target_mw_m2=q_target)
    pt = tpc.DetachmentControllerParams(q_target_mw_m2=q_target)
    fj, frj, qj = jpc.run_detachment_loop(pj, p_sol_mw=p_sol, n_u_19=n_u, n_steps=n_steps)
    ft, frt, qt = tpc.run_detachment_loop(pt, p_sol_mw=p_sol, n_u_19=n_u, n_steps=n_steps,
                                          dtype=F64, device="cpu")
    assert rel(frt, frj) <= TOL and rel(qt, qj) <= TOL
    assert rel(ft.f_rad, fj.f_rad) <= TOL and rel(ft.integral, fj.integral) <= TOL


@pytest.mark.parametrize("readings", [
    [1.0, 1.05, 0.97, 50.0, np.nan],               # four finite: an even count
    [1.0, 1.05, 0.97, 50.0, np.nan, 1.2],          # five finite
    [np.nan, np.nan, 1.0],
    [np.nan, np.nan, np.nan],
    [2.0, np.inf, 1.0, -np.inf, 3.0, 2.5],         # four finite, infinities dropped
])
def test_sensor_vote_matches_jax(readings):
    r = np.asarray(readings, float)
    sigma = np.full(r.shape, 0.1)
    for p in (jpc.FaultToleranceParams(), jpc.FaultToleranceParams(min_healthy_sensors=4)):
        ref = jpc.sensor_vote(jnp.asarray(r), jnp.asarray(sigma), p)
        ours = tpc.sensor_vote(t(r), t(sigma), tpc.FaultToleranceParams(
            p.residual_threshold, p.min_healthy_sensors))
        assert np.array_equal(ours.healthy.numpy(), np.asarray(ref.healthy))
        assert bool(ours.degraded) == bool(ref.degraded)
        assert rel(ours.fused_estimate, ref.fused_estimate) <= 1e-15


@pytest.mark.parametrize("x", [[4.0, 1.0, np.nan, 2.0, 3.0],     # even: (2 + 3) / 2
                               [5.0, 1.0, 2.0, 3.0, 4.0, 7.0],    # even: (3 + 4) / 2
                               [3.0, np.nan, 1.0, 2.0],           # odd: 2
                               [np.nan, np.nan]])
def test_nanmedian_even_count_averages_the_middle_pair(x):
    ref = float(jnp.nanmedian(jnp.asarray(x)))
    ours = float(tpc.nanmedian(t(x)))
    assert ours == ref or (np.isnan(ours) and np.isnan(ref))
    finite = np.sort(np.asarray(x)[~np.isnan(x)])
    if finite.size and finite.size % 2 == 0:
        k = finite.size // 2
        assert ours == 0.5 * (finite[k - 1] + finite[k])
        assert ours != float(torch.nanmedian(t(x)))    # torch's lower middle value


def test_reallocation_matches_jax():
    g = np.random.default_rng(7)
    for _ in range(4):
        avail, eff = g.uniform(size=5) > 0.3, g.uniform(-0.5, 3.0, 5)
        ref = jpc.reallocate_actuators(jnp.asarray(10.0), jnp.asarray(avail), jnp.asarray(eff))
        ours = tpc.reallocate_actuators(t(10.0), torch.tensor(avail), t(eff))
        assert rel(ours, ref) <= 1e-15


class TestGates:
    """``tests/test_plasma_controllers.py``'s gates on the port."""

    def test_tracks_target_in_closed_loop(self):
        p = tpc.DensityControllerParams()
        state, ne = tpc.DensityControllerState(t(0.0)), t(2.0)
        for _ in range(400):
            state, puff = tpc.density_controller_step(p, state, ne, 8.0, ip_ma=15.0, a_m=2.0,
                                                      dt=0.05)
            ne = tpc.density_plant_step(ne, puff, p, 0.05)
        assert float(ne) == pytest.approx(8.0, abs=0.5)

    def test_greenwald_ceiling_caps_target(self):
        p = tpc.DensityControllerParams(greenwald_fraction_max=0.85)
        state, ne = tpc.DensityControllerState(t(0.0)), t(2.0)
        for _ in range(600):
            state, puff = tpc.density_controller_step(p, state, ne, 20.0, ip_ma=2.0, a_m=1.0,
                                                      dt=0.05)
            ne = tpc.density_plant_step(ne, puff, p, 0.05)
        assert float(ne) < 0.9 * 10.0 * 2.0 / np.pi

    def test_slew_limit(self):
        p = tpc.BurnControllerParams(slew_mw_s=20.0)
        state = tpc.BurnControllerState(t(0.0), t(0.0))
        state, cmd = tpc.burn_controller_step(p, state, 5.0, 20.0, dt=0.1)
        assert float(cmd) <= 2.0 + 1e-6

    def test_saturation_and_antiwindup(self):
        p = tpc.BurnControllerParams(p_aux_max_mw=50.0)
        state = tpc.BurnControllerState(t(0.0), t(50.0))
        for _ in range(100):
            state, cmd = tpc.burn_controller_step(p, state, 1.0, 30.0, dt=0.1)
        assert float(cmd) == pytest.approx(50.0)
        assert float(state.integral) < 1.0

    def test_seeding_brings_flux_to_target(self):
        p = tpc.DetachmentControllerParams(q_target_mw_m2=5.0)
        final, _, q_tr = tpc.run_detachment_loop(p, p_sol_mw=100.0, n_u_19=3.0, n_steps=600,
                                                 dtype=F64, device="cpu")
        assert float(q_tr[-1]) == pytest.approx(5.0, rel=0.2)
        assert 0.0 < float(final.f_rad) < 1.0
        assert float(q_tr[0]) > float(q_tr[-1])

    def test_low_power_needs_no_seeding(self):
        p = tpc.DetachmentControllerParams(q_target_mw_m2=50.0)
        final, _, _ = tpc.run_detachment_loop(p, p_sol_mw=5.0, n_u_19=3.0, n_steps=200,
                                              dtype=F64, device="cpu")
        assert float(final.f_rad) < 0.05

    def test_outlier_and_nan_flagged(self):
        rep = tpc.sensor_vote(t([1.0, 1.05, 0.97, 50.0, np.nan]), torch.full((5,), 0.1,
                                                                              dtype=F64))
        assert rep.healthy.tolist() == [True, True, True, False, False]
        assert float(rep.fused_estimate) == pytest.approx(1.0, abs=0.05)
        assert not bool(rep.degraded)

    def test_degraded_mode(self):
        rep = tpc.sensor_vote(t([np.nan, np.nan, 1.0]), torch.full((3,), 0.1, dtype=F64),
                              tpc.FaultToleranceParams(min_healthy_sensors=2))
        assert bool(rep.degraded)
        assert np.isfinite(float(rep.fused_estimate))

    def test_reallocation_preserves_total(self):
        alloc = tpc.reallocate_actuators(t(10.0), torch.tensor([True, False, True]),
                                         t([1.0, 1.0, 3.0])).numpy()
        assert alloc[1] == 0.0
        assert alloc.sum() == pytest.approx(10.0)
        assert alloc[2] == pytest.approx(3.0 * alloc[0])


def test_detachment_loop_needs_the_card():
    with pytest.raises((RuntimeError, AssertionError)):
        tpc.run_detachment_loop(tpc.DetachmentControllerParams(), p_sol_mw=5.0, n_u_19=3.0,
                                n_steps=2)


class TestContracts:
    """``tests/test_equilibrium_3d.py:171-208``'s contract gates on the port,
    and the clamp and slew against JAX."""

    def test_actuator_clamp_and_slew(self):
        ch = tsc.ActuatorChannel(name="trim_coil_1", unit="A", min_value=-100.0, max_value=100.0,
                                 max_slew_per_s=50.0)
        assert float(ch.clamp(250.0)) == 100.0
        out = ch.apply_slew(t(0.0), t(80.0), dt_s=0.1)
        assert float(out) == pytest.approx(5.0)
        jch = jsc.ActuatorChannel("trim_coil_1", "A", -100.0, 100.0, 50.0)
        g = np.random.default_rng(5)
        prev, req = g.uniform(-150, 150, 16), g.uniform(-150, 150, 16)
        assert rel(ch.apply_slew(t(prev), t(req), 0.7),
                   jch.apply_slew(jnp.asarray(prev), jnp.asarray(req), 0.7)) == 0.0
        assert rel(ch.clamp(t(req)), jch.clamp(jnp.asarray(req))) == 0.0
        with pytest.raises(ValueError, match="dt_s"):
            ch.apply_slew(t(0.0), t(1.0), dt_s=0.0)

    def test_actuator_set_unique_names(self):
        ch = tsc.ActuatorChannel("a", "A", -1.0, 1.0, 1.0)
        with pytest.raises(ValueError, match="unique"):
            tsc.ActuatorSet(channels=(ch, ch))
        assert tsc.ActuatorSet(channels=(ch,)).by_name("a") is ch

    def test_diagnostic_frame_validation(self):
        ch = tsc.DiagnosticChannel("iota_edge", "", 0.5, 1.5)
        frame = tsc.DiagnosticFrame(time_s=0.1, values=(("iota_edge", 2.0),))
        assert frame.validate_against((ch,)) == ["iota_edge"]

    def test_replay_scenario_round_trip(self):
        def build(m):
            return m.ReplayScenario(
                name="w7x-iota-hold",
                configuration=m.MagneticConfiguration("w7x-std", 5, 0.97, 0.05),
                actuators=m.ActuatorSet(channels=(
                    m.ActuatorChannel("trim_coil_1", "A", -100, 100, 50),)),
                diagnostics=(m.DiagnosticChannel("iota_edge", "", 0.5, 1.5),),
                objectives=(m.ControlObjective("iota_edge", 0.97, 0.02),))

        scenario = build(tsc)
        d = scenario.to_dict()
        assert d == build(jsc).to_dict()
        assert d["configuration"]["n_fp"] == 5
        assert float(scenario.objectives[0].normalised_error(t(0.99))) == pytest.approx(1.0)

    def test_objective_validation(self):
        with pytest.raises(ValueError, match="band"):
            tsc.ControlObjective("x", 1.0, 0.0)
        for bad in (dict(name=" "), dict(n_fp=0), dict(iota_edge=float("inf"))):
            with pytest.raises(ValueError):
                tsc.MagneticConfiguration(**{**dict(name="w", n_fp=5, iota_edge=1.0,
                                                    mirror_ratio=0.1), **bad})
