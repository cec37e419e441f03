"""Port parity: realtime twin ingest and SNN scenario planning
(``control/twin_ingest.py``).

In float64 on the CPU, fed JAX's draws: the emulated streams of both
machines, the chaos monkey, the risk channel and the masked linear-logit
risk and scenario plans are within 1e-9 of JAX (the sessions are in
``test_torch_twin_ingest_sessions.py``).  The planner's controller runs in
float32, as JAX's does, so a plan is held to JAX evaluated op by op
(``jax.disable_jit``): compiled, XLA rounds the float32 command of its scan
differently (one float32 ulp, ~7e-9 of the float64 risk), and the plan is
held to the compiled run within ``COMPILED_TOL`` as well.  The gates of
``tests/test_twin_ingest.py:25-135`` hold, the public functions draw from a
``torch.Generator`` and the entry points raise without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, rng

from scpn_fusion_tpu.control import twin_ingest as jti
from scpn_fusion_tpu_torch.control import twin_ingest as tti

TOL = 1e-9
COMPILED_TOL = 1e-6     # against JAX's compiled scan: its float32 command rounds apart
F64 = torch.float64


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_stream_noise(key, samples: int) -> torch.Tensor:
    """The stream's two normal channels as ``generate_emulated_stream`` draws them."""
    k1, k2 = jax.random.split(key)
    return _t(jnp.stack([jax.random.normal(k1, (samples,)), jax.random.normal(k2, (samples,))]))


def jax_chaos_draws(key, samples: int):
    kd, kn = jax.random.split(key)
    return _t(jax.random.uniform(kd, (4, samples))), _t(jax.random.normal(kn, (4, samples)))


def _same_stream(ours, ref):
    assert np.array_equal(ours.t_ms.numpy(), np.asarray(ref.t_ms))
    for field in ("ip_ma", "beta_n", "q95", "density_1e19"):
        assert rel(getattr(ours, field), getattr(ref, field)) <= TOL, field


@pytest.mark.parametrize("machine, samples", [("SPARC", 64), ("NSTX-U", 320)])
def test_stream_matches_jax(machine, samples):
    ref = jti.generate_emulated_stream(machine, samples=samples)
    ours = tti._emulated_stream(machine, jax_stream_noise(jax.random.PRNGKey(42), samples))
    _same_stream(ours, ref)


def test_chaos_matches_jax():
    ref_s = jti.generate_emulated_stream("NSTX-U", samples=128)
    ours_s = tti._emulated_stream("NSTX-U", jax_stream_noise(jax.random.PRNGKey(42), 128))
    key = jax.random.PRNGKey(2)
    ref, drops_j, noise_j = jti.apply_chaos_monkey(ref_s, key, dropout_prob=0.3, noise_std=5.0)
    ours, drops, noise = tti._apply_chaos_monkey(ours_s, *jax_chaos_draws(key, 128),
                                                 dropout_prob=0.3, noise_std=5.0)
    _same_stream(ours, ref)
    assert int(drops) == int(drops_j) and noise == int(noise_j) == 4 * 128
    assert float(ours.density_1e19.min()) >= 0.0
    assert rel(tti.risk_signal(ours), jti.risk_signal(ref)) <= TOL


def test_masked_risk_matches_jax():
    g = rng(5)
    for n_valid in (64, 40, 1):
        sig = g.uniform(0.3, 1.8, 64)
        mask = np.arange(64) >= 64 - n_valid
        tor = g.uniform(0.0, 0.2, 5)
        ref = jti.disruption_risk_masked(jnp.asarray(sig), jnp.asarray(mask), jnp.asarray(tor))
        ours = tti.disruption_risk_masked(torch.tensor(sig), torch.tensor(mask), torch.tensor(tor))
        assert rel(ours, ref) <= 1e-14


def test_risk_gates():
    mask = torch.ones(64, dtype=torch.bool)
    tor = torch.zeros(5, dtype=F64)
    r_calm = float(tti.disruption_risk_masked(torch.full((64,), 0.45, dtype=F64), mask, tor))
    r_hot = float(tti.disruption_risk_masked(torch.linspace(0.45, 1.6, 64, dtype=F64), mask, tor))
    assert 0.0 < r_calm < r_hot < 1.0
    sig = torch.cat([torch.full((32,), 99.0, dtype=F64), torch.full((32,), 0.5, dtype=F64)])
    half = torch.cat([torch.zeros(32, dtype=torch.bool), torch.ones(32, dtype=torch.bool)])
    r = float(tti.disruption_risk_masked(sig, half, tor))
    r_clean = float(tti.disruption_risk_masked(torch.full((64,), 0.5, dtype=F64), mask, tor))
    assert abs(r - r_clean) < 1e-6


@pytest.mark.parametrize("hot", [False, True])
def test_scenario_plan_matches_jax(hot):
    ctrl_j, cfg_j = jti.build_snn_planner()
    ctrl_t, cfg_t = tti.build_snn_planner(device="cpu")
    hist = np.linspace(0.45, 1.4, 64) if hot else np.full(64, 0.45)
    mask = np.arange(64) >= (20 if hot else 0)
    point = (2.3, 3.6, 9.1) if hot else (1.65, 3.9, 8.2)
    with jax.disable_jit():
        ref = jti.scenario_plan(ctrl_j, cfg_j, jnp.asarray(hist), jnp.asarray(mask), *point,
                                horizon=24)
    compiled = jti.scenario_plan(ctrl_j, cfg_j, jnp.asarray(hist), jnp.asarray(mask), *point,
                                 horizon=24)
    ours = tti.scenario_plan(ctrl_t, cfg_t, torch.tensor(hist), torch.tensor(mask), *point,
                             horizon=24)
    for field in ("safe_horizon_rate", "mean_risk", "recommended_action"):
        assert rel(getattr(ours, field), getattr(ref, field)) <= TOL, field
        assert rel(getattr(ours, field), getattr(compiled, field)) <= COMPILED_TOL, field
    assert bool(ours.passes) == bool(ref.passes) == bool(compiled.passes)
    assert ours.recommended_action.dtype == torch.float32
    if not hot:
        assert bool(ours.passes) and float(ours.mean_risk) <= 0.75
        assert abs(float(ours.recommended_action)) <= 0.8
    with pytest.raises(ValueError):
        tti.scenario_plan(ctrl_t, cfg_t, torch.tensor(hist), torch.tensor(mask), *point,
                          horizon=2)


def test_public_functions_draw_from_a_generator():
    s1 = tti.generate_emulated_stream("SPARC", samples=64, device="cpu")
    s2 = tti.generate_emulated_stream("sparc ", samples=64, device="cpu")
    assert torch.equal(s1.beta_n, s2.beta_n) and s1.beta_n.shape == (64,)
    burst = tti.generate_emulated_stream("NSTX-U", samples=320, device="cpu").beta_n.numpy()
    phase = np.arange(320) / 319.0
    in_burst = (phase >= 0.60) & (phase <= 0.74)
    assert burst[in_burst].max() > burst[~in_burst].max()
    out, drops, noise = tti.apply_chaos_monkey(s1, torch.Generator().manual_seed(0))
    assert torch.equal(out.beta_n, s1.beta_n) and int(drops) == 0 and noise == 0
    out, drops, _ = tti.apply_chaos_monkey(
        tti.generate_emulated_stream("SPARC", samples=128, device="cpu"),
        torch.Generator().manual_seed(1), dropout_prob=0.5)
    assert 50 < int(drops) < 4 * 128 and int((out.ip_ma == 0.0).sum()) > 0
    a = tti.run_realtime_twin_session("SPARC", samples=96, plan_every=32, horizon=8,
                                      device="cpu")
    b = tti.run_realtime_twin_session("SPARC", samples=96, plan_every=32, horizon=8,
                                      device="cpu")
    assert torch.equal(a[0].mean_risk, b[0].mean_risk)
    with pytest.raises(ValueError):
        tti.generate_emulated_stream("ITER", device="cpu")
    with pytest.raises(ValueError):
        tti.generate_emulated_stream("SPARC", samples=8, device="cpu")


def test_entry_points_default_to_the_card():
    calls = (lambda: tti.generate_emulated_stream("SPARC", samples=64),
             lambda: tti.run_realtime_twin_session("SPARC", samples=64, plan_every=32,
                                                   horizon=4),
             lambda: tti.build_snn_planner())
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
