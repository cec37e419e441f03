"""Port parity: the disturbance-rejection ladder
(``control/disturbance_ladder.py``).

Float64.  The scenarios' disturbance traces (lengths from the same
``np.arange``) and initial states equal JAX's; the plant; the DARE gain
(2000 Riccati iterations) and the H-inf design (3000 RK4 steps) within
1e-9; ``_metrics`` on a trace that crosses its band (the settling index
equal); ``run_mpc`` on the density ramp (40,000 ticks) against JAX: the z
trace within 1e-9, the settling time equal.  The whole ladder on one
scenario is ``test_torch_disturbance_ladder_elm.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import disturbance_ladder as jl
from scpn_fusion_tpu.control import hinf as jh
from scpn_fusion_tpu_torch.control import disturbance_ladder as tl

F64 = torch.float64


@pytest.mark.parametrize("scenario", ["VDE", "density_ramp", "elm_pacing"])
def test_scenarios_equal_jax(scenario):
    d_t = tl.disturbance_trace(scenario, F64, "cpu")
    d_j = np.asarray(jl.disturbance_trace(scenario, jnp.float64))
    assert d_t.shape == d_j.shape and np.array_equal(d_t.numpy(), d_j)
    assert np.array_equal(tl.initial_state(scenario, F64, "cpu").numpy(),
                          np.asarray(jl.initial_state(scenario, jnp.float64)))
    assert d_t.shape[0] == {"VDE": 20_000, "density_ramp": 40_000, "elm_pacing": 30_000}[scenario]
    with pytest.raises(ValueError, match="unknown scenario"):
        tl.disturbance_trace("tornado", F64, "cpu")


def test_designs_match_jax():
    for a, b in zip(tl.plant_matrices(dtype=F64, device="cpu"),
                    jl.plant_matrices(dtype=jnp.float64)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    a, b, _ = jl.plant_matrices(dtype=jnp.float64)
    a_d = jnp.eye(2, dtype=jnp.float64) + jl.DT * a
    k_ref = jl._dare_gain(a_d, jl.DT * b, jnp.asarray([[1.0, 0.0], [0.0, 1e-4]]),
                          jnp.asarray(1e-9, jnp.float64))
    assert rel(tl.mpc_gain(F64, "cpu"), k_ref) <= 1e-9
    g = jl.GAMMA_GROWTH
    a_s = jnp.asarray([[0.0, 1.0], [1.0, -10.0 / g]])
    ref = jh.synthesize_hinf(a_s, jnp.asarray([[0.0], [0.5 / (g * g)]]),
                             jnp.asarray([[0.0], [1.0 / (g * g)]]),
                             jnp.asarray([[1.0, 0.0], [0.0, 0.1]]), jnp.asarray([[1.0, 0.0]]),
                             jnp.asarray(8.0), riccati_steps=3000, riccati_dt=0.01)
    ours = tl.hinf_gains(8.0, F64, "cpu")
    assert rel(ours.f, ref.f) <= 1e-9 and rel(ours.l, ref.l) <= 1e-9


def test_metrics_match_jax():
    t = np.arange(400) * 1e-4
    z = 0.01 * np.exp(-t / 0.004) * np.cos(900 * t)
    u = np.sin(t)
    ours, ref = tl._metrics(torch.from_numpy(z), torch.from_numpy(u)), jl._metrics(
        jnp.asarray(z), jnp.asarray(u))
    for f in ("ise", "overshoot", "control_effort", "settling_time_s"):
        assert rel(getattr(ours, f), getattr(ref, f)) <= 1e-12, f
    assert 0.0 < float(ours.settling_time_s) < 0.04 and bool(ours.stable)


def test_mpc_density_ramp_matches_jax():
    ours = tl.run_mpc("density_ramp", dtype=F64, device="cpu")
    ref = jl.run_mpc("density_ramp", dtype=jnp.float64)
    assert rel(ours.z_trace, ref.z_trace) <= 1e-9
    assert float(ours.settling_time_s) == float(ref.settling_time_s)
