"""Port parity: whole realtime twin sessions (``control/twin_ingest.py``).

In float64 on the CPU, fed JAX's draws, the default SPARC and NSTX-U
sessions (39 plan points x 24 horizon ticks, the plan points one batch) are
within 1e-9 of JAX evaluated op by op (``jax.disable_jit``; see
``test_torch_twin_ingest.py`` on the planner's float32 command), and every
session -- those two, the JAX tests' smaller one and the chaotic one --
within ``COMPILED_TOL`` of JAX's compiled session, with equal pass flags,
plan counts and chaos counts, and the gates of
``tests/test_twin_ingest.py:107-135``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_twin_ingest import COMPILED_TOL, TOL, jax_chaos_draws, jax_stream_noise
from torch_parity import rel

from scpn_fusion_tpu.control import twin_ingest as jti
from scpn_fusion_tpu_torch.control import twin_ingest as tti

SESSIONS = {
    "sparc_default": ("SPARC", dict()),
    "nstxu_default": ("NSTX-U", dict()),
    "sparc_small": ("SPARC", dict(samples=128, plan_every=16, horizon=16)),
    "sparc_chaos": ("SPARC", dict(samples=96, plan_every=24, horizon=8,
                                  chaos_dropout_prob=0.2, chaos_noise_std=0.01)),
}


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_matches_jax_with_its_draws(name):
    machine, kw = SESSIONS[name]
    samples = kw.get("samples", 320)
    key = jax.random.PRNGKey(42)
    plans_c, info_c = jti.run_realtime_twin_session(machine, **kw)
    if name.endswith("default"):
        with jax.disable_jit():
            plans_j, info_j = jti.run_realtime_twin_session(machine, **kw)
    else:
        plans_j, info_j = plans_c, info_c
    tol = TOL if name.endswith("default") else COMPILED_TOL
    draws = (jax_stream_noise(key, samples), *jax_chaos_draws(jax.random.fold_in(key, 2026),
                                                              samples))
    run_kw = {k: v for k, v in kw.items() if k != "samples"}
    plans, info = tti._run_realtime_twin_session(machine, *draws, **run_kw)
    for field in ("safe_horizon_rate", "mean_risk", "recommended_action"):
        assert rel(getattr(plans, field), getattr(plans_j, field)) <= tol, field
        assert rel(getattr(plans, field), getattr(plans_c, field)) <= COMPILED_TOL, field
    assert np.array_equal(plans.passes.numpy(), np.asarray(plans_j.passes))
    assert np.array_equal(plans.passes.numpy(), np.asarray(plans_c.passes))
    assert info["n_plans"] == int(info_j["n_plans"])
    assert int(info["chaos_dropouts"]) == int(info_j["chaos_dropouts"])
    assert info["chaos_noise_injections"] == int(info_j["chaos_noise_injections"])
    for key_ in ("all_pass_rate", "worst_mean_risk", "min_safe_horizon_rate"):
        assert rel(info[key_], info_j[key_]) <= tol, key_
    if name == "sparc_small":
        assert info["n_plans"] == 7 and float(info["all_pass_rate"]) == 1.0
        assert int(info["chaos_dropouts"]) == 0
    if name == "sparc_chaos":
        assert int(info["chaos_dropouts"]) > 0 and info["chaos_noise_injections"] == 4 * 96
    if name == "nstxu_default":
        assert bool(torch.isfinite(plans.mean_risk).all())
        assert float(info["worst_mean_risk"]) <= 1.0
    if name == "sparc_default":
        assert info["n_plans"] == 39 and float(info["all_pass_rate"]) == 1.0
