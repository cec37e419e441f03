"""Port parity: the stress-test campaign (``control/stress.py``).

JAX's threefry bits cannot be reproduced, so the test rebuilds JAX's own
draws by the same key splits as ``stress.py:75, 94-105, 135`` (a key a shot,
a key a tick, three keys a tick: ``u``, the ELM amplitude, two noise
normals) and feeds them to the port's ``_run_stress_campaign``: 8 shots of
250 ticks at 1 kHz, in float64 and float32, on the default disturbances and
on ELMs strong enough to disrupt some shots (JAX's jitted campaign runs
float32 only, as its ``dtype`` is not a static argument: the float64
reference is the unjitted function).  ``u`` comes in float64 as JAX
draws it with x64 on.  Per-shot disruption flags equal; the other results
within 1e-12 in float64 and 1e-5 in float32 (XLA's float32 ``sin`` of the
ramp drift and its summation order differ from PyTorch's in the last bits).
The public campaign draws from a ``torch.Generator``: seeded, it repeats.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.control import flight_sim as jf
from scpn_fusion_tpu.control import stress as js
from scpn_fusion_tpu_torch.control import flight_sim as tf
from scpn_fusion_tpu_torch.control import stress as ts

N_SHOTS = 8
PARAMS = dict(control_hz=1000.0, shot_duration_s=0.25)
CONFIGS = {"default": {}, "strong_elms": dict(elm_rate_hz=10.0, elm_kick_m=0.6)}


def jax_draws(n_shots: int, n: int, seed: int, dtype) -> np.ndarray:
    """(n, P, 4) float64: JAX's u (float64 under x64), ELM amplitude and
    noise (in ``dtype``, widened exactly), from the campaign's key splits."""
    def shot(key):
        def tick(kk):
            k1, k2, k3 = jax.random.split(kk, 3)
            return (jax.random.uniform(k1), jax.random.normal(k2, dtype=dtype),
                    jax.random.normal(k3, (2,), dtype))
        return jax.vmap(tick)(jax.random.split(key, n))

    u, amp, noise = jax.vmap(shot)(jax.random.split(jax.random.PRNGKey(seed), n_shots))
    assert u.dtype == jnp.float64
    d = np.concatenate([np.asarray(u, np.float64)[..., None],
                        np.asarray(amp, np.float64)[..., None], np.asarray(noise, np.float64)],
                       axis=-1)
    return d.transpose(1, 0, 2).copy()


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_campaign_on_jax_draws(config, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    jparams = jf.FlightSimParams(**PARAMS)
    tparams = tf.FlightSimParams(**dataclasses.asdict(jparams))
    jcfg = js.StressConfig(**CONFIGS[config])
    tcfg = ts.StressConfig(**dataclasses.asdict(jcfg))
    if dtype == "float32":
        ref = js.run_stress_campaign(jparams, jcfg, n_shots=N_SHOTS, seed=3)
    else:   # its jit does not take dtype as static: the unjitted function
        ref = js.run_stress_campaign.__wrapped__(jparams, jcfg, n_shots=N_SHOTS, seed=3,
                                                 dtype=jdt)
    draws = torch.from_numpy(jax_draws(N_SHOTS, jparams.n_steps, 3, jdt))
    ours = ts._run_stress_campaign(tparams, tcfg, draws, dtype=tdt)
    assert torch.equal(ours.per_shot_disrupted,
                       torch.from_numpy(np.array(ref.per_shot_disrupted)))
    if config == "strong_elms":
        assert 0 < int(ours.per_shot_disrupted.sum()) < N_SHOTS
    else:
        assert not bool(ours.per_shot_disrupted.any())
    for name in ref._fields[:-1]:
        a, b = as_np(getattr(ours, name)), as_np(getattr(ref, name))
        assert getattr(ours, name).dtype == tdt and a.shape == b.shape == ()
        assert abs(float(a) - float(b)) <= tol * max(abs(float(b)), 1e-3), name


def test_public_campaign_draws_from_a_generator():
    params = tf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.05)
    runs = [ts.run_stress_campaign(params, n_shots=4, seed=s, dtype=torch.float64,
                                   device="cpu") for s in (1, 1, 2)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0].r_err_p95, runs[2].r_err_p95)
    d = ts.stress_draws(50, 4, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    assert d.shape == (50, 4, 4) and bool(((d[..., 0] >= 0) & (d[..., 0] < 1)).all())
    again = ts._run_stress_campaign(params, ts.StressConfig(), d, dtype=torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


def test_default_device_is_the_card():
    params = tf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.002)
    if torch.cuda.is_available():
        assert ts.run_stress_campaign(params, n_shots=2).per_shot_disrupted.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ts.run_stress_campaign(params, n_shots=2)
