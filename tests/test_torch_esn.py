"""Port parity: the echo-state-network oracle (``models/surrogates/esn.py``).

In float64: the power-iteration spectral radius within 1e-10 of JAX's;
``_init_esn`` on JAX's draws (``split(key, 3)``: the input and reservoir
uniforms in [-1, 1), the mask's uniforms) within 1e-12 of ``init_esn``; the
harvested states, ``train_readout`` and ``fit_esn`` on the sine case of
``tests/test_drift_wave_esn.py`` within 1e-9, and its closed-loop rollout
within 1e-8 (periodic, so rounding does not grow).  The sine lane's gate
(horizon > 50) depends on the reservoir's draw in both packages, so the
port meets it in float32 on the JAX test's draw.  The drift-wave oracle is
chaotic: the port's own run is held to the JAX test's gates (a finite
horizon within its window, one-step relative error < 0.5), not to JAX's
trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, rng

from scpn_fusion_tpu.models.surrogates import esn as je
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.physics import drift_wave as tdw
from scpn_fusion_tpu_torch.models.surrogates import esn as te

F64 = torch.float64


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_init_draws(key, input_dim: int, reservoir: int, dtype=jnp.float64):
    """The draws ``init_esn`` makes from ``key``: w_in, w, the mask's uniforms."""
    k_in, k_res, k_mask = jax.random.split(key, 3)
    w_in = jax.random.uniform(k_in, (reservoir, input_dim), dtype, minval=-1.0, maxval=1.0)
    w = jax.random.uniform(k_res, (reservoir, reservoir), dtype, minval=-1.0, maxval=1.0)
    return t(w_in), t(w), t(jax.random.uniform(k_mask, (reservoir, reservoir), dtype))


def _sine():
    tt = np.linspace(0.0, 40.0, 800)
    return np.stack([np.sin(tt), np.sin(0.5 * tt + 0.3)], axis=1)


def test_spectral_radius_and_init_match_jax():
    a = rng(1).standard_normal((60, 60)) * (rng(2).random((60, 60)) < 0.2)
    assert rel(te._spectral_radius(torch.from_numpy(a)), je._spectral_radius(jnp.asarray(a))) \
        <= 1e-10
    key = jax.random.PRNGKey(3)
    ref = je.init_esn(key, 4, reservoir_size=100, spectral_radius=0.9, dtype=jnp.float64)
    got = te._init_esn(*jax_init_draws(key, 4, 100), 0.9)
    assert rel(got.w_in, ref.w_in) <= 1e-12 and rel(got.w_res, ref.w_res) <= 1e-12
    eig = np.max(np.abs(np.linalg.eigvals(got.w_res.numpy())))
    assert eig == pytest.approx(0.9, rel=0.05)


def test_sine_fit_and_rollout_match_jax():
    u = _sine()
    key = jax.random.PRNGKey(5)
    p_ref = je.init_esn(key, 2, reservoir_size=300, dtype=jnp.float64)
    r_ref, x_ref = je.fit_esn(p_ref, jnp.asarray(u[:600]), jnp.asarray(u[1:601]), reg=1e-2)
    preds_ref = je.predict_closed_loop(p_ref, r_ref, x_ref, jnp.asarray(u[600]), steps=100)

    params = interop.esn_params(p_ref, device="cpu")
    states = te.harvest_states(params, t(u[:600]))
    assert rel(states, je.harvest_states(p_ref, jnp.asarray(u[:600]))) <= 1e-9
    readout = te.train_readout(states, t(u[1:601]), 1e-2)
    r_fit, x_last = te.fit_esn(params, t(u[:600]), t(u[1:601]), reg=1e-2)
    assert rel(readout.w_out, r_ref.w_out) <= 1e-9 and torch.equal(r_fit.w_out, readout.w_out)
    assert rel(x_last, x_ref) <= 1e-9
    preds = te.predict_closed_loop(params, readout, x_last, t(u[600]), steps=100)
    assert rel(preds, preds_ref) <= 1e-8
    horizon, mse = te.trust_horizon(t(u[601:701]), preds)
    h_ref, mse_ref = je.trust_horizon(jnp.asarray(u[601:701]), preds_ref)
    assert int(horizon) == int(h_ref) > 50 and rel(mse, mse_ref) <= 1e-6


def test_trust_horizon_matches_jax():
    g = rng(6)
    truth = g.standard_normal((40, 3))
    pred = truth + np.linspace(0.0, 2.0, 40)[:, None] * g.standard_normal((40, 3))
    for p in (pred, truth):
        h, mse = te.trust_horizon(t(truth), t(p))
        h_ref, mse_ref = je.trust_horizon(jnp.asarray(truth), jnp.asarray(p))
        assert int(h) == int(h_ref) and np.allclose(mse.numpy(), np.asarray(mse_ref), rtol=1e-12)
    assert int(te.trust_horizon(t(truth), t(truth))[0]) == 40


def test_sine_lane_meets_the_jax_gate_on_its_draw():
    """``test_esn_closed_loop_horizon_on_sine`` on the port in float32, from
    the test's reservoir draw (``bench_config.ESN_SINE_JAX_INIT``, held here
    to JAX's): the gate (horizon > 50) depends on the draw in both packages."""
    from scpn_fusion_tpu_torch.bench_config import ESN_SINE_JAX_INIT

    w_in, w, mask_u = jax_init_draws(jax.random.PRNGKey(5), 2, 300, jnp.float32)
    with np.load(ESN_SINE_JAX_INIT) as f:
        w_in_f, w_f = f["w_in"], f["w_masked"]
    assert np.array_equal(w_in_f, w_in.numpy())
    assert np.array_equal(w_f, (w * (mask_u < 0.1)).numpy())
    ref = je.init_esn(jax.random.PRNGKey(5), 2, reservoir_size=300)
    params = te._init_esn(t(w_in_f), t(w_f), torch.zeros(w_f.shape))
    assert rel(params.w_res, ref.w_res) <= 1e-6
    u = t(_sine())
    readout, x_last = te.fit_esn(params, u[:600], u[1:601], reg=1e-2)
    preds = te.predict_closed_loop(params, readout, x_last, u[600], steps=100)
    horizon, mse = te.trust_horizon(u[601:701], preds)
    assert int(horizon) > 50 and mse.shape == (100,)


def test_port_one_step_fit():
    tt = torch.linspace(0.0, 20.0, 400, dtype=F64)
    v = torch.stack([torch.sin(tt), torch.cos(1.7 * tt)], dim=1)
    p2 = te.init_esn(torch.Generator().manual_seed(4), 2, reservoir_size=200, dtype=F64,
                     device="cpu")
    r2, _ = te.fit_esn(p2, v[:-1], v[1:])
    pred = te.harvest_states(p2, v[:-1]) @ r2.w_out.T
    assert float(torch.linalg.norm(pred - v[1:]) / torch.linalg.norm(v[1:])) < 0.05


def test_drift_wave_oracle_meets_the_jax_gates():
    """``test_oracle_end_to_end_on_drift_wave``'s lane on the port: 32^2, 16
    probes, warm-up 200, 500 steps, reservoir 300, 80-step horizon."""
    cfg = tdw.DriftWaveConfig(n=32)
    s = tdw.initial_state(torch.Generator().manual_seed(7), cfg, device="cpu")
    _, data = tdw.simulate_probes(s, cfg, tdw.default_probe_indices(cfg.n, 16, device="cpu"),
                                  warmup=200, steps=500)
    params = te.init_esn(torch.Generator().manual_seed(8), 16, reservoir_size=300, device="cpu")
    readout, x_last = te.fit_esn(params, data[:400], data[1:401])
    preds = te.predict_closed_loop(params, readout, x_last, data[400], steps=80)
    horizon, mse = te.trust_horizon(data[401:481], preds)
    assert 0 <= int(horizon) <= 80 and bool(torch.isfinite(mse).all())
    one_step = te.harvest_states(params, data[:400]) @ readout.w_out.T
    err = float(torch.linalg.norm(one_step - data[1:401]) / torch.linalg.norm(data[1:401]))
    assert err < 0.5, err


def test_interop_round_trip():
    p_ref = je.init_esn(jax.random.PRNGKey(0), 3, reservoir_size=20)
    r_ref = je.ESNReadout(w_out=jnp.ones((3, 20), jnp.float32))
    p = interop.esn_params(p_ref, device="cpu")
    r = interop.esn_readout(r_ref, device="cpu")
    assert p.w_in.dtype == torch.float32 and np.array_equal(p.w_res.numpy(),
                                                            np.asarray(p_ref.w_res))
    assert torch.equal(interop.esn_params(p, device="cpu").w_in, p.w_in)
    assert torch.equal(interop.esn_readout(r, device="cpu").w_out, r.w_out)


def test_default_device_is_the_card():
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    def call():
        return te.init_esn(torch.Generator().manual_seed(0), 2, reservoir_size=8).w_in

    if torch.cuda.is_available():
        assert call().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
