"""Port parity: the shot replay pipeline (``control/replay.py``).

Float64.  The JAX test's shot library and a JAX-trained predictor (its
weights carried across with ``interop.mlp_params``): the resampling, the
median prefilter (with a NaN in a window), the robust clip (NaN and
outliers) and the actuator lag within 1e-12; ``replay_shot`` on a disruptive
and on a safe shot, with the default command and with a two-column one: the
risk and the lagged commands within 1e-9, the latched alarm, the trip and
the warning time equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.control import disruption as jd
from scpn_fusion_tpu.control import replay as jr
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import disruption as td
from scpn_fusion_tpu_torch.control import replay as tr


def _make_shots(n=24, t_len=128, c=2, seed=0):
    """The JAX test's library: disruptive shots ramp channel 0 at the end."""
    rng = np.random.default_rng(seed)
    shots = rng.standard_normal((n, t_len, c)) * 0.1
    labels = (np.arange(n) % 2).astype(float)
    ramp = np.linspace(0, 3.0, 40)
    for i in range(n):
        if labels[i] > 0.5:
            shots[i, -40:, 0] += ramp
    return shots, labels


@pytest.fixture(scope="module")
def predictors():
    shots, labels = _make_shots()
    ref = jd.train_disruption_predictor(jnp.asarray(shots), jnp.asarray(labels),
                                        jax.random.PRNGKey(0), window=16, n_steps=300)
    ours = td.DisruptionPredictor(interop.mlp_params(ref.mlp, device="cpu"),
                                  torch.from_numpy(np.array(ref.x_mean)),
                                  torch.from_numpy(np.array(ref.x_std)), ref.window)
    return ref, ours


def test_preprocessing_matches_jax():
    t = np.linspace(0.0, 0.1, 37)
    x = np.sin(40 * t) + 0.01 * np.arange(37)
    x[9] = 50.0
    cfg = jr.ReplayConfig()
    assert rel(tr.resample_to_control_grid(torch.from_numpy(t), torch.from_numpy(x), 1e-3, 120),
                jr.resample_to_control_grid(jnp.asarray(t), jnp.asarray(x), 1e-3, 120)) <= 1e-12
    assert rel(tr.preprocess_channel(torch.from_numpy(t), torch.from_numpy(x), cfg, 90),
                jr.preprocess_channel(jnp.asarray(t), jnp.asarray(x), cfg, 90)) <= 1e-12
    spiky = np.ones(20)
    spiky[7] = 100.0
    spiky[15] = np.nan
    ours = tr.median_prefilter(torch.from_numpy(spiky), 5).numpy()
    ref = np.asarray(jr.median_prefilter(jnp.asarray(spiky), 5))
    assert np.array_equal(np.isnan(ours), np.isnan(ref))
    assert np.array_equal(ours[~np.isnan(ref)], ref[~np.isnan(ref)])
    for arr in ([1.0, 1.1, 0.9, np.nan, 500.0, 1.05], [2.0, np.inf, 1.0, 3.0, np.nan, -4.0, 0.5]):
        a = np.asarray(arr)
        assert np.array_equal(tr.robust_clip(torch.from_numpy(a), 6.0).numpy(),
                              np.asarray(jr.robust_clip(jnp.asarray(a), 6.0)))
    u = np.concatenate([np.zeros(10), np.ones(200)])
    assert rel(tr.actuator_lag(torch.from_numpy(u), 1e-3, 20e-3),
                jr.actuator_lag(jnp.asarray(u), 1e-3, 20e-3)) <= 1e-12


@pytest.mark.parametrize("label,command", [(1.0, None), (0.0, None), (1.0, "two")])
def test_replay_matches_jax(predictors, label, command):
    ref_pred, ours_pred = predictors
    shots, labels = _make_shots(seed=42)
    i = int(np.where(labels == label)[0][0])
    raw = shots[i].T
    t = np.linspace(0.0, 0.128, raw.shape[1])
    cfg = jr.ReplayConfig(control_dt_s=1e-3)
    n_win = max(int(0.128 / 1e-3), 5 + 16 + 1) - 16 + 1
    cmd = None if command is None else np.stack([np.ones(n_win), np.linspace(0, 2, n_win)], 1)
    ref = jr.replay_shot(ref_pred, cfg, jnp.asarray(t), jnp.asarray(raw),
                         None if cmd is None else jnp.asarray(cmd))
    ours = tr.replay_shot(ours_pred, tr.ReplayConfig(control_dt_s=1e-3), torch.from_numpy(t),
                          torch.from_numpy(raw), None if cmd is None else torch.from_numpy(cmd))
    assert rel(ours.risk, ref.risk) <= 1e-9
    assert np.array_equal(ours.alarm_latched.numpy(), np.asarray(ref.alarm_latched))
    assert bool(ours.tripped) == bool(ref.tripped) == (label > 0.5)
    assert float(ours.warning_time_s) == float(ref.warning_time_s)
    assert np.max(np.abs(as_np(ours.actuated) - as_np(ref.actuated))) <= 1e-9


def test_config_validation():
    with pytest.raises(ValueError):
        tr.ReplayConfig(median_window=4)
