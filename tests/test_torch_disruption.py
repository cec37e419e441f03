"""Port parity: windowed-feature disruption prediction
(``control/disruption.py``) and the validations' cohorts.

Float64.  ``extract_window_features`` within 1e-12; 40 Adam steps of
``train_disruption_predictor`` from JAX's initial weights on JAX's minibatch
indices (the draws rule): the normalisation, the weights and the per-tick
risk within 1e-9; the alarm runtime (``run_alarm``,
``alarm_threshold_sweep`` with confirmation 3 and 15,
``evaluate_predictor``) gives equal integer outputs (latched alarms, first
ticks, fired flags) on the same risk traces.  The validations' cohort
generators (``validation/run_control_ladder.py:_synthetic_cohort``,
``validation/run_disruption_roc.py:_cohort``) are carried into
``bench_config`` as they are: the same source and the same arrays.
"""

import importlib.util
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, rng

from scpn_fusion_tpu.control import disruption as jd
from scpn_fusion_tpu.models.surrogates import mlp as jm
from scpn_fusion_tpu_torch import bench_config, interop
from scpn_fusion_tpu_torch.control import disruption as td

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-9


def _validation(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "validation" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _body(fn) -> list[str]:
    lines = inspect.getsource(fn).splitlines()[1:]
    return [ln for ln in lines if ln.strip() != "MODES = ROC_MODES"]


def test_window_features_match_jax():
    sig = rng(1).standard_normal((50, 3))
    for window in (4, 16):
        assert rel(td.extract_window_features(torch.from_numpy(sig), window),
                    jd.extract_window_features(jnp.asarray(sig), window)) <= 1e-12


def test_training_and_alarms_match_jax():
    shots, labels = bench_config.ladder_cohort(12, 60, seed=3)
    shots = shots.astype(np.float64)
    key = jax.random.PRNGKey(0)
    n_steps, window = 40, 16
    ref = jd.train_disruption_predictor(jnp.asarray(shots), jnp.asarray(labels), key,
                                        window=window, n_steps=n_steps)
    n_rows = 12 * (60 - window + 1)
    batch = min(512, n_rows)
    fit = jax.random.fold_in(key, 1)
    idx = jax.vmap(lambda k: jax.random.randint(jax.random.fold_in(fit, k), (batch,), 0,
                                                n_rows))(jnp.arange(n_steps))
    p0 = jm.init_mlp(key, (9, 64, 64, 1), dtype=jnp.float64)
    ours = td._train_disruption_predictor(
        torch.from_numpy(shots), torch.from_numpy(labels), interop.mlp_params(p0, device="cpu"),
        torch.from_numpy(np.array(idx)).long(), window=window)
    assert rel(ours.x_mean, ref.x_mean) <= TOL and rel(ours.x_std, ref.x_std) <= TOL
    for a, b in zip([*ours.mlp.weights, *ours.mlp.biases], jax.tree.leaves(ref.mlp)):
        assert rel(a, b) <= TOL
    risk_t = ours.risk(torch.from_numpy(shots))
    risk_j = jax.vmap(ref.risk)(jnp.asarray(shots))
    assert rel(risk_t, risk_j) <= TOL

    # the alarm runtime on the same traces: integer outputs equal
    risks = np.array(risk_j)
    cfg = jd.AlarmConfig(threshold=0.4, confirm_ticks=3)
    for r in risks[:4]:
        a_j = jd.run_alarm(jnp.asarray(r), cfg)
        a_t = td.run_alarm(torch.from_numpy(r), td.AlarmConfig(0.4, 3))
        assert np.array_equal(a_t.alarm.numpy(), np.asarray(a_j.alarm))
        assert int(a_t.first_alarm_tick) == int(a_j.first_alarm_tick)
    ths = np.linspace(0.02, 0.98, 9)
    for confirm in (3, 15):
        f_j, first_j = jd.alarm_threshold_sweep(jnp.asarray(risks), jnp.asarray(ths), confirm)
        f_t, first_t = td.alarm_threshold_sweep(torch.from_numpy(risks), torch.from_numpy(ths),
                                                confirm)
        assert np.array_equal(f_t.numpy(), np.asarray(f_j))
        assert np.array_equal(first_t.numpy(), np.asarray(first_j))
        assert first_t.dtype == torch.int32
    ev_j = jd.evaluate_predictor(ref, jnp.asarray(shots), jnp.asarray(labels), cfg)
    ev_t = td.evaluate_predictor(ours, torch.from_numpy(shots), torch.from_numpy(labels),
                                 td.AlarmConfig(0.4, 3))
    assert np.array_equal(ev_t["fired"].numpy(), np.asarray(ev_j["fired"]))
    assert float(ev_t["recall"]) == float(ev_j["recall"])
    assert float(ev_t["fpr"]) == float(ev_j["fpr"])


def test_alarm_never_fires_gives_minus_one():
    r = torch.full((20,), 0.1, dtype=torch.float64)
    trace = td.run_alarm(r, td.AlarmConfig())
    assert int(trace.first_alarm_tick) == -1 and not bool(trace.alarm.any())


@pytest.mark.parametrize("ours,module,theirs", [
    ("ladder_cohort", "run_control_ladder", "_synthetic_cohort"),
    ("roc_cohort", "run_disruption_roc", "_cohort"),
])
def test_validation_cohorts_are_carried_over(ours, module, theirs):
    src = getattr(_validation(module), theirs)
    port = getattr(bench_config, ours)
    assert _body(port) == _body(src)
    sizes = (bench_config.LADDER_COHORTS if ours == "ladder_cohort"
             else bench_config.ROC_COHORTS).values()
    for n, t_len, seed in sizes:
        for a, b in zip(port(n, t_len, seed), src(n, t_len, seed)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_training_runs_where_the_shots_lie():
    """The predictor trains on the shots' device in their dtype (the card's
    shots train on the card); its draws come from the generator."""
    shots, labels = bench_config.ladder_cohort(4, 40, seed=1)
    runs = [td.train_disruption_predictor(torch.from_numpy(shots), torch.from_numpy(labels),
                                          torch.Generator().manual_seed(3), n_steps=5)
            for _ in range(2)]
    w = runs[0].mlp.weights[0]
    assert w.device.type == "cpu" and w.dtype == torch.float32
    assert torch.equal(w, runs[1].mlp.weights[0])
