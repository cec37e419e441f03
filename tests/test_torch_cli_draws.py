"""The CLI's modes that draw: ``learning``, ``neuro-control``, ``safety``
(whose JAX functions take a ``jax.random`` key: the port's take a CPU
``torch.Generator`` seeded as the JAX mode seeds its key), ``gk`` and
``stress`` (whose port functions draw from their seed with torch's
generator, not JAX's threefry).  Each has the JAX mode's exit code and JSON
keys, and its JSON equals a direct call of the port function with the same
draws.

``design-scan``, ``optimizer``, ``sandpile``, ``control-room`` and
``realtime``: ``tests/test_torch_cli_draws_b.py``.
"""

import json

import pytest
import torch

from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu_torch import cli
from scpn_fusion_tpu_torch.cli import main
from tests.torch_parity import cli_run, flat_json

PORT = ["--device", "cpu", "--dtype", "float64"]
F64 = torch.float64


def gen(seed):
    return torch.Generator().manual_seed(seed)


def learning():
    from scpn_fusion_tpu_torch.control.soc_learning import run_soc_learning
    _, summary, _ = run_soc_learning(gen(0), n_steps=120, dtype=F64, device="cpu")
    return {k: float(v) for k, v in summary.items()}


def neuro_control():
    from scpn_fusion_tpu_torch.control.neuro_cybernetic import run_neuro_cybernetic_shot
    _, metrics = run_neuro_cybernetic_shot(gen(0), n_ticks=40, dtype=F64, device="cpu")
    return {k: float(v) for k, v in metrics.items()}


def safety():
    from scpn_fusion_tpu_torch.control.disruption import (
        evaluate_predictor, train_disruption_predictor)
    shots, labels = (torch.as_tensor(a) for a in cli.safety_shots(0))
    pred = train_disruption_predictor(shots, labels, gen(0), n_steps=200)
    m = evaluate_predictor(pred, shots, labels)
    return {"recall": float(m["recall"]), "fpr": float(m["fpr"]), "n_shots": 24}


def gk():
    from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import (
        NonlinearGKConfig, run_nonlinear_gk)
    cfg = NonlinearGKConfig(n_kx=8, n_ky=8, n_theta=8, n_vpar=8, n_mu=4, n_steps=10,
                            save_interval=1)
    _, trace = run_nonlinear_gk(cfg, device="cpu")
    return {"q_ion_final_gb": float(trace.q_ion[-1]), "phi_rms_final": float(trace.phi_rms[-1]),
            "zonal_rms_final": float(trace.zonal_rms[-1]), "n_saves": int(trace.times.shape[0])}


def stress():
    from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams
    from scpn_fusion_tpu_torch.control.stress import StressConfig, run_stress_campaign
    res = run_stress_campaign(FlightSimParams(), StressConfig(), n_shots=20, seed=0,
                              dtype=F64, device="cpu")
    return {"n_shots": 20, "disruption_rate": float(res.disruption_rate),
            "r_err_p95_m": float(res.r_err_p95), "r_err_p99_m": float(res.r_err_p99)}


CASES = {
    "learning": (["learning", "--steps", "120"], learning),
    "neuro-control": (["neuro-control", "--steps", "40"], neuro_control),
    "safety": (["safety", "--train-steps", "200"], safety),
    "gk": (["gk", "--steps", "10", "--grid", "8"], gk),
    "stress": (["stress", "--shots", "20"], stress),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_draws_as_the_port_function(case, capsys):
    argv, direct = CASES[case]
    rc, ours = cli_run(main, PORT + argv, capsys)
    assert ours == json.loads(json.dumps(direct()))
    rc_ref, ref = cli_run(jax_main, argv, capsys)
    assert rc == rc_ref == 0
    assert set(flat_json(ours)) == set(flat_json(ref))
