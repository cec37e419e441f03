"""More of the CLI's modes that draw, held as ``tests/test_torch_cli_draws.py``
holds them: ``design-scan``, ``optimizer``, ``sandpile`` and
``control-room`` draw from their seed with torch's generator, not JAX's
threefry; each has the JAX mode's exit code and JSON keys, and its JSON
equals a direct call of the port function with the same seed.

``realtime``: the three-process session is the source of the JAX package's
flaky test, so here ``run_realtime_session`` is a stub that checks the
mode's arguments and exercises its JSON and exit-code rule; the smoke runs
the real session on the card host.
"""

import json

import pytest
import torch

from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu_torch.cli import main
from tests.torch_parity import cli_run, flat_json

PORT = ["--device", "cpu", "--dtype", "float64"]
F64 = torch.float64


def _search(**kw):
    from scpn_fusion_tpu_torch.models.physics.design_scan import compact_reactor_search
    res = compact_reactor_search(seed=0, device="cpu", **kw)
    i = int(res.best_index)
    return res, res.points, i


def design_scan():
    res, p, i = _search(n_samples=256, p_aux_mw=50.0)
    return {"n_feasible_q10": int(res.n_feasible),
            "best": {"r_m": float(p.r_m[i]), "a_m": float(p.a_m[i]), "b0_t": float(p.b0_t[i]),
                     "ip_ma": float(p.ip_ma[i]), "q_fusion": float(p.q_fusion[i]),
                     "p_net_mw": float(p.p_net_mw[i])}}


def optimizer():
    res, p, i = _search(n_samples=1024)
    return {"n_feasible": int(res.n_feasible),
            "best": {"R0_m": float(p.r_m[i]), "a_m": float(p.a_m[i]), "B0_T": float(p.b0_t[i]),
                     "Ip_MA": float(p.ip_ma[i]), "Q": float(p.q_fusion[i]),
                     "P_fusion_MW": float(p.p_fusion_mw[i])}}


def sandpile():
    from scpn_fusion_tpu_torch.models.physics.sandpile import (
        SandpileConfig, avalanche_statistics, run_sandpile)
    trace = run_sandpile(SandpileConfig(n_cells=32, n_steps=200), seed=0, dtype=F64,
                         device="cpu")
    return {k: float(v) for k, v in avalanche_statistics(trace).items()}


def control_room():
    from scpn_fusion_tpu_torch.control.control_room import run_control_room_session
    _, summary = run_control_room_session(steps=40, size=16, seed=42, device="cpu")
    return {k: float(v) for k, v in summary.items()}


CASES = {
    "design-scan": (["design-scan", "--samples", "256"], design_scan),
    "optimizer": (["optimizer", "--samples", "1024"], optimizer),
    "sandpile": (["sandpile", "--steps", "200", "--n", "32"], sandpile),
    "control-room": (["control-room", "--steps", "40", "--n", "16"], control_room),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_draws_as_the_port_function(case, capsys):
    argv, direct = CASES[case]
    rc, ours = cli_run(main, PORT + argv, capsys)
    assert ours == json.loads(json.dumps(direct()))
    rc_ref, ref = cli_run(jax_main, argv, capsys)
    assert rc == rc_ref == 0
    assert set(flat_json(ours)) == set(flat_json(ref))


class _Session:
    n_ticks = 12
    final_r_err = 0.01
    final_z_err = 0.002
    open_loop_r_err = 0.05
    controller_actions = 11
    stale_action_reads = 0
    diagnostics = {"disrupted_any": False, "ticks_seen": 12}
    wall_s = 0.123456


@pytest.mark.parametrize("closed", [True, False])
def test_realtime_mode_json_and_exit_rule(closed, capsys, monkeypatch):
    import scpn_fusion_tpu.control.realtime_bus as jax_bus
    import scpn_fusion_tpu_torch.control.realtime_bus as bus

    seen = []

    def stub(n_ticks, tick_interval_s):
        seen.append((n_ticks, tick_interval_s))
        s = _Session()
        if not closed:
            s.final_r_err = 0.04          # not below half the open-loop error
        return s

    monkeypatch.setattr(bus, "run_realtime_session", stub)
    monkeypatch.setattr(jax_bus, "run_realtime_session", stub)
    argv = ["realtime", "--ticks", "12", "--tick-interval", "0.001"]
    rc, ours = cli_run(main, PORT + argv, capsys)
    rc_ref, ref = cli_run(jax_main, argv, capsys)
    assert seen == [(12, 0.001)] * 2
    assert rc == rc_ref == (0 if closed else 1)
    assert ours == ref and ours["wall_s"] == 0.123
