"""The carried-over numpy modules of control slice 4a: ``control/realtime_bus.py``,
``control/director.py`` and ``io/imas_history.py``.

Each copy equals its source text but for the lines named here: the bus
imports the port's ``FlightSimParams``, and its diagnostics node reads the
bus once more after it sees the stop flag (the source's node stops at the
flag, and misses the last telemetry when the physics node publishes it and
stops within one poll: ``n_seen`` 399 of 400 in a loaded run of the
three-process session).  The bus's parity oracle
``run_monolithic_twin`` is held to the port's ``run_shot_reduced`` in
float64 at atol 1e-12 (as ``tests/test_realtime_bus.py:31-52`` holds it to
JAX), its schema validation fails closed, and the Director's directed
mission supervises the port's SCPN controller exactly as it supervises
JAX's (as ``tests/test_nef_director.py:125-153`` drives it).  The bus's
three-process session is not run here: the JAX package's test of the same
text is the one that spawns it.
"""

import difflib
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.control import neuro_closed_loop as jn
from scpn_fusion_tpu.scpn import controller as jc
from scpn_fusion_tpu.scpn.structure import StochasticPetriNet as JNet
from scpn_fusion_tpu_torch.bench_config import RZ_SPECS, rz_net
from scpn_fusion_tpu_torch.control import director as tdir
from scpn_fusion_tpu_torch.control import neuro_closed_loop as tn
from scpn_fusion_tpu_torch.control import realtime_bus as tbus
from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams, run_shot_reduced
from scpn_fusion_tpu_torch.scpn import controller as tc
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet as TNet

ROOT = Path(__file__).resolve().parent.parent

# (path, [(the source's lines, the port's lines that stand for them), ...])
COPIES = {
    "realtime_bus": ("control/realtime_bus.py", [
        (["from scpn_fusion_tpu.control.flight_sim import FlightSimParams"],
         ["from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams"]),
        (["        while not stop_event.is_set():"],
         ["        while True:",
          "            # The physics node publishes its last telemetry before it sets",
          "            # the stop flag: read the bus once more after seeing the flag.",
          "            stopping = stop_event.is_set()"]),
        ([], ["                if stopping:", "                    break"]),
    ]),
    "director": ("control/director.py", []),
    "imas_history": ("io/imas_history.py", []),
}


@pytest.mark.parametrize("name", list(COPIES))
def test_copy_equals_its_source(name):
    path, differs = COPIES[name]
    ours = (ROOT / "scpn_fusion_tpu_torch" / path).read_text().splitlines()
    ref = (ROOT / "scpn_fusion_tpu" / path).read_text().splitlines()
    blocks = [(ref[i1:i2], ours[j1:j2]) for tag, i1, i2, j1, j2 in
              difflib.SequenceMatcher(None, ref, ours, autojunk=False).get_opcodes()
              if tag != "equal"]
    assert blocks == differs


def test_bus_oracle_matches_the_port_reduced_shot_f64():
    params = FlightSimParams(control_hz=100.0, shot_duration_s=2.0)
    trace, metrics = run_shot_reduced(params, dtype=torch.float64, device="cpu")
    twin = tbus.run_monolithic_twin(params)
    for key, ours in (("r", trace.r), ("z", trace.z), ("beta", trace.beta),
                      ("heating", trace.heating_mw), ("ip_ma", trace.ip_ma),
                      ("r_err", trace.r_err), ("z_err", trace.z_err)):
        np.testing.assert_allclose(twin[key], ours.numpy(), rtol=0.0, atol=1e-12, err_msg=key)
    assert np.array_equal(twin["disrupted"], trace.disrupted.numpy())
    assert float(metrics["r_err_final"]) < 0.05


def test_bus_schema_fails_closed():
    good = {"seq": 3, "t_sim": 0.03, "r": 6.25, "z": 0.01, "ip_ma": 5.5, "beta": 0.7,
            "heating": 25.0, "disrupted": False}
    tbus.validate_telemetry(good)
    for bad in ({k: v for k, v in good.items() if k != "r"}, {**good, "beta": float("nan")},
                {**good, "r": "6.2"}, {**good, "seq": -1}, [("r", 6.2)]):
        with pytest.raises(tbus.BusSchemaError):
            tbus.validate_telemetry(bad)
    tbus.validate_action({"seq": 0, "telemetry_seq": 0, "cmd_r": 0.1, "cmd_z": -0.2})
    with pytest.raises(tbus.BusSchemaError):
        tbus.validate_action({"seq": 0, "telemetry_seq": 0, "cmd_r": math.inf, "cmd_z": 0.0})


def _supervised(controller_step, plant_step, ctrl, cfg, plant0, as_targets, period=20):
    """The Director's supervised callable over an SCPN controller of either
    package: one oversight period is ``period`` ticks of the R/Z controller
    (its axis targets set to ``targets``) and the reduced plant, carried
    across periods; it reports the firing entropy of the period's last tick
    and proposes a radial target 2 cm further in."""
    carried = {"cs": jc.initial_controller_state(ctrl, cfg) if isinstance(ctrl, jc.CompiledController)
               else tc.initial_controller_state(ctrl, cfg), "ps": plant0}

    def step(targets, k):
        c = ctrl._replace(axis_targets=as_targets(targets))
        cs, ps = carried["cs"], carried["ps"]
        for t in range(period):
            cs, actions, diag = controller_step(c, cfg, cs, as_targets((float(ps.r), float(ps.z))),
                                                k * period + t)
            ps, _ = plant_step(ps, actions, 1e-3)
        carried.update(cs=cs, ps=ps)
        err = abs(float(ps.r) - targets[0])
        snapshot = tdir.DirectorSnapshot(stable=err < 0.25,
                                         brain_entropy=tdir.firing_entropy(np.asarray(diag["firing"])),
                                         axis_error_m=err, tick=k)
        return snapshot, (targets[0] - 0.02, targets[1])

    return step


def test_directed_mission_supervises_the_port_controller_as_jax():
    kw = dict(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    ref_ctrl = jc.build_controller(rz_net(JNet), dtype=jnp.float64, **RZ_SPECS)
    ctrl = tc.build_controller(rz_net(TNet), dtype=torch.float64, device="cpu", **RZ_SPECS)
    ref_step = _supervised(jc.controller_step, jn.reduced_plant_step, ref_ctrl,
                           jc.ControllerConfig(**kw),
                           jn.ReducedPlantState(jnp.float64(6.5), jnp.float64(0.3)),
                           lambda x: jnp.asarray(x, jnp.float64))
    our_step = _supervised(tc.controller_step, tn.reduced_plant_step, ctrl,
                           tc.ControllerConfig(**kw),
                           tn.ReducedPlantState(torch.tensor(6.5, dtype=torch.float64),
                                                torch.tensor(0.3, dtype=torch.float64)),
                           lambda x: torch.tensor(x, dtype=torch.float64))
    ref_di = tdir.DirectorInterface(ref_step, entropy_threshold=0.6, history_window=2)
    our_di = tdir.DirectorInterface(our_step, entropy_threshold=0.6, history_window=2)
    ref_final, ref_log = ref_di.run_directed_mission((6.2, 0.0), n_periods=12)
    final, log = our_di.run_directed_mission((6.2, 0.0), n_periods=12)
    assert our_di.director_backend == "fallback_rule_based"
    assert final == ref_final and len(log) == len(ref_log) == 12
    for ours, ref in zip(log, ref_log):
        assert ours.keys() == ref.keys()
        for key in ours:
            assert ours[key] == pytest.approx(ref[key], rel=1e-9, abs=1e-12), key
    assert our_di.approval_rate == ref_di.approval_rate
    assert 0.0 < our_di.approval_rate <= 1.0
