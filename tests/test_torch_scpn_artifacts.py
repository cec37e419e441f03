"""Port parity: the SCPN host-side layer (``scpn/{structure,
safety_interlocks, proof_manifest, artifact, contracts}.py``).

``structure.py`` and ``safety_interlocks.py`` are numpy-only copies of the
JAX package's files, held equal to their sources (the latter outside its
import line); ``proof_manifest.py`` is held equal outside its import lines
and the lines that give its PID check a device.  The copies compile the
same nets, the interlocks allow the same actions, and the property checks
give the same evidence as the JAX package's.  A controller artifact that
either package writes loads in the other, with the same payload and SHA.
The vectorised invariant audit agrees with JAX on seeded readings.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rng

from scpn_fusion_tpu.scpn import artifact as jart
from scpn_fusion_tpu.scpn import contracts as jcon
from scpn_fusion_tpu.scpn import controller as jc
from scpn_fusion_tpu.scpn import proof_manifest as jpm
from scpn_fusion_tpu.scpn import safety_interlocks as jsi
from scpn_fusion_tpu.scpn.structure import StochasticPetriNet as JNet
from scpn_fusion_tpu_torch.scpn import artifact as tart
from scpn_fusion_tpu_torch.scpn import contracts as tcon
from scpn_fusion_tpu_torch.scpn import controller as tc
from scpn_fusion_tpu_torch.scpn import proof_manifest as tpm
from scpn_fusion_tpu_torch.scpn import safety_interlocks as tsi
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet as TNet
from test_torch_scpn_controller import SPECS, _net

ROOT = Path(__file__).resolve().parent.parent
PORT, SRC = ROOT / "scpn_fusion_tpu_torch" / "scpn", ROOT / "scpn_fusion_tpu" / "scpn"

# The proof manifest's port-only lines, each with the source line it stands
# for (None: the port adds it).  The PID property check runs the port's PID
# and actuator, whose state lives on a device (the card by default), and
# binds ``jnp`` to torch's array functions on that device.
MANIFEST_PORT_ONLY = {
    '                             abs_max: float = 5.0, device="cuda") -> dict:':
        "                             abs_max: float = 5.0) -> dict:",
    "    jnp = torch_arrays.on(device)": None,
    "    pstate = pid_init(device=device)": "    pstate = pid_init()",
    "    astate = actuator_init(act, device=device)": "    astate = actuator_init(act)",
    '                         out_path: str | Path | None = None, device="cuda") -> dict:':
        "                         out_path: str | Path | None = None) -> dict:",
    "        check_pid_bounded_output(device=device),": "        check_pid_bounded_output(),",
}


def _code_lines(path: Path, port_only: dict | None = None) -> list[str]:
    lines = [line for line in path.read_text().splitlines()
             if not line.lstrip().startswith(("import ", "from "))]
    if port_only is None:
        return lines
    assert all(lines.count(line) == 1 for line in port_only)
    return [port_only.get(line, line) for line in lines if port_only.get(line, line) is not None]


def test_copies_equal_their_sources():
    assert (PORT / "structure.py").read_text() == (SRC / "structure.py").read_text()
    assert _code_lines(PORT / "safety_interlocks.py") == _code_lines(SRC / "safety_interlocks.py")
    assert _code_lines(PORT / "proof_manifest.py", MANIFEST_PORT_ONLY) == \
        _code_lines(SRC / "proof_manifest.py")
    for name in ("safety_interlocks.py", "proof_manifest.py"):
        imports = [line for line in (PORT / name).read_text().splitlines()
                   if line.lstrip().startswith(("import ", "from "))]
        assert not [line for line in imports if "jax" in line or "scpn_fusion_tpu." in line]


def test_nets_and_verification_match_jax():
    ref, ours = _net(JNet), _net(TNet)
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        assert (np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b), field.name
    for cls in (JNet, TNet):
        assert cls.topology_report(_net(cls)) == JNet.topology_report(ref)
    j_net, t_net = jsi.build_safety_net(), tsi.build_safety_net()
    assert j_net.verify_boundedness() == t_net.verify_boundedness()
    assert j_net.verify_liveness() == t_net.verify_liveness()


def test_interlocks_match_jax():
    g = rng(4)
    j_rt, t_rt = jsi.SafetyInterlockRuntime(), tsi.SafetyInterlockRuntime()
    for _ in range(50):
        state = {"T_e": float(g.choice([g.uniform(0, 40), np.nan])),
                 "n_e": float(g.uniform(0, 20)), "beta_N": float(g.uniform(0, 4)),
                 "I_p": float(g.uniform(0, 20)), "dZ_dt": float(g.uniform(-2, 2))}
        assert j_rt.update_from_state(state) == t_rt.update_from_state(state)
        assert j_rt.last_violations == t_rt.last_violations
        assert np.array_equal(j_rt.marking, t_rt.marking)


def test_proof_checks_match_jax():
    """The checks that need no device give JAX's evidence; the PID check on
    the CPU gives JAX's verdict and worst actuation."""
    net_j, net_t = jsi.build_safety_net(), tsi.build_safety_net()
    assert jpm.check_token_boundedness(net_j) == tpm.check_token_boundedness(net_t)
    assert jpm.check_liveness(net_j) == tpm.check_liveness(net_t)
    assert jpm.check_interlock_replay_invariance() == tpm.check_interlock_replay_invariance()
    assert jpm._net_sha(net_j.compile()) == tpm._net_sha(net_t.compile())
    ref, ours = jpm.check_pid_bounded_output(), tpm.check_pid_bounded_output(device="cpu")
    assert ref["passed"] and ours["passed"]
    assert ours["evidence"]["worst_abs_actuation"] == pytest.approx(
        ref["evidence"]["worst_abs_actuation"], rel=1e-12)
    manifest, ref_manifest = tpm.build_proof_manifest(net_t, device="cpu"), \
        jpm.build_proof_manifest(net_j)
    assert tpm.verify_manifest_matches(manifest, net_t)
    for key in ("net_sha256", "all_passed"):
        assert manifest[key] == ref_manifest[key], key
    assert [c["passed"] for c in manifest["checks"]] == \
        [c["passed"] for c in ref_manifest["checks"]]


def _controllers(dtype):
    ref = jc.build_controller(_net(JNet), dtype=jnp.float64 if dtype == "float64"
                              else jnp.float32, **SPECS)
    ours = tc.build_controller(_net(TNet), dtype=getattr(torch, dtype), device="cpu", **SPECS)
    return ref, ours


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_artifact_round_trip_both_ways(tmp_path, dtype):
    ref, ours = _controllers(dtype)
    kw = dict(firing_mode="fractional", firing_margin=0.3, max_delay_ticks=2, seed_base=3)
    names = dict(place_names=list(_net(TNet).place_names),
                 transition_names=list(_net(TNet).transition_names), meta={"shot": 1})
    j_path = jart.export_controller(ref, jc.ControllerConfig(**kw), tmp_path / "j.scpnctl.json",
                                    **names)
    t_path = tart.export_controller(ours, tc.ControllerConfig(**kw),
                                    tmp_path / "t.scpnctl.json", **names)
    j_payload, t_payload = (json.loads(p.read_text()) for p in (j_path, t_path))
    assert j_payload == t_payload and j_payload["sha256"] == t_payload["sha256"]
    # the port loads JAX's file, JAX loads the port's
    t_ctrl, t_cfg, _ = tart.import_controller(j_path, dtype=getattr(torch, dtype), device="cpu")
    j_ctrl, j_cfg, _ = jart.import_controller(t_path, dtype=getattr(jnp, dtype))
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg) == kw | {
        k: v for k, v in dataclasses.asdict(tc.ControllerConfig()).items() if k not in kw}
    for field in ref._fields:
        a, b = getattr(t_ctrl, field).numpy(), np.asarray(getattr(j_ctrl, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert np.array_equal(a, np.asarray(getattr(ref, field))), field
    bad = t_payload | {"meta": {"shot": 2}}
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(tart.ArtifactError, match="checksum"):
        tart.import_controller(tmp_path / "bad.json", device="cpu")


def test_invariant_audit_matches_jax():
    g = rng(8)
    values = np.stack([g.uniform(0.5, 1.5, 40), g.uniform(2.0, 3.5, 40), g.uniform(0.8, 1.5, 40),
                       g.uniform(15.0, 35.0, 40), g.uniform(0.0, 0.02, 40)], 1)
    values[3, 1] = np.nan
    values[5, 0] = 1.0
    ref = jcon.check_invariants_compiled(jcon.invariant_table(dtype=jnp.float64),
                                         jnp.asarray(values))
    ours = tcon.check_invariants_compiled(
        tcon.invariant_table(dtype=torch.float64, device="cpu"), torch.tensor(values))
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    reading = dict(zip(("q_min", "beta_N", "greenwald", "T_i"), (0.9, 2.9, 1.6, float("nan"))))
    j_v, t_v = jcon.check_all(reading), tcon.check_all(reading)
    assert [(v.invariant.name, v.severity) for v in j_v] == \
        [(v.invariant.name, v.severity) for v in t_v]
    assert jcon.should_trigger_mitigation(j_v) == tcon.should_trigger_mitigation(t_v)


def test_default_device_is_the_card(tmp_path):
    """With no ``device`` the audit table, an imported controller and the
    PID property check land on CUDA; without a card they raise."""
    _, ours = _controllers("float32")
    path = tart.export_controller(ours, tc.ControllerConfig(), tmp_path / "c.scpnctl.json")
    calls = (lambda: tcon.invariant_table(), lambda: tpm.check_pid_bounded_output(n_trials=2),
             lambda: tart.import_controller(path))
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
