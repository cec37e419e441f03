"""Proof manifest: executed property checks recorded against the artifact.

Role-parity with the reference's proof layer (``scpn/proof_manifest.py``
plus the Lean theorems it indexes: interlock replay invariance
``InterlockReplayInvariance.lean:104-193``, PID bounded output, Petri
token boundedness, SNN reachability preservation).  This framework has no
Lean toolchain; per SURVEY.md §2.11 the *properties* are mirrored as
executable checks, and the manifest records which properties were
verified, with what parameters, against which exact net (sha256 of the
compiled incidence payload) — fail-closed: an unverified or failed
property is recorded as such, never omitted.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

import numpy as np

from scpn_fusion_tpu_torch.io import torch_arrays
from scpn_fusion_tpu_torch.scpn.safety_interlocks import SafetyInterlockRuntime
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet


def _net_sha(net) -> str:
    payload = {
        "places": net.place_names,
        "transitions": net.transition_names,
        "w_in": net.w_in.tolist(),
        "w_out": net.w_out.tolist(),
        "thresholds": net.thresholds.tolist(),
        "initial_marking": net.initial_marking.tolist(),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def check_token_boundedness(spn: StochasticPetriNet, **kw) -> dict:
    """Lean `token boundedness` analogue (Monte-Carlo)."""
    res = spn.verify_boundedness(**kw)
    return {"property": "token_boundedness", "passed": bool(res["bounded"]),
            "evidence": res}


def check_liveness(spn: StochasticPetriNet, **kw) -> dict:
    res = spn.verify_liveness(**kw)
    return {"property": "transition_liveness", "passed": bool(res["live"]),
            "evidence": res}


def check_interlock_replay_invariance(n_steps: int = 200,
                                      seed: int = 0) -> dict:
    """Lean ``InterlockReplayInvariance`` analogue: replaying the SAME
    plant-state sequence through two fresh interlock runtimes yields
    identical allowed-action decisions at every tick (incl. NaN states)."""
    rng = np.random.default_rng(seed)
    states = [{
        "T_e": float(rng.choice([rng.uniform(0.0, 40.0), np.nan])),
        "n_e": float(rng.uniform(0.0, 20.0)),
        "beta_N": float(rng.uniform(0.0, 4.0)),
        "I_p": float(rng.uniform(0.0, 20.0)),
        "dZ_dt": float(rng.uniform(-5.0, 5.0)),
    } for _ in range(n_steps)]
    rt_a = SafetyInterlockRuntime()
    rt_b = SafetyInterlockRuntime()
    mismatches = 0
    for s in states:
        if rt_a.update_from_state(s) != rt_b.update_from_state(s):
            mismatches += 1
    return {"property": "interlock_replay_invariance",
            "passed": mismatches == 0,
            "evidence": {"n_steps": n_steps, "mismatches": mismatches}}


def check_pid_bounded_output(*, n_trials: int = 200, seed: int = 0,
                             abs_max: float = 5.0, device="cuda") -> dict:
    """Lean `PID bounded output` analogue for the deployed composition:
    PID command -> actuator envelope.  The APPLIED actuation stays within
    the actuator's saturation bound and remains finite for arbitrary
    (huge, NaN, inf) errors — the fail-safe + clamp chain the reference
    proves in Lean."""
    jnp = torch_arrays.on(device)

    from scpn_fusion_tpu_torch.control.actuator import (
        ActuatorParams,
        actuator_init,
        actuator_step,
    )
    from scpn_fusion_tpu_torch.control.pid import PIDGains, pid_init, pid_step

    rng = np.random.default_rng(seed)
    gains = PIDGains(kp=jnp.asarray(3.0), ki=jnp.asarray(1.0),
                     kd=jnp.asarray(0.5))
    act = ActuatorParams(tau_s=1e-2, dt_s=1e-3, u_min=-abs_max,
                         u_max=abs_max, rate_limit=1e4)
    pstate = pid_init(device=device)
    astate = actuator_init(act, device=device)
    worst = 0.0
    for _ in range(n_trials):
        err = rng.choice([rng.uniform(-1e6, 1e6), np.nan, np.inf])
        pstate, cmd = pid_step(gains, pstate, jnp.asarray(err))
        astate, applied = actuator_step(act, astate, cmd)
        a = float(applied)
        if not np.isfinite(a):
            return {"property": "pid_bounded_output", "passed": False,
                    "evidence": {"nonfinite_actuation": True}}
        worst = max(worst, abs(a))
    return {"property": "pid_bounded_output",
            "passed": worst <= abs_max + 1e-9,
            "evidence": {"worst_abs_actuation": worst, "bound": abs_max}}


def build_proof_manifest(spn: StochasticPetriNet, *,
                         out_path: str | Path | None = None, device="cuda") -> dict:
    """Run every property check and assemble the checksummed manifest."""
    net = spn.compile()
    checks = [
        check_token_boundedness(spn),
        check_liveness(spn),
        check_interlock_replay_invariance(),
        check_pid_bounded_output(device=device),
    ]
    manifest = {
        "schema": "scpn-fusion-tpu.proof-manifest.v1",
        "generated_unix": time.time(),
        "net_sha256": _net_sha(net),
        "all_passed": all(c["passed"] for c in checks),
        "checks": checks,
    }
    manifest["manifest_sha256"] = hashlib.sha256(
        json.dumps(manifest, sort_keys=True, default=str).encode()
    ).hexdigest()
    if out_path is not None:
        Path(out_path).write_text(json.dumps(manifest, indent=2,
                                             default=str))
    return manifest


def verify_manifest_matches(manifest: dict,
                            spn: StochasticPetriNet) -> bool:
    """Fail-closed: a manifest only vouches for the exact net it hashed."""
    return manifest.get("net_sha256") == _net_sha(spn.compile())
