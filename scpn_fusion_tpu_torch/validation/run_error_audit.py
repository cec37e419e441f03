"""Error-handling audit: input validation + fault injection, the port's
``validation/run_error_audit.py``.

Counterpart of the reference's ``validation/task3_error_handling_audit.py``
(fault-injection episodes: divertor overheat faults, controller fail-safe
response) plus a systematic fail-closed input-validation sweep across the
public API surfaces.  Lanes (fail-closed):

1. api_input_validation — a probe table of malformed inputs (NaN fields,
   non-increasing grids, corrupt payloads, wrong shapes, out-of-range
   parameters) against config loading, checkpointing, G-EQDSK parsing,
   the Aurora-parity solver contract, vertical-control sizing, and the
   SCPN interlock evaluator.  Gate: EVERY probe raises its documented
   exception; none returns a value silently.
2. overheat_fault_injection — 64 randomised stagnant-flow divertor
   states (flow 0.0005-0.05 m/s, expansion 9-16x, the reference's fault
   window): every one must be detected by the overheat predicate
   (reference ``_simulate_overheat_fault``: unstable OR q > 45 MW/m^2 OR
   T > 1400 C), and the SCPN safety-interlock runtime must block the
   heating action when fed the faulted plasma state while allowing it
   in the nominal state.
3. nan_semantics_parity — non-finite measured channels map to their
   defaults (no spurious trip, no crash) — pinned parity with the
   reference's ``scpn/safety_interlocks.py:101`` `_safe_float`.

The checkpoints, the Aurora-parity probes and the divertor scan run on
``device`` in float64.  Writes checksummed JSON+MD evidence into ``out_dir``.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import exit_code


def _probe(fn):
    """Run a probe; return (raised_expected, detail)."""
    try:
        fn()
    except Exception as exc:                      # noqa: BLE001 -- the lane asks that each raises
        return True, type(exc).__name__
    return False, "no exception"


def _case(nr=8, nz=3, nt=3, bad_radius=False):
    from scpn_fusion_tpu_torch.models.transport.aurora_parity import AuroraParityCase
    radius = np.array([0.2, 0.1] + [0.3 + 0.1 * i for i in range(nr - 2)]) \
        if bad_radius else np.linspace(0.05, 0.6, nr)
    return AuroraParityCase(
        element="Ne", charge_states=np.arange(nz, dtype=float), radius_m=radius,
        time_s=np.linspace(0.0, 0.1, nt), major_radius_m=1.65, ne_t_r=np.full((nt, nr), 3e19),
        diffusion_m2_s_r_z=np.ones((nr, nz)), convection_m_s_r_z=np.zeros((nr, nz)),
        ionisation_m3_s_t_r_z=np.full((nt, nr, nz), 1e-15),
        recombination_m3_s_t_r_z=np.full((nt, nr, nz), 5e-16))


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.control.vessel_rzip import required_feedback_gain
    from scpn_fusion_tpu_torch.core.config import load_config
    from scpn_fusion_tpu_torch.io import read_geqdsk
    from scpn_fusion_tpu_torch.models.physics.divertor_lab import flow_velocity_scan
    from scpn_fusion_tpu_torch.models.transport.aurora_parity import (
        derive_effective_source_closure, radial_transport_budget_diagnostic,
    )
    from scpn_fusion_tpu_torch.scpn.safety_interlocks import (
        SafetyInterlockRuntime, build_safety_net, evaluate_transition_enablement,
        safety_tokens_from_state,
    )
    from scpn_fusion_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    lanes = []
    with tempfile.TemporaryDirectory(prefix="error_audit_") as tmp_dir:
        tmp = Path(tmp_dir)

        # ── Lane 1: input-validation probe table ──
        good = _case()
        bad_cfg = tmp / "bad.json"
        bad_cfg.write_text(json.dumps({"dimensions": {"R_min": -1.0, "R_max": 9.0,
                                                      "Z_min": -3.0, "Z_max": 3.0}}))
        nondict_cfg = tmp / "nondict.json"
        nondict_cfg.write_text("[1, 2, 3]")
        trunc_g = tmp / "trunc.geqdsk"
        trunc_g.write_text("SCPN  17-Aug-26       3  65  65\n 1.0 2.0\n")
        ckpt = tmp / "ok.ckpt"
        state = {"psi": torch.ones((4, 4), dtype=torch.float64, device=dev)}
        save_checkpoint(ckpt, state, metadata={"note": "audit"})
        corrupt = tmp / "corrupt.ckpt"
        blob = bytearray(Path(str(ckpt) + ".npz").read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        Path(str(corrupt) + ".npz").write_bytes(bytes(blob))
        Path(str(corrupt) + ".json").write_text(Path(str(ckpt) + ".json").read_text())
        net = build_safety_net()

        probes = [
            ("config_negative_rmin", lambda: load_config(bad_cfg)),
            ("config_top_level_not_object", lambda: load_config(nondict_cfg)),
            ("config_size_cap", lambda: load_config(bad_cfg, max_bytes=4)),
            ("geqdsk_truncated", lambda: read_geqdsk(trunc_g)),
            ("checkpoint_corrupt_payload", lambda: load_checkpoint(corrupt, state)),
            ("checkpoint_dtype_mismatch", lambda: load_checkpoint(
                ckpt, {"psi": torch.ones((4, 4), dtype=torch.float32, device=dev)})),
            ("aurora_nonincreasing_radius", lambda: _case(bad_radius=True)),
            ("aurora_nan_density", lambda: radial_transport_budget_diagnostic(
                good, np.full((8, 3), np.nan), 1e-4, device=dev)),
            ("aurora_negative_dt", lambda: radial_transport_budget_diagnostic(
                good, np.ones((8, 3)), -1.0, device=dev)),
            ("aurora_closure_wrong_shape", lambda: derive_effective_source_closure(
                good, np.ones((2, 8, 3)), device=dev)),
            ("vessel_gain_negative_gamma", lambda: required_feedback_gain(-1.0, 0.1, 1e-3)),
            ("vessel_gain_nan_tau", lambda: required_feedback_gain(10.0, float("nan"), 1e-3)),
            ("interlock_wrong_marking_shape",
             lambda: evaluate_transition_enablement(net._compiled, np.zeros(3))),
        ]
        rows = []
        for name, fn in probes:
            raised, detail = _probe(fn)
            rows.append({"probe": name, "raised": raised, "exception": detail})
        n_ok = sum(r["raised"] for r in rows)
        lanes.append(LaneResult(
            name="api_input_validation",
            status="pass" if n_ok == len(probes) else "fail",
            metrics={"probes": rows, "raised": n_ok, "total": len(probes)},
            thresholds={"raised": len(probes)},
            notes="every malformed-input probe must raise; silent returns fail",
        ))

    # ── Lane 2: overheat fault injection ──
    rng = np.random.default_rng(42)
    flows = rng.uniform(0.0005, 0.05, 64)
    expansions = rng.uniform(9.0, 16.0, 64)
    detected = []
    for flow, exp_f in zip(flows, expansions):
        st = flow_velocity_scan(np.array([flow]), 80.0, 2.1, 2.5, expansion_factor=float(exp_f),
                                dtype=torch.float64, device=dev)
        detected.append(not bool(st.is_stable[0]) or float(st.q_surface[0]) > 45.0e6
                        or float(st.t_surface_c[0]) > 1400.0)
    detect_rate = float(np.mean(detected))

    rt = SafetyInterlockRuntime()
    nominal = {"T_e": 10.0, "n_e": 5.0, "beta_N": 1.5, "I_p": 10.0, "dZ_dt": 0.0}
    fault = dict(nominal, T_e=40.0)       # overheat mapped to thermal channel
    allowed_nominal = rt.update_from_state(nominal)
    allowed_fault = rt.update_from_state(fault)
    blocks = allowed_nominal.get("heat_ramp", False) and not allowed_fault.get("heat_ramp", True)
    lanes.append(LaneResult(
        name="overheat_fault_injection",
        status="pass" if detect_rate == 1.0 and blocks else "fail",
        metrics={"n_episodes": 64, "detect_rate": detect_rate,
                 "nominal_heat_allowed": bool(allowed_nominal.get("heat_ramp", False)),
                 "fault_heat_blocked": bool(not allowed_fault.get("heat_ramp", True))},
        thresholds={"detect_rate": 1.0},
        notes=("stagnant-flow fault window (reference "
               "_simulate_overheat_fault: flow 0.0005-0.05 m/s, "
               "expansion 9-16x at 80 MW) must always be detected; "
               "interlock must block heating under the faulted state"),
    ))

    # ── Lane 3: NaN semantics parity ──
    tokens = safety_tokens_from_state({"T_e": float("nan")})
    no_spurious = all(v == 0.0 for v in tokens.values())
    crashed, allowed = False, {}
    try:
        allowed = SafetyInterlockRuntime().update_from_state({"T_e": float("nan"),
                                                              "dZ_dt": float("inf")})
    except Exception:                                  # noqa: BLE001 -- the lane records a crash
        crashed = True
    lanes.append(LaneResult(
        name="nan_semantics_parity",
        status="pass" if (no_spurious and not crashed and bool(allowed)) else "fail",
        metrics={"nan_tokens_all_zero": no_spurious, "runtime_crashed": crashed,
                 "n_actions_evaluated": len(allowed)},
        thresholds={},
        notes=("non-finite channels map to defaults (no spurious trip, "
               "no crash) — pinned parity with the reference's "
               "scpn/safety_interlocks.py:101 _safe_float; a fail-closed "
               "alternative (trip on NaN) would diverge from the "
               "reference contract and is intentionally not adopted"),
    ))

    write_report("error_audit", lanes, out_dir=out_dir)
    return exit_code(lanes)
