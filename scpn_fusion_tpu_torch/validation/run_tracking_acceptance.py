"""Free-boundary tracking acceptance campaign, the port's
``validation/run_tracking_acceptance.py``.

Mirrors the reference's deterministic real-kernel acceptance campaign
(`validation/free_boundary_tracking_acceptance.py`): nominal convergence,
coil-kick rejection sweep, measurement-offset fault visibility + observer
correction, latency sweep, and supervisor fallback — each lane a full
closed-loop shot where every tick runs a real free-boundary plant solve
(`control/free_boundary_tracking.py`).

Gate values follow the reference's thresholds where the objective spaces
coincide (final tracking error 0.02, bounded coil currents); the
measurement lanes adapt its measured/true-gap contract to this repo's
disturbance-observer design: with the observer OFF a sensor bias must
visibly displace the converged TRUE state (the fault is not silently
absorbed), with the observer ON the true error must return under the
nominal gate (the fault is corrected, not just detected).

Float64 on ``device`` (the plant solves are plain ops).  The campaign's
eleven shots (:data:`SHOTS`) are independent given the machine
(:func:`setup`), so :func:`main` runs them in order and :func:`finish`
builds the lanes from their traces, whichever process ran them.  Writes
checksummed JSON+MD evidence into ``out_dir``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import iter_like

FINAL_ERR_GATE = 0.02        # reference max_final_tracking_error_norm
KICK_SCALES = (0.5, 1.0, 2.0)
LATENCY_STEPS = (0, 1, 2, 3)
BIAS = (-0.06, 0.05, 0.0, 0.0)
MIN_VISIBLE_GAP = 0.02       # reference min_measured_true_gap
COIL_CURRENT_LIMIT = 50.0
KICK_PATTERN = (1.0, -1.0, 0.5, -0.5, 1.0, 0.0)
# the script's shots in its order: (lane, what differs from the nominal shot, ticks)
SHOTS = ((("nominal", None), 10),
         *((("kick", s), 12) for s in KICK_SCALES),
         (("offset", "uncorrected"), 12), (("offset", "corrected"), 12),
         *((("latency", k), 14) for k in LATENCY_STEPS),
         (("fallback", None), 6))


def setup(device) -> dict:
    """The machine (33^2, Ip 150, multigrid Picard, at most 80 iterations),
    its coils, the initial plant solve's objectives and the targets (a step
    of (-0.05, 0.04) in the first two)."""
    from scpn_fusion_tpu_torch.control import free_boundary_tracking as fbt
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import coilset_from_config
    dtype = torch.float64
    cfg = iter_like("tracking-acceptance", 33, ip=150.0, max_iterations=80,
                    convergence_threshold=1e-4, relaxation_factor=0.1, solver_method="multigrid")
    grid = Grid.from_config(cfg, dtype=dtype, device=device)
    coils = coilset_from_config(cfg, dtype, device)
    obj0 = fbt.soft_objectives(fbt._plant_solve(coils, cfg, grid, False), grid)
    step = torch.tensor([-0.05, 0.04, 0.0, 0.0], dtype=dtype, device=device)
    return {"cfg": cfg, "grid": grid, "coils": coils, "obj0": obj0, "targets": obj0 + step}


def run_shot(shot, m: dict):
    """One of :data:`SHOTS` on the machine ``m`` of :func:`setup`: its trace."""
    from scpn_fusion_tpu_torch.control import free_boundary_tracking as fbt
    (lane, arg), n_steps = shot
    coils, targets, tcfg = m["coils"], m["targets"], fbt.TrackingConfig()
    dtype, device = coils.currents.dtype, coils.currents.device
    if lane == "kick":
        kick = torch.tensor(KICK_PATTERN, dtype=dtype, device=device)
        coils = coils._replace(currents=coils.currents + arg * kick)
    elif lane == "offset":
        tcfg = fbt.TrackingConfig(sensor_bias=BIAS, **(
            {"measurement_correction_bias": BIAS} if arg == "corrected" else {}))
    elif lane == "latency":
        tcfg = fbt.TrackingConfig(latency_steps=arg)
    elif lane == "fallback":
        targets = m["obj0"] + torch.tensor([-0.5, 0.3, 0.0, 0.0], dtype=dtype, device=device)
    return fbt.run_tracking_shot(m["cfg"], coils, targets, grid=m["grid"], dtype=dtype, tcfg=tcfg,
                                 fallback_currents=m["coils"].currents, n_steps=n_steps)


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def finish(traces: list, fallback_currents, out_dir: str | Path = REPORTS_DIR) -> int:
    """The lanes of the shots' ``traces`` (in :data:`SHOTS`' order; tensors or
    numpy arrays), written into ``out_dir``; the script's exit code."""
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report
    by_shot = dict(zip((shot for shot, _ in SHOTS), traces))
    lanes = []

    # ── Lane 1: nominal convergence ──
    tr = by_shot[("nominal", None)]
    err, lvl = _host(tr.axis_error), _host(tr.alert_level)
    max_cur = float(np.max(np.abs(_host(tr.currents))))
    ok = (err[-1] < FINAL_ERR_GATE and err[0] > 0.05 and lvl[-1] == 0
          and max_cur < COIL_CURRENT_LIMIT)
    lanes.append(LaneResult(
        name="nominal_convergence",
        status="pass" if ok else "fail",
        metrics={"initial_error": float(err[0]),
                 "final_error": float(err[-1]),
                 "final_alert_level": int(lvl[-1]),
                 "max_abs_current": max_cur},
        thresholds={"final_error": FINAL_ERR_GATE,
                    "final_alert_level": 0,
                    "max_abs_current": COIL_CURRENT_LIMIT},
        notes="reference NOMINAL_THRESHOLDS scenario"))

    # ── Lane 2: coil-kick rejection sweep ──
    metrics, ok = {}, True
    for s in KICK_SCALES:
        tr = by_shot[("kick", s)]
        e = float(_host(tr.axis_error)[-1])
        mx = float(np.max(np.abs(_host(tr.currents))))
        metrics[f"final_error_kick_{s}"] = e
        metrics[f"max_abs_current_kick_{s}"] = mx
        ok = ok and e < FINAL_ERR_GATE and mx < COIL_CURRENT_LIMIT
    lanes.append(LaneResult(
        name="coil_kick_rejection",
        status="pass" if ok else "fail",
        metrics=metrics,
        thresholds={"final_error": FINAL_ERR_GATE,
                    "max_abs_current": COIL_CURRENT_LIMIT},
        notes="initial coil currents kicked by scaled +/- pattern "
              "(reference COIL_KICK_SCALE_SWEEP)"))

    # ── Lane 3: measurement offset, visible uncorrected, corrected ──
    e_unc = float(_host(by_shot[("offset", "uncorrected")].axis_error)[-1])
    e_cor = float(_host(by_shot[("offset", "corrected")].axis_error)[-1])
    bias_norm = float(np.linalg.norm(np.asarray(BIAS)[:2]))
    ok = e_unc > MIN_VISIBLE_GAP and e_cor < FINAL_ERR_GATE
    lanes.append(LaneResult(
        name="measurement_offset_corrected",
        status="pass" if ok else "fail",
        metrics={"true_error_uncorrected": e_unc,
                 "true_error_corrected": e_cor,
                 "bias_norm": bias_norm},
        thresholds={"true_error_uncorrected_min": MIN_VISIBLE_GAP,
                    "true_error_corrected_max": FINAL_ERR_GATE},
        notes="sensor bias visibly displaces the converged true state "
              "(fault visible, not absorbed); applying the calibration "
              "(measurement_correction_bias) returns tracking to nominal "
              "(reference MEASUREMENT/CORRECTED lane contract)"))

    # ── Lane 4: latency sweep ──
    metrics, ok = {}, True
    for lat in LATENCY_STEPS:
        e = float(_host(by_shot[("latency", lat)].axis_error)[-1])
        metrics[f"final_error_latency_{lat}"] = e
        ok = ok and e < FINAL_ERR_GATE
    lanes.append(LaneResult(
        name="latency_sweep",
        status="pass" if ok else "fail",
        metrics=metrics,
        thresholds={"final_error": FINAL_ERR_GATE},
        notes="measurement delay 0-3 ticks, latency-compensating estimator "
              "(reference LATENCY_STEP_SWEEP / LATENCY_CORRECTED lanes)"))

    # ── Lane 5: supervisor fallback ──
    tr = by_shot[("fallback", None)]
    lvl = _host(tr.alert_level)
    drift = float(np.max(np.abs(_host(tr.currents)[-1] - _host(fallback_currents))))
    ok = bool(np.all(lvl == 3)) and drift < 1e-9
    lanes.append(LaneResult(
        name="supervisor_fallback",
        status="pass" if ok else "fail",
        metrics={"alert_levels": [int(v) for v in lvl],
                 "fallback_current_drift": drift},
        thresholds={"all_levels": 3, "fallback_current_drift": 1e-9},
        notes="severe target -> SEVERE from tick 0, commanded currents "
              "ramp-pinned to fallback (reference SUPERVISOR_FALLBACK)"))

    path = write_report("tracking_acceptance", lanes, out_dir=out_dir)
    overall = json.loads(path.read_text())["overall_status"]
    print(json.dumps({"overall": overall, "lanes": {ln.name: ln.status for ln in lanes}}))
    return 0 if overall == "pass" else 1


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    m = setup(device)
    return finish([run_shot(shot, m) for shot in SHOTS], m["coils"].currents, out_dir)
