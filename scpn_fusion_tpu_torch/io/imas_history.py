"""Digital-twin history <-> IDS payload-sequence / pulse converters.

Covers the reference's ``io/imas_history_payloads.py``: sequence
validation (shared machine/shot/run identity, strictly increasing
``time_slice.index`` and ``time_slice.time_s``,
``validate_ids_payload_sequence:37``), history -> payload conversion
with millisecond de-duplication (``digital_twin_history_to_ids:101``),
the inverse (``ids_to_digital_twin_history:158``), and the aggregated
``ids_equilibrium_pulse_v1`` pulse payload
(``validate_ids_pulse_payload:174`` /
``digital_twin_history_to_ids_pulse:214`` /
``ids_pulse_to_digital_twin_history:239``).

Host-side I/O layer by design (pure dict/JSON plumbing, no device
code); the per-snapshot IDS tree comes from
``control/digital_twin.twin_to_ids``.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np

PULSE_SCHEMA = "ids_equilibrium_pulse_v1"
REQUIRED_PAYLOAD_KEYS = ("machine", "shot", "run", "time_slice", "twin")
REQUIRED_PULSE_KEYS = ("schema", "machine", "shot", "run", "time_slices")


def _coerce_int(name: str, value: Any, *, minimum: int = 0) -> int:
    if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
        raise ValueError(f"{name} must be an integer >= {minimum}.")
    out = int(value)
    if out < minimum:
        raise ValueError(f"{name} must be an integer >= {minimum}.")
    return out


def _coerce_finite(name: str, value: Any, *, minimum: float = 0.0) -> float:
    out = float(value)
    if not np.isfinite(out) or out < minimum:
        raise ValueError(f"{name} must be finite and >= {minimum}.")
    return out


def validate_ids_payload(payload: Mapping[str, Any]) -> None:
    """Single-payload schema gate."""
    if isinstance(payload, bool) or not isinstance(payload, Mapping):
        raise ValueError("IDS payload must be a mapping.")
    missing = [k for k in REQUIRED_PAYLOAD_KEYS if k not in payload]
    if missing:
        raise ValueError(f"IDS payload missing keys: {', '.join(missing)}")
    if not str(payload.get("machine", "")).strip():
        raise ValueError("payload.machine must be a non-empty string.")
    _coerce_int("payload.shot", payload.get("shot", 0))
    _coerce_int("payload.run", payload.get("run", 0))
    ts = payload.get("time_slice")
    if not isinstance(ts, Mapping):
        raise ValueError("payload.time_slice must be a mapping.")
    _coerce_int("payload.time_slice.index", ts.get("index", 0))
    _coerce_finite("payload.time_slice.time_s", ts.get("time_s", 0.0))
    if not isinstance(payload.get("twin"), Mapping):
        raise ValueError("payload.twin must be a mapping (IDS tree).")


def validate_ids_payload_sequence(payloads: Sequence[Mapping[str, Any]]) -> None:
    """Sequence gate: schema + shared identity + strict monotonic time
    (reference ``validate_ids_payload_sequence:37-99``)."""
    if isinstance(payloads, (str, bytes, bytearray)) or not isinstance(
            payloads, Sequence):
        raise ValueError("payloads must be a sequence of IDS payload mappings.")
    if len(payloads) == 0:
        raise ValueError("payloads must contain at least one IDS payload.")
    baseline: tuple[str, int, int] | None = None
    prev_index: int | None = None
    prev_time: float | None = None
    for idx, payload in enumerate(payloads):
        validate_ids_payload(payload)
        identity = (str(payload["machine"]),
                    _coerce_int(f"payloads[{idx}].shot", payload["shot"]),
                    _coerce_int(f"payloads[{idx}].run", payload["run"]))
        if baseline is None:
            baseline = identity
        elif identity != baseline:
            raise ValueError(
                "All IDS payloads in sequence must share the same "
                "machine, shot, and run.")
        ts = payload["time_slice"]
        index = _coerce_int(f"payloads[{idx}].time_slice.index",
                            ts.get("index", 0))
        time_s = _coerce_finite(f"payloads[{idx}].time_slice.time_s",
                                ts.get("time_s", 0.0))
        if prev_index is not None and index <= prev_index:
            raise ValueError(
                "IDS payload sequence requires strictly increasing "
                "time_slice.index.")
        if prev_time is not None and time_s <= prev_time:
            raise ValueError(
                "IDS payload sequence requires strictly increasing "
                "time_slice.time_s.")
        prev_index, prev_time = index, time_s


def twin_history_to_ids(
    history: Sequence[tuple[float, Mapping[str, Any]]],
    *,
    machine: str = "ITER",
    shot: int = 0,
    run: int = 0,
) -> list[dict[str, Any]]:
    """Convert ``[(time_s, ids_tree), ...]`` twin snapshots into a valid
    payload sequence (reference ``digital_twin_history_to_ids:101-155``).

    ``ids_tree`` is the output of ``control/digital_twin.twin_to_ids``.
    Non-increasing timestamps are bumped by 1 ms exactly as the
    reference does, and indices are re-stamped sequentially.
    """
    if isinstance(history, (str, bytes, bytearray)) or not isinstance(
            history, Sequence):
        raise ValueError("history must be a sequence of twin snapshots.")
    if len(history) == 0:
        raise ValueError("history must contain at least one snapshot.")
    out: list[dict[str, Any]] = []
    prev_ms: int | None = None
    for idx, item in enumerate(history):
        if not (isinstance(item, Sequence) and len(item) == 2
                and isinstance(item[1], Mapping)):
            raise ValueError(
                f"history[{idx}] must be a (time_s, ids_tree) pair.")
        time_s, tree = item
        time_ms = round(_coerce_finite(f"history[{idx}].time_s", time_s) * 1e3)
        if prev_ms is not None and time_ms <= prev_ms:
            time_ms = prev_ms + 1
        out.append({
            "machine": machine,
            "shot": int(shot),
            "run": int(run),
            "time_slice": {"index": idx, "time_s": time_ms * 1e-3},
            "twin": dict(tree),
        })
        prev_ms = time_ms
    validate_ids_payload_sequence(out)
    return out


def ids_to_twin_history(
    payloads: Sequence[Mapping[str, Any]],
) -> list[tuple[float, dict[str, Any]]]:
    """Inverse: payload sequence -> ``[(time_s, ids_tree), ...]``
    (reference ``ids_to_digital_twin_history:158-172``)."""
    validate_ids_payload_sequence(payloads)
    return [(float(p["time_slice"]["time_s"]), dict(p["twin"]))
            for p in payloads]


def validate_ids_pulse_payload(pulse: Mapping[str, Any]) -> None:
    """Pulse-payload integrity gate (reference ``:174-212``)."""
    if not isinstance(pulse, Mapping):
        raise ValueError("IDS pulse payload must be a mapping.")
    missing = [k for k in REQUIRED_PULSE_KEYS if k not in pulse]
    if missing:
        raise ValueError(f"IDS pulse payload missing keys: {', '.join(missing)}")
    schema = str(pulse.get("schema", "")).strip()
    if schema != PULSE_SCHEMA:
        raise ValueError(
            f"Unsupported IDS pulse schema '{schema}'. "
            f"Expected '{PULSE_SCHEMA}'.")
    machine = str(pulse.get("machine", "")).strip()
    if not machine:
        raise ValueError("pulse.machine must be a non-empty string.")
    shot = _coerce_int("pulse.shot", pulse.get("shot", 0))
    run = _coerce_int("pulse.run", pulse.get("run", 0))
    slices = pulse.get("time_slices")
    if not isinstance(slices, Sequence) or isinstance(
            slices, (str, bytes, bytearray)):
        raise ValueError("pulse.time_slices must be a sequence.")
    if len(slices) == 0:
        raise ValueError("pulse.time_slices must contain at least one payload.")
    validate_ids_payload_sequence(slices)
    for idx, payload in enumerate(slices):
        if (str(payload.get("machine", "")).strip() != machine
                or _coerce_int(f"pulse.time_slices[{idx}].shot",
                               payload.get("shot", 0)) != shot
                or _coerce_int(f"pulse.time_slices[{idx}].run",
                               payload.get("run", 0)) != run):
            raise ValueError(
                f"pulse.time_slices[{idx}] identity does not match pulse.")


def twin_history_to_ids_pulse(
    history: Sequence[tuple[float, Mapping[str, Any]]],
    *,
    machine: str = "ITER",
    shot: int = 0,
    run: int = 0,
) -> dict[str, Any]:
    """History -> one pulse payload (reference ``:214-237``)."""
    pulse = {
        "schema": PULSE_SCHEMA,
        "machine": machine,
        "shot": int(shot),
        "run": int(run),
        "time_slices": twin_history_to_ids(history, machine=machine,
                                           shot=shot, run=run),
    }
    validate_ids_pulse_payload(pulse)
    return pulse


def ids_pulse_to_twin_history(
    pulse: Mapping[str, Any],
) -> list[tuple[float, dict[str, Any]]]:
    """Pulse payload -> history (reference ``:239-246``)."""
    validate_ids_pulse_payload(pulse)
    return ids_to_twin_history(pulse["time_slices"])
