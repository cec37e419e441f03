"""Checksummed validation-evidence reports (fail-closed).

The reference's validation campaign culture (SURVEY.md §4: 140 scripts
emitting checksummed JSON+MD with "blocked != pass" semantics, SHA-256 of
payloads, git-commit provenance — e.g.
``validation/benchmark_free_boundary_strict_parity.py:9-107``).  This module
is the shared report writer: every lane emits a JSON artifact whose status is
one of ``pass`` / ``fail`` / ``blocked``, where *blocked* (missing data,
missing hardware) is never silently upgraded to pass.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import subprocess
import time
from pathlib import Path
from typing import Any

VALID_STATUSES = ("pass", "fail", "blocked")


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=Path(__file__).resolve().parents[2],
            capture_output=True, text=True, timeout=5, check=True)
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _payload_sha(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class LaneResult:
    """One validation lane outcome."""

    name: str
    status: str                 # pass | fail | blocked
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    thresholds: dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: str = ""

    def __post_init__(self) -> None:
        if self.status not in VALID_STATUSES:
            raise ValueError(f"status must be one of {VALID_STATUSES}")


def write_report(
    report_name: str,
    lanes: list[LaneResult],
    out_dir: str | Path = "validation/reports",
    extra: dict[str, Any] | None = None,
) -> Path:
    """Write a checksummed JSON + MD evidence report; returns the JSON path.

    Overall status: fail if any lane failed, else blocked if any lane
    blocked, else pass — blocked never counts as pass.
    """
    statuses = [lane.status for lane in lanes]
    overall = ("fail" if "fail" in statuses
               else "blocked" if "blocked" in statuses
               else "pass")
    payload = {
        "schema": f"scpn-fusion-tpu.{report_name}.v1",
        "generated_unix": time.time(),
        "git_sha": _git_sha(),
        "host": {
            "platform": platform.platform(),
            "python": platform.python_version(),
        },
        "overall_status": overall,
        "lanes": [dataclasses.asdict(lane) for lane in lanes],
    }
    if extra:
        payload["extra"] = extra
    payload["payload_sha256"] = _payload_sha(payload)

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    json_path = out / f"{report_name}.json"
    json_path.write_text(json.dumps(payload, indent=2, default=str) + "\n")

    md = [f"# {report_name}", "",
          f"*status:* **{overall}** | *git:* {payload['git_sha']} | "
          f"*sha256:* `{payload['payload_sha256'][:16]}…`", ""]
    for lane in lanes:
        md.append(f"## {lane.name} — {lane.status}")
        for k, v in lane.metrics.items():
            gate = lane.thresholds.get(k)
            md.append(f"- `{k}` = {v}" + (f" (gate: {gate})" if gate is not None else ""))
        if lane.notes:
            md.append(f"- note: {lane.notes}")
        md.append("")
    (out / f"{report_name}.md").write_text("\n".join(md))
    return json_path
