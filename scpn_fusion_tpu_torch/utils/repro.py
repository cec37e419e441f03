"""Full-reproduction evidence ledger: artifact checksums + re-run gate.

Covers the reference's ``repro.py`` (``build_reproduction_report:126``,
``render_reproduction_markdown:167``, ``run_full_reproduction:209``):
one command that inventories every committed evidence artifact
(campaign reports under ``validation/reports/``, weight artifacts under
``weights/``), records sha256 / schema / status per artifact, stamps
the source commit, hashes the canonical JSON payload, and renders a
Markdown companion.  Like the reference, the claim boundary is
explicit: the command reproduces the *local* fail-closed evidence
chain; blocked lanes stay blocked until their external parifacts
exist.

Optionally (``rerun_scripts``), a subset of campaign scripts is
re-executed and gated on exit status before the ledger is built — the
reproduction analogue of the reference's ``campaign.run_campaign()``
step.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Any

REPO_ROOT = Path(__file__).resolve().parents[2]
REPORTS_DIR = REPO_ROOT / "validation" / "reports"
WEIGHTS_DIR = REPO_ROOT / "weights"
DEFAULT_JSON = REPORTS_DIR / "reproduction.json"
DEFAULT_MD = REPORTS_DIR / "reproduction.md"


def _sha256_file(path: Path) -> str:
    digest = hashlib.sha256()
    with path.open("rb") as handle:
        for chunk in iter(lambda: handle.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _canonical_json_sha256(payload: dict[str, Any]) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def _current_commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO_ROOT,
                             capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def _artifact_record(path: Path) -> dict[str, Any]:
    rec: dict[str, Any] = {
        "path": str(path.relative_to(REPO_ROOT)),
        "exists": path.is_file(),
        "sha256": None, "schema": None, "status": None,
    }
    if not rec["exists"]:
        return rec
    rec["sha256"] = _sha256_file(path)
    if path.suffix == ".json":
        try:
            payload = json.loads(path.read_text())
            rec["schema"] = payload.get("schema")
            rec["status"] = payload.get("overall_status",
                                        payload.get("status"))
        except (json.JSONDecodeError, OSError):
            rec["status"] = "unreadable"
    return rec


def build_reproduction_report(
    *,
    rerun_scripts: list[str] | None = None,
    timeout_s: float = 900.0,
) -> dict[str, Any]:
    """Inventory all evidence artifacts into one checksummed payload."""
    reruns: list[dict[str, Any]] = []
    for script in rerun_scripts or []:
        script_path = REPO_ROOT / "validation" / script
        if not script_path.is_file():
            reruns.append({"script": script, "status": "missing"})
            continue
        proc = subprocess.run([sys.executable, str(script_path)],
                              cwd=REPO_ROOT, capture_output=True, text=True,
                              timeout=timeout_s)
        reruns.append({"script": script,
                       "status": "pass" if proc.returncode == 0 else "fail",
                       "returncode": proc.returncode})

    artifacts = [_artifact_record(p)
                 for p in sorted(REPORTS_DIR.glob("*.json"))
                 if p.name != DEFAULT_JSON.name]
    artifacts += [_artifact_record(p) for p in sorted(WEIGHTS_DIR.glob("*"))
                  if p.is_file()]
    missing = [a["path"] for a in artifacts if not a["exists"]]
    statuses = [a["status"] for a in artifacts if a["status"] is not None]
    blocked = [a["path"] for a in artifacts if a["status"] == "blocked"]
    failed = [a["path"] for a in artifacts if a["status"]
              in ("fail", "unreadable")]
    rerun_failed = [r["script"] for r in reruns if r["status"] != "pass"]

    report: dict[str, Any] = {
        "schema": "scpn-fusion-tpu.full-reproduction-evidence.v1",
        "producer": "scpn_fusion_tpu.utils.repro.build_reproduction_report",
        "source_commit": _current_commit(),
        "artifact_count": len(artifacts),
        "report_status_counts": {s: statuses.count(s)
                                 for s in sorted(set(statuses))},
        "missing_artifacts": missing,
        "blocked_reports": blocked,
        "failed_reports": failed,
        "reruns": reruns,
        "acceptance_passed": (not failed and not rerun_failed),
        "artifacts": artifacts,
        "claim_boundary": (
            "This command reproduces the local fail-closed evidence chain. "
            "Blocked lanes remain blocked until their external parity "
            "artifacts exist; blocked never counts as pass."),
    }
    report["evidence_payload_sha256"] = _canonical_json_sha256(report)
    return report


def render_reproduction_markdown(report: dict[str, Any]) -> str:
    lines = [
        "# Full Reproduction Evidence", "",
        f"- Schema: `{report['schema']}`",
        f"- Source commit: `{report['source_commit']}`",
        f"- Acceptance passed: `{report['acceptance_passed']}`",
        f"- Artifact count: `{report['artifact_count']}`",
        f"- Status counts: `{report['report_status_counts']}`",
        f"- Evidence payload SHA-256: `{report['evidence_payload_sha256']}`",
        "", "## Artifacts", "",
        "| Artifact | Exists | SHA-256 (12) | Schema | Status |",
        "| --- | ---: | --- | --- | --- |",
    ]
    for a in report["artifacts"]:
        sha = (a["sha256"] or "missing")[:12]
        lines.append(f"| `{a['path']}` | `{a['exists']}` | `{sha}` | "
                     f"`{a['schema'] or 'n/a'}` | `{a['status'] or 'n/a'}` |")
    lines += ["", "## Claim Boundary", "", str(report["claim_boundary"]), ""]
    return "\n".join(lines)


def run_full_reproduction(
    *,
    json_output: Path = DEFAULT_JSON,
    markdown_output: Path = DEFAULT_MD,
    rerun_scripts: list[str] | None = None,
) -> dict[str, Any]:
    """Build + persist the reproduction evidence (JSON + Markdown)."""
    report = build_reproduction_report(rerun_scripts=rerun_scripts)
    json_output.parent.mkdir(parents=True, exist_ok=True)
    json_output.write_text(json.dumps(report, indent=2, sort_keys=True,
                                      default=str) + "\n")
    markdown_output.write_text(render_reproduction_markdown(report))
    return report
