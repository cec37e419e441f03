"""Aggregate the port's validation reports into ``RESULTS.md``, the port's
``validation/collect_results.py``.

Every checksummed JSON report under the port's reports directory
(``validation/reports_torch/``) is summarised into one table with per-lane
status, headline metrics, payload checksums, and git provenance; the table
is written to ``RESULTS.md`` in the same directory (never to the
repository's ``RESULTS.md``, which is the JAX package's).  Fail-closed:
blocked lanes are surfaced as blocked, never folded into pass.  The
external-parity score counts the externally anchored campaigns among the
port's reports; one the port has not run is missing, and the score then
fails, as the JAX script's does.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path

from scpn_fusion_tpu_torch.validation import REPORTS_DIR

_STATUS_ICON = {"pass": "PASS", "fail": "FAIL", "blocked": "BLOCKED"}


def _fmt_metric(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _verify_checksums(reports: list[Path]) -> list[str]:
    """Recompute every report's payload sha256 (tamper check)."""
    import hashlib

    bad = []
    for path in reports:
        rep = json.loads(path.read_text())
        recorded = rep.get("payload_sha256")
        if recorded is None:
            # The meta-runner summary (full_pipeline_summary.json) is an
            # aggregate index, not a checksummed evidence report.
            if "lanes" in rep:
                bad.append(f"{path.name}: no payload_sha256")
            continue
        body = {k: v for k, v in rep.items() if k != "payload_sha256"}
        digest = hashlib.sha256(
            json.dumps(body, sort_keys=True, default=str).encode()).hexdigest()
        if digest != recorded:
            bad.append(f"{path.name}: checksum mismatch "
                       f"({digest[:12]} != {recorded[:12]})")
    return bad


# Reports whose gates are anchored OUTSIDE this repo: published figures,
# committed external-code outputs, digitised experimental data, or the
# reference's own artifacts.  The score is the reference's
# ``external_parity_score.py`` role: one number for "how much of this
# framework is held to external truth".
EXTERNAL_ANCHOR_REPORTS = (
    "aurora_public", "torax_parity", "blind_demo", "slough_anchors",
    "real_shot_accuracy", "equilibrium_parity", "implementation_parity",
    "confinement_burn", "runaway_dream", "eped_tiers",
    "quasi3d_contracts", "multi_machine", "gk_growth_rates",
    "disruption_transfer", "physics_closures", "adjoint_fd",
)


def _write_external_parity_score(reports_dir: Path) -> None:
    """Aggregate external-anchor lanes into one scored evidence report."""
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    n_pass = n_fail = n_blocked = 0
    per_source = {}
    missing = []
    for stem in EXTERNAL_ANCHOR_REPORTS:
        path = reports_dir / f"{stem}.json"
        if not path.exists():
            missing.append(stem)
            continue
        rep = json.loads(path.read_text())
        statuses = [l["status"] for l in rep.get("lanes", [])]
        per_source[stem] = {s: statuses.count(s)
                            for s in ("pass", "fail", "blocked")}
        n_pass += statuses.count("pass")
        n_fail += statuses.count("fail")
        n_blocked += statuses.count("blocked")
    total = n_pass + n_fail + n_blocked
    score = n_pass / total if total else 0.0
    lane = LaneResult(
        name="external_parity_score",
        status="pass" if (n_fail == 0 and not missing and total > 0)
        else ("blocked" if not missing else "fail"),
        metrics={"score": round(score, 4), "lanes_pass": n_pass,
                 "lanes_fail": n_fail, "lanes_blocked": n_blocked,
                 "sources": len(per_source),
                 **{f"{k}_pass_frac":
                    round(v["pass"] / max(sum(v.values()), 1), 3)
                    for k, v in per_source.items()}},
        notes="score = externally-anchored lanes passing / total across "
              f"{len(EXTERNAL_ANCHOR_REPORTS)} campaigns (published "
              "figures, committed external-code outputs, digitised "
              "experiments, reference artifacts); blocked lanes count "
              "against the score, never as pass"
              + (f"; MISSING sources: {missing}" if missing else ""))
    write_report("external_parity_score", [lane], out_dir=reports_dir)


def main(*, out_dir: str | Path = REPORTS_DIR, check: bool = False) -> int:
    """Write ``RESULTS.md`` over the reports in ``out_dir`` (with ``check``:
    verify every report's checksum first, and return 1 if one fails)."""
    reports_dir = Path(out_dir)
    reports_dir.mkdir(parents=True, exist_ok=True)
    out = reports_dir / "RESULTS.md"
    if not check:
        _write_external_parity_score(reports_dir)
    reports = sorted(reports_dir.glob("*.json"))
    if check:
        bad = _verify_checksums(reports)
        if bad:
            print("TAMPERED/INVALID reports:\n  " + "\n  ".join(bad))
            return 1
        print(f"all {len(reports)} report checksums verify")
    lines = [
        "# RESULTS — scpn_fusion_tpu_torch validation evidence",
        "",
        f"_Generated {datetime.now(timezone.utc).isoformat(timespec='seconds')} "
        f"by `scpn_fusion_tpu_torch.validation.collect_results` from "
        f"{len(reports)} report(s) in `{reports_dir}`._",
        "",
        "Fail-closed semantics: a blocked lane is never a pass.",
        "",
    ]
    overall_ok = True
    for path in reports:
        rep = json.loads(path.read_text())
        name = rep.get("schema", path.stem).replace("scpn-fusion-tpu.", "").replace(".v1", "")
        status = rep.get("overall_status", "blocked")
        overall_ok &= status == "pass"
        lines.append(f"## {name} — {_STATUS_ICON.get(status, status)}")
        lines.append("")
        lines.append(f"- source: `{path.name}` "
                     f"(sha256 `{rep.get('payload_sha256', '?')[:16]}…`)")
        lines.append(f"- git: `{rep.get('git_sha', '?')}`  "
                     f"generated: {rep.get('generated_unix', '?')}")
        lines.append("")
        lines.append("| lane | status | headline metrics |")
        lines.append("|---|---|---|")
        for lane in rep.get("lanes", []):
            metrics = lane.get("metrics", {})
            head = ", ".join(f"{k}={_fmt_metric(v)}"
                             for k, v in list(metrics.items())[:4])
            lines.append(f"| {lane['name']} | "
                         f"{_STATUS_ICON.get(lane['status'], lane['status'])}"
                         f" | {head} |")
        lines.append("")
        notes = [l.get("notes") for l in rep.get("lanes", [])
                 if l.get("notes")]
        if notes:
            lines.append("Notes: " + " / ".join(notes))
            lines.append("")
    out.write_text("\n".join(lines))
    print(f"wrote {out} ({'all pass' if overall_ok else 'NOT all pass'})")
    return 0

