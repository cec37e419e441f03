"""Versioned controller artifact (.scpnctl.json) -- export/import/validate
(port of ``scpn_fusion_tpu/scpn/artifact.py``).

A self-contained JSON document carrying meta (schema version, seed, sha256
payload checksum), topology (place/transition names), dense weights,
feature-axis/injection specs, and the action readout, so a compiled
controller can be shipped, audited, and reloaded bit-exactly.  The payload
and its checksum are the JAX package's for the same controller: an artifact
either package writes loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from scpn_fusion_tpu_torch.scpn.controller import CompiledController, ControllerConfig

SCHEMA = "scpn-fusion-tpu.controller-artifact.v1"
MAX_ARTIFACT_BYTES = 50 * 1024 * 1024


class ArtifactError(ValueError):
    """Raised on malformed or checksum-failing artifacts."""


def _arrays_to_lists(ctrl: CompiledController) -> dict[str, Any]:
    out = {}
    for name, arr in ctrl._asdict().items():
        a = arr.detach().cpu().numpy()
        out[name] = {"shape": list(a.shape), "dtype": str(a.dtype),
                     "data": a.reshape(-1).tolist()}
    return out


def _payload_sha(payload: dict) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def export_controller(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    path: str | Path,
    *,
    place_names: list[str] | None = None,
    transition_names: list[str] | None = None,
    meta: dict[str, Any] | None = None,
) -> Path:
    """Write a checksummed .scpnctl.json artifact."""
    payload = {
        "schema": SCHEMA,
        "config": dataclasses.asdict(cfg),
        "topology": {
            "n_places": int(ctrl.initial_marking.shape[0]),
            "n_transitions": int(ctrl.thresholds.shape[0]),
            "place_names": place_names or [],
            "transition_names": transition_names or [],
        },
        "weights": _arrays_to_lists(ctrl),
        "meta": meta or {},
    }
    payload["sha256"] = _payload_sha({k: v for k, v in payload.items()
                                      if k != "sha256"})
    p = Path(path)
    p.write_text(json.dumps(payload) + "\n", encoding="utf-8")
    return p


def import_controller(path: str | Path, *, dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda"):
    """Load and validate an artifact; returns (controller, config, payload)."""
    p = Path(path)
    if p.stat().st_size > MAX_ARTIFACT_BYTES:
        raise ArtifactError(f"artifact exceeds {MAX_ARTIFACT_BYTES} byte cap")
    payload = json.loads(p.read_text(encoding="utf-8"))
    if payload.get("schema") != SCHEMA:
        raise ArtifactError(f"unknown schema {payload.get('schema')!r}")
    sha = payload.get("sha256")
    expect = _payload_sha({k: v for k, v in payload.items() if k != "sha256"})
    if sha != expect:
        raise ArtifactError("artifact checksum mismatch (payload corrupted)")

    cfg = ControllerConfig(**payload["config"])
    fields = {}
    for name, spec in payload["weights"].items():
        arr = np.asarray(spec["data"], dtype=spec["dtype"]).reshape(spec["shape"])
        if not np.all(np.isfinite(arr.astype(np.float64))):
            raise ArtifactError(f"non-finite values in weight field {name!r}")
        target = torch.int32 if "int" in spec["dtype"] else (
            torch.bool if "bool" in spec["dtype"] else dtype)
        fields[name] = torch.as_tensor(arr, dtype=target, device=device)
    ctrl = CompiledController(**fields)
    return ctrl, cfg, payload
