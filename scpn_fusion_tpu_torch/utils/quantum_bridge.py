"""Fail-closed runtime wrapper for the optional local Quantum Lab suite.

Covers the reference's ``quantum_bridge.py``: a staged runner for three
external quantum-computing workflow scripts (Trotterised transport, VQE
Grad-Shafranov, Knm-VQE).  The scripts are an optional local add-on and
are not redistributable with this framework, so — exactly like the
reference — the bridge validates, resolves, and executes them when
present and fails closed (``FileNotFoundError`` / ``RuntimeError``)
when they are not.  No quantum simulation is emulated here; inventing
one would be a fake parity claim.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

QUANTUM_SCRIPT_NAMES = (
    "14_quantum_plasma_simulation.py",
    "15_vqe_grad_shafranov.py",
    "16_knm_vqe_fusion.py",
)
QUANTUM_STEP_LABELS = (
    "[1] Quantum Transport Simulation (Trotterization)",
    "[2] Quantum Equilibrium Solver (VQE)",
    "[3] Physics-Informed Knm-VQE (Topology Ansatz)",
)
DEFAULT_TIMEOUT_SECONDS = 1800.0


def _normalize_timeout(timeout_s: float) -> float:
    timeout = float(timeout_s)
    if not math.isfinite(timeout) or timeout <= 0.0:
        raise ValueError("script_timeout_seconds must be finite and > 0.")
    return timeout


def resolve_quantum_lab_path(base_path: str | Path | None = None) -> Path:
    """Resolve the Quantum Lab root (reference ``_resolve_quantum_lab_path``)."""
    if base_path is not None:
        return Path(base_path).expanduser().resolve()
    return Path(__file__).resolve().parents[2] / "QUANTUM_LAB"


def run_quantum_suite(
    *,
    base_path: str | Path | None = None,
    script_timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
) -> dict[str, object]:
    """Execute the staged Quantum Lab scripts in sequence, fail-closed
    (reference ``run_quantum_suite:48-113``)."""
    timeout_seconds = _normalize_timeout(script_timeout_seconds)
    lab_path = resolve_quantum_lab_path(base_path)
    if not lab_path.is_dir():
        raise FileNotFoundError(f"Quantum Lab not found at {lab_path}")
    script_paths = [lab_path / name for name in QUANTUM_SCRIPT_NAMES]
    missing = [p.name for p in script_paths if not p.is_file()]
    if missing:
        raise FileNotFoundError(
            "Quantum Lab missing required scripts: " + ", ".join(missing))
    for script_path in script_paths:
        try:
            subprocess.run([sys.executable, str(script_path)],
                           check=True, timeout=timeout_seconds)
        except subprocess.TimeoutExpired as exc:
            raise RuntimeError(
                f"Quantum script timed out: {script_path.name} "
                f"(timeout={timeout_seconds:.1f}s)") from exc
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(
                f"Quantum script failed: {script_path.name} "
                f"(exit={exc.returncode})") from exc
    return {"ok": True, "base_path": str(lab_path),
            "scripts": [p.name for p in script_paths]}


def quantum_suite_status(base_path: str | Path | None = None) -> dict[str, str]:
    """Availability probe without execution; honest blocked status."""
    lab_path = resolve_quantum_lab_path(base_path)
    if not lab_path.is_dir():
        return {"status": "blocked_missing_quantum_lab",
                "base_path": str(lab_path)}
    missing = [n for n in QUANTUM_SCRIPT_NAMES
               if not (lab_path / n).is_file()]
    if missing:
        return {"status": "blocked_missing_scripts",
                "missing": ", ".join(missing), "base_path": str(lab_path)}
    return {"status": "available", "base_path": str(lab_path)}
