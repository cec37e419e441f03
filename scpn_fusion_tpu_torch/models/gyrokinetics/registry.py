"""String-keyed GK solver registry + factory (GK path A discovery surface).

Analogue of the reference's ``core/gk_registry.py:46-191``: one canonical
way to enumerate, probe, and construct :class:`GKSolverBase`
implementations by name, with lazy class loading so importing this module
stays cheap.  Scope boundaries mirror the reference's:

* ``models/gyrokinetics/nonlinear.py`` (the 5D delta-f lane) is NOT
  registered — it is config-driven, not deck-driven;
* the hybrid surrogate scheduler (``hybrid.py``) keeps its own contract.

``resolve_tglf_solver`` implements the canonical TGLF resolution: the
GACODE binary when it is on PATH (higher fidelity), else the
always-available native quasilinear model.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable

from scpn_fusion_tpu_torch.models.gyrokinetics.interface import GKSolverBase

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_LOADERS: dict[str, Callable[[], type[GKSolverBase]]] = {}
_CLASSES: dict[str, type[GKSolverBase]] = {}


def register_gk_solver(
    name: str, loader: Callable[[], type[GKSolverBase]]
) -> None:
    """Register a lazily-loaded solver class under a canonical key.

    Re-registering replaces the loader and drops the cached class.
    """
    key = name.strip().lower()
    if not key:
        raise ValueError("registry key must be a non-empty string")
    with _LOCK:
        _LOADERS[key] = loader
        _CLASSES.pop(key, None)


def gk_solver_class(name: str) -> type[GKSolverBase]:
    """Resolve a registered solver class (loads lazily, caches)."""
    key = name.strip().lower()
    with _LOCK:
        if key in _CLASSES:
            return _CLASSES[key]
        loader = _LOADERS.get(key)
    if loader is None:
        raise KeyError(
            f"no GK solver registered under {name!r}; "
            f"registered: {registered_gk_solvers()}")
    cls = loader()
    if not (isinstance(cls, type) and issubclass(cls, GKSolverBase)):
        raise TypeError(
            f"loader for {name!r} did not return a GKSolverBase subclass")
    with _LOCK:
        _CLASSES[key] = cls
    return cls


def create_gk_solver(name: str, **kwargs: Any) -> GKSolverBase:
    """Instantiate the solver registered under *name*."""
    return gk_solver_class(name)(**kwargs)


def registered_gk_solvers() -> list[str]:
    with _LOCK:
        return sorted(_LOADERS)


def available_gk_solvers() -> dict[str, bool]:
    """Fail-closed availability probe of every registered solver.

    Load failure, default-construction failure, or a raising
    ``is_available`` all report False; the probe never raises.
    """
    out: dict[str, bool] = {}
    for key in registered_gk_solvers():
        try:
            out[key] = bool(gk_solver_class(key)().is_available())
        except Exception as exc:  # noqa: BLE001 — fail-closed by contract
            logger.debug("availability probe failed for %s: %s", key, exc)
            out[key] = False
    return out


def resolve_tglf_solver(**kwargs: Any) -> GKSolverBase:
    """Canonical TGLF: external GACODE binary if on PATH, else native."""
    external = create_gk_solver("tglf", **kwargs)
    if external.is_available():
        return external
    logger.info("tglf binary not on PATH; using the native quasilinear model")
    return create_gk_solver("tglf-native", **kwargs)


def _bootstrap() -> None:
    def _tglf():
        from scpn_fusion_tpu_torch.models.gyrokinetics.external import TGLFSolver
        return TGLFSolver

    def _tglf_native():
        from scpn_fusion_tpu_torch.models.gyrokinetics.tglf_native import (
            TGLFNativeSolver,
        )
        return TGLFNativeSolver

    def _gene():
        from scpn_fusion_tpu_torch.models.gyrokinetics.external import GENESolver
        return GENESolver

    def _gs2():
        from scpn_fusion_tpu_torch.models.gyrokinetics.external import GS2Solver
        return GS2Solver

    def _cgyro():
        from scpn_fusion_tpu_torch.models.gyrokinetics.external import CGYROSolver
        return CGYROSolver

    def _qualikiz():
        from scpn_fusion_tpu_torch.models.gyrokinetics.external import (
            QuaLiKizSolver,
        )
        return QuaLiKizSolver

    register_gk_solver("tglf", _tglf)
    register_gk_solver("tglf-native", _tglf_native)
    register_gk_solver("gene", _gene)
    register_gk_solver("gs2", _gs2)
    register_gk_solver("cgyro", _cgyro)
    register_gk_solver("qualikiz", _qualikiz)


_bootstrap()
