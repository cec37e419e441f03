"""MAST public-archive ingestor (FAIR MAST role, offline-honest).

TPU-native analogue of the reference's ``io/mast_ingestor.py:61-179``:
streaming access to the UKAEA FAIR MAST dataset via the S3/Zarr stack,
with a local on-disk cache.  This image has zero egress and no
fsspec/zarr stack, so the lanes are, in priority order:

1. **live S3/Zarr** — probed lazily; honestly unavailable here;
2. **local cache** — previously-downloaded shots as ``shot_<id>.npz``
   under the cache dir (``SCPN_MAST_CACHE_DIR`` overrides);
3. **synthetic fallback** — budget-tracked through the fallback
   telemetry ledger (the same discipline as ``io/archive.py``'s
   MDSplus lane), so silent synthetic data can never masquerade as
   archive data.

Channel naming follows the FAIR MAST summary conventions
(``ip``, ``ne_bar``, ``b_t``, per-probe ``b_pol``).
"""

from __future__ import annotations

import importlib
import os
from pathlib import Path

import numpy as np

from scpn_fusion_tpu_torch.utils.telemetry import record_fallback_event

_SUMMARY_CHANNELS = ("time", "ip", "ne_bar", "b_t")


def default_mast_cache_dir() -> Path:
    override = os.environ.get("SCPN_MAST_CACHE_DIR")
    if override:
        return Path(override)
    return Path.home() / ".cache" / "scpn_fusion_tpu" / "mast"


def _fair_mast_stack_available() -> bool:
    for mod in ("fsspec", "zarr", "xarray"):
        try:
            importlib.import_module(mod)
        except ImportError:
            return False
    return True


class MastIngestor:
    """Shot-summary + magnetic-probe loader with honest source labels.

    Every load returns ``(data, source)`` with source in
    {"s3", "cache", "synthetic"} — callers (and evidence reports) always
    know which lane produced the arrays.
    """

    def __init__(self, cache_dir: str | Path | None = None) -> None:
        self.cache_dir = Path(cache_dir) if cache_dir else \
            default_mast_cache_dir()
        self.stack_available = _fair_mast_stack_available()

    # ── lanes ────────────────────────────────────────────────────────

    def _cache_path(self, shot_id: int) -> Path:
        return self.cache_dir / f"shot_{int(shot_id)}.npz"

    def _load_cache(self, shot_id: int) -> dict[str, np.ndarray] | None:
        path = self._cache_path(shot_id)
        if not path.exists():
            return None
        with np.load(path) as data:
            out = {k: np.asarray(data[k]) for k in data.files}
        for ch in _SUMMARY_CHANNELS:
            if ch not in out:
                raise ValueError(
                    f"cached shot {shot_id} missing channel {ch!r} "
                    "(corrupt cache entry — delete and re-download)")
        return out

    def _synthetic_shot(self, shot_id: int) -> dict[str, np.ndarray]:
        """Deterministic synthetic MAST-like shot (0.8 MA, 0.5 T)."""
        record_fallback_event("mast_ingestor",
                              f"synthetic_shot_{shot_id}")
        rng = np.random.default_rng(shot_id)
        t = np.linspace(0.0, 0.5, 500)
        ramp = np.clip(t / 0.1, 0.0, 1.0) * np.clip((0.5 - t) / 0.1, 0.0, 1.0)
        ip = 0.8e6 * ramp + 1e4 * rng.standard_normal(t.size)
        ne = 2e19 * ramp + 1e17 * rng.standard_normal(t.size)
        bt = np.full_like(t, 0.5)
        return {"time": t, "ip": ip, "ne_bar": ne, "b_t": bt}

    # ── public API (reference surface) ───────────────────────────────

    def load_shot_summary(
        self, shot_id: int
    ) -> tuple[dict[str, np.ndarray], str]:
        """(channels, source) for one shot.

        Lane order: local cache first (a cached real shot always beats
        any other lane), then live S3 (requires the FAIR MAST stack AND
        egress — never satisfiable in this image, so it raises if
        explicitly reached), then the budget-tracked synthetic fallback.
        """
        cached = self._load_cache(shot_id)
        if cached is not None:
            return cached, "cache"
        if self.stack_available:
            raise NotImplementedError(
                "live FAIR MAST S3 access needs egress; this image has "
                "none — populate the local cache instead")
        return self._synthetic_shot(shot_id), "synthetic"

    def load_magnetic_probes(
        self, shot_id: int, n_probes: int = 8
    ) -> tuple[dict[str, np.ndarray], str]:
        """Per-probe b_pol traces (synthetic lane derives them from the
        summary Ip with per-probe geometry factors)."""
        path = self.cache_dir / f"shot_{int(shot_id)}_magnetics.npz"
        if path.exists():
            with np.load(path) as data:
                return ({k: np.asarray(data[k]) for k in data.files},
                        "cache")
        summary, source = self.load_shot_summary(shot_id)
        rng = np.random.default_rng(shot_id + 77)
        geom = 0.5 + 0.5 * rng.random(n_probes)
        mu0_like = 2e-7
        b_pol = geom[:, None] * mu0_like * summary["ip"][None, :]
        out = {"time": summary["time"], "b_pol": b_pol,
               "probe_gain": geom}
        return out, ("synthetic" if source == "synthetic" else source)

    def save_to_cache(self, shot_id: int,
                      channels: dict[str, np.ndarray]) -> Path:
        """Persist a shot into the local cache (download helper)."""
        for ch in _SUMMARY_CHANNELS:
            if ch not in channels:
                raise ValueError(f"shot payload missing channel {ch!r}")
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        path = self._cache_path(shot_id)
        np.savez(path, **channels)
        return path
