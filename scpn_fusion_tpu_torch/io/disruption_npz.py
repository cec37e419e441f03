"""Fail-closed disruption-shot NPZ reader/writer.

Reference parity: ``io/tokamak_disruption_archive.py:30-73``
(``load_disruption_shot``: required diagnostic-channel keys, scalar
disruption metadata, pickle-free load).  Design delta: every parse
failure — numpy format internals, zip corruption, shape/key/dtype
mismatches, non-finite payloads — is normalised to ``DisruptionNpzError``
so callers (and the fuzz target ``fuzz/fuzz_disruption_npz.py``) handle
exactly one exception type, and the channels are returned STACKED as one
``(T, C)`` signals matrix ready for the sequence predictor
(:mod:`scpn_fusion_tpu.control.disruption_seq`) instead of a dict of
ragged arrays.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path
from typing import NamedTuple

import numpy as np

# Channel order is the schema: metadata-free consumers index by position.
CHANNEL_KEYS = (
    "time_s",
    "ip_ma",
    "bt_t",
    "beta_n",
    "q95",
    "ne_1e19",
    "n1_amp",
    "n2_amp",
    "locked_mode_amp",
    "dbdt_gauss_per_s",
    "vertical_position_m",
)
SCALAR_KEYS = ("is_disruption", "disruption_time_idx", "disruption_type")
_MAX_TICKS = 1_000_000


class DisruptionNpzError(ValueError):
    """Raised for ANY malformed disruption-shot npz payload."""


class DisruptionShot(NamedTuple):
    signals: np.ndarray          # (T, C) float64, C == len(CHANNEL_KEYS)
    is_disruption: bool
    disruption_time_idx: int
    disruption_type: str

    @property
    def time_s(self) -> np.ndarray:
        return self.signals[:, 0]


def write_disruption_npz(path, shot: DisruptionShot) -> None:
    """Inverse of :func:`read_disruption_npz` (round-trip tested)."""
    sig = np.asarray(shot.signals, dtype=np.float64)
    if sig.ndim != 2 or sig.shape[1] != len(CHANNEL_KEYS):
        raise DisruptionNpzError(
            f"signals must be (T, {len(CHANNEL_KEYS)}); got {sig.shape}")
    payload = {k: sig[:, i] for i, k in enumerate(CHANNEL_KEYS)}
    payload["is_disruption"] = np.asarray(bool(shot.is_disruption))
    payload["disruption_time_idx"] = np.asarray(
        int(shot.disruption_time_idx), dtype=np.int64)
    payload["disruption_type"] = np.asarray(str(shot.disruption_type))
    np.savez(path, **payload)


def read_disruption_npz(path) -> DisruptionShot:
    """Load + validate one disruption shot; fail-closed.

    Contract (fuzzed): arbitrary bytes either yield a fully-validated
    finite ``DisruptionShot`` or raise ``DisruptionNpzError`` / ``OSError``.
    """
    p = Path(path)
    if p.suffix.lower() != ".npz":
        raise DisruptionNpzError(f"disruption shot must be .npz: {p}")
    data = p.read_bytes()           # OSError propagates (missing file etc.)
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as raw:
            # Key lookup is case-insensitive: the reference's committed
            # DIII-D-like fixtures capitalise physics symbols (``Ip_MA``,
            # ``BT_T``, ``beta_N`` — reference_data/diiid/disruption_shots)
            # while this repo's writer emits lowercase.  Ambiguity (two
            # keys differing only by case) stays fail-closed.
            lookup: dict[str, str] = {}
            for name in raw.files:
                low = name.lower()
                if low in lookup:
                    raise DisruptionNpzError(
                        f"{p.name}: ambiguous keys {lookup[low]!r} vs "
                        f"{name!r} (case-insensitive collision)")
                lookup[low] = name
            missing = (set(CHANNEL_KEYS) | set(SCALAR_KEYS)) - set(lookup)
            if missing:
                raise DisruptionNpzError(
                    f"{p.name} missing keys: {sorted(missing)}")
            cols = []
            t_len = None
            for k in CHANNEL_KEYS:
                arr = np.asarray(raw[lookup[k]], dtype=np.float64)
                if arr.ndim != 1:
                    raise DisruptionNpzError(
                        f"channel {k} must be 1-D; got shape {arr.shape}")
                if t_len is None:
                    t_len = arr.shape[0]
                elif arr.shape[0] != t_len:
                    raise DisruptionNpzError(
                        f"channel {k} length {arr.shape[0]} != {t_len}")
                cols.append(arr)
            if t_len is None or t_len == 0 or t_len > _MAX_TICKS:
                raise DisruptionNpzError(f"bad shot length {t_len}")
            signals = np.stack(cols, axis=1)
            if not np.all(np.isfinite(signals)):
                raise DisruptionNpzError(f"{p.name}: non-finite samples")
            is_dis = bool(np.asarray(raw["is_disruption"]).reshape(()).item())
            idx = int(np.asarray(
                raw["disruption_time_idx"]).reshape(()).item())
            if idx < -1 or idx >= t_len:
                raise DisruptionNpzError(
                    f"disruption_time_idx {idx} outside [-1, {t_len})")
            if is_dis and idx < 0:
                raise DisruptionNpzError(
                    "disruptive shot without a disruption_time_idx")
            dtype_s = str(np.asarray(raw["disruption_type"]).reshape(()).item())
            return DisruptionShot(signals, is_dis, idx, dtype_s)
    except DisruptionNpzError:
        raise
    except (ValueError, KeyError, OSError, EOFError, zipfile.BadZipFile,
            UnicodeDecodeError, OverflowError, TypeError) as exc:
        # numpy's npz path leaks zipfile/format internals; normalise.
        raise DisruptionNpzError(f"{p.name}: malformed npz ({exc})") from exc
