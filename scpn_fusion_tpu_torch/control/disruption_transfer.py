"""Cross-generator disruption transfer: the reference's DIII-D-like shots
(port of ``scpn_fusion_tpu/control/disruption_transfer.py``).

The reference ships 16 sha256-manifested DIII-D-like shot files (an
11-channel 1 kHz telemetry schema) with a committed train/val/test split by
shot number.  This module trains the causal-transformer sequence predictor
(:mod:`.disruption_seq`) on the train split only and evaluates recall / FPR
at a train-calibrated alarm threshold on the held-out val+test shots, as the
JAX package does: the shots load through the fail-closed NPZ reader
(:mod:`scpn_fusion_tpu_torch.io.disruption_npz`) with per-file sha256
verification against the manifest, ground truth is each file's embedded
``is_disruption`` flag, and every shot is referenced to its own early-window
baseline and scaled by the train shots' IQR.

The shots are not part of this repository: they are looked for under
``validation/reference_data/diiid/`` of the checkout, and a missing tree
raises :class:`ReferenceShotsUnavailable` (callers report *blocked*).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.control.disruption_seq import roc_auc, seq_risk, train_seq_predictor
from scpn_fusion_tpu_torch.io.disruption_npz import DisruptionNpzError, read_disruption_npz

REFERENCE_DATA = Path(__file__).resolve().parents[2] / "validation" / "reference_data" / "diiid"
REFERENCE_SHOT_DIR = REFERENCE_DATA / "disruption_shots"
REFERENCE_MANIFEST = REFERENCE_DATA / "disruption_shots_manifest.json"
REFERENCE_SPLITS = REFERENCE_DATA / "disruption_shot_splits.json"

#: Downsample stride: 1 kHz traces -> 250 Hz model ticks.
STRIDE = 4
#: Precursor window before the quench labelled positive during training
#: (raw ticks).
PRECURSOR_TICKS = 150


class ReferenceShot(NamedTuple):
    name: str
    shot_number: int
    signals: np.ndarray          # (T, 10) float — time column dropped
    time_s: np.ndarray           # (T,)
    is_disruption: bool
    disruption_idx: int          # raw-tick index, -1 for safe


class TransferEvalResult(NamedTuple):
    n_train: int
    n_eval: int
    threshold: float
    recall: float
    fpr: float
    auc: float
    per_shot: tuple[dict, ...]
    label_disagreements: tuple[str, ...]   # manifest label != embedded


class ReferenceShotsUnavailable(RuntimeError):
    """The read-only reference tree is not mounted (or incomplete)."""


def load_reference_shots(
    shot_dir: Path = REFERENCE_SHOT_DIR,
    manifest_path: Path = REFERENCE_MANIFEST,
) -> tuple[list[ReferenceShot], list[str]]:
    """Load + sha256-verify all manifest shots.  Fail-closed: a hash or
    parse mismatch raises; a missing tree raises
    :class:`ReferenceShotsUnavailable` (callers report *blocked*)."""
    if not shot_dir.is_dir() or not manifest_path.is_file():
        raise ReferenceShotsUnavailable(str(shot_dir))
    manifest = json.loads(manifest_path.read_text(encoding="utf-8"))
    shots: list[ReferenceShot] = []
    disagreements: list[str] = []
    for entry in manifest["shots"]:
        path = shot_dir / entry["file"]
        if not path.is_file():
            raise ReferenceShotsUnavailable(f"manifest file missing: {path}")
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if digest != entry["sha256"]:
            raise DisruptionNpzError(
                f"{path.name}: sha256 {digest} != manifest {entry['sha256']}")
        shot = read_disruption_npz(path)
        if (entry["label"] == "disruptive") != shot.is_disruption:
            disagreements.append(entry["file"])
        shots.append(ReferenceShot(
            name=entry["file"],
            shot_number=int(entry["shot"]),
            signals=shot.signals[:, 1:],     # drop the time column
            time_s=shot.signals[:, 0],
            is_disruption=shot.is_disruption,
            disruption_idx=shot.disruption_time_idx))
    return shots, disagreements


def load_reference_splits(
    splits_path: Path = REFERENCE_SPLITS,
) -> dict[str, set[int]]:
    if not splits_path.is_file():
        raise ReferenceShotsUnavailable(str(splits_path))
    payload = json.loads(splits_path.read_text(encoding="utf-8"))
    return {k: set(int(s) for s in payload[k])
            for k in ("train", "val", "test")}


def _to_cohort(shots: list[ReferenceShot], stride: int = STRIDE):
    """Stack shots into the (N, T, C) / labels / onsets / pos_end arrays
    the sequence trainer consumes, downsampling by ``stride``.

    ``pos_end`` is the quench tick: supervision stops there so the model
    must learn the PRECURSOR, not the collapse itself.
    """
    sigs = np.stack([s.signals[::stride] for s in shots]).astype(np.float32)
    t_len = sigs.shape[1]
    labels = np.asarray([float(s.is_disruption) for s in shots],
                        dtype=np.float32)
    onsets = np.asarray(
        [max((s.disruption_idx - PRECURSOR_TICKS) // stride, 0)
         if s.is_disruption else -1 for s in shots], dtype=np.int64)
    pos_end = np.asarray(
        [s.disruption_idx // stride if s.is_disruption else t_len
         for s in shots], dtype=np.int64)
    return sigs, labels, onsets, pos_end


#: Per-shot baseline window (downsampled ticks; 200 ms at 1 kHz raw).
#: All committed shots flat-top well past this before any precursor.
BASELINE_TICKS = 50


def _subtract_shot_baseline(sigs: np.ndarray) -> np.ndarray:
    """Subtract each shot's OWN early-window per-channel median.

    The committed hard negatives carry *elevated but stationary* MHD
    amplitudes (e.g. highbeta n1_amp ~1.2 for the whole shot), while
    true precursors are *trends away from the shot's own healthy
    baseline* (VDE n1 0.02 -> 0.42, vertical drift 8 sigma over its own
    jitter).  Referencing every channel to the shot's first
    ``BASELINE_TICKS`` makes level-offsets vanish and trends stand out
    — and it is causal (uses only the first 200 ms), so the online
    predictor can do the same.
    """
    med = np.median(sigs[:, :BASELINE_TICKS, :], axis=1, keepdims=True)
    return sigs - med


def _robust_scaler(train_sigs: np.ndarray):
    """Per-channel IQR scale fitted on TRAIN shots only (after per-shot
    baseline subtraction).

    Plain std is dominated by the quench transient (dB/dt spikes ~200x
    the precursor scale), which crushes precursor dynamics to near-zero
    after standardisation; IQR keeps the precursor band O(1).
    Returns scale (C,).
    """
    flat = train_sigs.reshape(-1, train_sigs.shape[-1]).astype(np.float64)
    q75, q25 = np.percentile(flat, [75.0, 25.0], axis=0)
    scale = np.maximum(q75 - q25, 1e-6)
    return scale.astype(np.float32)


#: Alarm persistence (downsampled ticks): the alarm requires this many
#: CONSECUTIVE ticks above threshold (16 ms at the raw 1 kHz rate) —
#: the same anti-glitch operating point the hard-cohort lane uses.
PERSISTENCE = 4
#: Ensemble size: 10 training shots make a single init high-variance;
#: risk is averaged over independently-initialised models.
N_ENSEMBLE = 3
#: Train-only augmentation copies per original shot (noise + global and
#: per-channel gain jitter; no time ops, so onset bookkeeping is exact).
N_AUGMENT = 5


def _augment(x, y, on, pe, seed: int):
    """Expand the scaled train cohort with jittered copies."""
    rng = np.random.default_rng(seed)
    xs, ys, ons, pes = [x], [y], [on], [pe]
    for _ in range(N_AUGMENT):
        g_global = rng.uniform(0.8, 1.25, size=(x.shape[0], 1, 1))
        g_chan = rng.uniform(0.9, 1.1, size=(x.shape[0], 1, x.shape[2]))
        noise = rng.standard_normal(x.shape).astype(np.float32) * 0.1
        xs.append((x * g_global * g_chan + noise).astype(np.float32))
        ys.append(y)
        ons.append(on)
        pes.append(pe)
    return (np.concatenate(xs), np.concatenate(ys),
            np.concatenate(ons), np.concatenate(pes))


def _persistent_score(risk: np.ndarray, settle: int,
                      p: int = PERSISTENCE) -> np.ndarray:
    """Sliding-window MINIMUM over p ticks: score[t] > thr iff the alarm
    condition (p consecutive ticks above thr) first holds at window t."""
    r = risk[settle:]
    if r.shape[0] < p:
        return r
    win = np.lib.stride_tricks.sliding_window_view(r, p)
    return win.min(axis=1)


def run_transfer_eval(seed: int = 0, *, n_steps: int = 500,
                      settle: int = 16,
                      n_ensemble: int = N_ENSEMBLE,
                      device: torch.device | str = "cuda") -> TransferEvalResult:
    """Train on the reference's train split; evaluate on val+test.

    The alarm threshold is calibrated on the TRAIN shots only (midpoint
    of the worst safe / weakest disruptive persistent-risk peaks), then
    frozen for the held-out evaluation — mirroring the reference's
    committed ``disruption_risk_calibration.json`` flow.  Note the VDE
    scenario appears ONLY in the held-out split: it is evaluated as an
    unseen-scenario transfer case, like the reference's
    transfer-generalization benchmark
    (``benchmark_disruption_transfer_generalization.py``).  Each ensemble
    member's initial weights and minibatches are drawn from a
    ``torch.Generator`` seeded with ``seed + 101 k``.
    """
    shots, disagreements = load_reference_shots()
    splits = load_reference_splits()
    train = [s for s in shots if s.shot_number in splits["train"]]
    heldout = [s for s in shots
               if s.shot_number in splits["val"] | splits["test"]]
    if not train or not heldout:
        raise ReferenceShotsUnavailable("empty split")

    x_tr, y_tr, on_tr, pe_tr = _to_cohort(train)
    x_tr = _subtract_shot_baseline(x_tr)
    scale = _robust_scaler(x_tr)
    x_tr = np.clip(x_tr / scale, -8.0, 8.0)
    x_aug, y_aug, on_aug, pe_aug = _augment(x_tr, y_tr, on_tr, pe_tr,
                                            seed + 7919)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    members = []
    for k in range(n_ensemble):
        result = train_seq_predictor(
            t(x_aug), t(y_aug), t(on_aug),
            torch.Generator().manual_seed(seed + 101 * k), n_steps=n_steps,
            pos_end=t(pe_aug))
        members.append(result.params)

    def risk_traces(cohort):
        acc = None
        for params in members:
            with torch.no_grad():
                r = seq_risk(params, t(cohort)).double().cpu().numpy()
            acc = r if acc is None else acc + r
        return acc / len(members)

    r_tr = risk_traces(x_tr)
    safe_peaks = [float(_persistent_score(r, settle).max())
                  for r, lab in zip(r_tr, y_tr) if lab < 0.5]
    dis_peaks = [float(_persistent_score(r, settle).max())
                 for r, lab in zip(r_tr, y_tr) if lab > 0.5]
    lo = max(safe_peaks) if safe_peaks else 0.5
    hi = min(dis_peaks) if dis_peaks else 1.0
    threshold = float(np.clip(0.5 * (lo + hi), 0.05, 0.95))

    x_ev, y_ev, _, _ = _to_cohort(heldout)
    x_ev = np.clip(_subtract_shot_baseline(x_ev) / scale, -8.0, 8.0)
    r_ev = risk_traces(x_ev)
    per_shot = []
    tp = fn = fp = tn = 0
    scores = []
    for shot, risk, label in zip(heldout, r_ev, y_ev):
        pscore = _persistent_score(risk, settle)
        above = pscore > threshold
        det_ds = int(np.argmax(above)) + settle if above.any() else -1
        detected = det_ds >= 0
        lead_ms = float("nan")
        pre_quench = False
        if shot.is_disruption and shot.disruption_idx > 0:
            det_raw = det_ds * STRIDE if detected else -1
            if detected and det_raw < shot.time_s.shape[0]:
                lead_ms = float(
                    (shot.time_s[shot.disruption_idx]
                     - shot.time_s[det_raw]) * 1e3)
                pre_quench = det_raw < shot.disruption_idx
            tp += int(detected)
            fn += int(not detected)
        else:
            fp += int(detected)
            tn += int(not detected)
        scores.append(float(pscore.max()))
        per_shot.append({
            "file": shot.name, "is_disruption": shot.is_disruption,
            "detected": detected,
            "detected_pre_quench": pre_quench,
            "lead_ms": None if np.isnan(lead_ms) else round(lead_ms, 1),
            "peak_risk": round(float(pscore.max()), 4)})

    recall = tp / max(tp + fn, 1)
    fpr = fp / max(fp + tn, 1)
    auc = roc_auc(np.asarray(scores), y_ev)
    return TransferEvalResult(
        n_train=len(train), n_eval=len(heldout), threshold=threshold,
        recall=float(recall), fpr=float(fpr), auc=float(auc),
        per_shot=tuple(per_shot),
        label_disagreements=tuple(disagreements))
