"""Port parity: the cross-generator disruption-transfer lane
(``control/disruption_transfer.py``) on synthetic shots.

The reference's DIII-D-like shots are not in this repository, so the lane's
evaluation is held on synthetic ``.npz`` shots written with the JAX
package's writer into a manifest tree of the reference's layout:
``load_reference_shots`` / ``load_reference_splits`` read the same shots and
splits in both packages, ``_to_cohort``, ``_subtract_shot_baseline``,
``_robust_scaler``, ``_augment`` and ``_persistent_score`` give equal arrays,
a missing tree raises ``ReferenceShotsUnavailable`` in both, and
``run_transfer_eval`` runs end to end on the CPU at a tiny size.
"""

import hashlib
import json

import numpy as np
import pytest
from torch_parity import rng

from scpn_fusion_tpu.control import disruption_transfer as jt
from scpn_fusion_tpu.io import disruption_npz as jn
from scpn_fusion_tpu_torch.control import disruption_transfer as tt


def _tree(root, n=8, t_len=600):
    """n synthetic shots (every other disruptive, a growing n1 precursor
    before its quench) with a manifest and a train/val/test split."""
    shots_dir = root / "disruption_shots"
    shots_dir.mkdir()
    entries = []
    g = rng(2)
    for i in range(n):
        sig = 0.05 * g.standard_normal((t_len, len(jn.CHANNEL_KEYS)))
        sig[:, 0] = np.arange(t_len) * 1e-3
        dis = i % 2 == 0
        idx = 450 + 10 * i if dis else -1
        if dis:
            sig[idx - 200:idx, 6] += np.linspace(0.0, 1.0, 200)
        name = f"shot_{1000 + i}.npz"
        jn.write_disruption_npz(shots_dir / name, jn.DisruptionShot(sig, dis, idx, "vde"))
        entries.append({"file": name, "shot": 1000 + i,
                        "label": "disruptive" if (dis or i == 1) else "safe",
                        "sha256": hashlib.sha256((shots_dir / name).read_bytes()).hexdigest()})
    (root / "manifest.json").write_text(json.dumps({"shots": entries}))
    (root / "splits.json").write_text(json.dumps(
        {"train": [1000, 1001, 1002, 1003], "val": [1004, 1005], "test": [1006, 1007]}))
    return shots_dir, root / "manifest.json", root / "splits.json"


def test_loading_and_numpy_stages_match_jax(tmp_path):
    shot_dir, manifest, splits = _tree(tmp_path)
    shots_j, dis_j = jt.load_reference_shots(shot_dir, manifest)
    shots_t, dis_t = tt.load_reference_shots(shot_dir, manifest)
    assert dis_j == dis_t == ["shot_1001.npz"]
    assert tt.load_reference_splits(splits) == jt.load_reference_splits(splits)
    for a, b in zip(shots_t, shots_j):
        assert a.name == b.name and np.array_equal(a.signals, b.signals)
    coh_t, coh_j = tt._to_cohort(shots_t), jt._to_cohort(shots_j)
    assert all(np.array_equal(a, b) for a, b in zip(coh_t, coh_j))
    base_t, base_j = tt._subtract_shot_baseline(coh_t[0]), jt._subtract_shot_baseline(coh_j[0])
    assert np.array_equal(base_t, base_j)
    assert np.array_equal(tt._robust_scaler(base_t), jt._robust_scaler(base_j))
    aug_t = tt._augment(base_t, *coh_t[1:], seed=5)
    aug_j = jt._augment(base_j, *coh_j[1:], seed=5)
    assert all(np.array_equal(a, b) for a, b in zip(aug_t, aug_j))
    risk = rng(3).random(60)
    for p in (1, 4, 80):
        assert np.array_equal(tt._persistent_score(risk, 8, p), jt._persistent_score(risk, 8, p))


def test_missing_tree_is_blocked(tmp_path):
    for mod in (jt, tt):
        with pytest.raises(mod.ReferenceShotsUnavailable):
            mod.load_reference_shots(tmp_path / "absent", tmp_path / "absent.json")
        with pytest.raises(mod.ReferenceShotsUnavailable):
            mod.load_reference_splits(tmp_path / "absent.json")


def test_default_tree_is_in_the_checkout():
    assert tt.REFERENCE_SHOT_DIR.parts[-4:] == ("validation", "reference_data", "diiid",
                                                "disruption_shots")


def test_eval_runs_end_to_end(tmp_path, monkeypatch):
    shot_dir, manifest, splits = _tree(tmp_path)
    load, load_splits = tt.load_reference_shots, tt.load_reference_splits
    monkeypatch.setattr(tt, "load_reference_shots", lambda: load(shot_dir, manifest))
    monkeypatch.setattr(tt, "load_reference_splits", lambda: load_splits(splits))
    res = tt.run_transfer_eval(0, n_steps=3, n_ensemble=1, device="cpu")
    assert (res.n_train, res.n_eval) == (4, 4)
    assert 0.05 <= res.threshold <= 0.95 and 0.0 <= res.recall <= 1.0 and 0.0 <= res.fpr <= 1.0
    assert len(res.per_shot) == 4 and res.label_disagreements == ("shot_1001.npz",)
