"""Port parity: the fail-closed disruption-shot NPZ reader/writer
(``io/disruption_npz.py``).

The port's module is a copy of the JAX package's numpy-only module, held
equal to its source line for line.  A shot written by either package reads
back equal through the other, and both reject the same malformed payloads
with the same message.
"""

from pathlib import Path

import numpy as np
import pytest
from torch_parity import rng

from scpn_fusion_tpu.io import disruption_npz as jn
from scpn_fusion_tpu_torch.io import disruption_npz as tn

ROOT = Path(__file__).resolve().parent.parent


def test_copy_equals_source():
    assert (ROOT / "scpn_fusion_tpu_torch" / "io" / "disruption_npz.py").read_text() == \
        (ROOT / "scpn_fusion_tpu" / "io" / "disruption_npz.py").read_text()


def _shot(mod, seed=0, t_len=50):
    sig = rng(seed).standard_normal((t_len, len(mod.CHANNEL_KEYS)))
    sig[:, 0] = np.arange(t_len) * 1e-3
    return mod.DisruptionShot(sig, True, 40, "vde")


@pytest.mark.parametrize("writer,reader", [(jn, tn), (tn, jn)])
def test_round_trip_across_packages(tmp_path, writer, reader):
    path = tmp_path / "shot.npz"
    shot = _shot(writer)
    writer.write_disruption_npz(path, shot)
    back = reader.read_disruption_npz(path)
    assert np.array_equal(back.signals, shot.signals)
    assert (back.is_disruption, back.disruption_time_idx, back.disruption_type) == (
        True, 40, "vde")


@pytest.mark.parametrize("case", ["suffix", "garbage", "missing_key", "nan", "bad_idx"])
def test_same_rejections(tmp_path, case):
    path = tmp_path / ("shot.txt" if case == "suffix" else "shot.npz")
    if case == "garbage":
        path.write_bytes(b"not a zip")
    elif case != "suffix":
        sig = _shot(jn).signals
        payload = {k: sig[:, i] for i, k in enumerate(jn.CHANNEL_KEYS)}
        payload.update(is_disruption=np.asarray(True), disruption_time_idx=np.asarray(40),
                       disruption_type=np.asarray("vde"))
        if case == "missing_key":
            del payload["q95"]
        elif case == "nan":
            payload["q95"] = payload["q95"].copy()
            payload["q95"][3] = np.nan
        else:
            payload["disruption_time_idx"] = np.asarray(500)
        np.savez(path, **payload)
    else:
        path.write_bytes(b"")
    msgs = []
    for mod in (jn, tn):
        with pytest.raises(mod.DisruptionNpzError) as err:
            mod.read_disruption_npz(path)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
