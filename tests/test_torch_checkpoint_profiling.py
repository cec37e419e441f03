"""Port parity: ``utils/checkpoint.py`` and ``utils/profiling.py``.

A checkpoint written by either package loads in the other, on NamedTuple,
dict, tuple / list and ``None`` trees: the leaves are flattened in
``jax.tree.flatten``'s order (dicts by sorted key, ``None`` a node without
leaves), the manifest's schema, layout and tree string are JAX's, and a
port load gives tensors of the example leaf's dtype and device (numpy for
numpy leaves).  Loading fails closed as JAX's does: a corrupt payload, a
dtype, shape or leaf-count mismatch, an unknown schema and a malformed
manifest raise ``ValueError``.  ``time_fn``, ``trace`` and ``StepTimer`` run
on the CPU.
"""

import json
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.models.gyrokinetics.nonlinear import GKState as JGKState
from scpn_fusion_tpu.utils import checkpoint as jck
from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import GKState as TGKState
from scpn_fusion_tpu_torch.utils import checkpoint as tck
from scpn_fusion_tpu_torch.utils import profiling


class Pair(NamedTuple):
    a: object
    b: object


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {"f": rng.standard_normal((2, 3, 4)) + 1j * rng.standard_normal((2, 3, 4)),
            "t": np.float64(0.25), "psi": rng.standard_normal((4, 5)).astype(np.float32),
            "n": np.arange(6, dtype=np.int64), "r": rng.standard_normal(3)}


def _trees(v, as_leaf):
    """The same trees in each package's leaves: a GK state, a dict with a
    None and nested tuple / list, a tuple with a NamedTuple inside."""
    f, t, psi, n, r = (as_leaf(v[k]) for k in ("f", "t", "psi", "n", "r"))
    gk = (JGKState if as_leaf is jnp.asarray else TGKState)(f=f, time=t)
    return {"gk": gk,
            "nested": {"z": psi, "a": None, "m": (n, [r, {"y": t, "x": psi}])},
            "tuple": (Pair(r, None), n)}


def _torch(x):
    return torch.from_numpy(np.array(x))


def _leaves_equal(a, b):
    la, lb = tck._flatten(a)[0], tck._flatten(b)[0]
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x),
                       np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y))
        for x, y in zip(la, lb))


@pytest.mark.parametrize("name", ["gk", "nested", "tuple"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, name):
    v = _values(1)
    jtree, ttree = _trees(v, jnp.asarray)[name], _trees(v, _torch)[name]
    jck.save_checkpoint(tmp_path / "ck", jtree, metadata={"by": "jax"})
    loaded, meta = tck.load_checkpoint(tmp_path / "ck", ttree)
    assert meta == {"by": "jax"}
    assert type(loaded) is type(ttree) and _leaves_equal(loaded, ttree)
    for got, want in zip(tck._flatten(loaded)[0], tck._flatten(ttree)[0]):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype


@pytest.mark.parametrize("name", ["gk", "nested", "tuple"])
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    v = _values(2)
    jtree, ttree = _trees(v, jnp.asarray)[name], _trees(v, _torch)[name]
    tck.save_checkpoint(tmp_path / "ck", ttree, metadata={"by": "port"})
    loaded, meta = jck.load_checkpoint(tmp_path / "ck", jtree)
    assert meta == {"by": "port"}
    assert _leaves_equal(loaded, ttree)
    # the manifests agree but for the checksum (the NPZ's zip timestamps)
    jck.save_checkpoint(tmp_path / "jx", jtree)
    ours = json.loads((tmp_path / "ck.json").read_text())
    theirs = json.loads((tmp_path / "jx.json").read_text())
    for key in ("schema", "n_leaves", "treedef", "shapes", "dtypes"):
        assert ours[key] == theirs[key], key


def test_numpy_leaves_load_as_numpy(tmp_path):
    tree = {"a": np.ones((2, 2)), "b": torch.zeros(3, dtype=torch.float32)}
    tck.save_checkpoint(tmp_path / "ck.step100", tree)
    assert (tmp_path / "ck.step100.npz").exists()
    loaded, _ = tck.load_checkpoint(tmp_path / "ck.step100", tree)
    assert isinstance(loaded["a"], np.ndarray) and isinstance(loaded["b"], torch.Tensor)
    assert loaded["b"].dtype == torch.float32


def _saved(tmp_path):
    state = {"psi": torch.ones((4, 4), dtype=torch.float64)}
    tck.save_checkpoint(tmp_path / "ok", state, metadata={"note": "audit"})
    return state


@pytest.mark.parametrize("fault", ["corrupt_payload", "dtype", "shape", "leaf_count", "schema",
                                   "manifest"])
def test_load_fails_closed(tmp_path, fault):
    state = _saved(tmp_path)
    path, example = tmp_path / "ok", state
    if fault == "corrupt_payload":       # run_error_audit.py's probe
        blob = bytearray((tmp_path / "ok.npz").read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        (tmp_path / "bad.npz").write_bytes(bytes(blob))
        (tmp_path / "bad.json").write_text((tmp_path / "ok.json").read_text())
        path = tmp_path / "bad"
    elif fault == "dtype":
        example = {"psi": torch.ones((4, 4), dtype=torch.float32)}
    elif fault == "shape":
        example = {"psi": torch.ones((4, 5), dtype=torch.float64)}
    elif fault == "leaf_count":
        example = {"psi": state["psi"], "extra": state["psi"]}
    else:
        manifest = json.loads((tmp_path / "ok.json").read_text())
        if fault == "schema":
            manifest["schema"] = "scpn-fusion-tpu.checkpoint.v0"
        else:
            del manifest["payload_sha256"]
        (tmp_path / "ok.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError):
        tck.load_checkpoint(path, example)
    with pytest.raises(ValueError):
        jck.load_checkpoint(path, {k: jnp.asarray(v.numpy()) for k, v in example.items()})


def test_time_fn_and_step_timer():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": (x * 2.0, [x + 1.0])}

    stats = profiling.time_fn(fn, torch.ones(8), n_warmup=1, n_repeats=4)
    assert len(calls) == 1 + 1 + 4
    assert stats["n"] == 4 and 0.0 <= stats["min_s"] <= stats["p50_s"] <= stats["max_s"]
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.measure("solve.step", grid=65):
            torch.ones(64).sum()
    summary = timer.summary()
    assert summary["solve.step"]["n"] == 3 and summary["solve.step"]["p50_us"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr") as d:
        (torch.ones(16) * 3.0).sum()
    data = json.loads((d / "trace.json").read_text())
    assert "traceEvents" in data and data["traceEvents"]
    timer = profiling.StepTimer()
    with timer.measure("x"):
        pass
    lines = timer.dump_jsonl(tmp_path / "t.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["metric"] == "x"
