"""Checkpoint/resume for solver and scenario state (JSON + NPZ hybrid;
port of ``scpn_fusion_tpu/utils/checkpoint.py``).

Reference analogue: ``core/checkpoint.py:25-99`` (JSON checkpoint with
numpy<->list conversion) and the sha256-allowlisted loading policy
(``control/disruption_checkpoint_policy.py:82-110``).  Trees of torch
tensors and numpy arrays are stored as an NPZ alongside a JSON manifest with
the tree structure, scalar metadata, and a payload checksum; loading is
fail-closed (checksum + shape validation).  Warm-start psi reuse is just
passing the loaded psi back into the solver.

The layout is the JAX package's, leaf for leaf: the tree is flattened as
``jax.tree.flatten`` flattens it (NamedTuples, tuples and lists in order,
dicts by sorted key, ``None`` a node without leaves, anything else a leaf),
so a checkpoint written by either package loads in the other.  Tensors are
saved from ``.detach().cpu()`` and load back as tensors of the example
leaf's dtype and device; numpy (and scalar) example leaves load as numpy.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, structure) in ``jax.tree.flatten``'s order; the structure is
    ``tree`` with each leaf replaced by ``_LEAF``."""
    leaves: list = []

    def walk(x):
        if x is None:
            return None
        if _is_namedtuple(x):
            return type(x)(*(walk(c) for c in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(c) for c in x)
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        leaves.append(x)
        return _LEAF

    return leaves, walk(tree)


class _Leaf:
    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def _unflatten(structure: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(x):
        if x is _LEAF:
            return next(it)
        if x is None:
            return None
        if _is_namedtuple(x):
            return type(x)(*(build(c) for c in x))
        if isinstance(x, (tuple, list)):
            return type(x)(build(c) for c in x)
        return {k: build(v) for k, v in x.items()}

    return build(structure)


def _treedef_str(structure: Any) -> str:
    """The structure as ``str`` of JAX's ``PyTreeDef`` prints it."""
    def show(x):
        if x is _LEAF:
            return "*"
        if x is None:
            return "None"
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], "
                    f"[{', '.join(show(c) for c in x)}])")
        if isinstance(x, tuple):
            inner = ", ".join(show(c) for c in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        if isinstance(x, list):
            return f"[{', '.join(show(c) for c in x)}]"
        return "{" + ", ".join(f"{k!r}: {show(v)}" for k, v in x.items()) + "}"

    return f"PyTreeDef({show(structure)})"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(want) -> tuple:
    return tuple(want.shape) if isinstance(want, torch.Tensor) else tuple(np.shape(want))


def _numpy_dtype(want) -> np.dtype:
    if isinstance(want, torch.Tensor):
        return torch.empty(0, dtype=want.dtype).numpy().dtype
    return np.dtype(want.dtype)


def _like(got: np.ndarray, want):
    """A loaded leaf as the example leaf's kind: a tensor on the example's
    device, else numpy."""
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(np.array(got)).to(device=want.device, dtype=want.dtype)
    return got


def save_checkpoint(
    path: str | Path,
    state: Any,
    *,
    metadata: dict | None = None,
) -> Path:
    """Save a tree checkpoint: <path>.npz (arrays) + <path>.json (manifest)."""
    path = Path(path)
    leaves, treedef = _flatten(state)
    arrays = {f"leaf_{i}": _as_numpy(leaf) for i, leaf in enumerate(leaves)}
    # Append suffixes rather than with_suffix(): dotted names like
    # "ckpt.step100" must not have ".step100" replaced.
    npz_path = Path(str(path) + ".npz")
    np.savez_compressed(npz_path, **arrays)

    sha = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    manifest = {
        "schema": "scpn-fusion-tpu.checkpoint.v1",
        "n_leaves": len(leaves),
        "treedef": _treedef_str(treedef),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "payload_sha256": sha,
        "metadata": metadata or {},
    }
    json_path = Path(str(path) + ".json")
    json_path.write_text(json.dumps(manifest, indent=2) + "\n")
    return json_path


def load_checkpoint(path: str | Path, example_state: Any) -> tuple[Any, dict]:
    """Load a checkpoint into the structure of ``example_state`` (fail-closed:
    checksum, leaf count, shapes, and dtypes must match the manifest).

    Any malformed manifest — missing keys, wrong value types — raises
    ``ValueError``, never an uncontrolled ``KeyError``/``TypeError``."""
    try:
        return _load_checkpoint_unchecked(path, example_state)
    except ValueError:
        raise
    except (KeyError, TypeError, AttributeError, IndexError) as exc:
        raise ValueError(f"malformed checkpoint manifest/payload: "
                         f"{exc!r}") from exc


def _load_checkpoint_unchecked(path: str | Path,
                               example_state: Any) -> tuple[Any, dict]:
    path = Path(path)
    manifest = json.loads(Path(str(path) + ".json").read_text())
    if manifest.get("schema") != "scpn-fusion-tpu.checkpoint.v1":
        raise ValueError(f"unknown checkpoint schema: {manifest.get('schema')!r}")
    npz_path = Path(str(path) + ".npz")
    sha = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    if sha != manifest["payload_sha256"]:
        raise ValueError("checkpoint payload checksum mismatch")

    with np.load(npz_path) as data:
        leaves_loaded = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    example_leaves, treedef = _flatten(example_state)
    if len(example_leaves) != len(leaves_loaded):
        raise ValueError(
            f"checkpoint has {len(leaves_loaded)} leaves, "
            f"expected {len(example_leaves)}")
    for i, (got, want) in enumerate(zip(leaves_loaded, example_leaves)):
        if tuple(got.shape) != _shape(want):
            raise ValueError(
                f"leaf {i} shape {got.shape} != expected {_shape(want)}")
        # .get: checkpoints saved before the dtype manifest was added carry
        # the same schema id but no "dtypes" key — still valid.
        want_dtype = manifest.get("dtypes", {}).get(f"leaf_{i}")
        if want_dtype is not None and str(got.dtype) != want_dtype:
            raise ValueError(
                f"leaf {i} dtype {got.dtype} != manifest dtype {want_dtype}")
        # Guard the f64-payload-into-f32-pipeline hazard: when the example
        # leaf is an array, its dtype is the pipeline contract.
        if hasattr(want, "dtype") and got.dtype != _numpy_dtype(want):
            raise ValueError(
                f"leaf {i} dtype {got.dtype} != expected pipeline dtype "
                f"{_numpy_dtype(want)}")
    leaves = [_like(got, want) for got, want in zip(leaves_loaded, example_leaves)]
    return _unflatten(treedef, leaves), manifest["metadata"]
