"""Helpers for holding the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; results
come back as numpy and are compared span-relatively.  JAX stays on the CPU
with x64 on (``tests/conftest.py``).  PyTorch runs one thread per process,
because the suite runs under several xdist workers.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from scpn_fusion_tpu_torch.bench_config import (  # noqa: F401
    BENCH_SOLVER,
    FREE_BOUNDARY_SOLVER,
    config_dict,
)

torch.set_num_threads(1)


def iter_like_cfg(n: int, **solver):
    """The JAX package's ReactorConfig for the ITER-like bench machine
    (``scpn_fusion_tpu_torch.bench_config.ITER_LIKE``) at n x n."""
    from scpn_fusion_tpu.core.config import config_from_dict
    return config_from_dict(config_dict(n, **solver))


def free_boundary_cfgs(n: int, **solver):
    """(JAX config, port config) of the free-boundary forward's machine and
    solver (``bench_config.free_boundary_config``) at n x n."""
    import dataclasses

    from scpn_fusion_tpu_torch import interop
    ref_cfg = iter_like_cfg(n, **{**FREE_BOUNDARY_SOLVER, **solver})
    return ref_cfg, interop.config_from_asdict(dataclasses.asdict(ref_cfg))


def rel(ours, ref) -> float:
    """max |ours - ref| over max |ref| (over 1e-300 where ``ref`` is all zero)."""
    a, b = as_np(ours), as_np(ref)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def crel(ours, ref) -> float:
    """:func:`rel` of complex (or real) values: max |ours - ref| over
    max |ref|, the imaginary parts included."""
    a, b = (np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                       dtype=np.complex128) for x in (ours, ref))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def as_np(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def to_torch(x, dtype=np.float64) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of ``dtype``."""
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True))


def span_rel(ours, ref) -> float:
    """max |ours - ref| over the span of ``ref``."""
    a, b = as_np(ours), as_np(ref)
    span = float(b.max() - b.min()) or 1.0
    return float(np.max(np.abs(a - b))) / span


def ring_equal(a, b) -> bool:
    """The boundary rings of two fields are bit-identical."""
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b)
    return all(np.array_equal(a[s], b[s]) for s in
               (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]))


def fields(seed: int, shape, n: int = 2, dtype=np.float64) -> list[np.ndarray]:
    """``n`` standard-normal fields from one seed."""
    g = rng(seed)
    return [g.standard_normal(shape).astype(dtype) for _ in range(n)]


def c_struct_fields(source: str, struct: str) -> list[tuple[str, str]]:
    """The fields of C struct ``struct`` in a kernel source, in order, as
    (name, "ptr" | "int" | "double"): what a ctypes argument block must list."""
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", source, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"^\s*(const void\*|void\*|const long long\*|const int\*"
                                   r"|int\*|unsigned char\*|int|double)"
                                   r"\s+([\w, ]+);", body, re.M):
        fields += [(n.strip(), "ptr" if "*" in ctype else ctype) for n in names.split(",")]
    return fields


def ctypes_fields(args_type) -> list[tuple[str, str]]:
    """A ctypes ``Structure``'s fields as :func:`c_struct_fields` lists them."""
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_double": "double"}
    return [(name, kinds[t.__name__]) for name, t in args_type._fields_]


def cli_run(main, argv, capsys) -> tuple[int, dict]:
    """(exit code, the JSON object of the last stdout line; a mode that
    prints indented JSON prints it whole) of one CLI call."""
    import json
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out.strip()
    try:
        return rc, json.loads(out)
    except ValueError:
        return rc, json.loads(out.splitlines()[-1])


def flat_json(d: dict, prefix: str = "") -> dict:
    """A nested JSON object flattened to dotted keys."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat_json(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def json_mismatches(ours: dict, ref: dict, tol: float) -> dict:
    """The entries of two CLI JSON objects that differ: keys in one only,
    strings and booleans unequal, numbers (and lists of numbers) further
    apart than ``tol`` relative to ``ref``'s largest magnitude."""
    a, b = flat_json(ours), flat_json(ref)
    bad = {k: "missing" for k in set(a) ^ set(b)}
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        numeric = isinstance(y, (int, float, list)) and not isinstance(y, bool) and \
            not (isinstance(y, list) and y and not isinstance(y[0], (int, float)))
        if numeric and y is not None and x is not None and (not isinstance(y, list) or y):
            xa, ya = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
            err = float(np.max(np.abs(xa - ya)) / max(np.max(np.abs(ya)), 1e-300))
            if xa.shape != ya.shape or not err <= tol:
                bad[k] = (x, y)
        elif x != y:
            bad[k] = (x, y)
    return bad


def report_mismatches(ours: dict, ref: dict, rules: dict | None = None) -> dict:
    """The differences of a port campaign report from the JAX package's
    committed one: the lanes' names and statuses, the metrics' keys, and
    every metric's value, equal within 1e-9 relative unless ``rules`` names
    another rule for ``(lane, metric)``:

    * ``("rel", tol)`` / ``("abs", tol)``: within ``tol`` relative to the
      reference's largest magnitude / absolutely;
    * ``("below", limit)``: both values at or below ``limit`` (the lane's
      own threshold, for rounding-noise metrics);
    * ``("timing", None)``: a time, reported, not compared;
    * ``("equal", value)``: equal to ``value`` (not to the reference's).
    """
    rules = rules or {}
    bad = {}
    lanes_o = {lane["name"]: lane for lane in ours["lanes"]}
    lanes_r = {lane["name"]: lane for lane in ref["lanes"]}
    if list(lanes_o) != list(lanes_r):
        return {"lanes": (list(lanes_o), list(lanes_r))}
    if ours["overall_status"] != ref["overall_status"]:
        bad["overall_status"] = (ours["overall_status"], ref["overall_status"])
    for name, lo in lanes_o.items():
        lr = lanes_r[name]
        for key in ("status", "thresholds"):
            if lo[key] != lr[key]:
                bad[(name, key)] = (lo[key], lr[key])
        mo, mr = lo["metrics"], lr["metrics"]
        if set(mo) != set(mr):
            bad[(name, "metrics")] = sorted(set(mo) ^ set(mr))
            continue
        for key, y in mr.items():
            x = mo[key]
            kind, tol = rules.get((name, key), ("rel", 1e-9))
            if kind == "timing":
                continue
            if kind == "equal":
                if x != tol:
                    bad[(name, key)] = (x, tol)
                continue
            if isinstance(y, (bool, str)) or y is None or (
                    isinstance(y, list) and y and isinstance(y[0], str)):
                ok = x == y
            else:
                xa, ya = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
                if xa.shape != ya.shape:
                    ok = False
                elif kind == "below":
                    ok = bool(np.all(xa <= tol) and np.all(ya <= tol))
                elif kind == "abs":
                    ok = bool(np.all(np.abs(xa - ya) <= tol))
                else:
                    scale = max(float(np.max(np.abs(ya))) if ya.size else 0.0, 1e-300)
                    ok = bool(np.all(np.abs(xa - ya) <= tol * scale))
            if not ok:
                bad[(name, key)] = (x, y)
    return bad


def flat_report(report: dict, rename: dict | None = None) -> dict:
    """``report`` with each lane's nested metrics (dicts, lists of dicts)
    flattened to dotted keys (``machines.0.iterations``), so that
    :func:`report_mismatches` compares every leaf; ``rename`` maps metric
    keys (after flattening) to the names the other report uses."""
    def flat(prefix, v, out):
        if isinstance(v, dict):
            for k, x in v.items():
                flat(f"{prefix}.{k}" if prefix else str(k), x, out)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            for i, x in enumerate(v):
                flat(f"{prefix}.{i}", x, out)
        else:
            out[prefix] = v
        return out

    rename = rename or {}
    lanes = []
    for lane in report["lanes"]:
        metrics = {rename.get(k, k): v for k, v in flat("", lane["metrics"], {}).items()}
        lanes.append({**lane, "metrics": metrics})
    return {**report, "lanes": lanes}


def layout_mismatches(ours: dict, ref: dict, blocked_notes: dict | None = None) -> dict:
    """The layout differences of a port campaign report from the JAX
    package's committed one where the statuses may differ (a report made
    on the TPU against the port's CPU run): the lanes' names in order, and
    for each lane the port runs, its thresholds, notes and metric keys;
    each lane the port reports blocked must carry the note of
    ``blocked_notes`` (lane name -> the JAX script's off-TPU note) and no
    metrics."""
    blocked_notes = blocked_notes or {}
    lanes_o = {lane["name"]: lane for lane in ours["lanes"]}
    lanes_r = {lane["name"]: lane for lane in ref["lanes"]}
    if list(lanes_o) != list(lanes_r):
        return {"lanes": (list(lanes_o), list(lanes_r))}
    bad = {}
    for name, lo in lanes_o.items():
        lr = lanes_r[name]
        if lo["status"] == "blocked":
            if (lo["notes"], lo["metrics"], lo["thresholds"]) != (blocked_notes.get(name), {}, {}):
                bad[name] = ("blocked", lo["notes"], lo["metrics"])
            continue
        for key in ("thresholds", "notes"):
            if lo[key] != lr[key]:
                bad[(name, key)] = (lo[key], lr[key])
        if set(lo["metrics"]) != set(lr["metrics"]):
            bad[(name, "metrics")] = sorted(set(lo["metrics"]) ^ set(lr["metrics"]))
    return bad
