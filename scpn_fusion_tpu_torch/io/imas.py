"""IMAS-lite connector: in-memory IDS trees + equilibrium/core-profiles maps.

Role-parity with the reference's IMAS layer (``io/imas_connector.py`` +
per-IDS modules ``imas_connector_{equilibrium,transport,...}.py``,
``io/imas_adapter.py``, ``core/imas_equilibrium_io.py``): the actual IMAS
access layer (``imas`` python module) is an optional heavyweight dependency
that is absent here, so — like the reference's OMAS path — IDSs are plain
nested dicts addressed by slash paths, JSON-serialisable, schema-checked
against a minimal declared structure, with converters to/from this
framework's solver types:

* ``equilibrium`` IDS  <->  (ReactorConfig grid, psi map, axis/X-point)
* ``core_profiles`` IDS  <->  :class:`~scpn_fusion_tpu.io.archive.MachineProfiles`

Fail-closed: unknown top-level IDS names and out-of-schema leaves raise.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

from scpn_fusion_tpu_torch.io.archive import MachineProfiles

MAX_IDS_BYTES = 32 * 1024 * 1024

# Minimal declared schemas: path -> kind ("scalar" | "array" | "array2d")
IDS_SCHEMAS: dict[str, dict[str, str]] = {
    "equilibrium": {
        "time": "scalar",
        "vacuum_toroidal_field/b0": "scalar",
        "vacuum_toroidal_field/r0": "scalar",
        "time_slice/global_quantities/ip": "scalar",
        "time_slice/global_quantities/magnetic_axis/r": "scalar",
        "time_slice/global_quantities/magnetic_axis/z": "scalar",
        "time_slice/global_quantities/psi_axis": "scalar",
        "time_slice/global_quantities/psi_boundary": "scalar",
        "time_slice/boundary/x_point/r": "scalar",
        "time_slice/boundary/x_point/z": "scalar",
        "time_slice/profiles_2d/grid/dim1": "array",
        "time_slice/profiles_2d/grid/dim2": "array",
        "time_slice/profiles_2d/psi": "array2d",
    },
    "core_profiles": {
        "time": "scalar",
        "global_quantities/ip": "scalar",
        "global_quantities/b0": "scalar",
        "global_quantities/r0": "scalar",
        "global_quantities/a_minor": "scalar",
        "profiles_1d/grid/rho_tor_norm": "array",
        "profiles_1d/electrons/temperature": "array",   # eV
        "profiles_1d/electrons/density": "array",       # m^-3
        "profiles_1d/t_i_average": "array",             # eV
    },
}


class IdsError(ValueError):
    pass


def ids_new(name: str) -> dict[str, Any]:
    if name not in IDS_SCHEMAS:
        raise IdsError(f"unknown IDS {name!r}; known: {sorted(IDS_SCHEMAS)}")
    return {"_ids": name}


def ids_put(ids: dict, path: str, value) -> None:
    """Set a leaf by slash path; path must be in the IDS schema."""
    schema = IDS_SCHEMAS.get(ids.get("_ids", ""))
    if schema is None:
        raise IdsError("not an IDS dict (missing _ids tag)")
    if path not in schema:
        raise IdsError(f"path {path!r} not in {ids['_ids']} schema")
    kind = schema[path]
    # Fail-closed coercion: hostile payloads (strings, ragged nests, None)
    # must surface as IdsError, never as a raw TypeError/ValueError from the
    # converter (fuzz finding, tests/test_fuzz_harness.py).
    if kind == "scalar":
        try:
            value = float(value)
        except (TypeError, ValueError) as exc:
            raise IdsError(f"{path} expects a real scalar: {exc}") from exc
    else:
        try:
            value = np.asarray(value, dtype=np.float64)
        except (TypeError, ValueError) as exc:
            raise IdsError(f"{path} expects a numeric array: {exc}") from exc
        if kind == "array" and value.ndim != 1:
            raise IdsError(f"{path} expects a 1D array")
        if kind == "array2d" and value.ndim != 2:
            raise IdsError(f"{path} expects a 2D array")
    node = ids
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def ids_get(ids: dict, path: str, default=None):
    node: Any = ids
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node


def ids_to_json(ids: dict, path: str | Path) -> Path:
    def conv(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(f"not serialisable: {type(o)}")
    p = Path(path)
    p.write_text(json.dumps(ids, default=conv))
    return p


def ids_from_json(path: str | Path) -> dict:
    p = Path(path)
    if p.stat().st_size > MAX_IDS_BYTES:
        raise IdsError(f"IDS file exceeds size cap: {p}")
    ids = json.loads(p.read_text())
    if not isinstance(ids, dict):
        raise IdsError(f"IDS file must hold a JSON object: {p}")
    name = ids.get("_ids")
    if name not in IDS_SCHEMAS:
        raise IdsError(f"file does not contain a known IDS: {p}")
    # Re-validate every present schema leaf (fail-closed).
    out = ids_new(name)
    for path_key in IDS_SCHEMAS[name]:
        val = ids_get(ids, path_key)
        if val is not None:
            ids_put(out, path_key, val)
    return out


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def equilibrium_to_ids(*, r_1d, z_1d, psi, ip_a: float, b0_t: float,
                       r0_m: float, axis_rz=(0.0, 0.0),
                       x_point_rz=(0.0, 0.0), psi_axis: float = 0.0,
                       psi_boundary: float = 0.0,
                       time_s: float = 0.0) -> dict:
    """Pack a solved equilibrium into an ``equilibrium`` IDS (reference
    ``imas_connector_equilibrium.py`` direction: solver -> IDS)."""
    ids = ids_new("equilibrium")
    ids_put(ids, "time", time_s)
    ids_put(ids, "vacuum_toroidal_field/b0", b0_t)
    ids_put(ids, "vacuum_toroidal_field/r0", r0_m)
    ids_put(ids, "time_slice/global_quantities/ip", ip_a)
    ids_put(ids, "time_slice/global_quantities/magnetic_axis/r", axis_rz[0])
    ids_put(ids, "time_slice/global_quantities/magnetic_axis/z", axis_rz[1])
    ids_put(ids, "time_slice/global_quantities/psi_axis", psi_axis)
    ids_put(ids, "time_slice/global_quantities/psi_boundary", psi_boundary)
    ids_put(ids, "time_slice/boundary/x_point/r", x_point_rz[0])
    ids_put(ids, "time_slice/boundary/x_point/z", x_point_rz[1])
    ids_put(ids, "time_slice/profiles_2d/grid/dim1", r_1d)
    ids_put(ids, "time_slice/profiles_2d/grid/dim2", z_1d)
    ids_put(ids, "time_slice/profiles_2d/psi", psi)
    return ids


def ids_to_equilibrium(ids: dict) -> dict:
    """Unpack an ``equilibrium`` IDS into plain solver-facing arrays."""
    if ids.get("_ids") != "equilibrium":
        raise IdsError("expected an equilibrium IDS")
    psi = ids_get(ids, "time_slice/profiles_2d/psi")
    r_1d = ids_get(ids, "time_slice/profiles_2d/grid/dim1")
    z_1d = ids_get(ids, "time_slice/profiles_2d/grid/dim2")
    if psi is None or r_1d is None or z_1d is None:
        raise IdsError("equilibrium IDS missing psi map or grid")
    if psi.shape != (z_1d.shape[0], r_1d.shape[0]):
        raise IdsError(f"psi shape {psi.shape} inconsistent with grid "
                       f"({z_1d.shape[0]}, {r_1d.shape[0]})")
    return {
        "r_1d": r_1d, "z_1d": z_1d, "psi": psi,
        "ip_a": ids_get(ids, "time_slice/global_quantities/ip", 0.0),
        "b0_t": ids_get(ids, "vacuum_toroidal_field/b0", 0.0),
        "r0_m": ids_get(ids, "vacuum_toroidal_field/r0", 0.0),
        "axis_rz": (
            ids_get(ids, "time_slice/global_quantities/magnetic_axis/r", 0.0),
            ids_get(ids, "time_slice/global_quantities/magnetic_axis/z", 0.0),
        ),
        "psi_axis": ids_get(ids, "time_slice/global_quantities/psi_axis", 0.0),
        "psi_boundary": ids_get(
            ids, "time_slice/global_quantities/psi_boundary", 0.0),
    }


def profiles_to_ids(profiles: MachineProfiles) -> dict:
    """MachineProfiles -> ``core_profiles`` IDS (SI units inside the IDS)."""
    ids = ids_new("core_profiles")
    ids_put(ids, "time", profiles.time_s)
    ids_put(ids, "global_quantities/ip", profiles.ip_ma * 1e6)
    ids_put(ids, "global_quantities/b0", profiles.b0_t)
    ids_put(ids, "global_quantities/r0", profiles.r0_m)
    ids_put(ids, "global_quantities/a_minor", profiles.a_m)
    ids_put(ids, "profiles_1d/grid/rho_tor_norm", profiles.rho)
    ids_put(ids, "profiles_1d/electrons/temperature",
            profiles.t_e_kev * 1e3)
    ids_put(ids, "profiles_1d/electrons/density", profiles.n_e_19 * 1e19)
    ids_put(ids, "profiles_1d/t_i_average", profiles.t_i_kev * 1e3)
    return ids


def ids_to_profiles(ids: dict, *, machine: str = "imas",
                    shot: int = 0) -> MachineProfiles:
    if ids.get("_ids") != "core_profiles":
        raise IdsError("expected a core_profiles IDS")
    rho = ids_get(ids, "profiles_1d/grid/rho_tor_norm")
    te = ids_get(ids, "profiles_1d/electrons/temperature")
    ne = ids_get(ids, "profiles_1d/electrons/density")
    ti = ids_get(ids, "profiles_1d/t_i_average")
    if rho is None or te is None or ne is None:
        raise IdsError("core_profiles IDS missing 1d profiles")
    if ti is None:
        ti = te
    return MachineProfiles(
        machine=machine, shot=shot,
        time_s=float(ids_get(ids, "time", 0.0)),
        rho=rho, t_e_kev=te / 1e3, t_i_kev=ti / 1e3, n_e_19=ne / 1e19,
        ip_ma=float(ids_get(ids, "global_quantities/ip", 0.0)) / 1e6,
        b0_t=float(ids_get(ids, "global_quantities/b0", 0.0)),
        r0_m=float(ids_get(ids, "global_quantities/r0", 0.0)),
        a_m=float(ids_get(ids, "global_quantities/a_minor", 1.0)),
        source="reference")
