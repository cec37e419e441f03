"""Public C-2U FRC performance-reference table with explicit claim boundaries
(port of ``scpn_fusion_tpu/models/physics/frc_public.py``).

The published supplementary table of Baltz et al., "Achievement of Sustained
Net Plasma Heating in a Fusion Experiment with the Optometrist Algorithm",
Sci. Rep. 7, 6425 (2017), doi:10.1038/s41598-017-06645-7 (CC-BY-4.0): every
C-2U shot with sustained positive net heating.

* The table parses into a structure-of-arrays ``C2UTable`` of tensors, so
  the plausibility screen is one vectorised expression.
* The artifact is read fail-closed with a sha256 gate against its metadata.
  A missing artifact returns the ``blocked_missing_public_reference_artifact``
  status instead of raising.  The table is not part of this repository: it
  is looked for under ``validation/reference_data/frc_public/`` of the
  checkout.
* Unit conversions (kJ->J, mWb->Wb, keV->eV, ms->s, MW->W) and the
  strict-monotone shot-id / positive-column gates are the reference
  parser's.  The parser and the gates are host-side Python; the columns go
  to ``device`` in ``dtype`` (float32 by default; JAX takes its float from
  the x64 flag).
"""

from __future__ import annotations

import csv
import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import torch

C2U_CSV = (Path(__file__).resolve().parents[3] / "validation" / "reference_data" / "frc_public"
           / "c2u_optometrist_positive_heating_shots.csv")
C2U_METADATA = C2U_CSV.with_suffix(".metadata.json")
C2U_CLAIM_BOUNDARY = (
    "public C-2U positive-net-heating shot table; not Slough Fig. 5 "
    "trajectory parity and not a time-resolved compression benchmark")

_REQUIRED = ("shot", "Eth(kJ)", "Fp(mWb)", "T(keV)", "t_max(ms)",
             "P_max(MW)", "E_max(kJ)", "comment")


class C2UTable(NamedTuple):
    """SoA view of the published shot table (SI units)."""

    shot: torch.Tensor                    # (n,) int32
    thermal_energy_j: torch.Tensor        # (n,)
    poloidal_flux_wb: torch.Tensor
    total_temperature_ev: torch.Tensor
    time_of_max_heating_s: torch.Tensor
    net_heating_power_w: torch.Tensor
    energy_at_max_heating_j: torch.Tensor
    comments: tuple                       # strings

    @property
    def energy_per_flux_j_per_wb(self) -> torch.Tensor:
        return self.thermal_energy_j / self.poloidal_flux_wb


def _positive(value: str, column: str, row_number: int) -> float:
    try:
        parsed = float(value)
    except ValueError as exc:
        raise ValueError(
            f"C-2U row {row_number} column {column} must be numeric"
        ) from exc
    if not parsed > 0.0:
        raise ValueError(
            f"C-2U row {row_number} column {column} must be positive")
    return parsed


def load_c2u_table(path: Path = C2U_CSV, *, verify_sha256: bool = True,
                   dtype: torch.dtype | None = None,
                   device: torch.device | str = "cuda") -> C2UTable:
    """Parse + validate the public table; fail-closed on any malformation."""
    path = Path(path)
    raw = path.read_bytes()
    if verify_sha256 and C2U_METADATA.exists():
        meta = json.loads(C2U_METADATA.read_text())
        want = meta.get("source_sha256", "")
        got = hashlib.sha256(raw).hexdigest()
        if want and got != want:
            raise ValueError(
                f"C-2U table sha256 mismatch: {got} != {want}")

    lines = [ln for ln in raw.decode("utf-8").splitlines()
             if not ln.startswith("#")]
    rows = list(csv.DictReader(lines))
    if not rows:
        raise ValueError("C-2U reference table must contain at least one shot")

    cols: dict[str, list] = {k: [] for k in _REQUIRED}
    for i, row in enumerate(rows, start=1):
        missing = [k for k in _REQUIRED if k not in row or row[k] is None]
        if missing:
            raise ValueError(
                f"C-2U row {i} missing required column(s): "
                f"{', '.join(missing)}")
        shot = int(row["shot"])
        if shot <= 0:
            raise ValueError(f"C-2U row {i} column shot must be positive")
        cols["shot"].append(shot)
        for k in _REQUIRED[1:-1]:
            cols[k].append(_positive(row[k], k, i))
        cols["comment"].append(row["comment"].strip())

    shots = cols["shot"]
    if any(b <= a for a, b in zip(shots, shots[1:])):
        raise ValueError("C-2U shot identifiers must be strictly increasing")

    dtype = dtype or torch.float32

    def column(key: str, unit: float) -> torch.Tensor:
        return torch.tensor(cols[key], dtype=dtype, device=device) * unit

    return C2UTable(
        shot=torch.tensor(shots, dtype=torch.int32, device=device),
        thermal_energy_j=column("Eth(kJ)", 1e3),
        poloidal_flux_wb=column("Fp(mWb)", 1e-3),
        total_temperature_ev=column("T(keV)", 1e3),
        time_of_max_heating_s=column("t_max(ms)", 1e-3),
        net_heating_power_w=column("P_max(MW)", 1e6),
        energy_at_max_heating_j=column("E_max(kJ)", 1e3),
        comments=tuple(cols["comment"]))


def c2u_reference_status(path: Path = C2U_CSV, *, dtype: torch.dtype | None = None,
                         device: torch.device | str = "cuda") -> dict:
    """Acceptance status dict (reference ``c2u_positive_heating_reference_status``)."""
    if not Path(path).exists() or not C2U_METADATA.exists():
        return {
            "case": "c2u_positive_net_heating_shots",
            "status": "blocked_missing_public_reference_artifact",
            "required_artifact":
                "C-2U supplemental shot table plus metadata",
        }
    t = load_c2u_table(path, dtype=dtype, device=device)
    return {
        "case": "c2u_positive_net_heating_shots",
        "status": "public_reference_table_available",
        "shot_count": int(t.shot.shape[0]),
        "shot_min": int(t.shot[0]),
        "shot_max": int(t.shot[-1]),
        "max_thermal_energy_j": float(t.thermal_energy_j.max()),
        "max_poloidal_flux_wb": float(t.poloidal_flux_wb.max()),
        "max_total_temperature_ev": float(t.total_temperature_ev.max()),
        "max_net_heating_power_w": float(t.net_heating_power_w.max()),
        "claim_boundary": C2U_CLAIM_BOUNDARY,
    }


def c2u_regime_screen(t: C2UTable) -> dict:
    """Vectorised plausibility screen of the published operating points:
    sub-keV total temperature, milliweber-scale flux, net heating power below
    the machine's ~10 MW NBI budget, the time of maximum heating inside the
    0-12 ms C-2U pulse, and the energy at maximum heating within 10x the
    thermal energy.  Claim-boundary checks on the data contract, not a
    trajectory-parity benchmark (``C2U_CLAIM_BOUNDARY``)."""
    ok_temp = bool(((t.total_temperature_ev > 50.0)
                    & (t.total_temperature_ev < 2000.0)).all())
    ok_flux = bool(((t.poloidal_flux_wb > 1e-4) & (t.poloidal_flux_wb < 0.1)).all())
    ok_power = bool((t.net_heating_power_w < 10e6).all())
    ok_time = bool(((t.time_of_max_heating_s > 0.0)
                    & (t.time_of_max_heating_s <= 12e-3)).all())
    ok_energy = bool((t.energy_at_max_heating_j < 10.0 * t.thermal_energy_j).all())
    return {
        "temperature_band_ok": ok_temp,
        "flux_band_ok": ok_flux,
        "power_budget_ok": ok_power,
        "heating_window_ok": ok_time,
        "energy_consistency_ok": ok_energy,
        "all_ok": ok_temp and ok_flux and ok_power and ok_time and ok_energy,
    }
