"""I/O round-trip interchange campaign (GEQDSK <-> IMAS <-> solver), the
port's ``validation/run_io_roundtrip.py``.

Mirrors the reference's interchange lanes (`validation/
torax_imas_interchange.py`, `benchmark_sparc_geqdsk_rmse.py` file
handling, `core/eqdsk.py` writer/tokenizer contracts):

1. geqdsk_write_read_roundtrip — a SOLVED equilibrium exported via
   `geqdsk_from_solution` -> `write_geqdsk` -> `read_geqdsk` reproduces
   every field at format precision (the 16-char Fortran fixed-width
   format carries ~10 significant digits).
2. external_reader_compat — every 16-char field of the written file
   parses with a plain `float()` (bare-exponent forms must appear ONLY
   when the standard E form overflows 16 columns); 3-digit-exponent
   values still round-trip through OUR tokenizer.
3. sparc_efit_reparse — the real SPARC EFIT files (read-only reference
   data) re-serialised by our writer and re-read land within format
   precision of the original parse (no information loss on real files).
4. imas_ids_roundtrip — GEqdsk -> equilibrium IDS -> GEqdsk is lossless
   at f64, and the IDS validates against the schema contract.
5. solve_from_roundtripped — the round-tripped file drives
   `eqdsk_solve` to the same converged psi as the original (span-rel).

The exported equilibrium is the script's float32 solve (on a CUDA device
through kernels 2 and 3); the reconstructions of lane 5 run in float64,
as the script's x64 CPU runs them.  Writes into ``out_dir``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import tempfile
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import REFERENCE_DATA, iter_like

SPARC_DIR = REFERENCE_DATA / "sparc"
# the script's solve_equilibrium(cfg): JAX's default dtype, float32
EXPORT_DTYPE = torch.float32


def exported_config():
    """The solved equilibrium's machine: 65^2, Ip 150, multigrid Picard."""
    return iter_like("io-roundtrip", 65, ip=150.0, max_iterations=200,
                     convergence_threshold=1e-5, relaxation_factor=0.1,
                     solver_method="multigrid")


def field_rel(eq_a, eq_b, *, missing: str | None = None) -> tuple[float, dict]:
    """The worst max |a - b| / max |a| over the float fields of two
    ``GEqdsk``s, and each field's (or ``missing`` where a non-float field
    differs; such fields are skipped when ``missing`` is None)."""
    from scpn_fusion_tpu_torch.io.geqdsk import GEqdsk
    worst, fields = 0.0, {}
    for f in dataclasses.fields(GEqdsk):
        a = np.asarray(getattr(eq_a, f.name))
        b = np.asarray(getattr(eq_b, f.name))
        if a.dtype.kind not in "fc" or a.size == 0:
            if missing is not None and not np.array_equal(a, b):
                fields[f.name] = missing
            continue
        scale = max(float(np.max(np.abs(a))), 1e-30)
        rel = float(np.max(np.abs(a - b))) / scale
        fields[f.name] = rel
        worst = max(worst, rel)
    return worst, fields


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.io.geqdsk import geqdsk_from_solution, read_geqdsk, write_geqdsk
    from scpn_fusion_tpu_torch.io.imas_ids import (
        equilibrium_ids_to_geqdsk, geqdsk_to_equilibrium_ids, validate_equilibrium_ids,
    )
    from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium
    from scpn_fusion_tpu_torch.models.equilibrium.eqdsk_solve import solve_from_geqdsk
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    lanes = []
    with tempfile.TemporaryDirectory(prefix="io_roundtrip_") as tmp_dir:
        tmp = Path(tmp_dir)
        cfg = exported_config()
        res = solve_equilibrium(cfg, dtype=EXPORT_DTYPE, device=device)
        if not bool(res.converged):
            raise RuntimeError("io_roundtrip: the exported equilibrium did not converge")
        eq0 = geqdsk_from_solution(cfg, res)

        # ── Lane 1: write -> read field-level round-trip ──
        p = tmp / "solved.geqdsk"
        write_geqdsk(eq0, p)
        eq1 = read_geqdsk(p)
        worst, fields = field_rel(eq0, eq1, missing="mismatch")
        gate = 1e-9      # 16-char E-format carries ~10 significant digits
        lanes.append(LaneResult(
            name="geqdsk_write_read_roundtrip",
            status="pass" if worst <= gate else "fail",
            metrics={"worst_field_rel": worst,
                     "psi_rel": fields.get("psirz", 0.0),
                     "n_fields": len(fields)},
            thresholds={"worst_field_rel": gate},
            notes="solved 65x65 equilibrium through geqdsk_from_solution"))

        # ── Lane 2: external fixed-width reader compatibility ──
        bad_fields = 0
        n_fields = 0
        for line in p.read_text().splitlines()[1:]:
            toks = line.split()
            if toks and all(t.lstrip("+-").isdigit() for t in toks):
                continue  # the 2i5 nbbbs/limitr counts line is integer-formatted
            for i in range(0, len(line), 16):
                tok = line[i:i + 16].strip()
                if not tok:
                    continue
                n_fields += 1
                try:
                    v = float(tok)
                    if not math.isfinite(v):
                        bad_fields += 1
                except ValueError:
                    bad_fields += 1
        # 3-digit-exponent bare form must still round-trip through our reader
        eq_tiny = dataclasses.replace(eq0, sibry=float(eq0.sibry), simag=-1.5e-101)
        p_tiny = tmp / "tiny.geqdsk"
        try:
            write_geqdsk(eq_tiny, p_tiny)
            tiny_ok = abs(read_geqdsk(p_tiny).simag - (-1.5e-101)) <= 1e-110
        except Exception:                    # noqa: BLE001 -- the lane records a failure
            tiny_ok = False
        lanes.append(LaneResult(
            name="external_reader_compat",
            status="pass" if (bad_fields == 0 and tiny_ok) else "fail",
            metrics={"n_fields": n_fields, "float_unparseable": bad_fields,
                     "bare_exponent_roundtrip": tiny_ok},
            thresholds={"float_unparseable": 0},
            notes="every 16-char field float()s (round-2 advisor regression "
                  "gate); 3-digit exponents still round-trip via our tokenizer"))

        # ── Lane 3: real SPARC EFIT files re-serialise losslessly ──
        if SPARC_DIR.exists():
            files = sorted(SPARC_DIR.glob("*.geqdsk")) or sorted(SPARC_DIR.glob("g*.*"))
            worst_sparc, n_ok = 0.0, 0
            for src in files[:5]:
                try:
                    eq_a = read_geqdsk(src)
                except Exception:            # noqa: BLE001 -- an unreadable file is skipped
                    continue
                q = tmp / f"re_{src.name}"
                write_geqdsk(eq_a, q)
                eq_b = read_geqdsk(q)
                span = float(np.ptp(np.asarray(eq_a.psirz))) or 1.0
                rel = float(np.max(np.abs(np.asarray(eq_a.psirz)
                                          - np.asarray(eq_b.psirz)))) / span
                worst_sparc = max(worst_sparc, rel)
                n_ok += 1
            status = "pass" if (n_ok >= 3 and worst_sparc <= 1e-9) else (
                "blocked" if n_ok == 0 else "fail")
            lanes.append(LaneResult(
                name="sparc_efit_reparse",
                status=status,
                metrics={"n_files": n_ok, "worst_psi_span_rel": worst_sparc},
                thresholds={"worst_psi_span_rel": 1e-9, "min_files": 3},
                notes="real SPARC EFIT equilibria re-serialised by our writer"))
        else:
            lanes.append(LaneResult(name="sparc_efit_reparse", status="blocked",
                                    notes="SPARC reference data absent"))

        # ── Lane 4: IMAS equilibrium IDS round-trip ──
        ids = geqdsk_to_equilibrium_ids(eq0)
        validate_equilibrium_ids(ids)
        eq2 = equilibrium_ids_to_geqdsk(ids)
        worst_ids, _ = field_rel(eq0, eq2)
        lanes.append(LaneResult(
            name="imas_ids_roundtrip",
            status="pass" if worst_ids <= 1e-12 else "fail",
            metrics={"worst_field_rel": worst_ids},
            thresholds={"worst_field_rel": 1e-12},
            notes="GEqdsk -> equilibrium IDS -> GEqdsk lossless at f64; IDS "
                  "schema-validated"))

        # ── Lane 5: round-tripped file drives the solver to the same psi ──
        r_a = solve_from_geqdsk(eq0, dtype=torch.float64, device=device)
        r_b = solve_from_geqdsk(eq1, dtype=torch.float64, device=device)
        psi_a, psi_b = r_a.psi.cpu().numpy(), r_b.psi.cpu().numpy()
        span = float(np.ptp(psi_a)) or 1.0
        dev = float(np.max(np.abs(psi_a - psi_b))) / span
        ok = bool(r_a.converged) and bool(r_b.converged) and dev <= 1e-6
        lanes.append(LaneResult(
            name="solve_from_roundtripped",
            status="pass" if ok else "fail",
            metrics={"span_rel_dev": dev,
                     "converged_a": bool(r_a.converged),
                     "converged_b": bool(r_b.converged)},
            thresholds={"span_rel_dev": 1e-6},
            notes="format-precision file perturbation does not move the "
                  "converged fixed point beyond solver tolerance"))

    path = write_report("io_roundtrip", lanes, out_dir=out_dir)
    overall = json.loads(path.read_text())["overall_status"]
    print(json.dumps({"overall": overall, "lanes": {ln.name: ln.status for ln in lanes}}))
    return 0 if overall == "pass" else 1

