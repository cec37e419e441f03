"""TGLF canonical-case benchmark surface for the reduced closures.

Counterpart of the reference's public TGLF-interface benchmark layer:

* ``core/_tglf_interface_reference.py:57-130`` — reconstruct a local
  transport state from a canonical ITG/TEM/ETG fixture's
  ``input_parameters`` and validate the reduced closure against its
  ``tglf_output`` (gyro-Bohm chi levels + dominant-mode match);
* ``core/_tglf_interface_benchmark.py:26-112`` — chi-profile comparison
  (RMS / correlation / max relative error) against the published TGLF v4
  regime profiles, with a markdown summary table.

Fixtures live in ``validation/configs/tglf_reference/`` (same canonical
Staebler 2007 / Kinsey 2008 data the reference ships).  Design deltas:
results are NamedTuples over jnp/np scalars; the closure under test is
the branchless :mod:`models.transport.reduced_closure`; profile
comparison is pure numpy (host-side evidence code, not a compute path).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

from scpn_fusion_tpu_torch.models.transport.reduced_closure import (
    ClosureInputs,
    channel_name,
    critical_gradient_fluxes,
    gyro_bohm_diffusivity,
)

FIXTURE_DIR = (Path(__file__).resolve().parents[3]
               / "validation" / "configs" / "tglf_reference")

#: Published TGLF v4 regime chi profiles (reference
#: ``_tglf_interface_reference.py:30-49`` REFERENCE_CASES).
PROFILE_CASES_FILE = "chi_profile_cases.json"


def case_filename(case_name: str) -> str:
    """``'ITG-dominated' -> 'itg_dominated.json'`` (reference
    ``_reference_case_filename``, ``_tglf_interface_reference.py:52-54``)."""
    return case_name.lower().replace("-", "_").replace(" ", "_") + ".json"


def load_reference_case(case_name: str,
                        ref_dir: str | Path = FIXTURE_DIR) -> dict:
    """Load a canonical fixture; fail closed on schema violations."""
    path = Path(ref_dir) / case_filename(case_name)
    payload = json.loads(path.read_text(encoding="utf-8"))
    for key in ("case_name", "input_parameters", "tglf_output"):
        if key not in payload:
            raise ValueError(f"TGLF fixture {path} missing '{key}'")
    return payload


def case_to_closure_inputs(payload: dict, *,
                           ti_kev: float = 10.0, device="cuda") -> ClosureInputs:
    """Canonical fixture ``input_parameters`` -> local closure state
    (reference ``_reference_case_to_transport_input``,
    ``_tglf_interface_reference.py:57-82``): Te from the Te/Ti ratio, ne
    back-solved from beta_e via beta_e ~= 4.03e-3 ne_19 Te_keV at the
    fixture's reference field."""
    params = payload["input_parameters"]
    ti = max(float(ti_kev), 0.2)
    te = max(ti * float(params.get("T_e_T_i", 1.0)), 0.2)
    ne = max(float(params["beta_e"]) / max(4.03e-3 * te, 1e-6), 0.2)
    from scpn_fusion_tpu_torch.io import torch_arrays
    jnp = torch_arrays.on(device)

    f = lambda v: jnp.asarray(float(v))  # noqa: E731
    return ClosureInputs(
        rho=f(params["rho_tor"]), te_kev=f(te), ti_kev=f(ti), ne_19=f(ne),
        grad_te=f(params["R_LT_e"]), grad_ti=f(params["R_LT_i"]),
        grad_ne=f(params["R_Ln_e"]), q=f(params["q"]),
        s_hat=f(params["s_hat"]), beta_e=f(params["beta_e"]),
        r_major_m=f(params["R_major_m"]), a_minor_m=f(params["a_minor_m"]),
        b_tesla=f(params["B_toroidal_T"]), z_eff=f(params["Z_eff"]))


class ReferenceCaseResult(NamedTuple):
    """Counterpart of the reference's ``TGLFReferenceCaseResult``."""

    case_name: str
    reference_mode: str
    predicted_mode: str
    mode_match: bool
    predicted_chi_i_gyrobohm: float
    predicted_chi_e_gyrobohm: float
    reference_chi_i_gyrobohm: float
    reference_chi_e_gyrobohm: float
    rel_error_chi_i: float
    rel_error_chi_e: float


def validate_reference_case(case_name: str, *, ti_kev: float = 10.0,
                            ref_dir: str | Path = FIXTURE_DIR, device="cuda",
                            ) -> ReferenceCaseResult:
    """Run the reduced closure against one canonical TGLF regime
    (reference ``validate_reduced_transport_reference_case``,
    ``_tglf_interface_reference.py:85-118``)."""
    payload = load_reference_case(case_name, ref_dir)
    inp = case_to_closure_inputs(payload, ti_kev=ti_kev, device=device)
    fluxes = critical_gradient_fluxes(inp)
    chi_gb = float(gyro_bohm_diffusivity(inp))
    ref = payload["tglf_output"]

    pred_i = float(fluxes.chi_i) / max(chi_gb, 1e-12)
    pred_e = float(fluxes.chi_e) / max(chi_gb, 1e-12)
    ref_i = float(ref["chi_i_gyroBohm"])
    ref_e = float(ref["chi_e_gyroBohm"])
    reference_mode = str(ref["dominant_mode"])
    predicted_mode = channel_name(fluxes.channel)
    return ReferenceCaseResult(
        case_name=str(payload.get("case_name", case_name)),
        reference_mode=reference_mode,
        predicted_mode=predicted_mode,
        mode_match=predicted_mode == reference_mode,
        predicted_chi_i_gyrobohm=pred_i,
        predicted_chi_e_gyrobohm=pred_e,
        reference_chi_i_gyrobohm=ref_i,
        reference_chi_e_gyrobohm=ref_e,
        rel_error_chi_i=abs(pred_i - ref_i) / max(abs(ref_i), 1e-6),
        rel_error_chi_e=abs(pred_e - ref_e) / max(abs(ref_e), 1e-6))


def validate_reference_suite(*, ti_kev: float = 10.0,
                             ref_dir: str | Path = FIXTURE_DIR, device="cuda",
                             ) -> list[ReferenceCaseResult]:
    """All three canonical regimes (reference
    ``validate_reduced_transport_reference_suite`` :121-130)."""
    return [validate_reference_case(name, ti_kev=ti_kev, ref_dir=ref_dir, device=device)
            for name in ("ITG-dominated", "TEM-dominated",
                         "ETG-dominated")]


# ── Chi-profile comparison (reference _tglf_interface_benchmark.py) ──


class ChiProfileComparison(NamedTuple):
    """Counterpart of the reference's ``TGLFComparisonResult``."""

    case_name: str
    rho_points: np.ndarray
    our_chi_i: np.ndarray
    our_chi_e: np.ndarray
    tglf_chi_i: np.ndarray
    tglf_chi_e: np.ndarray
    rms_error_chi_i: float
    rms_error_chi_e: float
    correlation_chi_i: float
    correlation_chi_e: float
    max_rel_error_chi_i: float
    max_rel_error_chi_e: float


def load_profile_cases(ref_dir: str | Path = FIXTURE_DIR) -> dict:
    """Published TGLF v4 regime chi(rho) profiles, one dict per case."""
    payload = json.loads(
        (Path(ref_dir) / PROFILE_CASES_FILE).read_text(encoding="utf-8"))
    for name, case in payload.items():
        for key in ("rho_points", "chi_i", "chi_e"):
            if key not in case:
                raise ValueError(
                    f"profile case '{name}' missing '{key}'")
    return payload


def compare_chi_profiles(
    our_chi_i: np.ndarray,
    our_chi_e: np.ndarray,
    rho_grid: np.ndarray,
    case_name: str,
    case: dict,
) -> ChiProfileComparison:
    """Interpolate our chi profiles onto a case's rho points and score
    RMS / correlation / max-relative error (reference
    ``TGLFBenchmark.compare``, ``_tglf_interface_benchmark.py:34-72``)."""
    rho = np.asarray(case["rho_points"], dtype=np.float64)
    t_i = np.asarray(case["chi_i"], dtype=np.float64)
    t_e = np.asarray(case["chi_e"], dtype=np.float64)
    o_i = np.interp(rho, np.asarray(rho_grid, np.float64),
                    np.asarray(our_chi_i, np.float64))
    o_e = np.interp(rho, np.asarray(rho_grid, np.float64),
                    np.asarray(our_chi_e, np.float64))

    def corr(a, b):
        if a.size > 1 and np.std(a) > 0 and np.std(b) > 0:
            return float(np.corrcoef(a, b)[0, 1])
        return 0.0

    return ChiProfileComparison(
        case_name=case_name, rho_points=rho,
        our_chi_i=o_i, our_chi_e=o_e, tglf_chi_i=t_i, tglf_chi_e=t_e,
        rms_error_chi_i=float(np.sqrt(np.mean((o_i - t_i) ** 2))),
        rms_error_chi_e=float(np.sqrt(np.mean((o_e - t_e) ** 2))),
        correlation_chi_i=corr(o_i, t_i),
        correlation_chi_e=corr(o_e, t_e),
        max_rel_error_chi_i=float(np.max(
            np.abs(o_i - t_i) / np.maximum(np.abs(t_i), 1e-10))),
        max_rel_error_chi_e=float(np.max(
            np.abs(o_e - t_e) / np.maximum(np.abs(t_e), 1e-10))))


def comparison_table_md(results: list[ChiProfileComparison]) -> str:
    """Markdown summary table (reference
    ``generate_comparison_table``, ``_tglf_interface_benchmark.py:75-88``)."""
    lines = [
        "| Case | RMS chi_i | RMS chi_e | Corr chi_i | Corr chi_e "
        "| MaxRel chi_i | MaxRel chi_e |",
        "|------|-----------|-----------|------------|------------"
        "|--------------|--------------|",
    ]
    for r in results:
        lines.append(
            f"| {r.case_name} | {r.rms_error_chi_i:.3f} "
            f"| {r.rms_error_chi_e:.3f} | {r.correlation_chi_i:.3f} "
            f"| {r.correlation_chi_e:.3f} | {r.max_rel_error_chi_i:.3f} "
            f"| {r.max_rel_error_chi_e:.3f} |")
    return "\n".join(lines)
