"""Standalone physics-invariant / safety-contract audit surface (port of
``scpn_fusion_tpu/scpn/contracts.py``).

Role parity with the reference's contracts layer
(``scpn/contracts.py:250-494``: ``PhysicsInvariant`` + violation
taxonomy + ``SafetyContract`` inhibitor verification).  Alongside the
host-side audit dataclasses, the invariant set becomes ONE vectorised check
on tensors (:func:`invariant_table`, :func:`check_invariants_compiled`), so
a whole flight-sim trajectory or a batch of shots is audited on the device
in a few elementwise ops -- the reference audits tick-by-tick in Python.

The default invariant set is the standard tokamak operating envelope:
kink safety factor, Troyon normalised beta, Greenwald density fraction,
first-wall ion temperature, and the solver's own energy-bookkeeping
tolerance.  Severity follows the reference's 20 %-of-threshold band.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple, Sequence

import torch

_COMPARATORS = ("gt", "lt", "gte", "lte")


@dataclasses.dataclass(frozen=True)
class PhysicsInvariant:
    """One hard operating-envelope constraint (audited, never silently
    clipped).  ``comparator`` relates the MEASURED value to ``threshold``;
    the invariant holds when the relation is true."""

    name: str
    description: str
    threshold: float
    comparator: str

    def __post_init__(self) -> None:
        if self.comparator not in _COMPARATORS:
            raise ValueError(f"comparator must be one of {_COMPARATORS}, "
                             f"got {self.comparator!r}")
        if not math.isfinite(self.threshold):
            raise ValueError("threshold must be finite")

    def holds(self, value: float) -> bool:
        if not math.isfinite(value):
            return False
        return bool(_CMP_FNS[self.comparator](value, self.threshold))


_CMP_FNS = {
    "gt": lambda v, t: v > t,
    "lt": lambda v, t: v < t,
    "gte": lambda v, t: v >= t,
    "lte": lambda v, t: v <= t,
}


@dataclasses.dataclass(frozen=True)
class InvariantViolation:
    """Audit record for one violated invariant."""

    invariant: PhysicsInvariant
    value: float
    margin: float            # |value - threshold|, inf for non-finite value
    severity: str            # "warning" within 20 % of threshold, else "critical"


DEFAULT_INVARIANTS: tuple[PhysicsInvariant, ...] = (
    PhysicsInvariant(
        name="q_min",
        description="external-kink (m=1/n=1) stability needs the safety "
                    "factor above unity everywhere (Kruskal-Shafranov)",
        threshold=1.0, comparator="gt"),
    PhysicsInvariant(
        name="beta_N",
        description="no-wall Troyon limit on normalised beta "
                    "(beta[%] a B_T / I_p[MA]); above ~2.8 resistive wall "
                    "modes grow on the wall time",
        threshold=2.8, comparator="lt"),
    PhysicsInvariant(
        name="greenwald",
        description="line-averaged density over the Greenwald value "
                    "I_p/(pi a^2); sustained operation above ~1.2 ends in "
                    "radiative collapse / density-limit disruption",
        threshold=1.2, comparator="lt"),
    PhysicsInvariant(
        name="T_i",
        description="core ion temperature cap [keV] from first-wall and "
                    "divertor material limits under neutron load",
        threshold=25.0, comparator="lt"),
    PhysicsInvariant(
        name="energy_conservation_error",
        description="fractional injected/radiated/stored energy mismatch "
                    "of the simulation itself; beyond 1% the state is not "
                    "trustworthy for control decisions",
        threshold=0.01, comparator="lt"),
)

_WARN_BAND = 0.20


def check_invariant(inv: PhysicsInvariant,
                    value: float) -> InvariantViolation | None:
    """None when satisfied; otherwise a violation with margin + severity.

    Non-finite values are always critical: a NaN reading must never pass
    an envelope audit.
    """
    if not math.isfinite(value):
        return InvariantViolation(inv, value, float("inf"), "critical")
    if inv.holds(value):
        return None
    margin = abs(value - inv.threshold)
    ref = abs(inv.threshold) if inv.threshold != 0.0 else 1.0
    sev = "critical" if margin > _WARN_BAND * ref else "warning"
    return InvariantViolation(inv, value, margin, sev)


def check_all(values: Mapping[str, float],
              invariants: Sequence[PhysicsInvariant] = DEFAULT_INVARIANTS,
              ) -> list[InvariantViolation]:
    """Audit every invariant that has a reading in ``values``."""
    out = []
    for inv in invariants:
        if inv.name in values:
            v = check_invariant(inv, values[inv.name])
            if v is not None:
                out.append(v)
    return out


def should_trigger_mitigation(
        violations: Sequence[InvariantViolation]) -> bool:
    """One critical violation => engage mitigation (MGI / ramp-down)."""
    return any(v.severity == "critical" for v in violations)


# ── Compiled (vectorised) audit path ────────────────────────────────────────

class InvariantTable(NamedTuple):
    """Device-resident invariant set: thresholds + comparator codes."""

    names: tuple[str, ...]
    thresholds: torch.Tensor     # (K,)
    cmp_code: torch.Tensor       # (K,) 0=gt 1=lt 2=gte 3=lte
    signs: torch.Tensor          # (K,) +1 for gt/gte, -1 for lt/lte


def invariant_table(
        invariants: Sequence[PhysicsInvariant] = DEFAULT_INVARIANTS,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cuda") -> InvariantTable:
    codes = {c: i for i, c in enumerate(_COMPARATORS)}
    return InvariantTable(
        names=tuple(i.name for i in invariants),
        thresholds=torch.tensor([i.threshold for i in invariants], dtype=dtype,
                                device=device),
        cmp_code=torch.tensor([codes[i.comparator] for i in invariants],
                              dtype=torch.int32, device=device),
        signs=torch.tensor([1.0 if i.comparator in ("gt", "gte") else -1.0
                            for i in invariants], dtype=dtype, device=device),
    )


def check_invariants_compiled(table: InvariantTable, values: torch.Tensor):
    """Vectorised audit: values (..., K) aligned with ``table.names``.

    Returns ``(violated (..., K) bool, critical (..., K) bool,
    mitigate (...,) bool)`` — elementwise over any leading shape, so a whole
    trajectory audits at once.  Strict > / < are evaluated; the gte/lte codes
    share them with an equality allowance at f32 resolution (audit
    semantics, not control law).
    """
    v = values
    t = table.thresholds
    strict = torch.where(table.signs > 0, v > t, v < t)
    equal_ok = (table.cmp_code >= 2) & ((v - t).abs()
                                        <= 1e-6 * torch.clamp(t.abs(), min=1.0))
    satisfied = (strict | equal_ok) & torch.isfinite(v)
    violated = ~satisfied
    ref = torch.where(t != 0.0, t.abs(), torch.ones_like(t))
    margin = (v - t).abs()
    critical = violated & (~torch.isfinite(v) | (margin > _WARN_BAND * ref))
    return violated, critical, critical.any(dim=-1)


# ── Inhibitor safety contracts (place -> transition) ───────────────────────

@dataclasses.dataclass(frozen=True)
class SafetyContract:
    """A marked safety place must inhibit its control transition: tokens in
    ``safety_place`` > 0 while ``control_transition`` is enabled is a
    contract violation (inhibitor-arc semantics)."""

    safety_place: str
    control_transition: str


DEFAULT_SAFETY_CONTRACTS: tuple[SafetyContract, ...] = (
    SafetyContract("thermal_limit", "heat_ramp"),
    SafetyContract("density_limit", "density_ramp"),
    SafetyContract("beta_limit", "power_ramp"),
    SafetyContract("current_limit", "current_ramp"),
    SafetyContract("vertical_limit", "position_move"),
)


def verify_safety_contracts(
    *,
    safety_tokens: Mapping[str, float],
    transition_enabled: Mapping[str, bool],
    contracts: Sequence[SafetyContract] = DEFAULT_SAFETY_CONTRACTS,
) -> list[str]:
    """Textual audit of inhibitor contracts against a runtime snapshot
    (consumes ``safety_interlocks.safety_tokens_from_state`` /
    ``evaluate_transition_enablement`` outputs)."""
    out = []
    for c in contracts:
        tokens = float(safety_tokens.get(c.safety_place, 0.0))
        enabled = bool(transition_enabled.get(c.control_transition, False))
        if tokens > 0.0 and enabled:
            out.append(f"{c.safety_place} inhibits {c.control_transition}")
    return out
