"""Studio capability contract: the verbs this framework federates.

Counterpart of the reference's platform-contract surface
(``studio/verbs.py:28-183`` + ``studio/federation.py:8-45``): eight
verbs — the six core-spine verbs (reconstruct, simulate, analyse,
validate, benchmark, replay) plus the two fusion-distinctive ones
(control, predict) — each carrying the attribute contract a federation
hub gates against: safety tier, side-effect class, timing class (with
the control loop's real-time deadline), fidelity, the evidence-schema
families produced, and the backends that can execute it.

Self-contained (the ``scpn_studio_platform`` SDK is not in this image):
the enums are frozen string sets here, and the backend vocabulary is
the PyTorch port's actual execution tiers — ``torch-cuda`` (PyTorch ops
on the CUDA device), ``cuda-kernels`` (the hand-written CUDA kernels of
``csrc/``), ``cpp-native`` (the C ABI runtime), ``python`` (plain CPU
twins / host orchestration) — instead of the reference's rust/julia/go
matrix.  No verb is live-hardware: everything is
simulated or read-only, every tier is research (same invariant the
reference asserts).

The contract feeds ``emit_studio_manifest`` so the federation document
carries capabilities alongside the artifact inventory.
"""

from __future__ import annotations

import dataclasses

STUDIO_ID = "scpn-fusion-tpu"

# Evidence claim families (stable order => reproducible digest).
EVIDENCE_SCHEMAS = (
    "studio.equilibrium-reconstruction.v1",
    "studio.transport-solution.v1",
    "studio.gyrokinetic-parity.v1",
    "studio.mhd-stability.v1",
    "studio.physics-validation.v1",
    "studio.solver-benchmark.v1",
    "studio.evidence-replay.v1",
    "studio.control-replay.v1",
    "studio.disruption-forecast.v1",
)

SAFETY_TIERS = frozenset({"research"})
SIDE_EFFECTS = frozenset({"read-only", "simulated"})
TIMING_CLASSES = frozenset({"batch", "realtime"})
FIDELITIES = frozenset({"first-principles", "analytic", "reduced-order",
                        "ml-surrogate"})
BACKENDS = frozenset({"torch-cuda", "cuda-kernels", "cpp-native", "python"})


@dataclasses.dataclass(frozen=True)
class Verb:
    """One federated capability with its locked attribute contract."""

    name: str
    side_effect: str
    timing_class: str
    fidelity: str
    produces: tuple
    backends: tuple
    deadline_us: float | None = None
    safety_tier: str = "research"

    def __post_init__(self):
        if self.safety_tier not in SAFETY_TIERS:
            raise ValueError(f"unknown safety tier {self.safety_tier!r}")
        if self.side_effect not in SIDE_EFFECTS:
            raise ValueError(f"unknown side effect {self.side_effect!r}")
        if self.timing_class not in TIMING_CLASSES:
            raise ValueError(f"unknown timing class {self.timing_class!r}")
        if self.fidelity not in FIDELITIES:
            raise ValueError(f"unknown fidelity {self.fidelity!r}")
        unknown = set(self.backends) - BACKENDS
        if unknown:
            raise ValueError(f"unknown backends {sorted(unknown)}")
        bad = [s for s in self.produces if s not in EVIDENCE_SCHEMAS]
        if bad:
            raise ValueError(f"undeclared evidence schemas {bad}")
        if self.timing_class == "realtime" and self.deadline_us is None:
            raise ValueError("realtime verbs must declare a deadline")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["produces"] = list(self.produces)
        d["backends"] = list(self.backends)
        return d


FUSION_VERBS = (
    # core spine
    Verb("reconstruct", "read-only", "batch", "first-principles",
         ("studio.equilibrium-reconstruction.v1",),
         ("torch-cuda", "cuda-kernels", "cpp-native", "python")),
    Verb("simulate", "simulated", "batch", "first-principles",
         ("studio.transport-solution.v1",),
         ("torch-cuda", "cuda-kernels", "cpp-native", "python")),
    Verb("analyse", "read-only", "batch", "analytic",
         ("studio.gyrokinetic-parity.v1", "studio.mhd-stability.v1"),
         ("torch-cuda", "python")),
    Verb("validate", "read-only", "batch", "analytic",
         ("studio.physics-validation.v1",), ("python",)),
    Verb("benchmark", "simulated", "batch", "analytic",
         ("studio.solver-benchmark.v1",),
         ("torch-cuda", "cuda-kernels", "cpp-native", "python")),
    Verb("replay", "read-only", "batch", "analytic",
         ("studio.evidence-replay.v1",), ("python",)),
    # fusion-distinctive
    Verb("control", "simulated", "realtime", "reduced-order",
         ("studio.control-replay.v1",), ("torch-cuda", "python"),
         deadline_us=100.0),   # the 10 kHz loop period the fused
                               # controller tick is benchmarked against
    Verb("predict", "read-only", "batch", "ml-surrogate",
         ("studio.disruption-forecast.v1",), ("torch-cuda", "python")),
)


def capability_block() -> dict:
    """The federation contract block for ``emit_studio_manifest``."""
    assert all(v.safety_tier == "research" for v in FUSION_VERBS)
    return {
        "studio_id": STUDIO_ID,
        "verbs": [v.to_dict() for v in FUSION_VERBS],
        "evidence_schemas": list(EVIDENCE_SCHEMAS),
        "scope_boundaries": [
            "no live-hardware verb: all execution simulated or read-only",
            "single-language compute path (PyTorch + hand-written CUDA "
            "kernels) + C++ runtime; no rust/julia/go tiers",
            "f32 kernels on the CUDA device; f64 on its plain ops and the CPU",
        ],
    }
