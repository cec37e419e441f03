"""The SCPN neuro-symbolic controller (port of ``scpn_fusion_tpu/scpn/``),
with the JAX package's exports.  ``structure.py`` and
``safety_interlocks.py`` are numpy-only copies of the JAX package's files
(only the import line of the latter differs); ``proof_manifest.py`` is held
equal to its source outside its import lines and its device argument."""

from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet  # noqa: F401
from scpn_fusion_tpu_torch.scpn.controller import (  # noqa: F401
    CompiledController,
    ControllerConfig,
    ControllerState,
    controller_step,
    initial_controller_state,
    run_controller,
)
from scpn_fusion_tpu_torch.scpn.proof_manifest import (  # noqa: F401
    build_proof_manifest,
    verify_manifest_matches,
)
from scpn_fusion_tpu_torch.scpn.contracts import (  # noqa: F401
    DEFAULT_INVARIANTS,
    DEFAULT_SAFETY_CONTRACTS,
    PhysicsInvariant,
    SafetyContract,
    check_all,
    check_invariant,
    check_invariants_compiled,
    invariant_table,
    should_trigger_mitigation,
    verify_safety_contracts,
)
