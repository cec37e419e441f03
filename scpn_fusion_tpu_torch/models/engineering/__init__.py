"""Plant engineering: balance of plant, thermal hydraulics, HTS quench,
direct energy conversion (port of ``scpn_fusion_tpu/models/engineering/``).

The quench transient runs through row H on the card
(``ops/cuda_quench.py``); ``direct_energy`` is the JAX package's module
carried over as it is (it imports no JAX)."""

from scpn_fusion_tpu_torch.models.engineering.balance_of_plant import (
    CoolantLoop,
    PlantParams,
    PlantPerformance,
    churchill_friction_factor,
    plant_performance,
    pumping_power,
)
from scpn_fusion_tpu_torch.models.engineering.direct_energy import (
    DECChannel,
    DECFault,
    DECReport,
    evaluate_direct_energy_conversion,
)
from scpn_fusion_tpu_torch.models.engineering.hts_quench import (
    QuenchReport,
    QuenchScenario,
    REBCOConductor,
    current_sharing_temperature_k,
    evaluate_rebco_quench,
    simulate_quench_transient,
)

__all__ = [
    "CoolantLoop",
    "DECChannel",
    "DECFault",
    "DECReport",
    "PlantParams",
    "PlantPerformance",
    "QuenchReport",
    "QuenchScenario",
    "REBCOConductor",
    "churchill_friction_factor",
    "current_sharing_temperature_k",
    "evaluate_direct_energy_conversion",
    "evaluate_rebco_quench",
    "plant_performance",
    "pumping_power",
    "simulate_quench_transient",
]
