"""Physics lanes (port of ``scpn_fusion_tpu/models/physics/``).

Ported so far: ``scaling_burn`` (the transport stepper's He pump takes its
IPB98(y,2) scaling), ``integrated_scenario`` (the whole-shot scenario of
``control/optimal_scenario.py``), ``ballooning`` (the Newcomb integration
through row B on the card) and ``edge`` (the SOL model and the EPED tiers).  The JAX package's exports of this package
come with the modules that define them.
"""
