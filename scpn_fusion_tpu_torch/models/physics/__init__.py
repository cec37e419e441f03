"""Physics lanes (port of ``scpn_fusion_tpu/models/physics/``).

Only ``scaling_burn`` is ported so far (the transport stepper's He pump
takes its IPB98(y,2) scaling).  The JAX package's exports of this package
come with the modules that define them.
"""
