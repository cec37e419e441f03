"""Port parity: ``run_ladder`` of ``control/disturbance_ladder.py`` on the
ELM-pacing scenario (30,000 ticks) in float64: the three linear lanes in one
``cuda_ladder.ladder`` call (its plain loop here), the SNN lane through row
N's linear variant (its per-tick loop here), against JAX's ``run_ladder``:
ISE, overshoot and control effort within 1e-9, settling times and stability
equal, every lane stable.
"""

import jax.numpy as jnp
import torch

from scpn_fusion_tpu.control import disturbance_ladder as jl
from scpn_fusion_tpu_torch.control import disturbance_ladder as tl


def test_ladder_elm_pacing_matches_jax():
    ours = tl.run_ladder(("elm_pacing",), dtype=torch.float64, device="cpu")
    ref = jl.run_ladder(("elm_pacing",), dtype=jnp.float64)
    assert list(ours) == list(ref)
    for key in ref:
        for f in ("ise", "overshoot", "control_effort"):
            assert abs(ours[key][f] - ref[key][f]) <= 1e-9 * abs(ref[key][f]), (key, f)
        assert ours[key]["settling_time_s"] == ref[key]["settling_time_s"], key
        assert ours[key]["stable"] == ref[key]["stable"] is True, key
