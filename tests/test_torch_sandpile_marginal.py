"""Port parity at the size of ``tests/test_sandpile_property.py``'s
marginal-slope test: 24 cells x 6000 drives through the plain twin of row S
(~384,000 sweeps of plain ops, the file's ~15 s).

Fed JAX's drive cells, the port's heights, avalanche sizes, edge flux and
mean slopes are EQUAL to JAX's ``run_sandpile(cfg, seed=0)`` in float64;
that test's gates (flux out, a final mean slope between 0.3 and 1 of the
critical slope, a largest avalanche over 5x the mean) hold for the port.
"""

import numpy as np
import torch
from test_torch_sandpile import jax_drive_indices

from scpn_fusion_tpu.models.physics import sandpile as js
from scpn_fusion_tpu_torch.models.physics import sandpile as ts


def test_reaches_marginal_slope_as_jax():
    cfg_j = js.SandpileConfig(n_cells=24, n_steps=6000)
    cfg = ts.SandpileConfig(n_cells=24, n_steps=6000)
    ref = js.run_sandpile(cfg_j, seed=0)
    ours = ts._run_sandpile(cfg, jax_drive_indices(cfg_j, 0), dtype=torch.float64, device="cpu")
    for name, a, b in zip(ref._fields, ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    stats = ts.avalanche_statistics(ours)
    assert stats == js.avalanche_statistics(ref)
    assert stats["total_flux_out"] > 0.0
    assert 0.3 * cfg.critical_slope < stats["final_mean_slope"] <= cfg.critical_slope
    assert stats["max_avalanche"] > 5.0 * max(stats["mean_avalanche"], 1.0)
