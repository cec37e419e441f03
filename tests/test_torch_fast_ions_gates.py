"""The ensemble gates of ``tests/test_fast_ions.py`` on the port: its three
4000-step alpha populations -- 256 centrally born (PRNGKey(0)), 512 born
within 0.4 m and 512 within 1.6 m (PRNGKey(7)), JAX's draws fed to
``fast_ions._sample_fast_ion_birth`` -- run as ONE batch of 1280 through row
F's wrapper (its CPU path, the plain twin), their statistics taken per
population with ``fast_ions.ensemble_stats``: the partition, loss fraction
< 0.35, trapped fraction in (0.05, 0.75), energy drift < 1e-2, and the
wider birth trapping more (by 0.02).  The per-population counts equal those
of JAX's runs of the same populations (218 / 38 / 0 for the central one).
"""

import jax
import torch
from test_torch_fast_ions import A, F64, FIELD_T, WALLS, births

from scpn_fusion_tpu.models.physics import fast_ions as jf
from scpn_fusion_tpu_torch.models.physics import fast_ions as tf
from scpn_fusion_tpu_torch.ops import cuda_orbits as co


def test_gates_of_the_jax_tests():
    pops = [births(jax.random.PRNGKey(0), 256, A)[1], births(jax.random.PRNGKey(7), 512, 0.4)[1],
            births(jax.random.PRNGKey(7), 512, 1.6)[1]]
    packed = torch.cat([torch.stack(list(s)) for s in pops], dim=1)
    c = tf.ensemble_constants(jf.ALPHA_AMU, jf.ALPHA_Z, 1e-8, **WALLS, dtype=F64, device="cpu")
    y_f, lost, bounced, drift = co.gc_ensemble(c, FIELD_T, packed, 4000)
    stats, start = [], 0
    for s in pops:
        part = slice(start, start + s.r.shape[0])
        stats.append(tf.ensemble_stats(s, y_f[part], lost[part], bounced[part], drift[part]))
        start += s.r.shape[0]
    central, narrow, wide = stats
    assert int(central.n_passing + central.n_trapped + central.n_lost) == 256
    assert float(central.loss_fraction) < 0.35
    assert 0.05 < float(central.trapped_fraction) < 0.75
    assert float(central.energy_drift_rel_max) < 1e-2
    assert float(wide.trapped_fraction) > float(narrow.trapped_fraction) + 0.02
    # JAX's runs of the same populations (tests/test_fast_ions.py's fixtures)
    assert (int(central.n_passing), int(central.n_trapped), int(central.n_lost)) == (218, 38, 0)
    assert (int(narrow.n_trapped), int(wide.n_trapped)) == (44, 75)
