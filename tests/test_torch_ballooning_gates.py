"""The port's s-alpha ballooning solver held to the gates of the JAX tests
(``tests/test_ballooning.py:26-86``), at their sizes and the default 4000
RK4 steps, in float64 on the CPU (row B's plain twin): the traversal
stable -> unstable -> stable at s = 0.5, the band structure of the scan, the
first boundary non-decreasing in shear, the helpers, and the bisected
boundary against the Connor-Hastie-Taylor estimate.  The marginal-vs-scan
gate is in ``test_torch_ballooning_marginal.py``.  (The ``stability_mhd``
eigen lane comes with that module.)
"""

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.physics.ballooning import (
    ballooning_stable,
    marginal_alpha,
    second_stability_scan,
)

F64 = torch.float64


def _linspace(a, b, n):
    return torch.tensor(np.linspace(a, b, n))


def test_traversal_first_unstable_second():
    stab = ballooning_stable(0.5, torch.tensor([0.1, 0.8, 3.5], dtype=F64))
    assert stab.tolist() == [True, False, True]


def test_scan_band_structure_consistent():
    res = second_stability_scan(_linspace(0.1, 2.0, 8), alpha_max=5.0, n_alpha=48)
    a1, a2 = res.alpha_crit_first.numpy(), res.alpha_crit_second.numpy()
    assert res.second_access.numpy().all()
    assert (a1 > 0.0).all()
    assert (a2 > a1).all()
    assert (a2 <= 5.0).all()


def test_first_boundary_non_decreasing_in_shear():
    res = second_stability_scan(_linspace(0.25, 2.0, 8), alpha_max=5.0, n_alpha=48)
    a1 = res.alpha_crit_first.numpy()
    assert (np.diff(a1) >= -1e-12).all(), a1


def test_interp_and_classification_helpers():
    res = second_stability_scan(_linspace(0.2, 2.0, 10), alpha_max=5.0, n_alpha=48)
    mid, lo, hi = (float(res.alpha_crit_at(x)) for x in (1.1, 0.2, 2.0))
    assert lo <= mid <= hi
    assert bool(res.has_second_stability_at(0.5))


def test_marginal_alpha_matches_connor_hastie_estimate():
    a_crit = float(marginal_alpha(1.0, alpha_hi=2.0, dtype=F64, device="cpu"))
    assert 0.45 < a_crit < 0.75, a_crit
