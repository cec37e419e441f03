"""The port's bisected boundary against its grid scan
(``tests/test_ballooning.py:62-71``'s gate), at the JAX test's sizes and the
default 4000 RK4 steps, in float64 on the CPU (row B's plain twin; the 24
bisection steps are 24 integrations one after another)."""

import torch

from scpn_fusion_tpu_torch.models.physics.ballooning import marginal_alpha, second_stability_scan


def test_marginal_matches_scan_boundary():
    s = 0.8
    res = second_stability_scan(torch.tensor([s], dtype=torch.float64), alpha_max=5.0,
                                n_alpha=96)
    cell = 5.0 / 95
    a_scan = float(res.alpha_crit_first[0])
    a_bis = float(marginal_alpha(s, alpha_hi=2.0, dtype=torch.float64, device="cpu"))
    assert abs(a_scan - a_bis) <= 2.0 * cell, (a_scan, a_bis)
