"""The port's shaped (Miller) ballooning tier and bootstrap path held to the
gates of the JAX tests (``tests/test_ballooning.py:105-181``), at their
sizes and RK4 steps (4000; 2000 on the bootstrap path), in float64 on the
CPU (row B's plain twin)."""

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.physics.ballooning import (
    ballooning_stable,
    bootstrap_path_alpha_crit,
    miller_ballooning_stable,
    miller_marginal_alpha,
)

F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
DIIID = dict(r0=1.67, a=0.67, rho=0.95, kappa=1.74, delta=0.3, q=5.7)


def test_thin_tube_recovers_s_alpha_exactly():
    s = torch.tensor([0.5, 1.0, 2.0], dtype=F64)[:, None]
    alphas = torch.tensor(np.linspace(0.0, 3.0, 25))[None, :]
    circ = ballooning_stable(s, alphas)
    thin = miller_ballooning_stable(s, alphas, rho=1e-4, kappa=1.0, delta=0.0)
    assert bool(torch.all(circ == thin))


def test_elongation_stabilises_first_boundary():
    acs = [float(miller_marginal_alpha(1.0, r0=3.0, a=1.0, rho=0.9, kappa=k, delta=0.0, q=3.0,
                                       **CPU)) for k in (1.0, 1.4, 1.8)]
    assert acs[0] < acs[1] < acs[2]


def test_positive_triangularity_opens_second_stability():
    alphas = torch.tensor(np.linspace(0.0, 8.0, 81))

    def band(delta, s):
        st = miller_ballooning_stable(torch.tensor(s, dtype=F64), alphas, rho=0.9, kappa=1.8,
                                      delta=delta, q=3.0).numpy()
        un = ~st
        if not un.any():
            return None
        i_last = len(un) - 1 - int(np.argmax(un[::-1]))
        return float(alphas[np.argmax(un)]), float(alphas[i_last])

    assert band(0.4, 0.5) is None          # PT: full access
    b_nt, b_circ = band(-0.4, 1.0), band(0.0, 1.0)
    assert b_nt is not None and b_circ is not None
    assert b_nt[1] > b_circ[1]             # NT: band extends higher


def test_strong_bootstrap_dodges_band():
    res = bootstrap_path_alpha_crit(2.04, 3.0, alpha_hi=16.0, n_steps=2000, **DIIID, **CPU)
    assert bool(res.second_access)
    assert float(res.alpha_crit) == 16.0


def test_weak_bootstrap_hits_band_nose():
    res = bootstrap_path_alpha_crit(2.04, 1.5, alpha_hi=16.0, n_steps=2000, **DIIID, **CPU)
    assert not bool(res.second_access)
    assert 0.0 < float(res.alpha_crit) < 2.0


def test_zero_bootstrap_matches_fixed_shear_boundary():
    res = bootstrap_path_alpha_crit(2.04, 0.0, alpha_hi=8.0, n_grid=65, n_steps=2000, **DIIID,
                                    **CPU)
    fixed = float(miller_marginal_alpha(2.04, alpha_hi=8.0, n_grid=65, n_steps=2000, **DIIID,
                                        **CPU))
    assert abs(float(res.alpha_crit) - (fixed - 8.0 / 64.0)) < 1e-9
