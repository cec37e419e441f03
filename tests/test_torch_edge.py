"""Port parity: the edge physics (``models/physics/edge.py``).

In float64 on the CPU the Eich width, the peak target flux, the two-point SOL
model, the EPED-like pedestal (s-alpha tier, and with an ``alpha_crit``
override) and the shaped tier (Miller ballooning along the bootstrap path,
2000 RK4 steps through row B's plain twin) at the DIII-D inputs of
``tests/test_ballooning.py:188-192`` at 0.5, 1.0 and 1.5 MA are within 1e-9
of JAX; the gates of ``tests/test_edge_orbits_frc.py:29-75`` and
``tests/test_ballooning.py:184-198`` hold for the port.
"""

import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.models.physics import edge as je
from scpn_fusion_tpu_torch.models.physics import edge as te

TOL = 1e-9
CPU = dict(dtype=torch.float64, device="cpu")
DIIID = dict(n_ped_1e19=6.0, r0=1.67, a=0.67, b0=2.1, kappa=1.74)


def test_eich_and_peak_flux_match_jax():
    g = np.random.default_rng(3)
    for p, r0, bp, eps in zip(g.uniform(1, 200, 6), g.uniform(1, 9, 6), g.uniform(0.2, 2, 6),
                              g.uniform(0.1, 0.6, 6)):
        assert rel(te.eich_heat_flux_width(p, r0, bp, eps, **CPU),
                   je.eich_heat_flux_width(p, r0, bp, eps)) <= 1e-14
    assert float(te.eich_heat_flux_width(-1.0, 6.2, 1.2, 0.3, **CPU)) == 1.0
    for lam in (1e-3, 2e-3, 0.0):
        assert rel(te.peak_target_heat_flux(100.0, 6.2, lam, **CPU),
                   je.peak_target_heat_flux(100.0, 6.2, lam)) <= 1e-14


@pytest.mark.parametrize("n_u, f_rad", [(3.0, 0.0), (30.0, 0.0), (30.0, 0.9), (10.0, 0.5)])
def test_two_point_sol_matches_jax(n_u, f_rad):
    kw = dict(p_sol_mw=100.0, n_u_19=n_u, r0=6.2, a=2.0, q95=3.0, b_pol=1.2, f_rad=f_rad)
    ours, ref = te.two_point_sol(**kw, **CPU), je.two_point_sol(**kw)
    for a, b in zip(ours, ref):
        assert rel(a, b) <= 1e-13


def test_two_point_follows_a_tensor_input():
    f_rad = torch.tensor(0.4, dtype=torch.float64)
    sol = te.two_point_sol(p_sol_mw=100.0, n_u_19=3.0, r0=6.2, a=2.0, q95=3.0, b_pol=1.2,
                           f_rad=f_rad)
    assert sol.t_target_ev.dtype == torch.float64 and sol.t_target_ev.device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(n_ped_1e19=8.0, r0=6.2, a=2.0, b0=5.3, ip_ma=15.0),
                                dict(n_ped_1e19=12.0, r0=6.2, a=2.0, b0=5.3, ip_ma=15.0),
                                dict(DIIID, ip_ma=1.0),
                                dict(DIIID, ip_ma=1.0, alpha_crit=2.5, nu_star_width_exp=0.0)])
def test_eped_pedestal_matches_jax(kw):
    ours, ref = te.eped_pedestal(**kw, **CPU), je.eped_pedestal(**kw)
    for name, a, b in zip(ours._fields, ours, ref):
        assert rel(a, b) <= TOL, name


@pytest.mark.parametrize("ip_ma", [0.5, 1.0, 1.5])
def test_eped_shaped_matches_jax(ip_ma):
    ours = te.eped_pedestal_shaped(**DIIID, ip_ma=ip_ma, **CPU)
    ref = je.eped_pedestal_shaped(**DIIID, ip_ma=ip_ma)
    for name, a, b in zip(ours.pedestal._fields, ours.pedestal, ref.pedestal):
        assert rel(a, b) <= TOL, (ip_ma, name)
    for name in ("alpha_crit", "alpha_ballooning", "alpha_peeling"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, (ip_ma, name)
    assert bool(ours.second_access) == bool(ref.second_access)


class TestGates:
    def test_eich_width_iter_scale(self):
        lam = float(te.eich_heat_flux_width(100.0, 6.2, 1.2, 2.0 / 6.2, **CPU))
        assert 0.5 < lam < 2.0, lam

    def test_two_point_invariants(self):
        low = te.two_point_sol(p_sol_mw=100.0, n_u_19=3.0, r0=6.2, a=2.0, q95=3.0, b_pol=1.2,
                               **CPU)
        assert float(low.t_target_ev) == pytest.approx(float(low.t_upstream_ev))
        assert float(low.q_parallel_mw_m2) > 100.0
        high = te.two_point_sol(p_sol_mw=100.0, n_u_19=30.0, r0=6.2, a=2.0, q95=3.0, b_pol=1.2,
                                f_rad=0.9, **CPU)
        t_t, t_u = float(high.t_target_ev), float(high.t_upstream_ev)
        assert 0 < t_t < t_u
        np.testing.assert_allclose(float(high.n_target_19) * t_t, 30.0 * t_u / 2.0, rtol=1e-6)

    def test_radiation_cools_target(self):
        kw = dict(p_sol_mw=100.0, n_u_19=30.0, r0=6.2, a=2.0, q95=3.0, b_pol=1.2, **CPU)
        hot, cool = te.two_point_sol(**kw, f_rad=0.0), te.two_point_sol(**kw, f_rad=0.9)
        assert float(cool.t_target_ev) < float(hot.t_target_ev)

    def test_peak_flux_scales_inverse_width(self):
        q1 = float(te.peak_target_heat_flux(100.0, 6.2, 1e-3, **CPU))
        q2 = float(te.peak_target_heat_flux(100.0, 6.2, 2e-3, **CPU))
        np.testing.assert_allclose(q1 / q2, 2.0, rtol=1e-6)

    def test_iter_like_pedestal(self):
        res = te.eped_pedestal(n_ped_1e19=8.0, r0=6.2, a=2.0, b0=5.3, ip_ma=15.0, **CPU)
        assert 0.5 < float(res.t_ped_kev) < 10.0
        assert 0.01 <= float(res.delta_ped) <= 0.15
        assert float(res.p_ped_kpa) > 10.0

    def test_density_degrades_temperature(self):
        lo = te.eped_pedestal(n_ped_1e19=5.0, r0=6.2, a=2.0, b0=5.3, ip_ma=15.0, **CPU)
        hi = te.eped_pedestal(n_ped_1e19=12.0, r0=6.2, a=2.0, b0=5.3, ip_ma=15.0, **CPU)
        assert float(hi.t_ped_kev) < float(lo.t_ped_kev)

    def test_eped_shaped_tier_lifts_diiid_floor(self):
        salpha = te.eped_pedestal(**DIIID, ip_ma=1.0, **CPU)
        assert float(salpha.t_ped_kev) <= 0.1 + 1e-9
        shaped = te.eped_pedestal_shaped(**DIIID, ip_ma=1.0, **CPU)
        assert bool(shaped.second_access)
        assert float(shaped.pedestal.t_ped_kev) > 0.3
        assert 13.0 / 3.0 < float(shaped.pedestal.p_ped_kpa) < 13.0 * 3.0


def test_bare_call_needs_the_card():
    with pytest.raises((RuntimeError, AssertionError)):
        te.eped_pedestal(n_ped_1e19=8.0, r0=6.2, a=2.0, b0=5.3, ip_ma=15.0)
