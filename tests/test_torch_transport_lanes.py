"""Port parity: the small transport lanes (``models/transport/{current_diffusion,
impurity, momentum_lh, aurora_parity}.py``), float64 on the CPU against JAX
on the seeded inputs of ``bench_config.lane_profiles`` /
``aurora_case_arrays`` (the chip smoke runs the same lanes at nr 50): within
1e-12 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.models.transport import aurora_parity as jau
from scpn_fusion_tpu.models.transport import current_diffusion as jcd
from scpn_fusion_tpu.models.transport import impurity as jim
from scpn_fusion_tpu.models.transport import momentum_lh as jml
from scpn_fusion_tpu_torch.bench_config import aurora_case_arrays, lane_profiles
from scpn_fusion_tpu_torch.models.transport import aurora_parity as tau
from scpn_fusion_tpu_torch.models.transport import current_diffusion as tcd
from scpn_fusion_tpu_torch.models.transport import impurity as tim
from scpn_fusion_tpu_torch.models.transport import momentum_lh as tml

TOL = 1e-12
NR = 33


def _close(ours, ref, tol=TOL):
    a, b = as_np(ours), as_np(ref)
    scale = float(np.max(np.abs(b)))
    assert float(np.max(np.abs(a - b))) <= tol * (scale if scale > 0 else 1.0)


def _inputs(nr=NR):
    p = lane_profiles(nr)
    return p, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def test_current_diffusion_matches_jax():
    p, j, t = _inputs()
    ref_p = jcd.CurrentDiffusionParams(nr=NR, r0=6.2, a=2.0, b0=5.3)
    ours_p = tcd.CurrentDiffusionParams(**dataclasses.asdict(ref_p))
    psi0_ref = jcd.initial_psi(ref_p)
    psi0 = tcd.initial_psi(ours_p, device="cpu")
    _close(psi0, psi0_ref)
    args = (0.01, "te_kev", "ne_19", 1.7, "j_source")
    ref, ref_tr = jcd.run_current_diffusion(
        ref_p, psi0_ref, *(j[a] if isinstance(a, str) else a for a in args), n_steps=40)
    ours, tr = tcd.run_current_diffusion(
        ours_p, psi0, *(t[a] if isinstance(a, str) else a for a in args), n_steps=40)
    _close(ours, ref)
    for key in ("q0", "q_edge"):
        _close(tr[key], ref_tr[key])
    assert float((ours - psi0).abs().max()) > 1e-6 * float(psi0.abs().max())   # psi moved
    eta = tcd.neoclassical_resistivity(t["te_kev"], t["ne_19"], 1.5, t["rho"] / 3.1, t["q"], 6.2)
    _close(eta, jcd.neoclassical_resistivity(j["te_kev"], j["ne_19"], 1.5, j["rho"] / 3.1,
                                             j["q"], 6.2))
    assert tcd.resistive_diffusion_time(2.0, 1e-8) == pytest.approx(
        float(jcd.resistive_diffusion_time(2.0, 1e-8)), rel=1e-15)


def test_impurity_matches_jax():
    p, j, t = _inputs(40)
    sp = jim.ImpuritySpecies(z_max=10)
    ours_sp = tim.ImpuritySpecies(**dataclasses.asdict(sp))
    t_e_ev = p["te_kev"] * 1e3 * 0.3 + 5.0
    n0 = np.zeros((11, 40))
    n0[0] = 0.1
    kw = dict(n_steps=30, edge_source_1e19=0.05)
    ref, ref_tr = jim.run_impurity(sp, jim.ImpurityState(jnp.asarray(n0)), jnp.asarray(t_e_ev),
                                   j["ne_19"], j["d_imp"], j["rho"], 1e-4, **kw)
    ours, tr = tim.run_impurity(ours_sp, tim.ImpurityState(torch.from_numpy(n0)),
                                torch.from_numpy(t_e_ev), t["ne_19"], t["d_imp"], t["rho"], 1e-4,
                                **kw)
    _close(ours.n_z, ref.n_z)
    for key in ("p_rad_total", "n_total"):
        _close(tr[key], ref_tr[key])
    assert float(ours.n_z[3:, 0].sum()) > 0.0             # the core ionised
    for t_ev in (5.0, 2000.0):
        _close(tim.coronal_equilibrium(ours_sp, t_ev, device="cpu"),
               jim.coronal_equilibrium(sp, t_ev))


def test_momentum_and_lh_match_jax():
    p, j, t = _inputs()
    ref_par = jml.MomentumParams(r_m=jnp.asarray(6.2), a_m=jnp.asarray(2.0),
                                 prandtl=jnp.asarray(0.7), pinch_v_m_s=jnp.asarray(0.0))
    par = tml.MomentumParams(*(torch.tensor(float(v), dtype=torch.float64) for v in ref_par))
    ref_tq = jml.nbi_torque_density(j["rho"], 33.0, 5.3, 6.2)
    tq = tml.nbi_torque_density(t["rho"], 33.0, 5.3, 6.2)
    _close(tq, ref_tq)
    ni = 10.0 * (1.0 - 0.8 * p["rho"] ** 2)
    ref = jml.evolve_rotation(jnp.zeros(NR), j["chi_i"], ref_tq, jnp.asarray(ni), j["rho"],
                              1e-3, 60, ref_par)
    ours = tml.evolve_rotation(torch.zeros(NR, dtype=torch.float64), t["chi_i"], tq,
                               torch.from_numpy(ni), t["rho"], 1e-3, 60, par)
    _close(ours.omega, ref.omega)
    _close(ours.v_tor_core_m_s, ref.v_tor_core_m_s)
    mode = torch.tensor(False)
    ref_mode = jnp.asarray(False)
    geo = (1.0, 5.3, 6.2, 2.0, 1.7)
    for p_net in (10.0, 120.0, 90.0, 60.0):     # up through the threshold, down through hysteresis
        ref_st = jml.lh_transition_step(p_net, *geo, ref_mode)
        st = tml.lh_transition_step(p_net, *geo, mode)
        assert bool(st.h_mode) == bool(ref_st.h_mode)
        _close(st.p_threshold_mw, ref_st.p_threshold_mw)
        _close(st.margin, ref_st.margin)
        mode, ref_mode = st.h_mode, ref_st.h_mode
    assert float(tml.confinement_multiplier(torch.tensor(False))) == 0.6


def test_aurora_parity_matches_jax():
    arrays = aurora_case_arrays()
    ref_case = jau.AuroraParityCase(**arrays["fields"])
    case = tau.AuroraParityCase(**arrays["fields"])
    density, reference = arrays["density"], arrays["reference"]
    ref_step = jau.advance_transport_and_cr(ref_case, jnp.asarray(density), 2, 1e-4)
    step = tau.advance_transport_and_cr(case, torch.from_numpy(density.copy()), 2, 1e-4)
    _close(step, ref_step)
    _close(tau.derive_effective_source_closure(case, reference, device="cpu"),
           jau.derive_effective_source_closure(ref_case, reference))
    ref_audit = jau.radial_transport_budget_diagnostic(ref_case, density, 1e-4)
    audit = tau.radial_transport_budget_diagnostic(case, density, 1e-4, device="cpu")
    assert audit["passed"] and audit["dtype"] == ref_audit["dtype"]
    for key in ("inventory_before", "inventory_after"):
        assert audit[key] == pytest.approx(ref_audit[key], rel=TOL)
    ref_art = jau.build_aurora_strahl_artifact(ref_case, reference)
    art = tau.build_aurora_strahl_artifact(case, reference, device="cpu")
    assert art.keys() == ref_art.keys()
    np.testing.assert_allclose(art["inventory_per_step"], ref_art["inventory_per_step"],
                               rtol=TOL)
    with pytest.raises(ValueError, match="strictly increasing"):
        tau.AuroraParityCase(**{**arrays["fields"], "radius_m": arrays["fields"]["radius_m"][::-1]})
