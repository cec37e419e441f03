"""Port parity: the transport closures, the reduced closure and the scaling /
burn / blanket lanes (``models/transport/{closures,reduced_closure}.py``,
``models/physics/scaling_burn.py``), float64, on seeded profiles: within
1e-12 relative of JAX (the blanket's Thomas solve included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, rng, to_torch

from scpn_fusion_tpu.models.physics import scaling_burn as jsb
from scpn_fusion_tpu.models.transport import closures as jcl
from scpn_fusion_tpu.models.transport import reduced_closure as jrc
from scpn_fusion_tpu_torch.models.physics import scaling_burn as tsb
from scpn_fusion_tpu_torch.models.transport import closures as tcl
from scpn_fusion_tpu_torch.models.transport import reduced_closure as trc

TOL = 1e-12
NR = 33


def _profiles(seed):
    g = rng(seed)
    rho = np.linspace(0.0, 1.0, NR)
    shape = 1.0 - rho**2
    return {
        "rho": rho,
        "ti": 0.2 + 12.0 * shape * (1.0 + 0.1 * g.random(NR)),
        "te": 0.2 + 10.0 * shape * (1.0 + 0.1 * g.random(NR)),
        "ne": 0.5 + 8.0 * np.sqrt(shape) * (1.0 + 0.05 * g.random(NR)),
        "q": 1.0 + 2.5 * rho**2 + 0.05 * g.random(NR),
        "s_hat": 2.0 * rho + 0.1 * g.standard_normal(NR),
    }


def _both(p, *names):
    return [jnp.asarray(p[k]) for k in names], [to_torch(p[k]) for k in names]


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float64)
    ours = ours.detach().numpy().astype(np.float64)
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(ours - ref)) <= tol * (scale if scale > 0 else 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_closures_match_jax(seed):
    p = _profiles(seed)
    (j_rho, j_ti, j_te, j_ne, j_q), (t_rho, t_ti, t_te, t_ne, t_q) = _both(
        p, "rho", "ti", "te", "ne", "q")
    _close(tcl.chang_hinton_chi(t_rho, t_ti, t_ne, t_q, 6.2, 2.0, 5.3, 2.0, 1.7),
           jcl.chang_hinton_chi(j_rho, j_ti, j_ne, j_q, 6.2, 2.0, 5.3, 2.0, 1.7))
    _close(tcl.gyro_bohm_chi(t_ti, t_te, t_q, 6.2, 2.0, 5.3, 2.5, 1.3),
           jcl.gyro_bohm_chi(j_ti, j_te, j_q, 6.2, 2.0, 5.3, 2.5, 1.3))
    _close(tcl.sauter_bootstrap_current(t_rho, t_te, t_ti, t_ne, t_q, 6.2, 2.0, 5.3, 1.5),
           jcl.sauter_bootstrap_current(j_rho, j_te, j_ti, j_ne, j_q, 6.2, 2.0, 5.3, 1.5))
    t_wide = to_torch(np.linspace(0.05, 150.0, 400))
    _close(tcl.bosch_hale_sigmav(t_wide), jcl.bosch_hale_sigmav(jnp.asarray(t_wide.numpy())))
    _close(tcl.tungsten_radiation_rate(t_wide),
           jcl.tungsten_radiation_rate(jnp.asarray(t_wide.numpy())))
    _close(tcl.bremsstrahlung_power_density(t_ne, t_te, 1.8),
           jcl.bremsstrahlung_power_density(j_ne, j_te, 1.8))


def test_float32_gyro_bohm_flushes_like_xla():
    """XLA flushes float32 subnormals: T_i m_i (~5e-43) is one, so JAX's
    float32 chi_gB sits on its 0.01 floor; the port reproduces it."""
    p = _profiles(2)
    args = [p[k].astype(np.float32) for k in ("ti", "te", "q")]
    ref = jcl.gyro_bohm_chi(*(jnp.asarray(a) for a in args), 6.2, 2.0, 5.3)
    ours = tcl.gyro_bohm_chi(*(torch.from_numpy(a) for a in args), 6.2, 2.0, 5.3)
    assert np.all(np.asarray(ref) == np.float32(0.01))
    assert torch.equal(ours, torch.full_like(ours, 0.01))
    f64 = tcl.gyro_bohm_chi(*(to_torch(p[k]) for k in ("ti", "te", "q")), 6.2, 2.0, 5.3)
    assert float(f64.max()) > 0.02          # float64 keeps the turbulent channel


@pytest.mark.parametrize("seed,stiffness", [(3, 2.0), (4, 3.5)])
def test_reduced_closure_profile_matches_jax(seed, stiffness):
    p = _profiles(seed)
    p["te"] = p["te"] * (1.0 + 2.0 * p["rho"] ** 4)      # steeper edge: TEM/ETG drive
    names = ("rho", "te", "ti", "ne", "q", "s_hat")
    j_in, t_in = _both(p, *names)
    kw = dict(r_major_m=6.2, a_minor_m=2.0, b_tesla=5.3, z_eff=1.6, beta_e=0.005,
              stiffness=stiffness)
    ref = jrc.evaluate_closure_profile(*j_in, **kw)
    ours = trc.evaluate_closure_profile(*t_in, **kw)
    assert np.array_equal(ours.channel.numpy(), np.asarray(ref.channel))
    assert len(set(ours.channel.tolist())) >= 2
    for name in ("chi_i", "chi_e", "d_e", "chi_i_itg", "chi_e_itg", "chi_e_tem", "chi_e_etg"):
        _close(getattr(ours, name), getattr(ref, name))


def test_reduced_closure_scalars_and_refusal():
    kw = dict(rho=0.5, te_kev=5.0, ti_kev=4.0, ne_19=6.0, grad_te=9.0, grad_ti=11.0,
              grad_ne=3.0, q=1.8, s_hat=0.9, beta_e=0.01, r_major_m=6.2, a_minor_m=2.0,
              b_tesla=5.3, z_eff=1.5)
    ref = jrc.critical_gradient_fluxes(jrc.ClosureInputs(**kw))
    ours = trc.critical_gradient_fluxes(trc.ClosureInputs(**kw), device="cpu")
    assert int(ours.channel) == int(ref.channel)
    assert trc.channel_name(ours.channel) == jrc.channel_name(ref.channel)
    _close(ours.chi_i, ref.chi_i)
    _close(ours.chi_e, ref.chi_e)
    with pytest.raises(ValueError, match="stiffness"):
        trc.critical_gradient_fluxes(trc.ClosureInputs(**kw), stiffness=7.0, device="cpu")


def test_ipb98_and_burn_point_match_jax():
    args = (15.0, 5.3, 10.0, 87.0, 6.2, 1.7, 2.0 / 6.2)
    np.testing.assert_allclose(tsb.ipb98y2_tau_e(*args), float(jsb.ipb98y2_tau_e(*args)),
                               rtol=TOL)
    for ne19 in (6.0, 10.0):
        kw = dict(ne19=ne19, p_aux_mw=50.0, ip_ma=15.0, bt_t=5.3, r_m=6.2, a_m=2.0, kappa=1.7)
        ref = jsb.burn_equilibrium_0d(**kw)
        ours = tsb.burn_equilibrium_0d(**kw, device="cpu")
        for name in ("q_fusion", "p_fusion_mw", "p_alpha_mw", "tau_e_s", "t_kev"):
            assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
        assert bool(ours.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(tsb.h_factor(torch.tensor(3.0, dtype=torch.float64),
                                                  torch.tensor(2.5, dtype=torch.float64))),
                               float(jsb.h_factor(3.0, 2.5)), rtol=TOL)


@pytest.mark.parametrize("kw", [dict(thickness_cm=80.0, li6_enrichment=0.9),
                                dict(li6_enrichment=0.6, rear_albedo=0.3, n_points=64)])
def test_blanket_tbr_matches_jax(kw):
    ref = jsb.blanket_tbr(**kw)
    ours = tsb.blanket_tbr(**kw, device="cpu")
    for name in ("r_cm", "flux", "tbr", "production_rate"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name


def test_default_device_is_the_card():
    """With no ``device`` the lanes run on CUDA; without a card they raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert tsb.blanket_tbr().flux.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tsb.blanket_tbr()
        with pytest.raises((AssertionError, RuntimeError)):
            tsb.burn_equilibrium_0d(ne19=10.0, p_aux_mw=50.0, ip_ma=15.0, bt_t=5.3, r_m=6.2,
                                    a_m=2.0, kappa=1.7)
