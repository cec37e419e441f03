"""Port parity: the native TGLF model (``models/gyrokinetics/tglf_native.py``).

The TGLF pieces (ExB shear, trapped fraction and damping, FLR Gamma_0,
spectral weight, SAT0/SAT1/SAT2) match on seeded spectra and batches of
them; the whole model's fluxes match within 1e-9 under each SAT rule, with
kinetic electrons and multi-scale ETG; a two-surface profile equals JAX's
profile and the port's single-surface call; the deck-file solver
round-trips.  A growing mode's omega_r is held; a stable k_y's omega_r is
whichever round-off-converged root the fallback picks, in JAX as here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import crel as rel
from torch_parity import rng

from scpn_fusion_tpu.models.gyrokinetics import tglf_native as jtn
from scpn_fusion_tpu.models.gyrokinetics.interface import GKLocalParams as JParams
from scpn_fusion_tpu_torch.models.gyrokinetics import tglf_native as ttn
from scpn_fusion_tpu_torch.models.gyrokinetics.interface import GKLocalParams as TParams

TOL = 1e-9
SMALL = dict(n_energy=12, n_lambda=8)


def test_scalar_factors_match():
    g = rng(3)
    s_hat, q, eps, r_l = (g.uniform(0.1, 2.0, 16) for _ in range(4))
    q[3] = 0.0
    t = [torch.from_numpy(x) for x in (s_hat, q, eps, r_l)]
    j = [jnp.asarray(x) for x in (s_hat, q, eps, r_l)]
    assert rel(ttn.exb_shear_rate(*t), jtn.exb_shear_rate(*j)) <= 1e-15
    assert rel(ttn.trapped_fraction(t[2]), jtn.trapped_fraction(j[2])) <= 1e-15
    assert rel(ttn.trapped_particle_damping(t[2], t[3]),
               jtn.trapped_particle_damping(j[2], j[3])) <= 1e-15
    b = g.uniform(0.0, 5.0, 32)
    assert rel(ttn.gamma0_flr(torch.from_numpy(b)), jtn.gamma0_flr(jnp.asarray(b))) <= 1e-14


@pytest.mark.parametrize("sat", ["SAT0", "SAT1", "SAT2"])
def test_saturation_rules_match_on_seeded_spectra(sat):
    g = rng(4)
    k_y = np.concatenate([np.linspace(0.1, 1.0, 6), np.linspace(3.0, 20.0, 4)])
    rows = []
    for case in range(3):
        gamma = np.where(g.uniform(size=10) < 0.6, g.uniform(0.0, 1.0, 10), 0.0)
        if case == 2:
            gamma[:6] = 0.0     # every ion-scale mode stable
        rows.append(gamma)
    gamma = np.stack(rows)
    omega = g.uniform(-2.0, 2.0, (3, 10))
    scale = np.asarray([40.0, 60.0, 80.0])
    ours = ttn.sat_phi_sq(torch.from_numpy(gamma), torch.from_numpy(omega),
                          torch.from_numpy(np.broadcast_to(k_y, (3, 10)).copy()), sat, 3.0,
                          etg_unit_scale=torch.from_numpy(scale))
    for i in range(3):
        ref = jtn.sat_phi_sq(jnp.asarray(gamma[i]), jnp.asarray(omega[i]), jnp.asarray(k_y),
                             sat, 3.0, etg_unit_scale=scale[i])
        assert rel(ours[i], ref) <= 1e-15
    w = ttn.spectral_weight(torch.from_numpy(gamma), torch.from_numpy(k_y))
    assert rel(w[0], jtn.spectral_weight(jnp.asarray(gamma[0]), jnp.asarray(k_y))) <= 1e-15


ARGS = (9.0, 6.9, 2.2, 1.4, 0.8, 0.18, 1.0, 0.1, 1.0, 2.0, 2.78, 8.0)
FIELDS_EXACT = ("chi_i", "chi_e", "d_e", "v_e", "chi_e_etg", "k_y", "gamma", "gamma_net",
                "phi_sq", "gamma_exb")


def _same_fluxes(ours, ref):
    for name in FIELDS_EXACT:
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    grow = np.asarray(ref.gamma) > 0.0
    assert rel(ours.omega_r.numpy()[grow], np.asarray(ref.omega_r)[grow]) <= TOL


@pytest.mark.parametrize("cfg", [
    dict(n_ky_ion=4, **SMALL),
    dict(n_ky_ion=2, sat_model="SAT0", kinetic_electrons=True, **SMALL),
    dict(n_ky_ion=4, sat_model="SAT2", n_ky_etg=3, **SMALL),
], ids=["sat1", "sat0-kinetic", "sat2-multiscale"])
def test_fluxes_match(cfg):
    ours = ttn.tglf_native_fluxes(*ARGS, cfg=ttn.TGLFNativeConfig(**cfg), device="cpu")
    ref = jtn.tglf_native_fluxes(*ARGS, cfg=jtn.TGLFNativeConfig(**cfg))
    assert ours.chi_i.shape == () and ours.k_y.shape == np.asarray(ref.k_y).shape
    _same_fluxes(ours, ref)


def test_profile_matches_jax_and_single_surfaces():
    prof = (np.array([6.0, 9.0]), 6.9, np.array([2.2, 2.0]), np.array([1.2, 1.4]), 0.8,
            np.array([0.1, 0.18]), 1.0, 0.1, 1.0, 2.0, 2.78, 8.0)
    cfg = dict(n_ky_ion=4)
    ours = ttn.tglf_native_fluxes_profile(
        *[torch.as_tensor(x, dtype=torch.float64) for x in prof], cfg=ttn.TGLFNativeConfig(**cfg))
    ref = jtn.tglf_native_fluxes_profile(*[jnp.asarray(x) for x in prof],
                                         cfg=jtn.TGLFNativeConfig(**cfg))
    assert ours.chi_i.shape == (2,) and ours.gamma.shape == (2, 4)
    _same_fluxes(ours, ref)
    one = ttn.tglf_native_fluxes(*[np.broadcast_to(x, (2,))[1] for x in prof],
                                 cfg=ttn.TGLFNativeConfig(**cfg), device="cpu")
    assert abs(float(one.chi_i) - float(ours.chi_i[1])) <= 1e-12 * float(one.chi_i)


def test_solver_deck_round_trip_and_classification():
    params = TParams(r_l_ti=9.0, r_l_te=6.9, r_l_ne=2.2, q=1.4, s_hat=0.8)
    cfg = dict(n_ky_ion=4, **SMALL)
    solver = ttn.TGLFNativeSolver(ttn.TGLFNativeConfig(**cfg), device="cpu")
    ref_solver = jtn.TGLFNativeSolver(jtn.TGLFNativeConfig(**cfg))
    assert solver.is_available()
    deck = solver.prepare_input(params)
    try:
        out = solver.run(deck)
    finally:
        deck.unlink()
    ref = ref_solver.run_from_params(JParams(r_l_ti=9.0, r_l_te=6.9, r_l_ne=2.2, q=1.4,
                                             s_hat=0.8))
    assert out.dominant_mode == ref.dominant_mode == "ITG" and out.converged
    assert abs(out.chi_i - ref.chi_i) <= TOL * ref.chi_i
    assert rel(out.gamma, ref.gamma) <= TOL
    with pytest.raises(ValueError, match="json"):
        solver.run(deck.with_suffix(".txt"))
