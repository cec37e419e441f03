"""Port parity: the heating/neutronics candidate contracts
(``models/nuclear/heating_neutronics``).

The private twins are fed JAX's draws, computed here with ``jax.random``
keyed as the JAX functions key them: the heating proxy's pitches, the
transport estimate's three draws a round from a key split each round, and
the candidate's eleven float32 uniforms and heating key.  In float64 on the
CPU every output is within 1e-9 of JAX's (the survival ``cumprod``, which XLA
may scan in another order than ``torch.cumprod``, is ~1e-15 off); the
transport estimate at 500 histories, the candidate and its refinement (700
histories) at JAX's sizes.  The gates of ``tests/test_heating_neutronics.py``
hold for the port on its own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.models.nuclear import heating_neutronics as jhn
from scpn_fusion_tpu_torch.models.nuclear import heating_neutronics as thn

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
HEATING = dict(major_radius_m=6.2, elongation=1.8, b_t=5.5, rf_power_mw=30.0, nbi_power_mw=25.0)


def _pitch(key, n_rays: int = 96):
    """genray_heating_proxy's pitches (heating_neutronics.py:70), float64 as under x64."""
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_rays, 1), jnp.float64, -0.22,
                                                        0.22)))


def _transport_draws(key, histories: int, rounds: int = 48):
    """mcnp_lite_transport_tbr's draws: a key split into four each round (:170-187)."""
    steps, albedos, events = [], [], []
    for _ in range(rounds):
        key, k1, k2, k3 = jax.random.split(key, 4)
        steps.append(jax.random.uniform(k1, (histories,)))
        albedos.append(jax.random.uniform(k2, (histories,)))
        events.append(jax.random.uniform(k3, (histories, 2)))
    return tuple(torch.from_numpy(np.array(jnp.stack(x))) for x in (steps, albedos, events))


def _candidate_draws(key):
    """quick_candidate's eleven float32 uniforms and its heating key (:224-234)."""
    ks = jax.random.split(key, 12)
    uniforms = [float(jax.random.uniform(k, (), jnp.float32, lo, hi))
                for k, (lo, hi) in zip(ks[:11], thn.CANDIDATE_RANGES)]
    return uniforms, _pitch(ks[11])


def test_heating_proxy_matches_jax():
    for seed, kw in ((0, HEATING), (3, dict(HEATING, elongation=1.5, b_t=8.0,
                                             major_radius_m=4.5))):
        key = jax.random.PRNGKey(seed)
        ref = jhn.genray_heating_proxy(key, **kw)
        ours = thn._genray_heating_proxy(_pitch(key), **kw)
        for name in ref:
            assert rel(ours[name], ref[name]) <= TOL, name


def test_projections_match_jax():
    kw = dict(major_radius_m=5.1, b_t=7.3, ip_ma=14.0, absorbed_heating_mw=48.0)
    assert rel(thn.aries_at_q_proxy(**kw, **CPU), jhn.aries_at_q_proxy(**kw)) <= TOL
    kw = dict(raw_tbr=1.03, li6_enrichment=0.9, be_multiplier_fraction=0.5, reflector_albedo=0.4)
    for a, b in zip(thn.mcnp_lite_tbr(**kw, **CPU), jhn.mcnp_lite_tbr(**kw)):
        assert rel(a, b) <= TOL


@pytest.mark.parametrize("kw", [
    dict(thickness_cm=60.0, li6_enrichment=0.9, be_multiplier_fraction=0.9, reflector_albedo=0.8),
    dict(thickness_cm=5.0, li6_enrichment=0.9, be_multiplier_fraction=0.5, reflector_albedo=0.3),
    dict(thickness_cm=100.0, li6_enrichment=0.1, be_multiplier_fraction=0.0, reflector_albedo=0.3),
])
def test_transport_matches_jax_on_its_draws(kw):
    key = jax.random.PRNGKey(2)
    ref = jhn.mcnp_lite_transport_tbr(key, histories=500, **kw)
    ours = thn._mcnp_lite_transport_tbr(*_transport_draws(key, 500), **kw)
    for name in ref:
        assert rel(ours[name], ref[name]) <= TOL, name


def test_candidate_and_refinement_match_jax():
    key = jax.random.PRNGKey(5)
    ref = jhn.quick_candidate(key, 7)
    ours = thn._quick_candidate(*_candidate_draws(key), 7)
    assert list(ours) == list(ref)
    for name, value in ref.items():
        assert abs(ours[name] - value) <= TOL * max(abs(value), 1.0), name
    key = jax.random.PRNGKey(100)
    ref_r = jhn.refine_candidate_tbr(ref, key)
    ours_r = thn._refine_candidate_tbr(ours, _transport_draws(key, 700), **CPU)
    assert list(ours_r) == list(ref_r)
    for name, value in ref_r.items():
        assert abs(ours_r[name] - value) <= TOL * max(abs(value), 1.0), name


class TestHeatingNeutronicsGates:
    """tests/test_heating_neutronics.py on the port, its own draws."""

    def test_heating_proxy_bounds_and_determinism(self):
        h1, h2 = (thn.genray_heating_proxy(torch.Generator().manual_seed(0), **HEATING, **CPU)
                  for _ in range(2))
        assert 0.35 <= float(h1["rf_absorption_eff"]) <= 0.95
        assert 0.28 <= float(h1["nbi_absorption_eff"]) <= 0.93
        assert float(h1["absorbed_heating_mw"]) == pytest.approx(
            30.0 * float(h1["rf_absorption_eff"]) + 25.0 * float(h1["nbi_absorption_eff"]),
            rel=1e-6)
        assert float(h1["rf_absorption_eff"]) == float(h2["rf_absorption_eff"])
        assert 0.0 <= float(h1["rf_reflection_rate"]) <= 1.0
        assert float(h1["mean_path_length_norm"]) > 0.9

    def test_projections(self):
        base = float(thn.aries_at_q_proxy(major_radius_m=6.2, b_t=5.5, ip_ma=12.0,
                                          absorbed_heating_mw=55.0, **CPU))
        assert base == pytest.approx(5.8, rel=1e-6)
        assert float(thn.aries_at_q_proxy(major_radius_m=6.2, b_t=6.5, ip_ma=12.0,
                                          absorbed_heating_mw=55.0, **CPU)) > base
        tbr, factor = thn.mcnp_lite_tbr(raw_tbr=1.0, li6_enrichment=0.9,
                                        be_multiplier_fraction=0.5, reflector_albedo=0.5, **CPU)
        expect = 1.11 + 0.22 * 0.5 + 0.08 * 0.9 + 0.05 * 0.5
        assert float(factor) == pytest.approx(expect, rel=1e-6)
        assert float(tbr) == pytest.approx(expect * 1.45, rel=1e-6)
        with pytest.raises(ValueError, match="li6_enrichment"):
            thn.mcnp_lite_tbr(raw_tbr=1.0, li6_enrichment=1.5, be_multiplier_fraction=0.5,
                              reflector_albedo=0.5, **CPU)
        assert thn.require_fraction("x", 0.5) == 0.5

    def test_transport_trends_and_weight_bound(self):
        def mc(seed, histories, **kw):
            return thn.mcnp_lite_transport_tbr(torch.Generator().manual_seed(seed),
                                               histories=histories, **kw, **CPU)
        thin = mc(1, 2000, thickness_cm=5.0, li6_enrichment=0.9, be_multiplier_fraction=0.5,
                  reflector_albedo=0.3)
        thick = mc(1, 2000, thickness_cm=100.0, li6_enrichment=0.9, be_multiplier_fraction=0.5,
                   reflector_albedo=0.3)
        assert float(thick["tbr_mc"]) > float(thin["tbr_mc"])
        assert float(thick["leakage_rate"]) < float(thin["leakage_rate"])
        assert float(thick["multiplication_gain"]) >= 1.0
        hi = mc(1, 2000, thickness_cm=100.0, li6_enrichment=0.9, be_multiplier_fraction=0.0,
                reflector_albedo=0.3)
        lo = mc(1, 2000, thickness_cm=100.0, li6_enrichment=0.1, be_multiplier_fraction=0.0,
                reflector_albedo=0.3)
        assert float(hi["tbr_mc"]) > float(lo["tbr_mc"])
        m = mc(2, 1500, thickness_cm=60.0, li6_enrichment=0.9, be_multiplier_fraction=0.9,
               reflector_albedo=0.8)
        assert float(m["tbr_mc"]) + float(m["leakage_rate"]) <= float(
            m["multiplication_gain"]) * 1.6 + 0.2

    def test_candidate_schema_objective_and_refinement(self):
        cand = thn.quick_candidate(torch.Generator().manual_seed(5), 7, **CPU)
        assert cand["candidate_id"] == 7.0
        assert 4.0 <= cand["major_radius_m"] <= 7.4 and 0.78 <= cand["li6_enrichment"] <= 1.0
        expect = (cand["q_proxy"] + 18.0 * (cand["tbr_est"] - 1.05)
                  - 0.45 * abs(cand["q_proxy"] - cand["q_aries_at_proxy"]))
        assert cand["objective"] == pytest.approx(expect, rel=1e-6)
        refined = thn.refine_candidate_tbr(cand, torch.Generator().manual_seed(100), **CPU)
        for field in ("raw_tbr", "tbr_final", "tbr_mc", "neutron_leakage_rate",
                      "neutron_multiplication_gain"):
            assert field in refined and np.isfinite(refined[field])
        blend = 0.60 * float(thn.mcnp_lite_tbr(
            raw_tbr=refined["raw_tbr"], li6_enrichment=refined["li6_enrichment"],
            be_multiplier_fraction=refined["be_multiplier_fraction"],
            reflector_albedo=refined["reflector_albedo"], **CPU)[0]) + 0.40 * refined["tbr_mc"]
        assert refined["tbr_final"] == pytest.approx(blend, rel=1e-6)
