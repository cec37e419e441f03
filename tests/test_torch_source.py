"""Port parity: topology, profiles and the fused source kernel's plain version.

``models/equilibrium/{topology,profiles}.py`` of the port against
``scpn_fusion_tpu.models.equilibrium`` in f64; the source kernel wrapper
(``ops/cuda_source.fused_topology_source``, its plain version on the CPU)
against ``ops/pallas_source.fused_topology_source(interpret=True)`` in the
four cases of ``tests/test_pallas_source.py``, with the X-point index of the
JAX ``analyze_topology``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import span_rel, to_torch

from scpn_fusion_tpu.models.equilibrium import profiles as jpr
from scpn_fusion_tpu.models.equilibrium import topology as jtp
from scpn_fusion_tpu.ops.pallas_source import fused_topology_source as pallas_source
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import profiles as tpr
from scpn_fusion_tpu_torch.models.equilibrium import topology as ttp
from scpn_fusion_tpu_torch.ops.cuda_source import fused_topology_source

MU0 = 1.0


def _field(n=65, seed=0, dtype=np.float32):
    r = np.asarray(jnp.linspace(2.0, 10.0, n, dtype=dtype))
    z = np.asarray(jnp.linspace(-4.0, 4.0, n, dtype=dtype))
    rr, zz = np.meshgrid(r, z)
    noise = np.random.default_rng(seed).standard_normal((n, n)).astype(dtype)
    blob = np.exp(-(((rr - 6.0) / 2.0) ** 2 + (zz / 2.0) ** 2)).astype(dtype)
    return (3.0 * blob + 0.01 * noise).astype(dtype), r, z, rr, zz


def _coeffs(seed, dtype=np.float32):
    vals = (0.3 + np.random.default_rng(seed).random(8)).astype(dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    return ((jpr.ProfileCoeffs(*[jnp.asarray(v) for v in vals[:4]]),
             jpr.ProfileCoeffs(*[jnp.asarray(v) for v in vals[4:]])),
            (interop.profile_coeffs(vals[:4], dtype=tdt, device="cpu"),
             interop.profile_coeffs(vals[4:], dtype=tdt, device="cpu")))


def test_topology_f64():
    """gradient / find_magnetic_axis / find_x_point / analyze_topology /
    compute_b_field == scpn_fusion_tpu topology (f64)."""
    psi, r, z, rr, zz = _field(dtype=np.float64)
    dr, dz = float(r[1] - r[0]), float(z[1] - z[0])
    for axis in (0, 1):
        assert span_rel(ttp.gradient(to_torch(psi), dr, axis),
                        jnp.gradient(jnp.asarray(psi), dr, axis=axis)) <= 1e-12
    ours = ttp.analyze_topology(to_torch(psi), to_torch(zz), dr, dz, float(z[0]))
    ref = jtp.analyze_topology(jnp.asarray(psi), jnp.asarray(zz), dr, dz, float(z[0]))
    for a, b in zip(ours, ref):
        assert float(a) == pytest.approx(float(b), rel=1e-12, abs=0)
    for a, b in zip(ttp.compute_b_field(to_torch(psi), to_torch(rr), dr, dz),
                    jtp.compute_b_field(jnp.asarray(psi), jnp.asarray(rr), dr, dz)):
        assert span_rel(a, b) <= 1e-12
    # empty divertor region: global-min fallback
    ours = ttp.find_x_point(to_torch(psi), to_torch(zz + 100.0), dr, dz, float(z[0]))
    ref = jtp.find_x_point(jnp.asarray(psi), jnp.asarray(zz + 100.0), dr, dz, float(z[0]))
    assert [float(v) for v in ours] == [float(v) for v in ref]


@pytest.mark.parametrize("h_mode", [False, True])
def test_profiles_f64(h_mode):
    """mtanh/lmode profiles and plasma_current_density (f64)."""
    psi, r, z, rr, zz = _field(dtype=np.float64)
    (jp, jf), (tp, tf) = _coeffs(2, np.float64)
    pn = np.linspace(-0.2, 1.2, 301)
    assert span_rel(tpr.mtanh_profile(to_torch(pn), tp), jpr.mtanh_profile(jnp.asarray(pn), jp)) \
        <= 1e-12
    assert span_rel(tpr.lmode_profile(to_torch(pn)), jpr.lmode_profile(jnp.asarray(pn))) <= 1e-12
    kw = dict(h_mode=h_mode, mu0=MU0, d_r=float(r[1] - r[0]), d_z=float(z[1] - z[0]))
    ours = tpr.plasma_current_density(to_torch(psi), to_torch(2.9), to_torch(0.4),
                                      to_torch(rr), p_coeffs=tp, ff_coeffs=tf,
                                      i_target=to_torch(12.5), **kw)
    ref = jpr.plasma_current_density(jnp.asarray(psi), jnp.asarray(2.9), jnp.asarray(0.4),
                                     jnp.asarray(rr), p_coeffs=jp, ff_coeffs=jf,
                                     i_target=jnp.asarray(12.5), **kw)
    assert span_rel(ours, ref) <= 1e-12


def _check_source(psi, r, z, zz, coeff_seed, i_t, h_mode, mask_zz=None):
    dr, dz = float(r[1] - r[0]), float(z[1] - z[0])
    z_min = float(z[0])
    mask = (zz < z_min * 0.5).astype(np.float32)
    if mask_zz is not None:
        mask = np.zeros_like(mask)
    (jp, jf), (tp, tf) = _coeffs(coeff_seed)
    ref = pallas_source(jnp.asarray(psi), jnp.asarray(r), jnp.asarray(mask), jp, jf,
                        jnp.asarray(i_t, jnp.float32), d_r=dr, d_z=dz, mu0=MU0,
                        h_mode=h_mode, interpret=True)
    ours, scal = fused_topology_source(
        to_torch(psi, np.float32), to_torch(r, np.float32), to_torch(mask, np.float32),
        tp, tf, torch.tensor(i_t, dtype=torch.float32), d_r=dr, d_z=dz, mu0=MU0,
        h_mode=h_mode, with_scalars=True)
    assert span_rel(ours, ref) <= 1e-6
    topo = jtp.analyze_topology(jnp.asarray(psi), jnp.asarray(zz if mask_zz is None else mask_zz),
                                dr, dz, z_min)
    assert int(scal.x_index) == int(topo.x_iz) * psi.shape[1] + int(topo.x_ir)
    assert float(scal.psi_axis) == float(topo.psi_axis)
    return scal


@pytest.mark.parametrize("h_mode", [False, True])
def test_source_plain_matches_pallas(h_mode):
    psi, r, z, _, zz = _field()
    _check_source(psi, r, z, zz, 1, 12.5, h_mode)


def test_source_plain_degenerate_snap():
    """Flat psi: the |axis - boundary| < 0.1 snap in both."""
    n = 33
    _, r, z, _, zz = _field(n)
    psi = np.full((n, n), 0.05, np.float32)
    scal = _check_source(psi, r, z, zz, 3, 5.0, False)
    assert float(scal.psi_boundary) == pytest.approx(0.1 * float(scal.psi_axis))


def test_source_plain_tie_picks_first_site():
    """Two exactly flat |grad psi| = 0 sites: the first row-major one wins."""
    n = 65
    _, r, z, rr, zz = _field(n)
    base = np.linspace(1.0, 2.0, n, dtype=np.float32)[None, :]
    psi = (3.0 * np.exp(-(((rr - 6.0) / 2.0) ** 2 + (zz / 2.0) ** 2)) + base).astype(np.float32)
    psi[5:8, 10:13] = 2.5
    psi[9:12, 40:43] = 0.3
    scal = _check_source(psi, r, z, zz, 11, 10.0, False)
    assert int(scal.x_index) == 6 * n + 11


def test_source_plain_empty_mask():
    """All-false mask: psi_b falls back to the global psi minimum."""
    psi, r, z, _, zz = _field(seed=7)
    scal = _check_source(psi, r, z, zz, 5, 8.0, False, mask_zz=zz + 100.0)
    assert int(scal.x_index) == 0
