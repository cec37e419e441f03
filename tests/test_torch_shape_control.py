"""Port parity: free-boundary shape control (``models/equilibrium/shape_control``).

Every function of the port against ``scpn_fusion_tpu.models.equilibrium.
shape_control`` on the CPU in float64, on the 6-coil ITER-like machine at
33^2 (the setup of ``tests/test_shape_control.py``) with seeded flux maps:
the closed forms (probe response, synthetic magnetics, the shape system, the
wall indices, the wall response and its flux) within 1e-12 of JAX relative to
the largest entry, the bounded fits (coil reconstruction, shape currents)
within 1e-9 after FISTA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, free_boundary_cfgs, rel, rng, to_torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium import free_boundary as jfb
from scpn_fusion_tpu.models.equilibrium import shape_control as jsc
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.equilibrium import shape_control as tsc

CLOSED = 1e-12
FISTA = 1e-9
N = 33


@pytest.fixture(scope="module")
def setup():
    ref_cfg, _ = free_boundary_cfgs(N)
    jgrid = JGrid.from_config(ref_cfg, dtype=np.float64)
    tgrid = TGrid.from_bounds(N, N, 2.0, 10.0, -4.0, 4.0, dtype=torch.float64, device="cpu")
    jcoils = jfb.coilset_from_config(ref_cfg, jnp.float64)
    tcoils = interop.coilset(jcoils._asdict(), dtype=torch.float64, device="cpu")
    th = np.linspace(0, 2 * np.pi, 9)[:-1]
    fp = np.stack([6.0 + 2.5 * np.cos(th), 2.5 * np.sin(th)], 1)
    bd = np.asarray([0, 1] * 4, np.int32)
    rr, zz = np.asarray(jgrid.RR), np.asarray(jgrid.ZZ)
    psi = (3.0 * np.exp(-((rr - 6.0) ** 2 + zz**2) / 4.0)
           + 0.01 * rng(12).standard_normal((N, N)))
    return jgrid, tgrid, jcoils, tcoils, fp, bd, psi


def test_probe_response_matches_jax(setup):
    _, _, jcoils, tcoils, fp, bd, _ = setup
    ref = jsc.probe_response_matrix(jcoils, flux_points=jnp.asarray(fp),
                                    b_probe_points=jnp.asarray(fp), b_probe_dirs=jnp.asarray(bd),
                                    mu0=1.0)
    ours = tsc.probe_response_matrix(tcoils, flux_points=to_torch(fp),
                                     b_probe_points=to_torch(fp),
                                     b_probe_dirs=torch.from_numpy(bd), mu0=1.0)
    assert ours.shape == (16, 6)
    assert rel(ours, ref) <= CLOSED
    with pytest.raises(ValueError):
        tsc.probe_response_matrix(tcoils)


@pytest.mark.parametrize("case", ["exact", "limited_weighted"])
def test_reconstruct_coil_currents_matches_jax(setup, case):
    _, _, jcoils, tcoils, fp, bd, _ = setup
    resp = np.asarray(jsc.probe_response_matrix(
        jcoils, flux_points=jnp.asarray(fp), b_probe_points=jnp.asarray(fp),
        b_probe_dirs=jnp.asarray(bd), mu0=1.0))
    meas = resp @ np.asarray(jcoils.currents)
    kw_j, kw_t = dict(tikhonov_alpha=1e-12, n_iter=200), dict(tikhonov_alpha=1e-12, n_iter=200)
    prior = np.zeros(6)
    if case == "limited_weighted":
        meas = meas + 1e-3 * rng(13).standard_normal(meas.shape)
        sigma = 0.5 + rng(14).random(meas.shape)
        lim = np.asarray([0.5, 40.0, 40.0, 40.0, 40.0, 40.0])
        alpha = np.asarray([1e-6, 1e-4, 1e-4, 1e-6, 1e-6, 1e-4])
        prior = np.asarray(jcoils.currents) * 0.9
        kw_j = dict(sigma=jnp.asarray(sigma), tikhonov_alpha=jnp.asarray(alpha),
                    current_limits=jnp.asarray(lim), n_iter=400)
        kw_t = dict(sigma=to_torch(sigma), tikhonov_alpha=to_torch(alpha),
                    current_limits=to_torch(lim), n_iter=400)
    ref = jsc.reconstruct_coil_currents(jnp.asarray(resp), jnp.asarray(meas), jnp.asarray(prior),
                                        **kw_j)
    ours = tsc.reconstruct_coil_currents(to_torch(resp), to_torch(meas), to_torch(prior), **kw_t)
    assert rel(ours.coil_currents, ref.coil_currents) <= FISTA
    # the residuals on the scale of the measurements (in the exact case they
    # are rounding noise)
    scale = float(np.max(np.abs(meas)))
    for a, b in zip(ours[1:], ref[1:]):
        assert float(np.max(np.abs(as_np(a) - as_np(b)))) <= FISTA * scale
    if case == "exact":
        assert rel(ours.coil_currents, jcoils.currents) <= 1e-6
    else:
        assert abs(float(ours.coil_currents[0])) <= 0.5


def test_synthetic_magnetics_matches_jax(setup):
    jgrid, tgrid, _, _, fp, bd, psi = setup
    ref = jsc.synthetic_magnetics(jnp.asarray(psi), jgrid, flux_points=jnp.asarray(fp),
                                  b_probe_points=jnp.asarray(fp), b_probe_dirs=jnp.asarray(bd))
    ours = tsc.synthetic_magnetics(to_torch(psi), tgrid, flux_points=to_torch(fp),
                                   b_probe_points=to_torch(fp), b_probe_dirs=torch.from_numpy(bd))
    assert ours.shape == (16,)
    assert rel(ours, ref) <= CLOSED


def _targets(fp):
    return dict(isoflux_points=fp[:4], isoflux_reference=np.asarray([8.2, 0.0]),
                flux_points=fp[4:6], flux_values=np.asarray([0.3, -0.2]),
                x_points=np.asarray([[5.2, -2.8]]), strike_points=fp[6:],
                weights=(1.0, 2.0, 0.5, 3.0))


def test_shape_system_and_currents_match_jax(setup):
    jgrid, tgrid, jcoils, tcoils, fp, _, psi = setup
    fields = _targets(fp)
    jt = jsc.ShapeTargets(**{k: v if k == "weights" else jnp.asarray(v)
                             for k, v in fields.items()})
    tt = interop.shape_targets(fields, dtype=torch.float64, device="cpu")
    ref_a, ref_b = jsc.build_shape_system(jcoils, jt, jnp.asarray(psi), jgrid, mu0=1.0)
    a, b = tsc.build_shape_system(tcoils, tt, to_torch(psi), tgrid, mu0=1.0)
    assert a.shape == (4 + 2 + 2 + 2, 6)
    assert rel(a, ref_a) <= CLOSED and rel(b, ref_b) <= CLOSED
    limits = np.full(6, 5.0)
    jc = jcoils._replace(current_limits=jnp.asarray(limits))
    tc = tcoils._replace(current_limits=to_torch(limits))
    ref = jsc.optimize_shape_currents(jc, jt, jnp.asarray(psi), jgrid, mu0=1.0)
    ours = tsc.optimize_shape_currents(tc, tt, to_torch(psi), tgrid, mu0=1.0)
    assert rel(ours, ref) <= FISTA
    assert float(torch.linalg.vector_norm(a @ ours - b)) \
        < float(torch.linalg.vector_norm(a @ tcoils.currents - b))
    with pytest.raises(ValueError):
        tsc.build_shape_system(tcoils, tsc.ShapeTargets(), to_torch(psi), tgrid)


def test_wall_response_matches_jax(setup):
    jgrid, tgrid, _, _, _, _, psi = setup
    for ours, ref in zip(tsc.wall_indices(N, 17, "cpu"), jsc.wall_indices(N, 17)):
        assert np.array_equal(ours.numpy(), np.asarray(ref))
    ref_m, ref_b, ref_s = jsc.wall_response_matrix(jgrid, mu0=1.0)
    m, b_idx, s_idx = tsc.wall_response_matrix(tgrid, mu0=1.0)
    assert m.shape == (4 * (N - 1), (N - 2) ** 2)
    assert rel(m, ref_m) <= CLOSED
    j_phi = np.abs(psi)
    ref = jsc.plasma_wall_flux(ref_m, ref_b, ref_s, jnp.asarray(j_phi), 0.0625, jgrid.shape)
    ours = tsc.plasma_wall_flux(m, b_idx, s_idx, to_torch(j_phi), 0.0625, tgrid.shape)
    assert rel(ours, ref) <= CLOSED
    assert float(ours[1:-1, 1:-1].abs().max()) == 0.0
    assert as_np(ours)[0].min() != 0.0
