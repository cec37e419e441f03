"""Port parity: the X-point AMR patch (``models/equilibrium/amr.py``) and the
rigid-body stability analysis (``models/equilibrium/rigid_body_stability.py``).

On the CPU in float64 against the JAX package: ``refine_x_point`` on the
analytic saddle of ``tests/test_amr.py`` plus a seeded source (no sweeps,
100 and the default 200 sweeps; every field of the result within 1e-12
relative) and ``_bilinear_upsample`` bit for bit; the ring forces, the
vacuum field, the exact stiffness Jacobian, its closed-form eigenvalues and
the stability flags on a decay-index field with a Z^2 well (within 1e-12
relative), and the force landscape over a query mesh (within 1e-12).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, rng

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium import amr as ja
from scpn_fusion_tpu.models.equilibrium import rigid_body_stability as jrb
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import amr as ta
from scpn_fusion_tpu_torch.models.equilibrium import rigid_body_stability as trb

TOL = 1e-12


def saddle(nr=65, nz=65, x_r=6.313, x_z=-3.147):
    r = np.linspace(4.0, 9.0, nr)
    z = np.linspace(-5.0, 5.0, nz)
    rr, zz = np.meshgrid(r, z)
    psi = -((rr - x_r) ** 2 - 2.0 * (zz - x_z) ** 2) * 0.1 + 3.0 * np.exp(
        -((rr - 6.3) ** 2 + (zz - 0.5) ** 2) / 1.5)
    return r, z, psi


def test_bilinear_upsample_matches_jax():
    tile = rng(1).standard_normal((7, 7))
    assert np.array_equal(ta._bilinear_upsample(torch.tensor(tile), 3).numpy(),
                          np.asarray(ja._bilinear_upsample(jnp.asarray(tile), 3)))


@pytest.mark.parametrize("kw", [dict(window=6, factor=4, n_sweeps=0),
                                dict(window=6, factor=2, n_sweeps=100), dict()])
def test_refine_x_point_matches_jax(kw):
    r, z, psi = saddle()
    src = 0.01 * rng(0).standard_normal(psi.shape)
    ref = ja.refine_x_point(*map(jnp.asarray, (psi, src, r, z)), **kw)
    ours = ta.refine_x_point(*map(torch.tensor, (psi, src, r, z)), **kw)
    for name in ref._fields:
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name


def grids():
    ref = JGrid(NR=129, NZ=129, R_min=3.0, R_max=9.0, Z_min=-3.0, Z_max=3.0,
                dtype=np.dtype("float64"))
    return ref, interop.grid(dataclasses.asdict(ref), dtype=torch.float64, device="cpu")


def decay_field(ref_grid, alpha):
    rr, zz = np.asarray(ref_grid.RR), np.asarray(ref_grid.ZZ)
    return -0.4 * 6.0 ** 0.7 * rr ** 1.3 / 1.3 + alpha * rr ** 2 * zz ** 2


def crel(a, b) -> float:
    """max |a - b| / max |b| (complex; 0 where both are zero)."""
    a, b = a.detach().numpy(), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


@pytest.mark.parametrize("alpha,z0", [(0.0, 0.0), (0.01, 0.1), (-0.02, -0.3)])
def test_rigid_body_report_matches_jax(alpha, z0):
    ref_grid, grid = grids()
    psi = decay_field(ref_grid, alpha)
    ref = jrb.analyze_rigid_body(jnp.asarray(psi), ref_grid, r_target=6.0, z_target=z0, ip_ma=1.2)
    ours = trb.analyze_rigid_body(torch.tensor(psi), grid, r_target=6.0, z_target=z0, ip_ma=1.2)
    for name in ref.forces._fields:
        assert crel(getattr(ours.forces, name), getattr(ref.forces, name)) <= TOL, name
    assert rel(ours.stiffness_n_m, ref.stiffness_n_m) <= TOL
    assert crel(ours.eigenvalues, ref.eigenvalues) <= TOL
    for flag in ("radial_stable", "vertical_stable", "n_index_ok"):
        assert bool(getattr(ours, flag)) == bool(getattr(ref, flag)), flag
    for a, b in zip(trb.vacuum_field_at(torch.tensor(psi), grid, 6.7, 2.9),
                    jrb.vacuum_field_at(jnp.asarray(psi), ref_grid, 6.7, 2.9)):
        assert crel(a, b) <= TOL


def test_stability_landscape_matches_jax():
    ref_grid, grid = grids()
    psi = decay_field(ref_grid, 0.01)
    r_pts, z_pts = np.linspace(5.0, 7.0, 9), np.linspace(-1.0, 1.0, 7)
    ref = jrb.stability_landscape(jnp.asarray(psi), ref_grid, r_points=jnp.asarray(r_pts),
                                  z_points=jnp.asarray(z_pts), ip_ma=1.2)
    ours = trb.stability_landscape(torch.tensor(psi), grid, r_points=torch.tensor(r_pts),
                                   z_points=torch.tensor(z_pts), ip_ma=1.2)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and rel(a, b) <= TOL
