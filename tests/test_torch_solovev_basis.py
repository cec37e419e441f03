"""Port parity: the Solov'ev family (``models/equilibrium/solovev.py``) and
the compact bases (``models/equilibrium/compact_basis.py``).

On the CPU in float64 against the JAX package: the Solov'ev psi and source
and its profile split exactly; the Chebyshev and B-spline designs equal bit
for bit; ``synth`` and ``fit`` (QR and the triangular solve) within 1e-12
relative, the synthesis gradient equal to the design; the same errors on
ill-posed requests; and the continuation-reset truth table.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel, rng

from scpn_fusion_tpu.models.equilibrium import compact_basis as jb
from scpn_fusion_tpu.models.equilibrium import solovev as js
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import compact_basis as tb
from scpn_fusion_tpu_torch.models.equilibrium import solovev as ts

R = np.linspace(3.0, 9.0, 65)
Z = np.linspace(-5.0, 5.0, 65)


@pytest.mark.parametrize("params", [{}, dict(a=-0.01, b=0.03, e=0.2, c=0.4, d=1.5)])
def test_solovev_matches_jax(params):
    ref = js.SolovevParams(**params)
    ours = interop.solovev_params(dataclasses.asdict(ref))
    assert isinstance(ours, ts.SolovevParams)
    rr, zz = np.meshgrid(R, Z)
    assert np.array_equal(as_np(ours.psi(torch.tensor(rr), torch.tensor(zz))),
                          np.asarray(ref.psi(jnp.asarray(rr), jnp.asarray(zz))))
    assert rel(ours.source(torch.tensor(rr)), ref.source(jnp.asarray(rr))) <= 1e-15
    assert (ours.p_prime(2.0), ours.ff_prime(), ours.source_r2_coeff, ours.source_const) == (
        ref.p_prime(2.0), ref.ff_prime(), ref.source_r2_coeff, ref.source_const)


@pytest.mark.parametrize("n_r,n_z", [(8, 6), (34, 16)])
def test_chebyshev_basis_matches_jax(n_r, n_z):
    ref, ours = jb.chebyshev_psi_basis(R, Z, n_r, n_z), tb.chebyshev_psi_basis(R, Z, n_r, n_z)
    assert np.array_equal(ours.design, ref.design) and ours.shape == ref.shape
    c = rng(3).standard_normal(ref.n_coeffs)
    assert rel(ours.synth(torch.tensor(c)), ref.synth(jnp.asarray(c))) <= 1e-12
    rr, zz = np.meshgrid(R, Z)
    psi = np.exp(-((rr - 6.2) ** 2 + 0.5 * zz ** 2) / 4.0)
    assert rel(ours.fit(torch.tensor(psi)), ref.fit(jnp.asarray(psi))) <= 1e-12


def test_synthesis_gradient_is_the_design():
    basis = tb.chebyshev_psi_basis(R[:9], Z[:7], n_r=3, n_z=2)
    jac = torch.autograd.functional.jacobian(lambda c: basis.synth(c).reshape(-1),
                                             torch.zeros(basis.n_coeffs, dtype=torch.float64))
    assert np.array_equal(as_np(jac), basis.design)


@pytest.mark.parametrize("n_coeff,degree", [(12, 3), (6, 2), (4, 1)])
def test_bspline_basis_matches_jax(n_coeff, degree):
    q = np.concatenate([np.linspace(-0.1, 1.1, 57), [0.0, 1.0]])
    ref, ours = (jb.profile_bspline_basis(q, n_coeff, degree),
                 tb.profile_bspline_basis(q, n_coeff, degree))
    assert np.array_equal(ours.design, ref.design)
    y = np.sin(3 * np.clip(q, 0, 1))
    assert rel(ours.fit(torch.tensor(y)), ref.fit(jnp.asarray(y))) <= 1e-12


def test_triangular_solve_matches_jax():
    a = rng(5).standard_normal((6, 6))
    r = np.triu(a) + 6 * np.eye(6)
    b = rng(6).standard_normal(6)
    assert rel(tb.triangular_solve(torch.tensor(r), torch.tensor(b)),
               jb.jax_triangular_solve(jnp.asarray(r), jnp.asarray(b))) <= 1e-14


def test_ill_posed_requests_fail_like_jax():
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="under-resolved"):
            mod.chebyshev_psi_basis(R[:5], Z, n_r=8, n_z=4)
        with pytest.raises(ValueError, match="n_coeff > degree"):
            mod.profile_bspline_basis(np.linspace(0, 1, 9), 3, 3)


@pytest.mark.parametrize("use_sep", [False, True])
def test_continuation_reset_matches_jax(use_sep):
    kw = dict(ip_ramp=5, separatrix_start=3, separatrix_ramp=4, use_separatrix=use_sep)
    for i in range(12):
        assert bool(tb.continuation_history_reset(i, **kw)) == bool(
            jb.continuation_history_reset(i, **kw)), i
