"""Port parity: GS* stencil ops and the SOR kernel's plain version.

The plain ops (``scpn_fusion_tpu_torch.ops.stencil``) hold against
``scpn_fusion_tpu.ops.stencil`` in f64; the SOR kernel wrapper
(``ops/cuda_stencil.sor_sweeps``, which runs its plain version on the CPU)
holds against ``ops/pallas_stencil.sor_sweeps_pallas(interpret=True)`` at
the bar of ``tests/test_pallas_stencil.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import fields, ring_equal, span_rel, to_torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.ops import stencil as jst
from scpn_fusion_tpu.ops.pallas_stencil import sor_sweeps_pallas
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.ops import stencil as tst
from scpn_fusion_tpu_torch.ops.cuda_stencil import sor_sweeps, sor_sweeps_plain

SHAPE = (33, 40)   # (NZ, NR), deliberately non-square


def _grids(shape, npdt, tdt):
    nz, nr = shape
    return (JGrid.from_bounds(nr, nz, 2.0, 10.0, -4.0, 4.0, dtype=npdt),
            TGrid.from_bounds(nr, nz, 2.0, 10.0, -4.0, 4.0, dtype=tdt))


def test_stencil_ops_f64():
    """gs_operator, gs_residual(_rms), apply_dirichlet, jacobi_step and
    stencil_coeffs == scpn_fusion_tpu.ops.stencil (f64, <= 1e-12)."""
    jg, tg = _grids(SHAPE, np.float64, torch.float64)
    psi, src, bc = fields(0, SHAPE, 3)
    r, tr = jg.R, tg.R
    jp, js, tp, ts = jnp.asarray(psi), jnp.asarray(src), to_torch(psi), to_torch(src)
    for a, b in zip(tst.stencil_coeffs(tr, tg.dR, tg.dZ), jst.stencil_coeffs(r, jg.dR, jg.dZ)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=0)
    pairs = [
        (tst.gs_operator(tp, tr, tg.dR, tg.dZ), jst.gs_operator(jp, r, jg.dR, jg.dZ)),
        (tst.gs_residual(tp, ts, tr, tg.dR, tg.dZ), jst.gs_residual(jp, js, r, jg.dR, jg.dZ)),
        (tst.apply_dirichlet(tp, to_torch(bc)), jst.apply_dirichlet(jp, jnp.asarray(bc))),
        (tst.jacobi_step(tp, ts, tr, tg.dR, tg.dZ), jst.jacobi_step(jp, js, r, jg.dR, jg.dZ)),
        (tst.jacobi_sweeps(tp, ts, tr, tg.dR, tg.dZ, 5),
         jst.jacobi_sweeps(jp, js, r, jg.dR, jg.dZ, 5)),
    ]
    for ours, ref in pairs:
        assert span_rel(ours, ref) <= 1e-12
    rms = float(tst.gs_residual_rms(tp, ts, tr, tg.dR, tg.dZ))
    assert abs(rms / float(jst.gs_residual_rms(jp, js, r, jg.dR, jg.dZ)) - 1.0) <= 1e-12


@pytest.mark.parametrize("omega", [1.0, 1.6])
def test_sor_step_and_sweeps_f64(omega):
    """sor_step / sor_sweeps (with the 1e12 clip) == the JAX XLA path, f64."""
    jg, tg = _grids(SHAPE, np.float64, torch.float64)
    psi, src = fields(1, SHAPE)
    ours = tst.sor_step(to_torch(psi), to_torch(src), tg.R, tg.dR, tg.dZ, omega)
    ref = jst.sor_step(jnp.asarray(psi), jnp.asarray(src), jg.R, jg.dR, jg.dZ, omega)
    assert span_rel(ours, ref) <= 1e-12
    ours = tst.sor_sweeps(to_torch(psi), to_torch(src), tg.R, tg.dR, tg.dZ, omega, 6)
    ref = jst.sor_sweeps(jnp.asarray(psi), jnp.asarray(src), jg.R, jg.dR, jg.dZ, omega, 6)
    assert span_rel(ours, ref) <= 1e-12
    assert ring_equal(ours, psi)


def test_clip_applies_to_plain_ops_only():
    """The plain sweep clips at 1e12 like stencil.sor_step; the kernel's
    plain version does not, like the Pallas kernel."""
    jg, tg = _grids((9, 9), np.float64, torch.float64)
    psi = torch.zeros((9, 9), dtype=torch.float64)
    src = torch.full((9, 9), -1e20, dtype=torch.float64)
    clipped = tst.sor_step(psi, src, tg.R, tg.dR, tg.dZ, 1.0)
    unclipped = sor_sweeps_plain(psi, src, tg.R, tg.dR, tg.dZ, 1.0, 1)
    assert float(clipped.max()) == tst.NUMERIC_CAP
    assert float(unclipped.max()) > tst.NUMERIC_CAP


@pytest.mark.parametrize("n_sweeps", [1, 7])
@pytest.mark.parametrize("shape", [(33, 33), (65, 48)])
def test_sor_kernel_plain_matches_pallas(shape, n_sweeps):
    """sor_sweeps on a CPU tensor (its plain version) ==
    sor_sweeps_pallas(interpret=True), rtol=atol=2e-6, ring bit-identical."""
    jg, tg = _grids(shape, np.float32, torch.float32)
    psi, src = fields(0, shape, dtype=np.float32)
    ref = sor_sweeps_pallas(jnp.asarray(psi), jnp.asarray(src), jg.R.astype(jnp.float32),
                            jg.dR, jg.dZ, 1.6, n_sweeps, interpret=True)
    ours = sor_sweeps(to_torch(psi, np.float32), to_torch(src, np.float32), tg.R,
                      tg.dR, tg.dZ, 1.6, n_sweeps)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-6, atol=2e-6)
    assert ring_equal(ours, psi)
    assert torch.equal(ours, sor_sweeps_plain(to_torch(psi, np.float32),
                                              to_torch(src, np.float32), tg.R, tg.dR,
                                              tg.dZ, 1.6, n_sweeps))
