"""Port parity: the Newton-Krylov solve (``models/equilibrium/newton``).

On the CPU in float64 against the JAX package: the port's BiCGSTAB against
``jax.scipy.sparse.linalg.bicgstab`` on a seeded non-symmetric system with a
preconditioner (within 1e-10 relative, stopped by the tolerance and by
``maxiter``); the exact JVP of the GS residual (``torch.func.jvp``) against
``jax.jvp`` of the same residual built from the JAX package's functions
(within 1e-10 relative, L- and H-mode); and ``solve_equilibrium_newton`` at
33^2 in L-mode: the same Newton iterations, the residual history within 1e-6
relative, psi within 1e-9 span-relative.  The H-mode solve is held in
``tests/test_torch_newton_hmode.py`` (kept apart so each file stays short).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, iter_like_cfg, rel, rng, span_rel, to_torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium import newton as jn
from scpn_fusion_tpu.models.equilibrium.profiles import (
    plasma_current_density,
    profile_coeffs_from_physics,
)
from scpn_fusion_tpu.models.equilibrium.topology import analyze_topology
from scpn_fusion_tpu.ops.stencil import gs_operator
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.equilibrium import newton as tn
from scpn_fusion_tpu_torch.models.equilibrium import profiles as tprof


def newton_cfgs(n, mode):
    ref_cfg = iter_like_cfg(n, solver_method="multigrid")
    ref_cfg = dataclasses.replace(
        ref_cfg, physics=dataclasses.replace(ref_cfg.physics, profile_mode=mode))
    return ref_cfg, interop.config_from_asdict(dataclasses.asdict(ref_cfg))


def assert_newton_parity(n, mode):
    ref_cfg, cfg = newton_cfgs(n, mode)
    ref = jn.solve_equilibrium_newton(ref_cfg, dtype=jnp.float64)
    ours = tn.solve_equilibrium_newton(cfg, device="cpu")
    k = int(ref.iterations)
    assert ours.iterations == k and ours.converged == bool(ref.converged) and ours.converged
    assert ours.psi.dtype == torch.float64
    assert rel(ours.residual_history[:k], np.asarray(ref.residual_history)[:k]) <= 1e-6
    assert bool(torch.isnan(ours.residual_history[k:]).all())
    assert rel(ours.residual_norm, ref.residual_norm) <= 1e-6
    assert span_rel(ours.psi, ref.psi) <= 1e-9
    assert span_rel(ours.j_phi, ref.j_phi) <= 1e-9


@pytest.mark.parametrize("maxiter,tol", [(200, 1e-10), (3, 1e-10), (30, 1e-3)])
def test_bicgstab_matches_jax(maxiter, tol):
    g = rng(19)
    n = 48
    a = np.eye(n) * 8.0 + 0.5 * g.standard_normal((n, n))
    m = np.linalg.inv(np.eye(n) * 4.0 + np.triu(0.5 * g.standard_normal((n, n)), 1))
    b = g.standard_normal((6, 8))

    ref = jax.scipy.sparse.linalg.bicgstab(
        lambda v: (jnp.asarray(a) @ v.reshape(-1)).reshape(v.shape), jnp.asarray(b),
        M=lambda v: (jnp.asarray(m) @ v.reshape(-1)).reshape(v.shape), maxiter=maxiter,
        tol=tol)[0]
    ta, tm = to_torch(a), to_torch(m)
    ours = tn._bicgstab(lambda v: (ta @ v.reshape(-1)).reshape(v.shape), to_torch(b),
                        lambda v: (tm @ v.reshape(-1)).reshape(v.shape), maxiter=maxiter, tol=tol)
    assert rel(ours, ref) <= 1e-10
    if maxiter == 200:
        assert rel(ours, np.linalg.solve(a, b.reshape(-1)).reshape(b.shape)) <= 1e-8
    assert not bool(tn._bicgstab(lambda v: v, torch.zeros(3, 3, dtype=torch.float64),
                                 lambda v: v, maxiter=5).any())


@pytest.mark.parametrize("mode", ["l-mode", "h-mode"])
def test_residual_jvp_matches_jax(mode):
    n = 33
    ref_cfg, cfg = newton_cfgs(n, mode)
    jgrid = JGrid.from_config(ref_cfg, dtype=np.float64)
    tgrid = TGrid.from_config(cfg, dtype=torch.float64, device="cpu")
    rr, zz = np.asarray(jgrid.RR), np.asarray(jgrid.ZZ)
    psi = (3.0 * np.exp(-((rr - 6.0) ** 2 + zz**2) / 4.0) - 0.2 * zz
           + 0.01 * rng(20).standard_normal((n, n)))
    v = rng(21).standard_normal((n, n))
    p_c, ff_c = profile_coeffs_from_physics(ref_cfg.physics, jnp.float64)
    i_t = jnp.asarray(15.0)
    h_mode = mode == "h-mode"

    def residual_j(p):
        # scpn_fusion_tpu/models/equilibrium/newton.py:85-98
        topo = analyze_topology(p, jgrid.ZZ, jgrid.dR, jgrid.dZ, jgrid.Z_min)
        j_phi = plasma_current_density(
            p, topo.psi_axis, topo.psi_boundary, jgrid.RR, h_mode=h_mode, p_coeffs=p_c,
            ff_coeffs=ff_c, mu0=1.0, i_target=i_t, d_r=jgrid.dR, d_z=jgrid.dZ)
        res = gs_operator(p, jgrid.R, jgrid.dR, jgrid.dZ) - (-1.0 * jgrid.RR * j_phi)
        return (res.at[0, :].set(0.0).at[-1, :].set(0.0)
                .at[:, 0].set(0.0).at[:, -1].set(0.0))

    f_ref, jv_ref = jax.jit(lambda p, t: jax.jvp(residual_j, (p,), (t,)))(
        jnp.asarray(psi), jnp.asarray(v))
    tp_c, tff_c = tprof.profile_coeffs_from_physics(cfg.physics, torch.float64, "cpu")
    _, residual_t = tn._residual_fns(tgrid, torch.tensor(15.0, dtype=torch.float64), tp_c,
                                     tff_c, h_mode=h_mode, mu0=1.0)
    f, jv = torch.func.jvp(residual_t, (to_torch(psi),), (to_torch(v),))
    assert rel(f, f_ref) <= 1e-10
    assert rel(jv, jv_ref) <= 1e-10
    assert float(np.max(np.abs(as_np(jv)[0]))) == 0.0


def test_newton_lmode_matches_jax():
    assert_newton_parity(33, "l-mode")
