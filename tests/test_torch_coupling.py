"""Port parity: the GS <-> transport coupling (``models/transport/coupling.py``).

The self-consistent loop of ``examples/10_integrated_scenario.py`` on the
ITER-like machine at 33^2 with the transport at nr 25, ``n_inner`` 3, in
float64 on the CPU: the same outer iteration count as JAX, psi, J_phi and
the transport state within 1e-10.  ``jnp.interp`` has no torch twin: the
port's ``interp_1d`` is held to it on knots, between them and outside them
(held at the end values).  As in JAX, J_phi does not enter the GS solve.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, iter_like_cfg, span_rel

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium.vacuum import vacuum_psi_from_config as jvac
from scpn_fusion_tpu.models.transport import coupling as jcp
from scpn_fusion_tpu.models.transport import solver as js
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu_torch.models.transport import coupling as tcp
from scpn_fusion_tpu_torch.models.transport import solver as ts

SOLVER = dict(solver_method="multigrid", max_iterations=150, relaxation_factor=0.1,
              inner_sweeps=1)


def _rel(ours, ref) -> float:
    """max |ours - ref| over max |ref| (1 where ref is all zero); equal
    infinities count as equal."""
    a, b = as_np(ours), as_np(ref)
    same = a == b
    diff = np.abs(np.where(same, 0.0, a) - np.where(same, 0.0, b))
    scale = np.max(np.abs(np.where(np.isfinite(b), b, 0.0)))
    return float(np.max(diff)) / (scale if scale > 0 else 1.0)


def _case(n=33, nr=25):
    ref_cfg = iter_like_cfg(n, **SOLVER)
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    ref_tp = js.TransportParams(nr=nr)
    return ref_cfg, cfg, ref_tp, interop.transport_params(dataclasses.asdict(ref_tp))


def test_interp_matches_jnp_interp():
    g = np.random.default_rng(8)
    xp = np.sort(g.random(17))
    xp[5] = xp[4]                                # a repeated knot
    fp = g.standard_normal(17)
    x = np.concatenate([xp, g.uniform(-0.5, 1.5, 200), [xp[0] - 1.0, xp[-1] + 1.0]])
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    ours = tcp.interp_1d(*(torch.from_numpy(v) for v in (x, xp, fp))).numpy()
    # within an ulp: XLA may contract fp[i-1] + (delta / dx) df into an FMA
    assert np.max(np.abs(ours - ref)) <= 4e-16 * np.max(np.abs(fp))
    assert np.array_equal(ours[:17], ref[:17])                 # on the knots
    assert ours[-2] == fp[0] and ours[-1] == fp[-1]           # held outside


@pytest.mark.parametrize("seed", [0, 1])
def test_map_profiles_and_confinement_time(seed):
    ref_cfg, cfg, ref_tp, tp = _case()
    jgrid = JGrid.from_config(ref_cfg, dtype=np.float64)
    grid = Grid.from_config(cfg, dtype=torch.float64, device="cpu")
    rr, zz = np.asarray(jgrid.RR), np.asarray(jgrid.ZZ)
    g = np.random.default_rng(seed)
    psi = np.exp(-((rr - 6.0) ** 2 + zz**2) / 3.0) * 10.0 + 0.1 * g.random(rr.shape)
    ref_s = js.run_transport(js.initial_state(ref_tp, jnp.float64), jnp.asarray(0.02),
                             jnp.asarray(30.0), ref_tp, 2)[0]
    s = interop.transport_state(ref_s._asdict(), dtype=torch.float64, device="cpu")
    ref = jcp.map_profiles_to_2d(jnp.asarray(psi), ref_s, ref_tp, jgrid, jnp.float64(15.0), 1.0)
    ours = tcp.map_profiles_to_2d(torch.from_numpy(psi), s, tp, grid,
                                  torch.tensor(15.0, dtype=torch.float64), 1.0)
    assert span_rel(ours, ref) <= 1e-12
    np.testing.assert_allclose(float(ours.sum()) * grid.dR * grid.dZ, 15.0, rtol=1e-10)
    for p_loss in (10.0, 100.0, 0.0):
        assert _rel(tcp.compute_confinement_time(s, tp, p_loss),
                   jcp.compute_confinement_time(ref_s, ref_tp, jnp.float64(p_loss))) <= 1e-13


def test_self_consistent_f64():
    ref_cfg, cfg, ref_tp, tp = _case()
    jgrid = JGrid.from_config(ref_cfg, dtype=np.float64)
    grid = Grid.from_config(cfg, dtype=torch.float64, device="cpu")
    ref_bc = jvac(jgrid, ref_cfg).astype(jnp.float64)
    bc = vacuum_psi_from_config(grid, cfg)
    assert span_rel(bc, ref_bc) <= 1e-14
    kw = dict(n_inner=3, n_outer=6, psi_tol=1e-3)
    ref = jcp.run_self_consistent(ref_cfg, jgrid, ref_tp, js.initial_state(ref_tp, jnp.float64),
                                  ref_bc, ref_bc, p_aux_mw=jnp.float64(30.0),
                                  dt=jnp.float64(0.02), **kw)
    ours = tcp.run_self_consistent(cfg, grid, tp, ts.initial_state(tp, torch.float64, "cpu"),
                                   bc, bc, p_aux_mw=30.0, dt=0.02, **kw)
    assert ours.outer_iterations == int(ref.outer_iterations) >= 2
    assert ours.converged == bool(ref.converged)
    assert span_rel(ours.psi, ref.psi) <= 1e-10
    assert span_rel(ours.j_phi, ref.j_phi) <= 1e-10
    for name in ref.transport._fields:
        assert _rel(getattr(ours.transport, name), getattr(ref.transport, name)) <= 1e-10, name
    for name in ("psi_residual", "t_core", "tau_e"):
        assert _rel(getattr(ours, name), getattr(ref, name)) <= 1e-10, name
