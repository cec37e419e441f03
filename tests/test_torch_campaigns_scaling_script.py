"""The port's ``resolution_scaling`` cascade against the JAX script's own.

The JAX script times a cascade it writes by hand
(``validation/run_resolution_scaling.py:127-147``): each level its
``_solve_fixed_boundary``, handed the prolonged coarser iterate as it is.
The port's lanes run the entry point ``solve_equilibrium_fmg`` instead,
which puts the exact fine vacuum ring on the prolonged iterate before a
level's first iteration (as the script's own parity solve does).  At 257^2
in float64 the two take the same iterations on every level and their psi
lie 2.7e-6 of the span apart; the test holds them to equal counts and
``SCRIPT_TOL`` of the span.
"""

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import run_resolution_scaling as rs

SCRIPT_TOL = 1e-5


def script_cascade(n_fine):
    """The JAX script's float32 cascade (``run_resolution_scaling.py:127-147``)
    at ``n_fine``, its levels in float64."""
    import dataclasses

    import jax.numpy as jnp

    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
    )
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.fixed_boundary import _solve_fixed_boundary
    from scpn_fusion_tpu.models.equilibrium.profiles import profile_coeffs_from_physics
    from scpn_fusion_tpu.models.equilibrium.vacuum import vacuum_psi_from_config
    from scpn_fusion_tpu.ops.multigrid import prolongate_bilinear
    from scpn_fusion_tpu_torch.bench_config import ITER_LIKE

    f64 = jnp.float64
    cfg = ReactorConfig(
        reactor_name=f"res-scale-{n_fine}", grid_resolution=(n_fine, n_fine),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=tuple(Coil(**c) for c in ITER_LIKE["coils"]),
        physics=PhysicsParams(plasma_current_target=15.0, vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=600, convergence_threshold=1e-4,
                            relaxation_factor=1.0, solver_method="anderson_mg",
                            anderson_depth=4, mg_pre_smooth=1, mg_post_smooth=2))
    sol = cfg.solver
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, f64)
    info, res = [], None
    for m in rs.cascade_levels(n_fine, mixed=False):
        level_cfg = dataclasses.replace(cfg, grid_resolution=(m, m))
        grid = Grid.from_config(level_cfg, dtype=np.float64)
        bc = vacuum_psi_from_config(grid, level_cfg).astype(f64)
        fine = m == n_fine and res is not None
        res = _solve_fixed_boundary(
            grid, bc if res is None else prolongate_bilinear(res.psi, m, m), bc,
            jnp.asarray(15.0, f64), p_c, ff_c,
            jnp.asarray(sol.convergence_threshold if fine else rs.COARSE_TOL, f64),
            jnp.asarray(jnp.inf, f64), jnp.asarray(1.0, f64), jnp.asarray(sol.sor_omega, f64),
            solver_method="anderson_mg", max_iter=sol.max_iterations, h_mode=False,
            inner_sweeps=sol.inner_sweeps, anderson_m=sol.anderson_depth, mu0=1.0,
            use_gs_criterion=False, use_pallas=False, skip_seed=res is not None,
            mg_pre_smooth=sol.mg_pre_smooth, mg_post_smooth=sol.mg_post_smooth,
            mg_min_grid=sol.mg_min_grid)
        info.append((m, int(res.iterations), bool(res.converged)))
    return res, info


def test_entry_point_cascade_against_script_cascade():
    ref, ref_info = script_cascade(257)
    ours, info = rs.Cascade(257, "cpu", dtype=torch.float64).solve()
    assert [(d["n"], d["iterations"], d["converged"]) for d in info] == ref_info
    p = np.asarray(ref.psi)
    assert float(np.max(np.abs(ours.psi.numpy() - p))) / float(p.max() - p.min()) <= SCRIPT_TOL
