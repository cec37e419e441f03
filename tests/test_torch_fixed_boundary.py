"""Port parity: the fixed-boundary Picard solver.

``scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary`` against
``scpn_fusion_tpu.models.equilibrium.fixed_boundary`` on the CPU, where both
run their plain ops (the JAX solver takes Pallas only on a TPU, the port's
kernels only on CUDA).  Configs are the normalised ITER-like set of
``tests/test_fixed_boundary.py``.  The FMG cascade is held in
``tests/test_torch_fmg.py`` (kept apart so each file stays short).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import BENCH_SOLVER, fields, iter_like_cfg, span_rel, to_torch

from scpn_fusion_tpu.models.equilibrium import fixed_boundary as jfb
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import fixed_boundary as tfb

@pytest.mark.parametrize("n_valid", [3, 4])
def test_anderson_mix_f64(n_valid):
    m, shape = 4, (17, 20)
    psi_buf = np.stack(fields(1, shape, m))
    f_buf = np.stack(fields(2, shape, m))
    ref = jfb._anderson_mix(jnp.asarray(psi_buf), jnp.asarray(f_buf), jnp.int32(n_valid))
    ours = tfb._anderson_mix(to_torch(psi_buf), to_torch(f_buf), n_valid)
    assert span_rel(ours, ref) <= 1e-12


@pytest.mark.parametrize("method,solver", [
    ("multigrid", dict(relaxation_factor=0.5)),
    ("anderson_mg", dict(relaxation_factor=1.0, anderson_depth=4)),
    ("sor", dict(relaxation_factor=0.5, inner_sweeps=10)),
    ("anderson", dict(relaxation_factor=0.5, inner_sweeps=10)),
])
def test_solve_equilibrium_f64(method, solver):
    """Same iteration count, same converged flag, psi within 1e-9 span-rel."""
    ref_cfg = iter_like_cfg(65, solver_method=method, **solver)
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    ref = jfb.solve_equilibrium(ref_cfg, dtype=jnp.float64)
    ours = tfb.solve_equilibrium(cfg, dtype=torch.float64, device="cpu")
    assert ours.iterations == int(ref.iterations)
    assert ours.converged == bool(ref.converged)
    assert span_rel(ours.psi, ref.psi) <= 1e-9
    for name in ("j_phi", "b_r", "b_z"):
        assert span_rel(getattr(ours, name), getattr(ref, name)) <= 1e-9
    k = ours.iterations
    np.testing.assert_allclose(ours.residual_history[:k].numpy(),
                               np.asarray(ref.residual_history[:k]), rtol=1e-6)
    assert torch.isnan(ours.residual_history[k:]).all()


def test_warm_start_and_zero_current_f64():
    """preserve_initial_state + boundary_flux + skip_seed, and the
    zero-current short-circuit, as in the JAX entry point."""
    ref_cfg = iter_like_cfg(33, **BENCH_SOLVER)
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    psi0, bc = fields(4, (33, 33))
    ref = jfb.solve_equilibrium(ref_cfg, psi0=jnp.asarray(psi0), boundary_flux=jnp.asarray(bc),
                                preserve_initial_state=True, skip_seed=True,
                                dtype=jnp.float64)
    ours = tfb.solve_equilibrium(cfg, psi0=to_torch(psi0), boundary_flux=to_torch(bc),
                                 preserve_initial_state=True, skip_seed=True,
                                 dtype=torch.float64)
    assert ours.iterations == int(ref.iterations)
    assert span_rel(ours.psi, ref.psi) <= 1e-9

    zero_ref = dataclasses.replace(
        ref_cfg, physics=dataclasses.replace(ref_cfg.physics, plasma_current_target=0.0))
    zero = interop.config_from_asdict(dataclasses.asdict(zero_ref))
    ref = jfb.solve_equilibrium(zero_ref, dtype=jnp.float64)
    ours = tfb.solve_equilibrium(zero, dtype=torch.float64)
    assert ours.converged and ours.iterations == 0
    assert span_rel(ours.psi, ref.psi) <= 1e-12
