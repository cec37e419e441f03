"""Port parity: the FMG Picard cascade (``solve_equilibrium_fmg``).

The port's cascade against ``scpn_fusion_tpu.models.equilibrium
.fixed_boundary.solve_equilibrium_fmg`` on the CPU (plain ops on both sides),
with the bench solver settings (``bench.py:221-229``) at 129^2 and
``min_coarse=65``.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch
from torch_parity import BENCH_SOLVER, iter_like_cfg, span_rel

from scpn_fusion_tpu.models.equilibrium import fixed_boundary as jfb
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import fixed_boundary as tfb


@pytest.mark.parametrize("np_dt,t_dt", [(jnp.float64, torch.float64),
                                        (jnp.float32, torch.float32)], ids=["f64", "f32"])
def test_fmg_cascade(np_dt, t_dt):
    """solve_equilibrium_fmg at 129^2 (min_coarse=65, bench solver): f64
    identical per-level counts and psi within 1e-9; f32 within 1e-4 and the
    fine-level count within 1."""
    ref_cfg = iter_like_cfg(129, **BENCH_SOLVER)
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    ref, ref_info = jfb.solve_equilibrium_fmg(ref_cfg, min_coarse=65, dtype=np_dt)
    ours, info = tfb.solve_equilibrium_fmg(cfg, min_coarse=65, dtype=t_dt, device="cpu")
    assert [d["n"] for d in info] == [d["n"] for d in ref_info] == [65, 129]
    assert all(d["converged"] for d in info)
    if t_dt == torch.float64:
        assert info == ref_info
        assert span_rel(ours.psi, ref.psi) <= 1e-9
    else:
        assert abs(info[-1]["iterations"] - ref_info[-1]["iterations"]) <= 1
        assert span_rel(ours.psi, ref.psi) <= 1e-4


def test_fmg_rejects_nonsquare():
    cfg = interop.config_from_asdict(dataclasses.asdict(
        dataclasses.replace(iter_like_cfg(65, **BENCH_SOLVER), grid_resolution=(65, 129))))
    with pytest.raises(ValueError, match="square"):
        tfb.solve_equilibrium_fmg(cfg)
