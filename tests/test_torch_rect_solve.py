"""Port parity: the rectangular-grid solve (``bench_config.rect_config``).

The DIII-D-like machine on a tall grid that is not a square 2^k+1, where
every level of the V-cycle smooths through ``sor_sweeps`` (the hand-written
kernel's route on a card): the port's solve against the JAX package's in f64
on the CPU, and one V-cycle with the kernels' plain twins against the JAX
V-cycle with its Pallas smoother in interpret mode, as the JAX package's own
tests run Pallas on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import fields, ring_equal, span_rel, to_torch

from scpn_fusion_tpu.core.config import config_from_dict as j_config_from_dict
from scpn_fusion_tpu.models.equilibrium import fixed_boundary as jfb
from scpn_fusion_tpu.ops import multigrid as jmg
from scpn_fusion_tpu.ops import pallas_stencil
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.bench_config import RECT_GRID, rect_config, rect_config_dict
from scpn_fusion_tpu_torch.models.equilibrium import fixed_boundary as tfb
from scpn_fusion_tpu_torch.ops import multigrid as tmg


def test_rect_config_is_the_diiid_machine():
    """The configuration carries the DIII-D-like validation machine (box,
    coils, Ip, L-mode) on the tall 257 x 129 grid with the bench solver."""
    import json
    from pathlib import Path
    raw = json.loads((Path(__file__).resolve().parent.parent / "validation" / "configs"
                      / "diiid_config.json").read_text())
    cfg = rect_config()
    assert cfg.grid_resolution == RECT_GRID == (129, 257)
    assert dataclasses.asdict(cfg.dimensions) == raw["dimensions"]
    assert [(c.name, c.r, c.z, c.current, c.turns) for c in cfg.coils] == [
        (c["name"], c["r"], c["z"], c["current"], c["turns"]) for c in raw["coils"]]
    assert cfg.physics.plasma_current_target == raw["physics"]["plasma_current_target"]
    assert cfg.physics.profile_mode == raw["physics"]["profiles"]["mode"]
    assert cfg.physics.vacuum_permeability == 1.0
    assert (cfg.solver.solver_method, cfg.solver.anderson_depth, cfg.solver.mg_pre_smooth,
            cfg.solver.mg_post_smooth, cfg.solver.use_pallas) == ("anderson_mg", 4, 1, 2, True)


def test_rect_solve_f64():
    """Same iteration count and converged flag as the JAX solve, psi within
    1e-9 span-rel, at (NR, NZ) = (33, 65)."""
    ref_cfg = j_config_from_dict(rect_config_dict((33, 65)))
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    assert cfg == rect_config((33, 65))
    ref = jfb.solve_equilibrium(ref_cfg, dtype=jnp.float64)
    ours = tfb.solve_equilibrium(cfg, dtype=torch.float64, device="cpu")
    assert bool(ref.converged) and ours.converged
    assert ours.iterations == int(ref.iterations)
    assert span_rel(ours.psi, ref.psi) <= 1e-9
    assert span_rel(ours.j_phi, ref.j_phi) <= 1e-9


@pytest.mark.parametrize("pre,post", [(1, 2), (3, 3)])
def test_rect_vcycle_kernel_route(monkeypatch, pre, post):
    """One V-cycle on a 65 x 33 level with ``use_pallas=True`` (every level
    through ``sor_sweeps``, its plain twin here, down to the 9 x 5 coarsest
    solve of 50 sweeps) == the JAX V-cycle with ``sor_sweeps_pallas`` in
    interpret mode, float32, <= 1e-5 span-rel, ring bit-identical."""
    interpreted = pallas_stencil.sor_sweeps_pallas

    def sor_sweeps_interpret(*args, interpret=None, **kwargs):
        return interpreted(*args, interpret=True, **kwargs)

    monkeypatch.setattr(pallas_stencil, "sor_sweeps_pallas", sor_sweeps_interpret)
    nz, nr = 65, 33
    r = np.asarray(jnp.linspace(0.9, 2.6, nr, dtype=jnp.float32))
    d_r, d_z = float(r[1] - r[0]), 3.0 / (nz - 1)
    psi, src = fields(11, (nz, nr), dtype=np.float32)
    ref = jmg._vcycle_impl(jnp.asarray(psi), jnp.asarray(src), jnp.asarray(r), d_r, d_z, 1.0,
                           pre, post, 5, 50, True)
    ours = tmg._vcycle_impl(to_torch(psi, np.float32), to_torch(src, np.float32),
                            to_torch(r, np.float32), d_r, d_z, 1.0, pre, post, 5, 50, True)
    assert span_rel(ours, ref) <= 1e-5
    assert ring_equal(ours, psi)
