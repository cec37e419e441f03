"""Port parity: ``parallel/gk_shard.run_gk_ensemble_sharded``, flux-tube
ensemble members split over a (data, v) = (2, 4) mesh of CPU shards, each
member's mu over 'v', the members stepped in lockstep; and the
electromagnetic two-species run on the (sx, sy, v) = (2, 2, 2) mesh against
JAX's monolithic run (the gates of ``test_torch_gk_shard.py``).

JAX draws each member's noise with ``fold_in(PRNGKey(0), seed)``; those bits
cannot be reproduced, so the port's public function draws from a CPU
``torch.Generator`` and its private twin ``_run_gk_ensemble_sharded`` takes
the draws.  Fed JAX's base state and JAX's draws, each of the four members
matches JAX's monolithic ``run_nonlinear_gk`` from the same member state
within 1e-10 of max |f| and the trace within rtol 1e-9 (the gates of
``tests/test_gk_spatial_shard.py``); the public function's draws are the
twin's, seeded per member.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gk_shard import MESHES, _check_run, _reference
from torch_parity import crel as rel

from scpn_fusion_tpu.models.gyrokinetics import nonlinear as jnl
from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as tnl
from scpn_fusion_tpu_torch.parallel import gk_shard as gs

CFG = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=6, n_mu=8, n_steps=4, save_interval=2,
           nonlinear=True, collisions=True, dtype="complex128")
SEEDS = (3, 11, 17, 29)
AMPLITUDE = 1e-5


def _jax_member_noise(seed, shape):
    """JAX's draw of ``run_gk_ensemble_sharded``'s member ``seed``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    kr, ki = jax.random.split(key)
    return np.asarray((jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
                      .astype(jnp.complex128))


@pytest.fixture(scope="module")
def jax_members():
    """JAX's base state, its draws and each member's monolithic run."""
    jc = jnl.NonlinearGKConfig(**CFG)
    jg = jnl.build_grids(jc)
    st = jnl.init_state(jc, jg, amplitude=AMPLITUDE, seed=0)
    noise = np.stack([_jax_member_noise(s, st.f.shape) for s in SEEDS])
    runs = [jnl._run_compiled(jc, jg, jnl.GKState(f=st.f + AMPLITUDE * 0.1 * jnp.asarray(n),
                                                  time=st.time))
            for n in noise]
    return np.array(st.f), noise, runs


def test_ensemble_matches_jax_member_runs(jax_members):
    f0, noise, runs = jax_members
    cfg = tnl.NonlinearGKConfig(**CFG)
    state, trace = gs._run_gk_ensemble_sharded(
        cfg, gs.ensemble_mesh(2, 4, device="cpu"), torch.from_numpy(f0),
        torch.from_numpy(noise), AMPLITUDE)
    assert state.f.shape == (4, 2, 8, 8, 8, 6, 8) and state.time.shape == (4,)
    assert trace.phi_rms.shape == (4, 2)
    for m, (j_final, j_trace) in enumerate(runs):
        assert rel(state.f[m], j_final.f) < 1e-10
        np.testing.assert_allclose(state.time[m].numpy(), np.asarray(j_final.time), rtol=1e-12)
        for name in j_trace._fields:
            np.testing.assert_allclose(getattr(trace, name)[m].numpy(),
                                       np.asarray(getattr(j_trace, name)),
                                       rtol=1e-9, atol=1e-13, err_msg=name)
    # the members differ: their own noise
    assert rel(state.f[0], state.f[1]) > 1e-3


def test_public_draws_are_the_twins_seeded_per_member():
    """The public function draws each member's noise from a CPU generator
    seeded with its seed, on top of the port's seed-0 initial state."""
    cfg = tnl.NonlinearGKConfig(**{**CFG, "n_steps": 2, "save_interval": 1})
    mesh = gs.ensemble_mesh(2, 4, device="cpu")
    state, trace = gs.run_gk_ensemble_sharded(cfg, mesh, np.array([5, 6]), AMPLITUDE)
    g = tnl.build_grids(cfg, device="cpu")
    f0 = tnl.init_state(cfg, g, amplitude=AMPLITUDE, seed=0).f
    draws = [gs.member_noise(seed, f0.shape) for seed in (5, 6)]
    gen = torch.Generator().manual_seed(6)
    assert torch.equal(draws[1].real, torch.randn(f0.shape, generator=gen, dtype=torch.float64))
    twin, twin_trace = gs._run_gk_ensemble_sharded(cfg, mesh, f0, torch.stack(draws), AMPLITUDE)
    assert torch.equal(state.f, twin.f)
    assert all(torch.equal(a, b) for a, b in zip(trace, twin_trace))
    # each member is the monolithic run of its own state
    member = tnl.GKState(f0 + (AMPLITUDE * 0.1) * draws[1], torch.tensor(0.0, dtype=torch.float64))
    mono, _ = tnl.run_nonlinear_gk(cfg, state=member, device="cpu")
    assert rel(state.f[1], mono.f) <= 1e-12


def test_electromagnetic_two_species():
    """EM + kinetic electrons: the Ampere and B_par moments' psum, the
    electron species through the transposes, on the full (2, 2, 2) mesh."""
    em = _reference(dict(n_species=2, kinetic_electrons=True, electromagnetic=True,
                         beta_e=0.01, n_steps=4, save_interval=2), 7)
    _check_run(em, MESHES["sx,sy,v=2,2,2"]())
