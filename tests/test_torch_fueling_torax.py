"""Port parity: the fueling loop and the TORAX-style campaign
(``control/fueling_torax.py``) and row N's plant kinds 2 and 3
(``ops/cuda_closed_loop.closed_loop_fueling`` / ``closed_loop_torax``).

In float64 on the CPU the port's fueling shot (3000 ticks) and campaign (8
episodes x 220 ticks, fed JAX's draws) are within 1e-9 of JAX and meet the
gates of ``tests/test_cad_fueling_torax.py:111-139``.  The campaign's
batched plain loop (the kernel's plain twin, one ``vmap`` over episodes)
equals the per-episode loop of ``torax_step`` bit for bit in float32 and
float64, which is the CPU reference of the kernel's per-CTA offsets.  The
argument block of kinds 2 and 3 points every field where the kernel reads
it, and the entry points raise without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.control import fueling_torax as jft
from scpn_fusion_tpu_torch.control import fueling_torax as tft
from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
from scpn_fusion_tpu_torch.scpn import controller as tc

TOL = 1e-9
F64 = torch.float64


def jax_campaign_draws(seed: int, episodes: int, steps: int):
    """The campaign's draws as JAX makes them (``fueling_torax.py:165-184``):
    each episode's amplitude (E,) and the two normals of each tick (E, steps, 2)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), episodes)

    def episode(ep_key):
        amp = 0.25 + 0.5 * jax.random.uniform(ep_key)
        ticks = jax.random.split(jax.random.fold_in(ep_key, 1), steps)
        n1 = jax.vmap(jax.random.normal)(ticks)
        n2 = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1)))(ticks)
        return amp, jnp.stack([n1, n2], axis=-1)

    amps, noise = jax.vmap(episode)(keys)
    return torch.from_numpy(np.array(amps)), torch.from_numpy(np.array(noise))


def test_fueling_matches_jax_and_meets_its_gates():
    ref = jft.run_fueling_mode(steps=3000, dtype=jnp.float64)
    ours = tft.run_fueling_mode(steps=3000, dtype=F64, device="cpu")
    for field in ref._fields:
        assert rel(getattr(ours, field), getattr(ref, field)) <= TOL, field
    assert float(ours.final_abs_error) < 0.02
    assert float(ours.rmse) < 0.2
    assert float(ours.command_trace.abs().max()) <= 2.0
    d = as_np(ours.density_trace)
    assert np.all(d >= 0.0) and np.all(np.isfinite(d))


@pytest.mark.parametrize("target", [1.2, 0.8])
def test_fueling_other_targets(target):
    ref = jft.run_fueling_mode(target_density=target, steps=600, dtype=jnp.float64)
    ours = tft.run_fueling_mode(target_density=target, steps=600, dtype=F64, device="cpu")
    assert rel(ours.density_trace, ref.density_trace) <= TOL
    assert rel(ours.command_trace, ref.command_trace) <= TOL


def test_campaign_matches_jax_with_its_draws_and_meets_its_gates():
    amps, noise = jax_campaign_draws(42, 8, 220)
    ref = jft.run_torax_hybrid_campaign(seed=42, episodes=8, steps=220, dtype=jnp.float64)
    ours = tft._run_torax_hybrid_campaign(amps, noise, steps=220)
    for field in ("beta_n_final", "q95_final", "beta_rmse", "risk_peak"):
        assert rel(getattr(ours, field), getattr(ref, field)) <= TOL, field
    assert np.array_equal(np.asarray(ours.within_limits), np.asarray(ref.within_limits))
    assert bool(ours.within_limits.all())
    assert float(ours.beta_rmse.max()) < 0.4
    assert float((ours.beta_n_final - 1.85).abs().max()) < 0.3
    assert bool(torch.isfinite(ours.risk_peak).all())


def test_public_campaign_draws_from_a_generator():
    a = tft.run_torax_hybrid_campaign(episodes=4, steps=60, dtype=F64, device="cpu")
    b = tft.run_torax_hybrid_campaign(episodes=4, steps=60, dtype=F64, device="cpu",
                                      generator=torch.Generator().manual_seed(42))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bool(a.within_limits.all())


def test_risk_signal_matches_jax():
    for args in ((1.85, 4.9, 0.95, 0.0), (2.3, 4.0, 1.4, 0.8)):
        ours = tft._risk_signal(*(torch.tensor(v, dtype=F64) for v in args))
        assert float(ours) == pytest.approx(float(jft._risk_signal(*args)), rel=1e-15)
    assert float(tft._risk_signal(*(torch.tensor(v, dtype=F64) for v in (2.3, 4.0, 1.4, 0.8)))) \
        > float(tft._risk_signal(*(torch.tensor(v, dtype=F64) for v in (1.85, 4.9, 0.95, 0.0))))


def _episode_loop(ctrl, cfg, plant0, d, noise):
    """The per-episode tick loop of ``torax_step`` that the batched plain
    loop (and the kernel's CTAs) replace."""
    finals, traces = [], []
    for e in range(d.shape[0]):
        carry = (*(p[e] for p in plant0), tc.initial_controller_state(ctrl, cfg))
        rows = []
        for k in range(d.shape[1]):
            carry, row = tft.torax_step(ctrl, cfg, carry, k, d[e, k], noise[e, k])
            rows.append(row)
        finals.append(torch.stack(carry[:4]))
        traces.append([torch.stack(col) for col in zip(*rows)])
    return torch.stack(finals), [torch.stack(col) for col in zip(*traces)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_plain_loop_equals_the_episode_loop(dtype):
    gen = torch.Generator().manual_seed(3)
    episodes, steps = 3, 40
    amps = (0.25 + 0.5 * torch.rand(episodes, generator=gen, dtype=F64)).to(dtype)
    noise = torch.randn((episodes, steps, 2), generator=gen, dtype=F64).to(dtype)
    ctrl = tft._build_axis_controller(5000.0, dtype, "cpu")
    cfg = tc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    plant0 = tuple(torch.full((episodes,), v, dtype=dtype) for v in (1.7, 5.1, 0.95, 140.0))
    d = tft.torax_disturbance(amps, steps)
    cs, final, trace = ccl.closed_loop_torax(ctrl, cfg, plant0, d, noise)
    final_e, (beta, q95, risk, actions, firing) = _episode_loop(ctrl, cfg, plant0, d, noise)
    assert torch.equal(final, final_e)
    for key, ref in zip(("beta_n", "q95", "risk", "actions", "firing"),
                        (beta, q95, risk, actions, firing)):
        assert torch.equal(trace[key], ref), key
    assert cs.marking.shape == (episodes, 5) and trace["firing"].shape == (episodes, steps, 4)


def test_fueling_plain_loop_is_the_wrapper_on_the_cpu():
    ctrl = tft._build_axis_controller(5000.0, F64, "cpu")
    cfg = tc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    plant = ccl.FuelingPlant(target=1.0, density0=0.82, dt=1e-3)
    a = ccl.closed_loop_fueling(ctrl, cfg, plant, n_ticks=50)
    b = ccl.closed_loop_fueling_plain(ctrl, cfg, plant, n_ticks=50)
    assert all(torch.equal(a[2][k], b[2][k]) for k in b[2])
    assert a[1].shape == (2,) and a[2]["error"].shape == (50,)


def test_argument_blocks_of_the_new_kinds():
    """Kind 2 launches one CTA with (density, integral) as its plant; kind 3
    one CTA an episode with every output (E, ...) and the disturbance and
    noise pointers set."""
    ctrl = tft._build_axis_controller(5000.0, F64, "cpu")
    cfg = tc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    plant0 = (torch.tensor(0.82, dtype=F64), torch.tensor(0.0, dtype=F64))
    args, state, trace, threads = ccl.launch_args(ctrl, cfg, plant0, n_ticks=9, dt=1e-3, kind=2,
                                                  target=1.0, baseline=1.15)
    assert (args.plant_kind, args.n_shots, args.target, args.baseline) == (2, 1, 1.0, 1.15)
    assert args.trace_c == trace["c"].data_ptr() and trace["c"].shape == (9,)
    assert state[4].tolist() == [0.82, 0.0] and args.lin_d is None and args.noise is None
    # the kernel writes its final state into fresh tensors, never into the controller's
    assert all(t.data_ptr() != u.data_ptr() for t in state for u in ctrl)

    episodes = 5
    plant0 = tuple(torch.full((episodes,), v, dtype=F64) for v in (1.7, 5.1, 0.95, 140.0))
    inputs = {"d": torch.zeros((episodes, 9), dtype=F64),
              "noise": torch.zeros((episodes, 9, 2), dtype=F64)}
    args, state, trace, threads = ccl.launch_args(ctrl, cfg, plant0, n_ticks=9, dt=0.0, kind=3,
                                                  inputs=inputs)
    assert (args.plant_kind, args.n_shots, threads) == (3, episodes, 32)
    assert [tuple(t.shape) for t in state] == [(episodes, 5), (episodes, 1, 4), (episodes,),
                                               (episodes, 1), (episodes, 4)]
    assert state[4][2].tolist() == [1.7, 5.1, 0.95, 140.0]
    assert all(t.data_ptr() != u.data_ptr() for t in state for u in (*ctrl, *plant0))
    assert trace["actions"].shape == (episodes, 9, 1) and trace["c"].shape == (episodes, 9)
    assert args.lin_d == inputs["d"].data_ptr() and args.noise == inputs["noise"].data_ptr()
    with pytest.raises(ValueError, match="CUDA"):
        ccl.check_closed_loop(ctrl, cfg, plant0, 9, kind=3, inputs=inputs)
    with pytest.raises(ValueError, match="episodes"):
        ccl.check_closed_loop(ctrl, cfg, plant0, 8, kind=3, inputs=inputs)


def test_entry_points_default_to_the_card():
    calls = (lambda: tft.run_fueling_mode(steps=4),
             lambda: tft.run_torax_hybrid_campaign(episodes=2, steps=4))
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
