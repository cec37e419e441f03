"""Port parity: the SCPN controller (``scpn/controller.py``).

A seeded net (8 places, 5 transitions, an inhibitor arc, delays 0-2) and a
seeded observation sequence go through the JAX controller step and the
port's, tick by tick in float64, on every path: hard binary, binary with a
margin, fractional, the delay ring, the sampled firing (antithetic with an
even and an odd pass count, and plain passes) and the mantissa bit flips.
Actions, the whole state and the diagnostics agree within 1e-12.  JAX draws
with threefry keys, which PyTorch cannot reproduce, so where a
configuration draws, the port's private step is fed JAX's own draws, made
here by the same ``jax.random`` calls as ``controller.py:158-184, 221-252``.
The port's public step draws from its own generator: deterministic by tick.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rng

from scpn_fusion_tpu.scpn import controller as jc
from scpn_fusion_tpu.scpn.structure import StochasticPetriNet as JNet
from scpn_fusion_tpu_torch.scpn import controller as tc
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet as TNet

TOL = 1e-12
N_TICKS = 40
PLACES = ("eR+", "eR-", "eZ+", "eZ-", "cR+", "cR-", "cZ+", "cZ-")


def _net(cls, seed=5):
    """The R/Z net of ``validation/run_control_latency.py`` with seeded
    thresholds and weights, a cross arc, an inhibitor arc and delays."""
    g = rng(seed)
    net = cls()
    for p in PLACES:
        net.add_place(p, float(g.uniform(0.0, 0.3)))
    for i, (t, src, dst) in enumerate((("tR+", "eR+", "cR+"), ("tR-", "eR-", "cR-"),
                                       ("tZ+", "eZ+", "cZ+"), ("tZ-", "eZ-", "cZ-"))):
        net.add_transition(t, threshold=float(g.uniform(0.01, 0.2)), delay_ticks=i % 3)
        net.add_arc(src, t, weight=float(g.uniform(0.5, 1.5)))
        net.add_arc(t, dst, weight=float(g.uniform(0.5, 1.0)))
    net.add_transition("tX", threshold=0.05, delay_ticks=1)
    net.add_arc("cR+", "tX", weight=0.7)
    net.add_arc("eZ-", "tX", weight=0.4, inhibitor=True)
    net.add_arc("tX", "cZ-", weight=0.9)
    return net.compile()


SPECS = dict(
    axis_targets=[6.2, 0.0], axis_scales=[0.5, 0.5],
    injections=[("eR+", 0, True, 1.0, 0.0), ("eR-", 0, False, 1.0, 0.0),
                ("eZ+", 1, True, 0.9, 0.05), ("eZ-", 1, False, 1.0, 0.0)],
    actions=[("cR+", "cR-", 0.5, 5.0, 1e4), ("cZ+", "cZ-", 0.7, 2.0, 50.0)])


def _controllers():
    ref = jc.build_controller(_net(JNet), dtype=jnp.float64, **SPECS)
    ours = tc.build_controller(_net(TNet), dtype=torch.float64, device="cpu", **SPECS)
    return ref, ours


def _obs(n=N_TICKS, seed=9):
    g = rng(seed)
    return np.stack([6.2 + 0.4 * g.standard_normal(n), 0.3 * g.standard_normal(n)], 1)


def _jax_draws(cfg, k, n_t, n_p):
    """JAX's random numbers of tick k, as its controller step draws them."""
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed_base), k)
    sample = flip_f = flip_m = None
    if tc.is_stochastic(cfg):
        n = cfg.sc_n_passes
        rows = (n + 1) // 2 if cfg.sc_antithetic and n >= 2 else n
        sample = jax.random.uniform(jax.random.fold_in(key, 1), (rows, n_t))

    def flips(sub, size):
        k1, k2 = jax.random.split(jax.random.fold_in(key, sub))
        return (torch.tensor(np.asarray(jax.random.uniform(k1, (size,)))),
                torch.tensor(np.asarray(jax.random.randint(k2, (size,), 0, 23, dtype=jnp.int32))))

    if cfg.sc_bitflip_rate > 0.0:
        flip_f, flip_m = flips(2, n_t), flips(3, n_p)
    return tc.StepDraws(None if sample is None else torch.tensor(np.asarray(sample)),
                        flip_f, flip_m)


def _same(ours, ref, what):
    a, b = as_np(ours), np.asarray(ref, np.float64)
    assert a.shape == b.shape, what
    assert float(np.max(np.abs(a - b), initial=0.0)) <= TOL * max(np.max(np.abs(b)), 1.0), what


CONFIGS = {
    "binary": dict(firing_mode="binary"),
    "binary_margin": dict(firing_mode="binary", sc_binary_margin=0.2),
    "fractional": dict(firing_mode="fractional", firing_margin=0.3),
    "delay_ring": dict(firing_mode="fractional", firing_margin=0.3, max_delay_ticks=2),
    "binary_delay": dict(firing_mode="binary", max_delay_ticks=3),
    "sampled_even": dict(firing_mode="fractional", firing_margin=0.3, sc_n_passes=8),
    "sampled_odd": dict(firing_mode="binary", sc_binary_margin=0.3, sc_n_passes=7),
    "sampled_plain": dict(firing_mode="fractional", sc_n_passes=5, sc_antithetic=False),
    "bitflip": dict(firing_mode="fractional", firing_margin=0.3, sc_bitflip_rate=0.3,
                    max_delay_ticks=1),
    "bitflip_sampled": dict(firing_mode="fractional", sc_n_passes=4, sc_bitflip_rate=0.2,
                            seed_base=7),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(name):
    cfg_kw = CONFIGS[name]
    jcfg, tcfg = jc.ControllerConfig(dt=1e-3, **cfg_kw), tc.ControllerConfig(dt=1e-3, **cfg_kw)
    ref_ctrl, ctrl = _controllers()
    js, ts = jc.initial_controller_state(ref_ctrl, jcfg), tc.initial_controller_state(ctrl, tcfg)
    n_t, n_p = ctrl.w_in.shape
    obs = _obs()
    for k in range(N_TICKS):
        js, ja, jd = jc.controller_step(ref_ctrl, jcfg, js, jnp.asarray(obs[k]), jnp.int32(k))
        draws = _jax_draws(tcfg, k, n_t, n_p)
        ts, ta, td = tc._controller_step(ctrl, tcfg, ts, torch.tensor(obs[k]), draws)
        _same(ta, ja, f"actions {k}")
        for field in js._fields:
            _same(getattr(ts, field), getattr(js, field), f"{field} {k}")
        for key in jd:
            _same(td[key], jd[key], f"{key} {k}")
    if not tc.needs_draws(tcfg):
        # the public step draws nothing here: it is the private one
        _, ref_tr = jc.run_controller(ref_ctrl, jcfg, jc.initial_controller_state(ref_ctrl, jcfg),
                                      jnp.asarray(obs))
        _, tr = tc.run_controller(ctrl, tcfg, tc.initial_controller_state(ctrl, tcfg),
                                  torch.tensor(obs))
        _same(tr, ref_tr, "run_controller")


def test_public_step_is_deterministic_by_tick():
    tcfg = tc.ControllerConfig(**CONFIGS["bitflip_sampled"])
    _, ctrl = _controllers()
    s0 = tc.initial_controller_state(ctrl, tcfg)
    obs = torch.tensor(_obs()[0])
    a = tc.controller_step(ctrl, tcfg, s0, obs, 11)
    b = tc.controller_step(ctrl, tcfg, s0, obs, 11)
    c = tc.controller_step(ctrl, tcfg, s0, obs, 12)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[2]["firing"], b[2]["firing"])
    assert not torch.equal(a[2]["firing"], c[2]["firing"])


@pytest.mark.parametrize("mode", ["binary", "fractional"])
def test_oracle_step_matches_jax(mode):
    jcfg, tcfg = jc.ControllerConfig(firing_mode=mode), tc.ControllerConfig(firing_mode=mode)
    ref_ctrl, ctrl = _controllers()
    for seed in range(3):
        m = rng(seed).uniform(0.0, 1.0, len(PLACES))
        jf, jm = jc.oracle_step(ref_ctrl, jcfg, jnp.asarray(m))
        f, m2 = tc.oracle_step(ctrl, tcfg, torch.tensor(m))
        _same(f, jf, "firing")
        _same(m2, jm, "marking")


def test_features_and_bitflip_match_jax():
    ref_ctrl, ctrl = _controllers()
    obs = _obs(4)
    for k in range(4):
        for x, y in zip(tc.extract_features(ctrl, torch.tensor(obs[k])),
                        jc.extract_features(ref_ctrl, jnp.asarray(obs[k]))):
            _same(x, y, "features")
    values = rng(1).uniform(0.0, 1.0, 64)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, values.shape)
    bits = jax.random.randint(k2, values.shape, 0, 23, dtype=jnp.int32)
    ref = jc._bitflip(jnp.asarray(values), 0.5, key)
    ours = tc._bitflip(torch.tensor(values), 0.5, torch.tensor(np.asarray(u)),
                       torch.tensor(np.asarray(bits)))
    assert np.array_equal(as_np(ours), np.asarray(ref))
    assert not np.array_equal(as_np(ours), values)


def test_build_controller_matches_jax():
    ref_ctrl, ctrl = _controllers()
    for field in ref_ctrl._fields:
        a, b = getattr(ctrl, field), np.asarray(getattr(ref_ctrl, field))
        assert str(a.numpy().dtype) == str(b.dtype), field
        assert np.array_equal(a.numpy(), b), field


def test_default_device_is_the_card():
    """With no ``device`` the controller lands on CUDA; without a card the
    build raises instead of falling back to the CPU."""
    call = lambda: tc.build_controller(_net(TNet), **SPECS)  # noqa: E731
    if torch.cuda.is_available():
        assert call().w_in.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
