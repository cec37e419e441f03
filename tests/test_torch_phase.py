"""Port parity: phase dynamics (``models/phase/{kuramoto, upde, guard, knm}``)
and row U's plain twin (``ops/cuda_phase``).

Inputs are made with numpy from a seed and handed to the JAX package and the
port in float64 on the CPU.  The port's every sum over oscillators is the
halving tree row U takes (``upde.tree_sum``), JAX's XLA's own order, so the
trajectories agree to rounding: phases within 1e-12 of max |theta| over the
whole trace (200 ticks at 4 x 16, both psi modes, a mask with holes, PAC
gating), order parameters and V within 1e-12; the guard's verdicts and
violation counts EQUAL.  The Knm builders are NumPy on both sides (equal);
the adaptive update within 1e-14.  Row U's argument block lists the C struct
field for field; its checks refuse CPU tensors and gradients.  Every entry
point of Python numbers defaults to the card and raises here.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import c_struct_fields, ctypes_fields, rel, to_torch

from scpn_fusion_tpu.models.phase import guard as jg
from scpn_fusion_tpu.models.phase import knm as jk
from scpn_fusion_tpu.models.phase import kuramoto as jku
from scpn_fusion_tpu.models.phase import monitor as jm
from scpn_fusion_tpu.models.phase import upde as ju
from scpn_fusion_tpu_torch.models.phase import guard as tg
from scpn_fusion_tpu_torch.models.phase import knm as tk
from scpn_fusion_tpu_torch.models.phase import kuramoto as tku
from scpn_fusion_tpu_torch.models.phase import monitor as tm
from scpn_fusion_tpu_torch.models.phase import upde as tu
from scpn_fusion_tpu_torch.ops import cuda_phase as cp

F64 = torch.float64
CSRC = Path(cp.__file__).resolve().parent.parent / "csrc"


def upde_inputs(seed: int, n_layers: int = 4, n: int = 16, holes: bool = True):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, (n_layers, n))
    omega = rng.normal(size=(n_layers, n))
    mask = np.ones((n_layers, n))
    if holes:
        mask[1, n - 5:] = 0.0
        theta[1, n - 5:] = 0.0
    k = np.abs(rng.normal(size=(n_layers, n_layers)))
    alpha = 0.2 * rng.normal(size=(n_layers, n_layers))
    zeta = np.abs(rng.normal(size=n_layers))
    return theta, omega, mask, k, alpha, zeta


# ── Kuramoto ──


def test_order_parameter_and_lyapunov_match_jax():
    rng = np.random.default_rng(0)
    theta, w = rng.uniform(-np.pi, np.pi, 37), rng.uniform(0.0, 1.0, 37)
    for ours, ref in ((tku.order_parameter(to_torch(theta)), jku.order_parameter(theta)),
                      (tku.order_parameter(to_torch(theta), to_torch(w)),
                       jku.order_parameter(jnp.asarray(theta), jnp.asarray(w)))):
        for a, b in zip(ours, ref):
            assert rel(a, b) <= 1e-14
    assert rel(tku.lyapunov_v(to_torch(theta), 0.3), jku.lyapunov_v(theta, 0.3)) <= 1e-14
    v = [1.0, 0.5, 0.25, 0.125]
    assert rel(tku.lyapunov_exponent(v, 0.1), jku.lyapunov_exponent(v, 0.1)) <= 1e-14


def test_wrap_phase_matches_jax_on_both_signs():
    x = np.concatenate([np.linspace(-20.0, 20.0, 401), [np.pi, -np.pi, 3 * np.pi, 0.0]])
    ours = tku.wrap_phase(to_torch(x))
    assert rel(ours, jku.wrap_phase(jnp.asarray(x))) <= 1e-15
    assert bool((ours > -np.pi - 1e-12).all()) and bool((ours <= np.pi + 1e-12).all())


@pytest.mark.parametrize("mode, k, sigma, steps", [("mean_field", 2.0, 0.1, 300),
                                                   ("external", 0.5, 1.0, 200)])
def test_run_kuramoto_matches_jax(mode, k, sigma, steps):
    rng = np.random.default_rng(1)
    theta0 = rng.uniform(-np.pi, np.pi, 64)
    omega = sigma * rng.normal(size=64)
    kw = dict(dt=0.01, k_coupling=k, zeta=0.3, psi_external=1.0, psi_mode=mode, n_steps=steps)
    ref = jku.run_kuramoto(jnp.asarray(theta0), jnp.asarray(omega), **kw)
    ours = tku.run_kuramoto(to_torch(theta0), to_torch(omega), device="cpu", **kw)
    assert float(np.max(np.abs(ours.theta.numpy() - np.asarray(ref.theta)))) <= 1e-12 * np.pi
    for name in ("r", "v", "lambda_exp"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= 1e-12, name


def test_kuramoto_step_matches_jax():
    rng = np.random.default_rng(2)
    theta, omega = rng.uniform(-np.pi, np.pi, 20), rng.normal(size=20)
    kw = dict(dt=0.05, k_coupling=1.3, alpha=0.2, zeta=0.4, psi=0.7)
    t1, aux = tku.kuramoto_step(to_torch(theta), to_torch(omega), **kw)
    r1, raux = jku.kuramoto_step(jnp.asarray(theta), jnp.asarray(omega), **kw)
    assert rel(t1, r1) <= 1e-14
    for key in ("R", "psi_r", "dtheta"):
        assert rel(aux[key], raux[key]) <= 1e-14, key


# ── UPDE and row U's twin ──


def test_tree_sum_pads_and_halves():
    x = torch.arange(1.0, 14.0, dtype=F64).reshape(1, 13)
    assert float(tu.tree_sum(x)[0]) == 91.0
    # the halving order: ((a0 + a2) + (a1 + a3)) for four values
    a = torch.tensor([1.0, 1e16, 1.0, -1e16], dtype=F64)
    assert float(tu.tree_sum(a)) == float((a[0] + a[2]) + (a[1] + a[3]))


def test_order_parameters_and_tick_match_jax():
    th, om, mask, k, al, ze = upde_inputs(3)
    t = [to_torch(a) for a in (th, om, mask, k, al, ze)]
    for ours, ref in ((tu.layer_order_parameters(t[0], t[2]), ju.layer_order_parameters(th, mask)),
                      (tu.global_order_parameter(t[0], t[2]),
                       ju.global_order_parameter(th, mask))):
        for a, b in zip(ours, ref):
            assert rel(a, b) <= 1e-14
    kw = dict(dt=0.01, psi_global=0.4, actuation_gain=1.2, pac_gamma=0.8)
    t1, aux = tu.upde_tick(*t, **kw)
    r1, raux = ju.upde_tick(*(jnp.asarray(a) for a in (th, om, mask, k, al, ze)), **kw)
    assert rel(t1, r1) <= 1e-14
    for key in raux:
        assert rel(aux[key], raux[key]) <= 1e-13, key


@pytest.mark.parametrize("mode", ["external", "mean_field"])
def test_row_u_twin_matches_run_upde(mode):
    """Row U's plain twin (the CPU route of ``run_upde``) at 4 x 16 x 200."""
    arrays = upde_inputs(4)
    kw = dict(dt=0.02, psi_external=0.5, psi_mode=mode, actuation_gain=1.1, pac_gamma=0.6,
              n_steps=200)
    ref = ju.run_upde(*(jnp.asarray(a) for a in arrays), **kw)
    ours = tu.run_upde(*(to_torch(a) for a in arrays), **kw)
    assert float(np.max(np.abs(ours.theta.numpy() - np.asarray(ref.theta)))) \
        <= 1e-12 * float(np.max(np.abs(np.asarray(ref.theta))))
    for name in ("r_layer", "r_global", "v_layer", "v_global", "lambda_exp"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= 1e-12, name
    twin = cp.upde_run_plain(*(to_torch(a) for a in arrays), **kw)
    assert all(torch.equal(a, b) for a, b in zip(twin, ours[:5]))


def monitor_pair(n_layers: int, n_per: int, seed: int):
    spec_j = jk.KnmSpec(k=0.8 * np.ones((n_layers, n_layers)) + 0.4 * np.eye(n_layers))
    spec_t = tk.KnmSpec(k=0.8 * np.ones((n_layers, n_layers)) + 0.4 * np.eye(n_layers))
    js, ja = jm.init_monitor(spec_j, n_per=n_per, seed=seed, dtype=jnp.float64)
    ts, ta = tm.init_monitor(spec_t, n_per=n_per, seed=seed, dtype=F64, device="cpu")
    return (js, ja), (ts, ta)


@pytest.mark.parametrize("psi, window, threshold, violations", [
    (0.0, 50, 0.0, 3), (float(np.pi), 20, -10.0, 1), (0.4, 7, 0.5, 2)])
def test_row_u_twin_matches_run_monitor(psi, window, threshold, violations):
    """The monitored run at 4 x 16 x 200, the guard's window shorter than the
    initial ring in two cases (as ``tests/test_phase_monitor.py`` runs it)."""
    (js, ja), (ts, ta) = monitor_pair(4, 16, 5)
    jcfg = jm.MonitorConfig(psi_driver=psi, pac_gamma=0.3, guard=jg.GuardConfig(
        window=window, lambda_threshold=threshold, max_violations=violations))
    tcfg = tm.MonitorConfig(psi_driver=psi, pac_gamma=0.3, guard=tg.GuardConfig(
        window=window, lambda_threshold=threshold, max_violations=violations))
    jf, jt = jm.run_monitor(js, ja, cfg=jcfg, n_ticks=200)
    tf, tt = tm.run_monitor(ts, ta, cfg=tcfg, n_ticks=200)
    assert float(np.max(np.abs(tf.theta.numpy() - np.asarray(jf.theta)))) <= 1e-12 * np.pi
    for name in ("r_global", "r_layer", "v_global", "v_layer", "lambda_exp"):
        assert rel(getattr(tt, name), getattr(jt, name)) <= 1e-12, name
    assert np.array_equal(tt.guard_approved.numpy(), np.asarray(jt.guard_approved))
    assert np.array_equal(tt.guard_violations.numpy(), np.asarray(jt.guard_violations))
    assert tt.guard_violations.dtype == torch.int32 and tt.guard_approved.dtype == torch.bool
    assert rel(tf.guard.v_buffer, jf.guard.v_buffer) <= 1e-12
    assert (int(tf.guard.n_seen), int(tf.guard.consecutive), int(tf.tick)) == (
        int(jf.guard.n_seen), int(jf.guard.consecutive), int(jf.tick))


def test_row_u_argument_block_and_checks():
    src = (CSRC / "phase.cu").read_text()
    assert c_struct_fields(src, "PhaseArgs") == ctypes_fields(cp._Args)
    assert cp.pow2(50) == 64 and cp.pow2(1) == 1 and cp.threads_for(8, 64) == 512
    assert cp.threads_for(40, 64) == 1024 and cp.threads_for(8, 64, 384) == 384
    assert cp.tick_stages(8, 64) == 24
    x = torch.zeros(4, 16, dtype=F64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cp._check("upde_run", {"theta0": x}, F64)
    with pytest.raises(TypeError, match="float32 or float64"):
        cp._check("upde_run", {"theta0": x.half()}, torch.float16)
    with pytest.raises(ValueError, match="unknown psi mode"):
        tu.run_upde(*(x, x, x, x[:, :4], x[:, :4], x[:, 0]), dt=0.1, psi_mode="bogus",
                    n_steps=2)


# ── Guard ──


def test_guard_sequence_matches_jax():
    jcfg, tcfg = jg.GuardConfig(window=6, dt=0.1, max_violations=2), \
        tg.GuardConfig(window=6, dt=0.1, max_violations=2)
    js, ts = jg.init_guard(jcfg, jnp.float64), tg.init_guard(tcfg, F64, "cpu")
    rng = np.random.default_rng(6)
    for k in range(15):
        theta = rng.uniform(-1.0, 1.0, 16) * (1.3 ** (k % 7))
        jv, js = jg.guard_check(jcfg, js, jnp.asarray(theta), 0.2)
        tv, ts = tg.guard_check(tcfg, ts, to_torch(theta), 0.2)
        assert rel(tv.lambda_exp, jv.lambda_exp) <= 1e-13
        assert bool(tv.approved) == bool(jv.approved)
        assert int(tv.consecutive_violations) == int(jv.consecutive_violations)
        assert rel(tv.score, jv.score) <= 1e-13
    assert rel(ts.v_buffer, js.v_buffer) <= 1e-14


def test_guard_trajectory_matches_jax():
    for v in ([1.0, 0.5, 0.2, 0.1], [0.1, 0.2, 0.5, 1.0], [0.3]):
        ours = tg.guard_check_trajectory(tg.GuardConfig(dt=0.1), v)
        ref = jg.guard_check_trajectory(jg.GuardConfig(dt=0.1), v)
        assert bool(ours.approved) == bool(ref.approved)
        assert rel(ours.lambda_exp, ref.lambda_exp) <= 1e-14
        assert int(ours.consecutive_violations) == int(ref.consecutive_violations)


# ── Knm ──


@pytest.mark.parametrize("mode", ["baseline", "elm", "ntm", "sawtooth", "hybrid"])
def test_knm_builders_equal_jax(mode):
    for n_layers in (4, 8, 16):
        a = tk.build_knm_plasma(mode, n_layers=n_layers, zeta_uniform=0.2)
        b = jk.build_knm_plasma(mode, n_layers=n_layers, zeta_uniform=0.2)
        assert np.array_equal(a.k, b.k) and np.array_equal(a.zeta, b.zeta)
        assert a.layer_names == b.layer_names
    c = tk.build_knm_plasma_from_config(6.2, 2.0, 5.3, 15.0, 12.0, mode=mode)
    d = jk.build_knm_plasma_from_config(6.2, 2.0, 5.3, 15.0, 12.0, mode=mode)
    assert np.array_equal(c.k, d.k)
    assert np.array_equal(tk.plasma_omega(16), jk.plasma_omega(16))
    k, alpha, zeta = c.arrays(F64, "cpu")
    assert np.array_equal(k.numpy(), np.asarray(d.arrays(jnp.float64)[0]))
    assert not alpha.any() and not zeta.any()
    with pytest.raises(ValueError):
        tk.KnmSpec(k=np.zeros((3, 2)))


@pytest.mark.parametrize("approved", [True, False])
def test_adaptive_knm_update_matches_jax(approved):
    spec_t, spec_j = tk.build_knm_plasma(), jk.build_knm_plasma()
    cfg_t, cfg_j = tk.AdaptiveKnmConfig(), jk.AdaptiveKnmConfig()
    st, sj = tk.init_adaptive_state(spec_t, F64, "cpu"), jk.init_adaptive_state(spec_j,
                                                                               jnp.float64)
    base_t, base_j = st.k_current.clone(), sj.k_current
    rng = np.random.default_rng(7)
    for tick in range(4):
        r = rng.uniform(0.0, 1.0, 8)
        ok = approved or tick < 2
        st = tk.adaptive_knm_update(cfg_t, base_t, st, r_layer=to_torch(r), beta_n=2.0 + tick,
                                    disruption_risk=0.3 * tick, guard_approved=ok)
        sj = jk.adaptive_knm_update(cfg_j, base_j, sj, r_layer=jnp.asarray(r), beta_n=2.0 + tick,
                                    disruption_risk=0.3 * tick, guard_approved=ok)
        for a, b in zip(st, sj):
            assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= 1e-14


def test_entry_points_default_to_cuda():
    spec = tk.build_knm_plasma()
    for run in (lambda: tku.run_kuramoto(np.zeros(4), np.zeros(4), dt=0.1, k_coupling=1.0,
                                         n_steps=2),
                lambda: tg.init_guard(tg.GuardConfig()),
                lambda: spec.arrays(),
                lambda: tk.init_adaptive_state(spec),
                lambda: tm.init_monitor(spec, n_per=4)):
        with pytest.raises((RuntimeError, AssertionError)):
            run()


def test_monitor_init_equals_jax():
    """The monitor's initial state is NumPy-drawn on both sides: equal."""
    (js, ja), (ts, ta) = monitor_pair(8, 50, 42)
    assert np.array_equal(ts.theta.numpy(), np.asarray(js.theta))
    for key in ja:
        assert np.array_equal(ta[key].numpy(), np.asarray(ja[key])), key
