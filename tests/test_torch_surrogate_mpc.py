"""Port parity: learned-dynamics MPC (``control/surrogate_mpc.py``).

JAX fixes this lane in float32 (``learn_dynamics`` casts the normalised
data to float32 and trains a float32 MLP; the planner's controls are
float32), so the lane is held at 1e-5 relative: float32 rounding of sums
taken in another order, not a defect.  The draws rule: JAX's initial
weights and minibatch indices go to ``_learn_dynamics``.  The data's
normalisation is float64 in both and held at 1e-12; the model's one-step
map and ``one_step_error`` on the same weights (float64 states through
float32 weights, promoted as JAX promotes) at 1e-9; a plan and a short
surrogate-in-the-loop run at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import mpc as jmpc
from scpn_fusion_tpu.control import surrogate_mpc as js
from scpn_fusion_tpu.models.surrogates import mlp as jm
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import mpc as tmpc
from scpn_fusion_tpu_torch.control import surrogate_mpc as ts

DT = 0.05
A = np.asarray([[-0.5, 0.1], [0.0, 0.4]])
B = np.asarray([[1.0, 0.0], [0.0, 1.5]])


def _rollouts(n=16, t=12, seed=0):
    """The JAX test's damped 2-state plant, logged under random controls."""
    rng = np.random.default_rng(seed)
    xs = np.empty((n, t + 1, 2))
    us = rng.uniform(-1.0, 1.0, (n, t, 2))
    for i in range(n):
        x = rng.uniform(-1.0, 1.0, 2)
        xs[i, 0] = x
        for k in range(t):
            x = x + DT * (A @ x + B @ us[i, k])
            xs[i, k + 1] = x
    return xs, us


@pytest.fixture(scope="module")
def models():
    xs, us = _rollouts()
    key = jax.random.PRNGKey(0)
    n_steps, hidden = 60, (16, 16)
    ref = js.learn_dynamics(jnp.asarray(xs), jnp.asarray(us), key, hidden=hidden, n_steps=n_steps)
    rows = xs.shape[0] * us.shape[1]
    fit = jax.random.fold_in(key, 1)
    idx = jax.vmap(lambda k: jax.random.randint(jax.random.fold_in(fit, k), (min(512, rows),),
                                                0, rows))(jnp.arange(n_steps))
    p0 = interop.mlp_params(jm.init_mlp(key, (4, *hidden, 2)), device="cpu")
    ours = ts._learn_dynamics(torch.from_numpy(xs), torch.from_numpy(us), p0,
                              torch.from_numpy(np.array(idx)).long())
    return ref, ours, xs, us


def test_normalisation_matches_jax():
    xs, us = _rollouts()
    xn, dn, x_mean, x_std, d_mean, d_std = ts.dynamics_dataset(torch.from_numpy(xs),
                                                               torch.from_numpy(us))
    x_in = np.concatenate([xs[:, :-1].reshape(-1, 2), us.reshape(-1, 2)], axis=1)
    d_out = (xs[:, 1:] - xs[:, :-1]).reshape(-1, 2)
    assert rel(x_mean, jnp.mean(x_in, axis=0)) <= 1e-12
    assert rel(x_std, jnp.maximum(jnp.std(x_in, axis=0), 1e-9)) <= 1e-12
    assert rel(d_std, jnp.maximum(jnp.std(d_out, axis=0), 1e-9)) <= 1e-12
    assert xn.dtype == dn.dtype == torch.float32


def test_learned_model_matches_jax(models):
    ref, ours, _, _ = models
    for a, b in zip([*ours.mlp.weights, *ours.mlp.biases], jax.tree.leaves(ref.mlp)):
        assert rel(a, b) <= 1e-5
    for f in ("x_mean", "x_std", "d_mean", "d_std"):
        assert rel(getattr(ours, f), getattr(ref, f)) <= 1e-6


def test_model_map_and_error_on_the_same_weights(models):
    ref, _, _, _ = models
    same = ts.DynamicsSurrogate(interop.mlp_params(ref.mlp, device="cpu"),
                                *(torch.from_numpy(np.array(getattr(ref, f))) for f in
                                  ("x_mean", "x_std", "d_mean", "d_std")), 2, 2)
    xs, us = _rollouts(n=6, seed=99)
    assert rel(same(torch.from_numpy(xs[:, :-1]), torch.from_numpy(us)),
                jax.vmap(jax.vmap(ref))(jnp.asarray(xs[:, :-1]), jnp.asarray(us))) <= 1e-9
    assert rel(ts.one_step_error(same, torch.from_numpy(xs), torch.from_numpy(us)),
                js.one_step_error(ref, jnp.asarray(xs), jnp.asarray(us))) <= 1e-9


def test_plan_and_closed_loop_match_jax(models):
    ref, _, _, _ = models
    same = ts.DynamicsSurrogate(interop.mlp_params(ref.mlp, device="cpu"),
                                *(torch.from_numpy(np.array(getattr(ref, f))) for f in
                                  ("x_mean", "x_std", "d_mean", "d_std")), 2, 2)
    kw = dict(horizon=5, dt=DT, iterations=10, learning_rate=0.1, u_min=-2.0, u_max=2.0)
    x0 = np.asarray([1.0, 0.8])
    p_j = js.surrogate_mpc_plan(ref, jmpc.MPCConfig(**kw), jnp.asarray(x0), jnp.zeros(2))
    p_t = ts.surrogate_mpc_plan(same, tmpc.MPCConfig(**kw), torch.from_numpy(x0),
                                torch.zeros(2, dtype=torch.float64))
    assert rel(p_t.u_traj, p_j.u_traj) <= 1e-5 and rel(p_t.x_traj, p_j.x_traj) <= 1e-5

    def j_plant(x, u):
        return jnp.asarray(A) @ x + jnp.asarray(B) @ jnp.atleast_1d(u)

    def t_plant(x, u):
        return torch.from_numpy(A) @ x + torch.from_numpy(B) @ torch.atleast_1d(u).to(x.dtype)

    xs_j, us_j = js.surrogate_mpc_closed_loop(ref, j_plant, jmpc.MPCConfig(**kw),
                                              jnp.asarray(x0), jnp.zeros(2), n_steps=3)
    xs_t, us_t = ts.surrogate_mpc_closed_loop(same, t_plant, tmpc.MPCConfig(**kw),
                                              torch.from_numpy(x0),
                                              torch.zeros(2, dtype=torch.float64), n_steps=3)
    assert rel(xs_t, xs_j) <= 1e-5 and rel(us_t, us_j) <= 1e-5


def test_learning_runs_where_the_data_lie():
    xs, us = _rollouts(n=2, t=3)
    runs = [ts.learn_dynamics(torch.from_numpy(xs), torch.from_numpy(us),
                              torch.Generator().manual_seed(1), n_steps=3) for _ in range(2)]
    assert runs[0].mlp.weights[0].device.type == "cpu"
    assert torch.equal(runs[0].mlp.weights[0], runs[1].mlp.weights[0])
