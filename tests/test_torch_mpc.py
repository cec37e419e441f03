"""Port parity: gradient-through-rollout MPC (``control/mpc.py``).

The planner is Adam (optax's formula, written out in the port) on the exact
gradient of the rollout cost: JAX takes ``jax.grad``, the port
``torch.autograd.grad`` through its Python rollout.  In float64: the
unstable linear plant of ``tests/test_mpc_disruption.py`` (horizon 15, 100
iterations, bounds +-2) and the MPC lane of
``validation/run_controller_comparison.py:165-183`` (the nominal model of
the vertically unstable R/Z plant, horizon 12, 12 iterations, lr 0.3);
``u_traj``, the predicted states and the cost within 1e-9, and a 20-step
receding-horizon closed loop on the same plant within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.control import mpc as jm
from scpn_fusion_tpu_torch.control import mpc as tm

TOL = 1e-9
A, B = np.asarray([[0.0, 1.0], [0.5, 0.0]]), np.asarray([[0.0], [1.0]])
# validation/run_controller_comparison.py's plant constants
DT, DRIFT_R, GAMMA_Z, Z_TARGET, U_MAX = 1e-3, 0.03, 5.0, 0.0, 2.0


def _linear(xp):
    a, b = (jnp.asarray(A), jnp.asarray(B)) if xp is jnp else (torch.tensor(A), torch.tensor(B))
    return lambda x, u: a @ x + b @ u


def _nominal(xp):
    stack = jnp.asarray if xp is jnp else torch.stack

    def f(x, u):
        return stack([DRIFT_R + u[0], GAMMA_Z * (x[1] - Z_TARGET) + u[1]])
    return f


def _true_plant(xp):
    stack = jnp.asarray if xp is jnp else torch.stack

    def f(x, u):
        u = xp.clip(u, -U_MAX, U_MAX) if xp is jnp else torch.clamp(u, -U_MAX, U_MAX)
        return stack([DRIFT_R + u[0], GAMMA_Z * (x[1] - Z_TARGET) + 1.1 * u[1]])
    return f


def _close(ours, ref, what):
    a, b = as_np(ours), np.asarray(ref, np.float64)
    assert a.shape == b.shape, what
    assert float(np.max(np.abs(a - b))) <= TOL * max(float(np.max(np.abs(b))), 1.0), what


CASES = {
    "linear": (_linear, dict(horizon=15, dt=0.1, iterations=100, u_min=-2.0, u_max=2.0),
               [1.0, 0.0], [0.0, 0.0], 1),
    "rz_lane": (_nominal, dict(horizon=12, dt=DT, iterations=12, learning_rate=0.3,
                               l2_reg=1e-3, u_min=-U_MAX, u_max=U_MAX),
                [6.5, 0.1], [6.2, 0.0], 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_jax(name):
    dyn, cfg_kw, x0, target, nu = CASES[name]
    x0, target = np.asarray(x0), np.asarray(target)
    u0 = 0.1 * np.ones((cfg_kw["horizon"], nu))
    ref = jm.plan(dyn(jnp), jm.MPCConfig(**cfg_kw), jnp.asarray(x0), jnp.asarray(target),
                  jnp.asarray(u0))
    ours = tm.plan(dyn(torch), tm.MPCConfig(**cfg_kw), torch.tensor(x0), torch.tensor(target),
                   torch.tensor(u0))
    for field in ref._fields:
        _close(getattr(ours, field), getattr(ref, field), field)
    free = tm.rollout(dyn(torch), torch.tensor(x0), torch.zeros_like(torch.tensor(u0)),
                      cfg_kw["dt"])
    _close(free, jm.rollout(dyn(jnp), jnp.asarray(x0), jnp.zeros(u0.shape), cfg_kw["dt"]),
           "rollout")


def test_adam_is_optax():
    g = np.random.default_rng(2)
    p = g.standard_normal(5)
    opt = optax.adam(0.05)
    state = opt.init(jnp.asarray(p))
    mu = nu = torch.zeros(5, dtype=torch.float64)
    count, ours = 0, torch.tensor(p)
    ref = jnp.asarray(p)
    for _ in range(30):
        grad = g.standard_normal(5)
        upd, state = opt.update(jnp.asarray(grad), state, ref)
        ref = optax.apply_updates(ref, upd)
        step, mu, nu, count = tm._adam_update(torch.tensor(grad), mu, nu, count, 0.05)
        ours = ours + step
    assert float(np.max(np.abs(ours.numpy() - np.asarray(ref)))) <= 1e-14


def test_closed_loop_matches_jax():
    cfg_kw = CASES["rz_lane"][1]
    x0, target = np.asarray([6.5, 0.1]), np.asarray([6.2, 0.0])
    ref = jm.mpc_closed_loop(_nominal(jnp), _true_plant(jnp), jm.MPCConfig(**cfg_kw),
                             jnp.asarray(x0), jnp.asarray(target), 20)
    ours = tm.mpc_closed_loop(_nominal(torch), _true_plant(torch), tm.MPCConfig(**cfg_kw),
                              torch.tensor(x0), torch.tensor(target), 20)
    for a, b, what in zip(ours, ref, ("states", "actions")):
        _close(a, b, what)
