"""Port parity: the batched cross-entropy search and the two tuners
(``control/tuning.py``).

The draws rule: JAX's normals of every generation are rebuilt from its key
(``jax.random.split(key, n_generations)``, then ``(population, k)`` float32
normals a generation) and fed to the port's private functions.  Float32, as
JAX fixes it: costs, best parameters, the final mean and the cost history
within 1e-5 relative (of 1e-3 for values below it: the quadratic's best
cost is ~1e-9, the square of a miss that agrees to 1e-6).  ``cem_minimize``
on the JAX test's quadratic (64 x 25, ``tests/test_tuning.py``); an objective with exact ties, where
``jnp.argsort``'s stable order picks the elite (``torch.argsort`` is not
stable by default); ``tune_pid`` at population 8 x 2 generations on the JAX
test's 1 kHz lane; ``tune_hinf`` at 8 x 2 on its plant.  The public tuners
draw from a ``torch.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.control import flight_sim as jf
from scpn_fusion_tpu.control import tuning as jt
from scpn_fusion_tpu_torch.control import flight_sim as tf
from scpn_fusion_tpu_torch.control import tuning as tt

TOL = 1e-5
_PARAMS = dict(control_hz=1000.0, shot_duration_s=0.25)


def jax_normals(seed: int, n_gen: int, population: int, k: int) -> torch.Tensor:
    keys = jax.random.split(jax.random.PRNGKey(seed), n_gen)
    z = jax.vmap(lambda kg: jax.random.normal(kg, (population, k), dtype=jnp.float32))(keys)
    return torch.from_numpy(np.array(z))


def _close(ours, ref, tol=TOL):
    a = ours.detach().double().numpy()
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1e-3)), (a, b)


def _same(ours: tt.CEMResult, ref) -> None:
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))


def test_cem_quadratic():
    target = [2.0, 0.5]
    ref = jt.cem_minimize(lambda x: jnp.sum((x - jnp.asarray(target)) ** 2),
                          jnp.asarray([0.1, 0.01]), jnp.asarray([10.0, 5.0]),
                          jax.random.PRNGKey(0), population=64, n_generations=25,
                          min_std=0.001)
    t_target = torch.tensor(target, dtype=torch.float64)
    ours = tt._cem_minimize(lambda x: ((x - t_target) ** 2).sum(-1), [0.1, 0.01], [10.0, 5.0],
                            jax_normals(0, 25, 64, 2), min_std=0.001)
    _same(ours, ref)
    assert float(ours.best_cost) < 1e-2


def test_stable_elite_on_ties():
    """Costs with exact ties (the integer part of the first parameter): the
    elite are the first candidates of each tie, as with ``jnp.argsort``."""
    ref = jt.cem_minimize(lambda x: jnp.floor(x[0]), jnp.asarray([1.0, 1.0]),
                          jnp.asarray([4.0, 4.0]), jax.random.PRNGKey(7), population=32,
                          n_generations=3)
    ours = tt._cem_minimize(lambda x: torch.floor(x[:, 0]), [1.0, 1.0], [4.0, 4.0],
                            jax_normals(7, 3, 32, 2))
    _same(ours, ref)


def test_tune_pid():
    jparams = jf.FlightSimParams(**_PARAMS)
    ref = jt.tune_pid(jparams, jax.random.PRNGKey(2), population=8, n_generations=2)
    ours = tt._tune_pid(tf.FlightSimParams(**_PARAMS), jax_normals(2, 2, 8, 6))
    _same(ours, ref)
    default = torch.tensor([2.0, 0.1, 0.5, 5.0, 0.2, 2.0])
    base = tt.pid_shot_cost(tf.FlightSimParams(**_PARAMS), default)
    _close(base, jt.pid_shot_cost(jparams, jnp.asarray(default.numpy())))
    batch = tt.pid_shot_cost(tf.FlightSimParams(**_PARAMS), torch.stack([default, default * 2]))
    assert batch.shape == (2,) and torch.equal(batch[0], base)


def _hinf_plant():
    return [np.asarray(m, np.float64) for m in (
        [[0.0, 1.0], [-4.0, -0.2]], [[0.0], [1.0]], [[0.0], [1.0]], [[1.0, 0.0]], [[1.0, 0.0]])]


def test_tune_hinf():
    plant = _hinf_plant()
    ref = jt.tune_hinf(*(jnp.asarray(m) for m in plant), jax.random.PRNGKey(5), population=8,
                       n_generations=2)
    ours = tt._tune_hinf(*(torch.from_numpy(m) for m in plant), jax_normals(5, 2, 8, 2))
    _same(ours, ref)
    assert float(ours.best_cost) < 1e3


def test_hinf_cost_batch_is_its_rows():
    plant = [torch.from_numpy(m) for m in _hinf_plant()]
    theta = torch.tensor([[2.0, 0.3], [15.0, 2.0], [1.05, 0.06]], dtype=torch.float32)
    x0 = torch.ones(2)
    batch = tt.hinf_closed_loop_cost(*plant, theta, x0=x0, n_steps=50, riccati_steps=200)
    ref = [jt.hinf_closed_loop_cost(*(jnp.asarray(m.numpy()) for m in plant),
                                    jnp.asarray(th.numpy()), x0=jnp.ones(2, jnp.float32),
                                    n_steps=50, riccati_steps=200) for th in theta]
    assert batch.dtype == torch.float64
    _close(batch, np.array(ref), 1e-9)


def test_public_tuners_draw_from_a_generator():
    params = tf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.05)
    runs = [tt.tune_pid(params, torch.Generator().manual_seed(s), population=4,
                        n_generations=2) for s in (3, 3)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    g = torch.Generator().manual_seed(3)
    normals = torch.randn((2, 4, 6), generator=g, dtype=torch.float32)
    again = tt._tune_pid(params, normals)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
    res = tt.cem_minimize(lambda x: (x * x).sum(-1), [0.1], [10.0],
                          torch.Generator().manual_seed(1), population=16, n_generations=4)
    running = np.minimum.accumulate(res.cost_history.numpy())
    assert float(res.best_cost) <= running[-1] + 1e-7


@pytest.mark.parametrize("bounds", ["pid", "hinf"])
def test_bounds_match(bounds):
    name = bounds.upper()
    for side in ("LO", "HI"):
        ours = getattr(tt, f"{name}_BOUNDS_{side}")
        assert np.array_equal(np.asarray(ours), np.asarray(getattr(jt, f"{name}_BOUNDS_{side}")))
