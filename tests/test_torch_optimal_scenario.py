"""Port parity: shot design by gradient through the integrated shot
(``control/optimal_scenario.py``).

In float64: the objective and its gradient at the conservative start of
``tests/test_optimal_scenario.py`` (``torch.autograd`` through the 840-tick
shot against ``jax.grad``), and ``optimize_shot`` with that test's settings
(25 iterations of Adam at lr 0.6 on the normalised gradient, box
projection): the knobs within 1e-8 relative, the loss history, Q and the
feasibility verdict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from scpn_fusion_tpu.control import optimal_scenario as jo
from scpn_fusion_tpu.control import scenario as js
from scpn_fusion_tpu.models.physics.integrated_scenario import ScenarioMachine as JMachine
from scpn_fusion_tpu_torch.control import optimal_scenario as to
from scpn_fusion_tpu_torch.control import scenario as ts
from scpn_fusion_tpu_torch.models.physics.integrated_scenario import ScenarioMachine as TMachine

BUDGET = dict(phi_cs_vs=280.0, l_plasma_uh=7.0, r0_m=6.2)
K0 = (20.0, 6.0, 10.0)


def _rel(ours, ref) -> float:
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_objective_and_gradient_match_jax():
    cfg = jo.OptimizerConfig(n_iters=1)

    def j_loss(vec):
        return jo.shot_objective(jo.ShotKnobs(*vec), js.FluxBudget(**BUDGET), JMachine(), cfg)[0]

    j_val, j_grad = jax.value_and_grad(j_loss)(jnp.asarray(K0))
    vec = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    t_val, _ = to.shot_objective(to.ShotKnobs(*vec), ts.FluxBudget(**BUDGET), TMachine(),
                                 to.OptimizerConfig(n_iters=1))
    (t_grad,) = torch.autograd.grad(t_val, vec)
    assert _rel(t_val.detach(), j_val) <= 1e-10
    assert _rel(t_grad, j_grad) <= 1e-8
    assert np.all(np.asarray(j_grad) != 0.0)


def test_optimize_shot_matches_jax():
    kw = dict(n_iters=25, learning_rate=0.6)
    ref = jo.optimize_shot(jo.ShotKnobs(*[jnp.asarray(v) for v in K0]), js.FluxBudget(**BUDGET),
                           cfg=jo.OptimizerConfig(**kw))
    ours = to.optimize_shot(to.ShotKnobs(*[torch.tensor(v, dtype=torch.float64) for v in K0]),
                            ts.FluxBudget(**BUDGET), cfg=to.OptimizerConfig(**kw))
    assert _rel(torch.stack(list(ours.knobs)), np.asarray(list(ref.knobs))) <= 1e-8
    assert _rel(ours.loss_history, ref.loss_history) <= 1e-8
    assert _rel(ours.q_flattop, ref.q_flattop) <= 1e-8
    assert bool(ours.feasible) == bool(ref.feasible)
    assert float(ours.loss_history[-1]) < float(ours.loss_history[0])
