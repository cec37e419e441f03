"""SOC predator-prey sandpile + tabular soft-Q learning (port of
``scpn_fusion_tpu/control/soc_learning.py``).

The avalanche relaxation is ``max_sub_steps`` synchronous branch-free sweeps
and the Q-table is carried from step to step; where JAX runs the whole
learning simulation as one ``lax.scan``, the port runs a Python loop of
steps.  The disclosed delta of the JAX package holds: the synchronous sweep
is the parallel sandpile variant of the reference's sequential one.

The draws rule: :func:`run_soc_learning` draws each step's three numbers
(the exploration uniform, the random action, the drive-noise uniform) from a
``torch.Generator``; :func:`_run_soc_learning` takes them as tensors, so a
test can feed it JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class CoupledSandpileConfig:
    """Reactor constants (reference :22-28, :46-90)."""

    size: int = 60
    z_crit_base: float = 6.0
    flow_generation: float = 0.2
    flow_damping: float = 0.05
    shear_efficiency: float = 3.0
    max_sub_steps: int = 50
    flow_lo: float = 0.0
    flow_hi: float = 5.0
    energy_per_topple_mj: float = 0.05

    def __post_init__(self) -> None:
        if self.size < 8:
            raise ValueError("size must be >= 8.")
        if not 0.0 <= self.flow_damping < 1.0:
            raise ValueError("flow_damping must be in [0, 1).")
        if self.flow_lo >= self.flow_hi:
            raise ValueError("flow bounds must satisfy lo < hi.")


def coupled_sandpile_step(cfg: CoupledSandpileConfig, z: torch.Tensor, flow, external_shear):
    """One avalanche-relaxation step with shear-raised critical slope
    (reference ``step_physics`` :95-117).  Returns
    ``(z, flow, topples, eff_shear)``."""
    eff_shear = flow + external_shear
    z_crit = cfg.z_crit_base + cfg.shear_efficiency * eff_shear
    n_top = torch.zeros((), dtype=z.dtype, device=z.device)
    zero = torch.zeros(1, dtype=z.dtype, device=z.device)
    for _ in range(cfg.max_sub_steps):
        active = (z >= z_crit).to(z.dtype)
        z1 = z - 2.0 * active
        z1 = z1 + torch.cat([zero, active[:-1]])
        z = z1 + torch.cat([active[1:], zero])
        n_top = n_top + active.sum()
    flow = flow + n_top * cfg.flow_generation / cfg.size
    flow = torch.clamp(flow * (1.0 - cfg.flow_damping), cfg.flow_lo, cfg.flow_hi)
    return z, flow, n_top, eff_shear


@dataclasses.dataclass(frozen=True)
class SoftQConfig:
    """Tabular soft-Q learner constants (reference :30-36, :128-218)."""

    alpha: float = 0.1
    gamma: float = 0.95
    epsilon: float = 0.1
    n_states_turb: int = 5
    n_states_flow: int = 5
    n_actions: int = 3
    entropy_beta: float = 0.05

    def __post_init__(self) -> None:
        for name in ("alpha", "gamma", "epsilon"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1].")


def discretize_state(qcfg: SoftQConfig, turb, flow):
    """Map continuous (turbulence, flow) to Q-table indices."""
    s_t = torch.clamp(torch.floor(torch.log1p(torch.clamp(turb, min=0.0))),
                      max=qcfg.n_states_turb - 1).to(torch.int32)
    s_f = torch.clamp(torch.floor(torch.clamp(flow, min=0.0)),
                      max=qcfg.n_states_flow - 1).to(torch.int32)
    return s_t, s_f


def soft_q_update(qcfg: SoftQConfig, q_table, state, action, new_state, reward):
    """Entropy-regularised Q update (reference ``learn`` :192-218):
    target = R + gamma (max Q(s') + beta H(softmax Q(s')))."""
    future = q_table[new_state[0].long(), new_state[1].long()]
    max_q = future.max()
    probs = torch.softmax(future, dim=-1)
    entropy = -(probs * torch.log(probs + 1e-9)).sum()
    target = reward + qcfg.gamma * (max_q + qcfg.entropy_beta * entropy)
    i, j, a = state[0].long(), state[1].long(), action.long()
    old = q_table[i, j, a]
    q_table = q_table.clone()
    q_table[i, j, a] = old + qcfg.alpha * (target - old)
    return q_table


class SOCLearningTrace(NamedTuple):
    turbulence: torch.Tensor     # (n,) avalanche sizes
    flow: torch.Tensor
    core_temp: torch.Tensor
    shear_ctrl: torch.Tensor
    reward: torch.Tensor


class SOCDraws(NamedTuple):
    """Each step's exploration uniform (n,), random action (n,) int and
    drive-noise uniform (n,)."""

    explore_u: torch.Tensor
    random_action: torch.Tensor
    noise_u: torch.Tensor


def run_soc_learning(generator: torch.Generator, *,
                     cfg: CoupledSandpileConfig = CoupledSandpileConfig(),
                     qcfg: SoftQConfig = SoftQConfig(), n_steps: int = 2000,
                     noise_probability: float = 0.01, shear_step: float = 0.05,
                     shear_lo: float = 0.0, shear_hi: float = 1.0, dtype=torch.float32,
                     device: torch.device | str = "cuda"):
    """The SOC + Q-learning control simulation (reference
    ``run_advanced_learning_sim`` :285-409), its draws from ``generator``;
    returns ``(trace, summary, q_table)``."""
    def draw(fn, *args, **kw):
        return fn(*args, generator=generator, **kw).to(device)

    draws = SOCDraws(draw(torch.rand, (n_steps,), dtype=dtype),
                     draw(torch.randint, 0, qcfg.n_actions, (n_steps,)),
                     draw(torch.rand, (n_steps,), dtype=dtype))
    return _run_soc_learning(draws, cfg=cfg, qcfg=qcfg, noise_probability=noise_probability,
                             shear_step=shear_step, shear_lo=shear_lo, shear_hi=shear_hi,
                             dtype=dtype)


def _run_soc_learning(draws: SOCDraws, *, cfg: CoupledSandpileConfig = CoupledSandpileConfig(),
                      qcfg: SoftQConfig = SoftQConfig(), noise_probability: float = 0.01,
                      shear_step: float = 0.05, shear_lo: float = 0.0, shear_hi: float = 1.0,
                      dtype=torch.float32):
    """:func:`run_soc_learning` with every step's draws given (on the device
    the simulation runs on)."""
    dev = draws.explore_u.device

    def scalar(v=0.0):
        return torch.tensor(v, dtype=dtype, device=dev)

    z, flow, ext_shear = torch.zeros(cfg.size, dtype=dtype, device=dev), scalar(), scalar()
    turb_prev, flow_prev = scalar(), scalar()
    q_table = torch.zeros((qcfg.n_states_turb, qcfg.n_states_flow, qcfg.n_actions),
                          dtype=dtype, device=dev)
    step_t, zero_t, one_t = scalar(shear_step), scalar(), scalar(1.0)
    rows = []
    for k in range(draws.explore_u.shape[0]):
        state = discretize_state(qcfg, turb_prev, flow_prev)
        greedy = torch.argmax(q_table[state[0].long(), state[1].long()])
        explore = draws.explore_u[k] < qcfg.epsilon
        action = torch.where(explore, draws.random_action[k].to(greedy.dtype), greedy)
        ext_shear = torch.clamp(
            ext_shear + torch.where(action == 2, step_t, zero_t)
            - torch.where(action == 0, step_t, zero_t), shear_lo, shear_hi)
        drive = 1.0 + torch.where(draws.noise_u[k] < noise_probability, one_t, zero_t)
        z = z.clone()
        z[0] = z[0] + drive
        z, flow, topples, _ = coupled_sandpile_step(cfg, z, flow, ext_shear)
        core_temp = z.sum()
        reward = 0.1 * core_temp - 0.5 * topples - 2.0 * ext_shear
        new_state = discretize_state(qcfg, topples, flow)
        q_table = soft_q_update(qcfg, q_table, state, action, new_state, reward)
        rows.append((topples, flow, core_temp, ext_shear, reward))
        turb_prev, flow_prev = topples, flow
    trace = SOCLearningTrace(*(torch.stack(col) for col in zip(*rows)))
    summary = {
        "final_core_temp": trace.core_temp[-1],
        "final_flow": trace.flow[-1],
        "final_external_shear": trace.shear_ctrl[-1],
        "mean_turbulence": trace.turbulence.mean(),
        "mean_flow": trace.flow.mean(),
        "mean_core_temp": trace.core_temp.mean(),
        "max_external_shear": trace.shear_ctrl.max(),
        "total_reward": trace.reward.sum(),
        "q_table_mean": q_table.mean(),
        "q_table_max_abs": q_table.abs().max(),
    }
    return trace, summary, q_table
