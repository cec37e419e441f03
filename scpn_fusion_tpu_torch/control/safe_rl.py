"""Safe RL: shielded tokamak environment + Lagrangian PPO (port of
``scpn_fusion_tpu/control/safe_rl.py``).

The reduced 0-D plant (I_p, beta_N, q95, Z) is a pure function over an
explicit state; a batch of episodes is a leading axis of every state field
(JAX ``vmap``s one episode), and an episode's steps are a Python loop (JAX's
``lax.scan``).  The interlock shield, the Lyapunov guard, the constraint
costs, the linear-Gaussian policy and the clipped-surrogate PPO with dual
ascent are the JAX package's.

The draws rule.  JAX threads a PRNG key through the environment state; the
port's :class:`EnvState` carries none.  The public functions draw from a
``torch.Generator`` (on the CPU, then moved, so the card and the CPU see the
same numbers): :func:`env_reset` a uniform and a normal, :func:`env_step`
three normals, :func:`collect_batch` all of an iteration's
(:class:`EpisodeDraws`), :func:`train` everything.  The private twins
(:func:`_env_reset`, :func:`_env_step`, :func:`_collect_batch`,
:func:`_train`) take the draws as tensors, so a test can feed them JAX's.

Observation layout: [I_p, beta_N, q95, Z, dR_err, dZ_err].
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

OBS_DIM = 6
ACT_DIM = 3     # [dIp command, heating command, vertical coil command]

FREEZE, NONNEGATIVE, NONPOSITIVE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class TokamakEnvParams:
    dt: float = 0.05
    ip_target: float = 15.0        # MA
    beta_target: float = 2.5
    q95_coeff: float = 45.0        # q95 ~ coeff / Ip
    z_gamma: float = 2.0           # vertical growth rate [1/s]
    act_limit: float = 1.0
    # Interlock thresholds (reference SafetyLimits semantics)
    beta_n_limit: float = 3.5
    ip_limit: float = 17.0
    dz_dt_limit: float = 1.5
    halt_penalty: float = -5.0
    noise: float = 0.02


class EnvState(NamedTuple):
    ip: torch.Tensor
    beta_n: torch.Tensor
    q95: torch.Tensor
    z: torch.Tensor
    z_prev: torch.Tensor


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded once, as JAX divides (``float / tensor`` in
    PyTorch multiplies by the reciprocal)."""
    return torch.div(torch.tensor(num, dtype=den.dtype, device=den.device), den)


def _obs(s: EnvState, p: TokamakEnvParams) -> torch.Tensor:
    dr_err = (s.ip - p.ip_target) / p.ip_target
    return torch.stack([s.ip, s.beta_n, s.q95, s.z, dr_err, s.z], dim=-1)


def _env_reset(p: TokamakEnvParams, u: torch.Tensor, n: torch.Tensor):
    """:func:`env_reset` with its uniform ``u`` and normal ``n`` given."""
    ip = 10.0 + u * 4.0
    z = 0.02 * n
    s = EnvState(ip, torch.full_like(ip, 1.5), _rdiv(p.q95_coeff, ip), z, z)
    return s, _obs(s, p)


def env_reset(p: TokamakEnvParams, generator: torch.Generator, *, dtype=torch.float32,
              device: torch.device | str = "cuda"):
    u = torch.rand((), generator=generator, dtype=dtype).to(device)
    n = torch.randn((), generator=generator, dtype=dtype).to(device)
    return _env_reset(p, u, n)


def _env_step(p: TokamakEnvParams, s: EnvState, action, normals: torch.Tensor):
    """Pure plant step with its three standard normals given ->
    (state', obs', reward, terminated)."""
    a = torch.clamp(action, -p.act_limit, p.act_limit)
    noise = p.noise * normals
    ip = torch.clamp(s.ip + p.dt * (3.0 * a[..., 0] - 0.1 * (s.ip - 12.0))
                     + noise[..., 0] * 0.1, 0.1, 25.0)
    beta = torch.clamp(s.beta_n + p.dt * (2.0 * a[..., 1] - 0.5 * (s.beta_n - 1.0))
                       + noise[..., 1] * 0.05, 0.0, 6.0)
    # Vertical: unstable mode gamma with coil authority.
    z = s.z + p.dt * (p.z_gamma * s.z + 1.5 * a[..., 2]) + noise[..., 2] * 1e-3
    q95 = _rdiv(p.q95_coeff, torch.clamp(ip, min=0.1))
    s2 = EnvState(ip, beta, q95, z, s.z)
    reward = (- (ip - p.ip_target) ** 2 / 4.0
              - (beta - p.beta_target) ** 2
              - 20.0 * z**2
              - 0.05 * (a**2).sum(-1))
    terminated = (z.abs() > 0.5) | (q95 < 1.5)
    return s2, _obs(s2, p), reward, terminated


def env_step(p: TokamakEnvParams, s: EnvState, action, generator: torch.Generator):
    normals = torch.randn((*s.ip.shape, 3), generator=generator,
                          dtype=s.ip.dtype).to(s.ip.device)
    return _env_step(p, s, action, normals)


# ---------------------------------------------------------------------------
# Interlock shield + Lyapunov guard
# ---------------------------------------------------------------------------

def interlock_allowed(p: TokamakEnvParams, obs, prev_obs):
    """Branch-free channel gates from the safety state."""
    dz_dt = (obs[..., 3] - prev_obs[..., 3]) / p.dt
    return {
        "heating": obs[..., 1] < p.beta_n_limit,
        "current": obs[..., 0].abs() < p.ip_limit,
        "vertical": dz_dt.abs() < p.dz_dt_limit,
    }


def shield_action(action, allowed):
    """Clamp gated components; returns (shielded, n_trips)."""
    heat_ok, cur_ok, vert_ok = allowed["heating"], allowed["current"], allowed["vertical"]
    zero = torch.zeros_like(action[..., 0])
    a0 = torch.where(cur_ok, action[..., 0], torch.minimum(action[..., 0], zero))  # <= 0
    a1 = torch.where(heat_ok, action[..., 1], zero)                                # freeze
    a2 = torch.where(vert_ok, action[..., 2], zero)                                # freeze
    n_trips = (((~heat_ok) & (action[..., 1] != 0.0)).to(torch.int32)
               + ((~cur_ok) & (action[..., 0] > 0.0)).to(torch.int32)
               + ((~vert_ok) & (action[..., 2] != 0.0)).to(torch.int32))
    return torch.stack([a0, a1, a2], dim=-1), n_trips


def position_lyapunov_v(obs):
    """V = 2 (1 - exp(-(dR^2 + dZ^2)/2)) in [0, 2)."""
    energy = obs[..., 4] ** 2 + obs[..., 5] ** 2
    return 2.0 * (1.0 - torch.exp(-0.5 * energy))


class ShieldState(NamedTuple):
    v_buffer: torch.Tensor       # (..., window)
    n_seen: torch.Tensor
    consecutive: torch.Tensor
    clamp_events: torch.Tensor
    halted: torch.Tensor


def init_shield(window: int = 50, batch: tuple = (), *, dtype=torch.float32,
                device: torch.device | str = "cuda") -> ShieldState:
    def i32():
        return torch.zeros(batch, dtype=torch.int32, device=device)

    return ShieldState(torch.zeros((*batch, window), dtype=dtype, device=device), i32(), i32(),
                       i32(), torch.zeros(batch, dtype=torch.bool, device=device))


def guard_update(sh: ShieldState, v, *, lambda_threshold: float = 0.0,
                 max_violations: int = 3, dt: float = 0.05):
    """Sliding-window Lyapunov check (reference ``LyapunovGuard.check``)."""
    window = sh.v_buffer.shape[-1]
    buf = torch.cat([sh.v_buffer[..., 1:], v[..., None]], dim=-1)
    n_seen = sh.n_seen + 1
    n_valid = torch.clamp(n_seen, max=window)
    oldest = buf.gather(-1, (window - n_valid).long()[..., None])[..., 0]
    ratio = torch.clamp(v, min=1e-15) / torch.clamp(oldest, min=1e-15)
    lam = torch.where(n_valid < 2, torch.zeros_like(v),
                      torch.log(ratio) / (n_valid.to(buf.dtype) * dt))
    violated = (n_valid >= 2) & (lam > lambda_threshold)
    consecutive = torch.where(violated, sh.consecutive + 1, torch.zeros_like(sh.consecutive))
    approved = consecutive < max_violations
    return approved, ShieldState(buf, n_seen, consecutive, sh.clamp_events, sh.halted)


def shielded_env_step(p: TokamakEnvParams, s: EnvState, sh: ShieldState, prev_obs, action,
                      normals: torch.Tensor):
    """Shield -> plant -> guard halt (reference ``ShieldedTokamakEnv.step``),
    with the plant's three normals given."""
    obs_now = _obs(s, p)
    allowed = interlock_allowed(p, obs_now, prev_obs)
    a_shielded, n_trips = shield_action(action, allowed)
    s2, obs2, reward, terminated = _env_step(p, s, a_shielded, normals)
    v = position_lyapunov_v(obs2)
    approved, sh = guard_update(sh, v, dt=p.dt)
    halt = ~approved
    reward = torch.where(halt & ~terminated, reward + p.halt_penalty, reward)
    terminated = terminated | halt
    sh = ShieldState(sh.v_buffer, sh.n_seen, sh.consecutive, sh.clamp_events + n_trips,
                     sh.halted | halt)
    return s2, obs2, reward, terminated, sh, a_shielded


# ---------------------------------------------------------------------------
# Constraint costs
# ---------------------------------------------------------------------------

N_CONSTRAINTS = 3
CONSTRAINT_NAMES = ("q95_lower_bound", "beta_n_upper_bound", "ip_positive")
CONSTRAINT_LIMITS = (0.0, 0.0, 0.0)


def constraint_costs(obs, act, next_obs):
    """[max(0, 2 - q95), max(0, beta_N - 3.5), max(0, -I_p)]."""
    return torch.stack([
        torch.clamp(2.0 - next_obs[..., 2], min=0.0),
        torch.clamp(next_obs[..., 1] - 3.5, min=0.0),
        torch.clamp(-next_obs[..., 0], min=0.0),
    ], dim=-1)


# ---------------------------------------------------------------------------
# Linear-Gaussian policy + Lagrangian PPO
# ---------------------------------------------------------------------------

class PolicyParams(NamedTuple):
    w: torch.Tensor          # (obs, act)
    b: torch.Tensor          # (act,)
    log_std: torch.Tensor    # (act,)


def _init_policy(normals: torch.Tensor, log_std: float = -0.5) -> PolicyParams:
    """:func:`init_policy` with its (obs, act) standard normals given."""
    act_dim = normals.shape[1]
    return PolicyParams(0.01 * normals, torch.zeros_like(normals[0]),
                        torch.full((act_dim,), log_std, dtype=normals.dtype,
                                   device=normals.device))


def init_policy(generator: torch.Generator, obs_dim: int = OBS_DIM, act_dim: int = ACT_DIM,
                log_std: float = -0.5, *, dtype=torch.float32,
                device: torch.device | str = "cuda") -> PolicyParams:
    normals = torch.randn((obs_dim, act_dim), generator=generator, dtype=dtype).to(device)
    return _init_policy(normals, log_std)


def policy_mean(params: PolicyParams, obs):
    return obs @ params.w + params.b


def policy_log_prob(params: PolicyParams, obs, action):
    mu = policy_mean(params, obs)
    std = torch.exp(params.log_std)
    z = (action - mu) / std
    return (-0.5 * z**2 - params.log_std - 0.5 * math.log(2.0 * math.pi)).sum(-1)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    lambda_lr: float = 0.01
    policy_lr: float = 0.05
    clip_epsilon: float = 0.2
    n_epochs: int = 4
    batch_episodes: int = 16
    max_episode_steps: int = 100


class Rollout(NamedTuple):
    obs: torch.Tensor          # (E, T, obs)
    actions: torch.Tensor      # (E, T, act)
    log_probs: torch.Tensor    # (E, T)
    rewards: torch.Tensor      # (E, T) augmented
    costs: torch.Tensor        # (E, T, C)
    mask: torch.Tensor         # (E, T) 1 while alive
    clamp_events: torch.Tensor  # (E,)
    halted: torch.Tensor        # (E,)


class EpisodeDraws(NamedTuple):
    """The random numbers of a batch of E episodes of T steps: the reset's
    uniform and normal (E,), the plant's normals (E, T, 3) and the policy's
    exploration normals (E, T, act)."""

    reset_u: torch.Tensor
    reset_n: torch.Tensor
    plant: torch.Tensor
    action: torch.Tensor


def draw_episodes(cfg: PPOConfig, generator: torch.Generator, *, dtype=torch.float32,
                  device: torch.device | str = "cuda") -> EpisodeDraws:
    e, t = cfg.batch_episodes, cfg.max_episode_steps

    def draw(fn, *shape):
        return fn(shape, generator=generator, dtype=dtype).to(device)

    return EpisodeDraws(draw(torch.rand, e), draw(torch.randn, e),
                        draw(torch.randn, e, t, 3), draw(torch.randn, e, t, ACT_DIM))


def _collect_batch(p: TokamakEnvParams, cfg: PPOConfig, params: PolicyParams, lambdas,
                   draws: EpisodeDraws) -> Rollout:
    """:func:`collect_batch` with the batch's draws given."""
    s, obs = _env_reset(p, draws.reset_u, draws.reset_n)
    e = draws.reset_u.shape[0]
    sh = init_shield(batch=(e,), dtype=obs.dtype, device=obs.device)
    prev_obs, alive = obs, torch.ones((e,), dtype=obs.dtype, device=obs.device)
    rows = []
    for t in range(cfg.max_episode_steps):
        mu = policy_mean(params, obs)
        a = mu + torch.exp(params.log_std) * draws.action[:, t]
        logp = policy_log_prob(params, obs, a)
        s, obs2, r, term, sh, a_sh = shielded_env_step(p, s, sh, prev_obs, a, draws.plant[:, t])
        cost = constraint_costs(obs, a_sh, obs2)
        r_aug = r - (lambdas * cost).sum(-1)
        rows.append((obs, a, logp, r_aug * alive, cost * alive[:, None], alive))
        alive = alive * (1.0 - term.to(obs.dtype))
        prev_obs, obs = obs, obs2
    cols = [torch.stack(col, dim=1) for col in zip(*rows)]
    return Rollout(*cols, sh.clamp_events, sh.halted)


def collect_batch(p: TokamakEnvParams, cfg: PPOConfig, params: PolicyParams, lambdas,
                  generator: torch.Generator) -> Rollout:
    """``cfg.batch_episodes`` episodes of ``cfg.max_episode_steps`` steps as
    one batch, their draws from ``generator``."""
    draws = draw_episodes(cfg, generator, dtype=params.w.dtype, device=params.w.device)
    return _collect_batch(p, cfg, params, lambdas, draws)


def _returns_to_go(rewards, mask, gamma):
    """Discounted suffix sums along T (a reverse loop)."""
    carry = torch.zeros_like(rewards[:, 0])
    out = []
    for t in range(rewards.shape[1] - 1, -1, -1):
        carry = rewards[:, t] + gamma * carry * mask[:, t]
        out.append(carry)
    return torch.stack(out[::-1], dim=1)


def ppo_update(cfg: PPOConfig, params: PolicyParams, roll: Rollout):
    """Primal: clipped-surrogate ascent with MC advantages, n_epochs."""
    rtg = _returns_to_go(roll.rewards, roll.mask, cfg.gamma)
    total = torch.clamp(roll.mask.sum(), min=1.0)
    mean = (rtg * roll.mask).sum() / total
    var = (((rtg - mean) * roll.mask) ** 2).sum() / total
    adv = (rtg - mean) / torch.sqrt(var + 1e-8)

    def loss_fn(w, b):
        logp = policy_log_prob(PolicyParams(w, b, params.log_std), roll.obs, roll.actions)
        ratio = torch.exp(torch.clamp(logp - roll.log_probs, -20.0, 20.0))
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_epsilon, 1.0 + cfg.clip_epsilon)
        surr = torch.minimum(ratio * adv, clipped * adv) * roll.mask
        return -surr.sum() / total

    w, b = params.w.detach(), params.b.detach()
    losses = []
    for _ in range(cfg.n_epochs):
        w, b = w.requires_grad_(True), b.requires_grad_(True)
        loss = loss_fn(w, b)
        g_w, g_b = torch.autograd.grad(loss, (w, b))
        w, b = (w - cfg.policy_lr * g_w).detach(), (b - cfg.policy_lr * g_b).detach()
        losses.append(loss.detach())
    return PolicyParams(w, b, params.log_std), torch.stack(losses)


def update_lambdas(cfg: PPOConfig, lambdas, roll: Rollout):
    """Dual ascent on mean per-episode constraint costs."""
    ep_costs = roll.costs.sum(1).mean(0)   # (C,)
    limits = torch.tensor(CONSTRAINT_LIMITS, dtype=ep_costs.dtype, device=ep_costs.device)
    return torch.clamp(lambdas + cfg.lambda_lr * (ep_costs - limits), min=0.0)


def _history(it: int, roll: Rollout, lambdas) -> dict:
    return {
        "iteration": it,
        "mean_return": float((roll.rewards * roll.mask).sum(1).mean()),
        "mean_cost": [float(c) for c in roll.costs.sum(1).mean(0)],
        "lambdas": [float(v) for v in lambdas],
        "clamp_events": int(roll.clamp_events.sum()),
        "halt_rate": float(roll.halted.to(torch.float32).mean()),
    }


def _train(p: TokamakEnvParams, cfg: PPOConfig, params: PolicyParams, draws: list):
    """:func:`train` from ``params`` with each iteration's draws given."""
    lambdas = torch.zeros(N_CONSTRAINTS, dtype=params.w.dtype, device=params.w.device)
    history = []
    for it, d in enumerate(draws):
        roll = _collect_batch(p, cfg, params, lambdas, d)
        params, _ = ppo_update(cfg, params, roll)
        lambdas = update_lambdas(cfg, lambdas, roll)
        history.append(_history(it, roll, lambdas))
    return params, lambdas, history


def train(p: TokamakEnvParams, cfg: PPOConfig, *, n_iterations: int = 30, seed: int = 0,
          dtype=torch.float32, device: torch.device | str = "cuda"):
    """Full primal-dual loop (reference ``LagrangianPPO.train``), every
    draw from a CPU ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    params = init_policy(gen, dtype=dtype, device=device)
    draws = [draw_episodes(cfg, gen, dtype=dtype, device=device) for _ in range(n_iterations)]
    return _train(p, cfg, params, draws)


def predict(params: PolicyParams, obs):
    """Deterministic (mean) action."""
    return policy_mean(params, torch.as_tensor(obs, dtype=params.w.dtype,
                                               device=params.w.device))
