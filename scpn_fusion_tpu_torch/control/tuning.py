"""Automated controller gain tuning -- batched cross-entropy search (port of
``scpn_fusion_tpu/control/tuning.py``).

Where the reference runs sequential Optuna trials
(``control/controller_tuning.py:184-264``), a whole generation of candidates
is one batched call: the objective takes the population as a leading batch
dimension (JAX's ``vmap``).  For :func:`tune_pid` a generation is ONE
launch of ``csrc/reduced_shot.cu`` on the card (the reduced flight-sim shot
of every candidate); for :func:`tune_hinf` it is one batch of Riccati
designs and closed-loop rollouts.  JAX's ``lax.scan`` over generations is a
Python loop.

Sampling is in log-space, matching the reference's ``log=True`` Optuna
search distributions.  The draws: :func:`cem_minimize` draws the
``(n_generations, population, k)`` standard normals from a
``torch.Generator``; :func:`_cem_minimize` takes them, as the tests hand it
JAX's own.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams, run_shot_reduced_gains
from scpn_fusion_tpu_torch.control.hinf import HInfState, _mv, hinf_step, synthesize_hinf


class CEMResult(NamedTuple):
    best_params: torch.Tensor      # (k,) best candidate ever seen
    best_cost: torch.Tensor        # scalar
    mean: torch.Tensor             # (k,) final sampling mean (log-space)
    cost_history: torch.Tensor     # (n_gen,) best cost per generation


def _cem_minimize(objective: Callable[[torch.Tensor], torch.Tensor], lo, hi,
                  normals: torch.Tensor, *, elite_frac: float = 0.125, init_std: float = 0.6,
                  min_std: float = 0.02) -> CEMResult:
    """CEM on given standard normals ``(n_generations, population, k)``
    (float32, on the device the search runs on).  ``objective`` maps a
    ``(population, k)`` batch of parameter vectors to ``(population,)``
    costs."""
    f32, dev = torch.float32, normals.device
    lo = torch.as_tensor(lo, dtype=f32, device=dev)
    hi = torch.as_tensor(hi, dtype=f32, device=dev)
    # log and exp in float64, rounded to float32: the correctly rounded
    # float32 value on every device (CUDA's logf / expf and the CPU's differ
    # in the last bit), so a search draws the same candidates on both
    log_lo, log_hi = (torch.log(b.double()).to(f32) for b in (lo, hi))
    n_generations, population, k = normals.shape
    n_elite = max(1, int(population * elite_frac))

    def decode(z):
        # z in log-space, clipped to the box.
        return torch.exp(torch.clamp(z, log_lo, log_hi).double()).to(f32)

    mean = 0.5 * (log_lo + log_hi)
    std = torch.full((k,), init_std, dtype=f32, device=dev) * (log_hi - log_lo) / 2.0
    best_p, best_c = decode(mean), torch.tensor(float("inf"), dtype=f32, device=dev)
    history = []
    for g in range(n_generations):
        z = mean + std * normals[g]
        costs = objective(decode(z)).to(f32)
        costs = torch.where(torch.isfinite(costs), costs, torch.full_like(costs, float("inf")))
        order = torch.argsort(costs, stable=True)     # jnp.argsort is stable
        elite = z[order[:n_elite]]
        mean = elite.sum(0) / n_elite
        centered = elite - mean
        # jnp.std: ddof 0, sqrt of the mean squared deviation
        std = torch.clamp(torch.sqrt((centered * centered).sum(0) / n_elite), min=min_std)
        gen_best_c = costs[order[0]]
        gen_best_p = decode(z[order[0]])
        improved = gen_best_c < best_c
        best_c = torch.where(improved, gen_best_c, best_c)
        best_p = torch.where(improved, gen_best_p, best_p)
        history.append(gen_best_c)
    return CEMResult(best_p, best_c, mean, torch.stack(history))


def cem_minimize(objective: Callable[[torch.Tensor], torch.Tensor], lo, hi,
                 generator: torch.Generator, *, population: int = 128,
                 n_generations: int = 20, elite_frac: float = 0.125, init_std: float = 0.6,
                 min_std: float = 0.02) -> CEMResult:
    """Minimise ``objective`` over a box ``[lo, hi]`` (log-uniform geometry),
    drawing the candidates' normals from ``generator`` (on its device, where
    the search runs).  ``objective`` maps a ``(population, k)`` batch to
    ``(population,)`` costs: a generation is one batched call."""
    k = len(lo)
    normals = torch.randn((n_generations, population, k), generator=generator,
                          device=generator.device, dtype=torch.float32)
    return _cem_minimize(objective, lo, hi, normals, elite_frac=elite_frac, init_std=init_std,
                         min_std=min_std)


# ── PID tuning on the reduced flight-sim lane ────────────────────────────

PID_BOUNDS_LO = (0.1, 0.01, 0.01, 0.1, 0.01, 0.01)
PID_BOUNDS_HI = (10.0, 1.0, 1.0, 10.0, 1.0, 1.0)


def pid_shot_cost(params: FlightSimParams, gains: torch.Tensor) -> torch.Tensor:
    """Integral-absolute-error score of closed-loop reduced shots, one for
    each gain set of ``gains`` (..., 6) (reference ``_pid_rollout_score``
    :148-181: summed |tracking error| with a max-steps residual penalty;
    here plus an explicit disruption term)."""
    trace, metrics = run_shot_reduced_gains(params, gains)
    iae = trace.r_err.abs().mean(-1) + trace.z_err.abs().mean(-1)
    return iae + 10.0 * metrics["disruption_fraction"] \
        + metrics["r_err_final"] + metrics["z_err_final"]


def _tune_pid(params: FlightSimParams, normals: torch.Tensor) -> CEMResult:
    """:func:`tune_pid` on given normals ``(n_generations, population, 6)``."""
    return _cem_minimize(lambda g: pid_shot_cost(params, g), PID_BOUNDS_LO, PID_BOUNDS_HI,
                         normals)


def tune_pid(params: FlightSimParams, generator: torch.Generator, *, population: int = 128,
             n_generations: int = 15) -> CEMResult:
    """Tune the six reduced-lane PID gains ``[r_kp, r_ki, r_kd, z_kp, z_ki,
    z_kd]`` over the reference's log-uniform search box
    (``controller_tuning.py:221-224`` per-axis), on the generator's device:
    on the card one kernel launch a generation."""
    return cem_minimize(lambda g: pid_shot_cost(params, g), PID_BOUNDS_LO, PID_BOUNDS_HI,
                        generator, population=population, n_generations=n_generations)


# ── H-infinity (gamma, bandwidth-weight) tuning ──────────────────────────

HINF_BOUNDS_LO = (1.01, 0.05)
HINF_BOUNDS_HI = (20.0, 5.0)


def hinf_closed_loop_cost(a: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor,
                          c1: torch.Tensor, c2: torch.Tensor, theta: torch.Tensor, *,
                          x0: torch.Tensor, dt: float = 0.01, n_steps: int = 400,
                          riccati_steps: int = 800) -> torch.Tensor:
    """Closed-loop regulation cost of the central H-inf controller
    synthesised at ``theta = [gamma, bandwidth_weight]`` (``theta`` (..., 2):
    one design and rollout for each row, all as one batch).

    The tuned parameters are scored by what they do: synthesize at
    (gamma, w C1), roll the observer-based loop from a perturbed state, and
    integrate state + control energy, with an infeasibility penalty from the
    rho(XY) < gamma^2 test.
    """
    dtype = torch.promote_types(a.dtype, theta.dtype)
    a, b1, b2, c1, c2, x0, theta = (t.to(dtype) for t in (a, b1, b2, c1, c2, x0, theta))
    gamma, w = theta[..., 0], theta[..., 1]
    gains = synthesize_hinf(a, b1, b2, w[..., None, None] * c1, c2, gamma,
                            riccati_steps=riccati_steps, riccati_dt=dt)

    x, est = x0, HInfState(torch.zeros_like(x0))
    cost_t = []
    for _ in range(n_steps):
        y_meas = _mv(c2, x)
        est, u = hinf_step(gains, a, b2, c2, est, y_meas, dt, u_max=1e3)
        x = x + dt * (_mv(a, x) + _mv(b2, u))
        cost_t.append((x * x).sum(-1) + 1e-3 * (u * u).sum(-1))
    ise = dt * torch.stack(cost_t).sum(0)
    penalty = torch.where(gains.robust_feasible, 0.0, 1e3)
    return ise + penalty


def _tune_hinf(a, b1, b2, c1, c2, normals: torch.Tensor, *,
               x0: torch.Tensor | None = None) -> CEMResult:
    """:func:`tune_hinf` on given normals ``(n_generations, population, 2)``."""
    if x0 is None:
        x0 = torch.ones((a.shape[0],), dtype=torch.float32, device=a.device)
    return _cem_minimize(lambda th: hinf_closed_loop_cost(a, b1, b2, c1, c2, th, x0=x0),
                         HINF_BOUNDS_LO, HINF_BOUNDS_HI, normals)


def tune_hinf(a: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor, c1: torch.Tensor,
              c2: torch.Tensor, generator: torch.Generator, *, x0: torch.Tensor | None = None,
              population: int = 64, n_generations: int = 10) -> CEMResult:
    """Tune ``[gamma, bandwidth_weight]`` for the central H-inf design over
    the reference's search box (gamma in [1.01, 20], bandwidth log-uniform in
    [0.05, 5] -- ``controller_tuning.py:258-259``), scored by closed-loop
    regulation performance: a generation synthesises and rolls out
    ``population`` complete Riccati designs as one batch."""
    normals = torch.randn((n_generations, population, 2), generator=generator,
                          device=generator.device, dtype=torch.float32)
    return _tune_hinf(a, b1, b2, c1, c2, normals, x0=x0)
