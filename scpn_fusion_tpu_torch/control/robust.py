"""Robust control: mu-synthesis (D-K lite) and RWM magnetic feedback (port of
``scpn_fusion_tpu/control/robust.py``).

Role-parity with the reference's robust-control family
(``control/mu_synthesis.py:191`` ``MuSynthesisController`` -- D-K-style
iteration returning a robustly-stabilising gain with a structured-singular-
value bound -- and ``control/rwm_feedback.py`` resistive-wall-mode magnetic
feedback).  Built on the Riccati integrator of ``control/hinf.py``.  The
gamma grid of :func:`_hinf_norm_bound` (JAX's ``vmap``) is one batch of 25
Riccati problems; the structured bound's ``jax.grad`` of the spectral norm
is ``torch.autograd`` through ``torch.linalg.matrix_norm(ord=2)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.hinf import _t, eigvals, solve_care_ode


# ---------------------------------------------------------------------------
# mu-synthesis (D-K iteration with diagonal D scales)
# ---------------------------------------------------------------------------

class MuSynthesisResult(NamedTuple):
    k_gain: torch.Tensor         # state-feedback gain
    d_scales: torch.Tensor       # diagonal uncertainty scalings
    mu_upper_bound: torch.Tensor
    gamma: torch.Tensor
    converged: torch.Tensor


def _hinf_norm_bound(a_cl: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                     gammas: torch.Tensor | None = None) -> torch.Tensor:
    """Upper bound of the closed-loop H-inf norm by scanning the
    bounded-real-lemma Riccati feasibility over a gamma grid (the whole grid
    as one batch)."""
    if gammas is None:
        gammas = torch.logspace(-1.0, 2.0, 25, dtype=a_cl.dtype, device=a_cl.device)
    bbt = b @ _t(b)
    q = _t(c) @ c
    g2 = (gammas ** 2)[:, None, None]
    # Bounded-real: A'X + XA + X BB' X / g^2 + C'C = 0, X >= 0.
    # solve_care_ode integrates A'X + XA - XSX + Q, so S = -BB'/g^2.
    x = solve_care_ode(a_cl, -bbt / g2, q, n_steps=400, dt=2e-3)
    finite = torch.isfinite(x).all(-1).all(-1)
    eig = eigvals(a_cl + bbt @ x / g2).real.amax(-1)
    feas = finite & (eig < 0.0)
    idx = torch.argmax(feas.to(torch.uint8))   # the first feasible gamma (ascending grid)
    return torch.where(feas.any(), gammas[idx], torch.full_like(gammas[0], math.inf))


def _d_step(d: torch.Tensor, a_cl: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """D-step: rebalance the scales by the closed-loop output-channel gains
    (observability Gramian diagonal, Perron-like rebalancing)."""
    gram = solve_care_ode(a_cl, torch.zeros_like(a_cl), _t(c) @ c, n_steps=2000, dt=2e-3)
    chan = torch.sqrt(torch.clamp(torch.diagonal(c @ gram @ _t(c)), min=1e-9))
    return torch.sqrt(d * chan.mean() / torch.clamp(chan, min=1e-9))


def mu_synthesis(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, n_dk_iters: int = 4,
                 uncertainty_scale: float = 0.3) -> MuSynthesisResult:
    """D-K-lite iteration.

    K-step: H-inf state feedback on the D-scaled plant.  D-step: diagonal
    scales from the closed-loop output magnitudes (the diagonal-mu upper
    bound refinement).  Returns the final gain and the achieved
    scaled-norm bound (an upper bound on mu against diagonal structured
    uncertainty of the given scale).
    """
    n = a.shape[0]
    d = torch.ones(c.shape[0], dtype=a.dtype, device=a.device)
    k = torch.zeros((b.shape[1], n), dtype=a.dtype, device=a.device)
    gamma = torch.tensor(math.inf, dtype=a.dtype, device=a.device)

    for _ in range(n_dk_iters):
        c_scaled = d[:, None] * c
        # K-step: LQR on the D-scaled plant (CARE with S = BB').
        x = solve_care_ode(a, b @ _t(b), _t(c_scaled) @ c_scaled, n_steps=2000, dt=2e-3)
        k = _t(b) @ x
        a_cl = a - b @ k
        gamma = _hinf_norm_bound(a_cl, b * uncertainty_scale, c_scaled)
        d = _d_step(d, a_cl, c)

    mu_ub = gamma * uncertainty_scale
    return MuSynthesisResult(k_gain=k, d_scales=d, mu_upper_bound=mu_ub, gamma=gamma,
                             converged=torch.isfinite(gamma))


# ---------------------------------------------------------------------------
# Structured uncertainty + block-diagonal mu upper bound
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UncertaintyBlock:
    """One structured uncertainty block (reference ``mu_synthesis.py:23-29``)."""

    name: str
    size: int
    bound: float
    block_type: str = "complex_scalar"   # real_scalar | complex_scalar | full

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError("uncertainty block size must be >= 1")
        if self.bound < 0.0 or not math.isfinite(self.bound):
            raise ValueError("block bound must be finite and non-negative")
        if self.block_type not in ("real_scalar", "complex_scalar", "full"):
            raise ValueError(f"unsupported block type {self.block_type!r}")


@dataclasses.dataclass(frozen=True)
class StructuredUncertainty:
    """Validated block structure."""

    blocks: tuple[UncertaintyBlock, ...]

    def __post_init__(self) -> None:
        if not self.blocks:
            raise ValueError("need at least one uncertainty block")

    @property
    def total_size(self) -> int:
        return sum(b.size for b in self.blocks)

    def block_index(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """(n,) int: which block each channel belongs to."""
        idx = []
        for i, b in enumerate(self.blocks):
            idx.extend([i] * b.size)
        return torch.tensor(idx, dtype=torch.int64, device=device)


def mu_upper_bound(m: torch.Tensor, structure: StructuredUncertainty | None = None, *,
                   n_steps: int = 80, lr: float = 0.2) -> torch.Tensor:
    """Structured-singular-value upper bound min_D sigma_max(D M D^-1).

    D is block-diagonal positive (constant within each uncertainty block);
    the minimisation runs gradient descent on log d with exact autograd
    gradients of sigma_max (the reference perturbs each scale numerically,
    ``mu_synthesis.py:99-110``).  With no structure the bound is the
    unstructured spectral norm.
    """
    if m.dim() != 2 or m.shape[0] != m.shape[1]:
        raise ValueError("M must be square")
    if structure is None:
        return torch.linalg.matrix_norm(m, ord=2)
    if structure.total_size != m.shape[0]:
        raise ValueError("Delta structure size must match M")
    idx = structure.block_index(m.device)
    m = m.detach()

    def sigma_of(log_d):
        d_chan = torch.exp(log_d)[idx]
        m_scaled = d_chan[:, None] * m / d_chan[None, :]
        return torch.linalg.matrix_norm(m_scaled, ord=2)

    dtype = m.dtype if m.dtype in (torch.float32, torch.float64) else torch.float32
    log_d = torch.zeros((len(structure.blocks),), dtype=dtype, device=m.device)
    with torch.no_grad():
        best = sigma_of(log_d)
    for _ in range(n_steps):
        log_d = log_d.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sigma_of(log_d), log_d)
        with torch.no_grad():
            log_d = log_d - lr * g
            log_d = log_d - log_d[0]        # gauge: D M D^-1 scale-invariant
            best = torch.minimum(best, sigma_of(log_d))
    return best


def dk_iteration_structured(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                            structure: StructuredUncertainty, *,
                            n_dk_iters: int = 4) -> MuSynthesisResult:
    """D-K iteration against a declared block structure.

    K-step: LQR on the D-scaled plant (as :func:`mu_synthesis`); D/mu-step:
    the block-structured :func:`mu_upper_bound` of the closed loop, scaled
    by the worst block bound -- the robustness margin is ``1 / mu``
    (reference ``MuSynthesisController.robustness_margin``).
    """
    if structure.total_size != a.shape[0]:
        raise ValueError("uncertainty structure must match the plant size")
    max_bound = max(blk.bound for blk in structure.blocks)
    n = a.shape[0]
    d = torch.ones(c.shape[0], dtype=a.dtype, device=a.device)
    k = torch.zeros((b.shape[1], n), dtype=a.dtype, device=a.device)
    mu_best = torch.tensor(math.inf, dtype=a.dtype, device=a.device)

    for _ in range(n_dk_iters):
        c_scaled = d[:, None] * c
        x = solve_care_ode(a, b @ _t(b), _t(c_scaled) @ c_scaled, n_steps=2000, dt=2e-3)
        k_cand = _t(b) @ x
        a_cl = a - b @ k_cand
        mu = mu_upper_bound(a_cl, structure) * (1.0 + max_bound)
        better = mu < mu_best
        mu_best = torch.where(better, mu, mu_best)
        k = torch.where(better, k_cand, k)
        d = _d_step(d, a_cl, c)

    return MuSynthesisResult(k_gain=k, d_scales=d, mu_upper_bound=mu_best,
                             gamma=mu_best / (1.0 + max_bound),
                             converged=torch.isfinite(mu_best))


# ---------------------------------------------------------------------------
# RWM feedback
# ---------------------------------------------------------------------------

class RWMPlant(NamedTuple):
    """2-state RWM model: mode amplitude + wall flux (reference
    ``rwm_feedback.py`` reduced plant)."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


def build_rwm_plant(*, gamma_rwm: float = 50.0, tau_wall_s: float = 5e-3,
                    coupling: float = 30.0, dtype: torch.dtype = torch.float64,
                    device: torch.device | str = "cuda") -> RWMPlant:
    """Unstable mode (growth rate gamma_rwm without feedback) coupled to a
    resistive wall with time constant tau_wall (float64: JAX's type with x64
    on)."""
    kw = dict(dtype=dtype, device=device)
    a = torch.tensor([[gamma_rwm, coupling], [0.0, -1.0 / tau_wall_s]], **kw)
    b = torch.tensor([[0.0], [1.0 / tau_wall_s]], **kw)
    c = torch.tensor([[1.0, 0.0]], **kw)
    return RWMPlant(a=a, b=b, c=c)


class RWMFeedbackResult(NamedTuple):
    k_gain: torch.Tensor
    closed_loop_rate: torch.Tensor   # max Re(eig) -- negative = stabilised
    stabilised: torch.Tensor
    trace: torch.Tensor              # mode-amplitude history


def rwm_feedback_design(plant: RWMPlant, *, q_weight: float = 100.0, r_weight: float = 1.0,
                        dt: float = 1e-4, n_steps: int = 3000) -> RWMFeedbackResult:
    """LQR-type magnetic feedback through the wall actuator + closed-loop
    simulation from a finite seed perturbation."""
    n = plant.a.shape[0]
    q = q_weight * torch.eye(n, dtype=plant.a.dtype, device=plant.a.device)
    # CARE: A'X + XA - X (B R^-1 B') X + Q = 0
    x = solve_care_ode(plant.a, plant.b @ _t(plant.b) / r_weight, q, n_steps=4000, dt=1e-4)
    k = (_t(plant.b) @ x) / r_weight
    a_cl = plant.a - plant.b @ k
    rate = eigvals(a_cl).real.amax()
    s = torch.tensor([1e-3, 0.0], dtype=plant.a.dtype, device=plant.a.device)
    amp = []
    for _ in range(n_steps):
        s = s + dt * (a_cl @ s)
        amp.append(s[0])
    return RWMFeedbackResult(k_gain=k, closed_loop_rate=rate, stabilised=rate < 0.0,
                             trace=torch.stack(amp))
