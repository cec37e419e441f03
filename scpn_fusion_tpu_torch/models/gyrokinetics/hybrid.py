"""Hybrid surrogate+GK transport lane: OOD detection, spot-check
scheduling, correction, online learning
(port of ``scpn_fusion_tpu/models/gyrokinetics/hybrid.py``).

The reference's path-C architecture (``core/gk_ood_detector.py:85``
Mahalanobis/range/ensemble OOD, ``core/gk_scheduler.py:48`` periodic /
adaptive / critical-region spot-check scheduling with a call budget,
``core/gk_corrector.py:60`` EMA-smoothed multiplicative corrections
interpolated from spot-check surfaces, ``core/gk_online_learner.py:47``
buffered retraining) as pure tensor functions with static shapes: the OOD
checks are vectorised over surfaces, the scheduler returns a fixed-size
index set (budget slots + validity mask + reason codes), the corrector is an
EMA + interpolation, the learner a ring buffer + closed-form ridge refit.

The scheduler's top-``budget`` choice keeps ``jax.lax.top_k``'s order:
larger scores first, equal scores by lower surface index (a stable
descending sort; ``torch.topk`` promises no order on ties).

Feature layout per surface (matches the reference's 10D surrogate input):
[R/L_Ti, R/L_Te, R/L_ne, q, s_hat, alpha_MHD, Te/Ti, Z_eff, nu_star, beta_e]
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.scenario import interp

N_GK_FEATURES = 10

# Scheduler reason codes (static-shape replacement for reason strings).
REASON_NONE, REASON_ANCHOR, REASON_OOD, REASON_CHI_CHANGE, \
    REASON_CRITICAL = 0, 1, 2, 3, 4


def _atleast_2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(1, -1) if x.dim() < 2 else x


# ---------------------------------------------------------------------------
# OOD detection
# ---------------------------------------------------------------------------

class OODParams(NamedTuple):
    mean: torch.Tensor          # (d,)
    cov_inv: torch.Tensor       # (d, d)
    std: torch.Tensor           # (d,)
    mahalanobis_threshold: torch.Tensor
    soft_sigma_threshold: torch.Tensor
    ensemble_threshold: torch.Tensor


def fit_ood(training_x: torch.Tensor, *, mahalanobis_threshold: float = 4.0,
            soft_sigma_threshold: float = 2.0,
            ensemble_threshold: float = 0.3,
            ridge: float = 1e-6) -> OODParams:
    """Fit training-distribution statistics for the detector."""
    x = torch.as_tensor(training_x)
    mean = torch.mean(x, dim=0)
    std = torch.clamp(torch.std(x, dim=0, correction=0), min=1e-12)
    cov = torch.cov(x.T) + ridge * torch.eye(x.shape[1], dtype=x.dtype, device=x.device)

    def scalar(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    return OODParams(
        mean=mean, cov_inv=torch.linalg.inv(cov), std=std,
        mahalanobis_threshold=scalar(mahalanobis_threshold),
        soft_sigma_threshold=scalar(soft_sigma_threshold),
        ensemble_threshold=scalar(ensemble_threshold))


def mahalanobis_distance(x: torch.Tensor, p: OODParams) -> torch.Tensor:
    """Batched Mahalanobis distance; x is (n_surfaces, d) or (d,)."""
    diff = _atleast_2d(x) - p.mean[None, :]
    d2 = torch.einsum("ni,ij,nj->n", diff, p.cov_inv, diff)
    return torch.sqrt(torch.clamp(d2, min=0.0))


class OODResult(NamedTuple):
    is_ood: torch.Tensor        # (n,) bool
    confidence: torch.Tensor    # (n,) in [0, 1]
    mahalanobis: torch.Tensor   # (n,)
    range_violation: torch.Tensor  # (n,) bool


def ood_check(x: torch.Tensor, p: OODParams,
              ensemble_std: torch.Tensor | None = None) -> OODResult:
    """Combined detector: Mahalanobis + soft range (+ optional ensemble
    disagreement), vectorised over surfaces (reference
    ``OODDetector.check_*`` :85-200 combined verdict)."""
    x2 = _atleast_2d(x)
    d_m = mahalanobis_distance(x2, p)
    maha_ood = d_m > p.mahalanobis_threshold
    sigma_dev = torch.abs(x2 - p.mean[None, :]) / p.std[None, :]
    range_ood = torch.any(sigma_dev > p.soft_sigma_threshold * 3.0, dim=1)
    is_ood = maha_ood | range_ood
    if ensemble_std is not None:
        is_ood = is_ood | (torch.atleast_1d(ensemble_std) > p.ensemble_threshold)
    conf = torch.clamp(d_m / torch.clamp(p.mahalanobis_threshold, min=1e-12), 0.0, 1.0)
    conf = torch.where(range_ood, torch.clamp(conf, min=1.0), conf)
    return OODResult(is_ood=is_ood, confidence=conf, mahalanobis=d_m,
                     range_violation=range_ood)


# ---------------------------------------------------------------------------
# Spot-check scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    strategy: str = "adaptive"     # "periodic" | "adaptive" | "critical_region"
    period: int = 5
    budget: int = 5
    anchor_rho: tuple = (0.3, 0.5, 0.8)
    pedestal_rho: float = 0.85
    axis_rho: float = 0.15
    chi_change_threshold: float = 0.5

    def __post_init__(self):
        if self.strategy not in ("periodic", "adaptive", "critical_region"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.budget < 1:
            raise ValueError("budget must be >= 1")


class SpotCheckPlan(NamedTuple):
    """Fixed-size plan: `indices[i]` is valid iff `valid[i]`."""

    indices: torch.Tensor   # (budget,) int32 surface indices
    valid: torch.Tensor     # (budget,) bool
    reasons: torch.Tensor   # (budget,) int32 reason codes
    any_requested: torch.Tensor  # scalar bool


def top_k(score: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest scores and their indices, equal
    scores by lower index (a stable descending sort)."""
    values, order = torch.sort(score, descending=True, stable=True)
    return values[:k], order[:k]


def schedule_spot_checks(cfg: SchedulerConfig, step,
                         rho: torch.Tensor, chi_i: torch.Tensor,
                         prev_chi_i: torch.Tensor,
                         ood_mask: torch.Tensor | None = None
                         ) -> SpotCheckPlan:
    """Decide which surfaces get an expensive GK run this transport step.

    Priority scores are built per surface and the top-`budget` surfaces win
    their slots (reference ``GKScheduler.step`` :57-140 semantics with the
    dict-of-reasons replaced by score/reason arrays).
    """
    n = rho.shape[0]
    dev = rho.device
    score = torch.zeros(n, dtype=chi_i.dtype, device=dev)
    reason = torch.full((n,), REASON_NONE, dtype=torch.int32, device=dev)

    def code(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    def value(v):
        return torch.tensor(v, dtype=score.dtype, device=dev)

    anchor_idx = torch.stack(
        [torch.argmin(torch.abs(rho - r)) for r in cfg.anchor_rho])
    is_anchor = torch.zeros(n, dtype=torch.bool, device=dev)
    is_anchor[anchor_idx] = True

    if cfg.strategy == "periodic":
        active = (torch.as_tensor(step, device=dev) % cfg.period) == 0
        score = torch.where(is_anchor & active, value(1.0), score)
        reason = torch.where(is_anchor & active, code(REASON_ANCHOR), reason)
    elif cfg.strategy == "adaptive":
        if ood_mask is not None:
            score = torch.where(ood_mask, value(3.0), score)
            reason = torch.where(ood_mask, code(REASON_OOD), reason)
        rel = torch.abs(chi_i - prev_chi_i) \
            / torch.clamp(torch.abs(prev_chi_i), min=1e-10)
        big = rel > cfg.chi_change_threshold
        score = torch.where(big & (score == 0), value(2.0), score)
        reason = torch.where(big & (reason == REASON_NONE),
                             code(REASON_CHI_CHANGE), reason)
        score = torch.where(is_anchor & (score == 0), value(1.0), score)
        reason = torch.where(is_anchor & (reason == REASON_NONE),
                             code(REASON_ANCHOR), reason)
    else:  # critical_region
        crit = (rho > cfg.pedestal_rho) | (rho < cfg.axis_rho)
        score = torch.where(crit, value(2.0), score)
        reason = torch.where(crit, code(REASON_CRITICAL), reason)
        score = torch.where(is_anchor & (score == 0), value(1.0), score)
        reason = torch.where(is_anchor & (reason == REASON_NONE),
                             code(REASON_ANCHOR), reason)

    top_scores, top_idx = top_k(score, cfg.budget)
    valid = top_scores > 0.0
    return SpotCheckPlan(
        indices=top_idx.to(torch.int32), valid=valid,
        reasons=reason[top_idx], any_requested=torch.any(valid))


# ---------------------------------------------------------------------------
# Corrector
# ---------------------------------------------------------------------------

class CorrectorState(NamedTuple):
    alpha_chi_i: torch.Tensor   # (nr,) multiplicative factors
    alpha_chi_e: torch.Tensor
    alpha_d_e: torch.Tensor


def init_corrector(nr: int, dtype: torch.dtype = torch.float64,
                   device: torch.device | str = "cuda") -> CorrectorState:
    one = torch.ones(nr, dtype=dtype, device=device)
    return CorrectorState(one, one, one)


def corrector_update(state: CorrectorState, rho: torch.Tensor,
                     spot_rho: torch.Tensor, spot_valid: torch.Tensor,
                     gk_fluxes: torch.Tensor, surr_fluxes: torch.Tensor,
                     smoothing_alpha: float = 0.3) -> CorrectorState:
    """EMA-blend new correction factors interpolated from spot checks.

    gk_fluxes / surr_fluxes: (budget, 3) columns [chi_i, chi_e, D_e].
    Invalid slots are masked out of the interpolation by collapsing them
    onto the first valid point (reference ``GKCorrector.update`` :71-106).
    """
    ratio = gk_fluxes / torch.clamp(torch.abs(surr_fluxes), min=1e-10)
    # Sort by rho so interp sees increasing x; push invalid slots to the end
    # with a huge rho and clamp ratios there to 1 (no correction).
    big = torch.tensor(10.0, dtype=rho.dtype, device=rho.device)
    x = torch.where(spot_valid, spot_rho, big)
    ratio = torch.where(spot_valid[:, None], ratio, torch.ones_like(ratio))
    order = torch.argsort(x, stable=True)
    x = x[order]
    ratio = ratio[order]

    new_i, new_e, new_d = (interp(rho, x, ratio[:, 0]), interp(rho, x, ratio[:, 1]),
                           interp(rho, x, ratio[:, 2]))
    a = smoothing_alpha
    any_valid = torch.any(spot_valid)

    def blend(old, new):
        return torch.where(any_valid, a * new + (1.0 - a) * old, old)

    return CorrectorState(
        alpha_chi_i=blend(state.alpha_chi_i, new_i),
        alpha_chi_e=blend(state.alpha_chi_e, new_e),
        alpha_d_e=blend(state.alpha_d_e, new_d))


def corrector_apply(state: CorrectorState, chi_i, chi_e, d_e):
    return (chi_i * state.alpha_chi_i, chi_e * state.alpha_chi_e,
            d_e * state.alpha_d_e)


# ---------------------------------------------------------------------------
# Online learner (ring buffer + closed-form ridge refit)
# ---------------------------------------------------------------------------

class LearnerState(NamedTuple):
    x_buf: torch.Tensor     # (capacity, d)
    y_buf: torch.Tensor     # (capacity, m)
    count: torch.Tensor     # total samples seen
    weights: torch.Tensor   # (d + 1, m) ridge model (bias row last)


def init_learner(capacity: int = 256, d: int = N_GK_FEATURES, m: int = 3,
                 dtype: torch.dtype = torch.float64,
                 device: torch.device | str = "cuda") -> LearnerState:
    return LearnerState(
        x_buf=torch.zeros((capacity, d), dtype=dtype, device=device),
        y_buf=torch.zeros((capacity, m), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        weights=torch.zeros((d + 1, m), dtype=dtype, device=device))


def learner_add(state: LearnerState, x: torch.Tensor,
                y: torch.Tensor) -> LearnerState:
    """Insert one (features, fluxes) sample into the ring buffer (on the
    device: the slot is a tensor, nothing is read back)."""
    cap = state.x_buf.shape[0]
    slot = (state.count % cap).to(torch.int64).reshape(1)
    return state._replace(
        x_buf=state.x_buf.index_copy(0, slot, x.to(state.x_buf.dtype).reshape(1, -1)),
        y_buf=state.y_buf.index_copy(0, slot, y.to(state.y_buf.dtype).reshape(1, -1)),
        count=state.count + 1)


def learner_refit(state: LearnerState, l2: float = 1e-3) -> LearnerState:
    """Closed-form ridge refit over the filled buffer (one (d+1)^2 solve;
    replaces the reference's buffered SGD retraining
    ``gk_online_learner.py:90-220``)."""
    cap = state.x_buf.shape[0]
    dev, dtype = state.x_buf.device, state.x_buf.dtype
    filled = (torch.arange(cap, device=dev) < state.count).to(dtype)
    xa = torch.cat([state.x_buf, torch.ones((cap, 1), dtype=dtype, device=dev)], dim=1)
    xw = xa * filled[:, None]
    gram = xw.T @ xa + l2 * torch.eye(xa.shape[1], dtype=dtype, device=dev)
    rhs = xw.T @ state.y_buf
    return state._replace(weights=torch.linalg.solve(gram, rhs))


def learner_predict(state: LearnerState, x: torch.Tensor) -> torch.Tensor:
    x2 = _atleast_2d(x).to(state.weights.dtype)
    xa = torch.cat([x2, torch.ones((x2.shape[0], 1), dtype=x2.dtype, device=x2.device)],
                   dim=1)
    return xa @ state.weights


# ---------------------------------------------------------------------------
# Session verification report
# ---------------------------------------------------------------------------

class ReportState(NamedTuple):
    """Accumulated per-session verification statistics: the moments the
    reference's mutable ``VerificationReport``
    (``core/gk_verification_report.py:25-97``) exposes (counts, error sums,
    running max, correction-factor sum), accumulated branch-free;
    ``report_to_dict`` finalises the same JSON summary fields."""

    total_steps: torch.Tensor        # scalar int32
    steps_verified: torch.Tensor     # scalar int32
    total_spot_checks: torch.Tensor  # scalar int32
    ood_triggers: torch.Tensor       # scalar int32
    n_records: torch.Tensor          # scalar int32 (valid spot comparisons)
    sum_abs_rel_err: torch.Tensor    # chi_i |rel err| sum over records
    max_abs_rel_err: torch.Tensor
    sum_correction: torch.Tensor     # aggregate |alpha - 1| magnitudes
    n_correction: torch.Tensor


def init_report(dtype: torch.dtype = torch.float64,
                device: torch.device | str = "cuda") -> ReportState:
    z_i = torch.zeros((), dtype=torch.int32, device=device)
    z_f = torch.zeros((), dtype=dtype, device=device)
    return ReportState(z_i, z_i, z_i, z_i, z_i, z_f, z_f, z_f, z_i)


def report_add_step(rep: ReportState, *, spot_valid: torch.Tensor,
                    ood_flags: torch.Tensor, gk_chi_i: torch.Tensor,
                    surr_chi_i: torch.Tensor,
                    corrector: CorrectorState | None = None) -> ReportState:
    """Fold one transport step's spot-check outcome into the report.

    ``spot_valid``: (budget,) bool -- which scheduled slots ran a GK check;
    ``gk_chi_i`` / ``surr_chi_i``: (budget,) fluxes at those slots;
    ``ood_flags``: (nr,) bool per-surface OOD indicators.
    """
    n_spots = torch.sum(spot_valid).to(torch.int32)
    verified = (n_spots > 0).to(torch.int32)
    # Signed relative chi_i error with the reference's tiny-GK guard.
    denom_ok = torch.abs(gk_chi_i) >= 1e-10
    zero = torch.zeros_like(gk_chi_i)
    rel = torch.where(denom_ok, (surr_chi_i - gk_chi_i)
                      / torch.where(denom_ok, gk_chi_i, torch.ones_like(gk_chi_i)), zero)
    rel = torch.where(spot_valid, torch.abs(rel), zero)
    new_max = torch.maximum(rep.max_abs_rel_err, torch.max(rel))
    corr_mag = torch.zeros_like(rep.sum_correction)
    n_corr = torch.zeros_like(rep.n_correction)
    if corrector is not None:
        corr_mag = torch.mean(torch.abs(corrector.alpha_chi_i - 1.0))
        n_corr = verified
    return ReportState(
        total_steps=rep.total_steps + 1,
        steps_verified=rep.steps_verified + verified,
        total_spot_checks=rep.total_spot_checks + n_spots,
        ood_triggers=rep.ood_triggers
        + torch.sum(ood_flags).to(torch.int32),
        n_records=rep.n_records + n_spots,
        sum_abs_rel_err=rep.sum_abs_rel_err + torch.sum(rel),
        max_abs_rel_err=new_max,
        sum_correction=rep.sum_correction + corr_mag * n_corr,
        n_correction=rep.n_correction + n_corr)


def report_to_dict(rep: ReportState) -> dict:
    """Finalise the JSON-shape summary (reference ``to_dict`` parity)."""
    total = int(rep.total_steps)
    n_rec = int(rep.n_records)
    n_corr = int(rep.n_correction)
    return {
        "total_steps": total,
        "steps_verified": int(rep.steps_verified),
        "verification_fraction":
            round(int(rep.steps_verified) / total, 4) if total else 0.0,
        "total_spot_checks": int(rep.total_spot_checks),
        "ood_triggers": int(rep.ood_triggers),
        "max_rel_error_chi_i": round(float(rep.max_abs_rel_err), 4),
        "mean_rel_error_chi_i":
            round(float(rep.sum_abs_rel_err) / n_rec, 4) if n_rec else 0.0,
        "n_correction_records": n_rec,
        "mean_correction_factor":
            round(float(rep.sum_correction) / n_corr, 4) if n_corr else 0.0,
    }


def report_to_json(rep: ReportState, path=None) -> str:
    import json as _json
    text = _json.dumps(report_to_dict(rep), indent=2)
    if path is not None:
        from pathlib import Path as _Path
        _Path(path).write_text(text)
    return text
