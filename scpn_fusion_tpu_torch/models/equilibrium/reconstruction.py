"""Real-shot strict-accuracy reconstruction: the measured-external-source GS
lane (port of ``scpn_fusion_tpu/models/equilibrium/reconstruction.py``).

1. **COCOS normalisation**: a g-file whose psi ascends from axis to
   boundary is flipped (psi, p', FF' negated, an exact GS symmetry), so psi
   peaks at the axis.
2. **Measured external source**: outside the axis-connected plasma region
   (the connected component of ``psi_N < 1`` above the X-point holding the
   axis) the source is pinned to the file's measured ``Delta* psi``.
3. **Model source inside**: ``S = -(mu0 R^2 p'(psi_N) + FF'(psi_N))`` from
   the file's profiles, optional n x n sub-cell averaging, a smooth LCFS
   roll-off weight, and Ip renormalised every iteration to the measured
   plasma-region current.
4. **Anderson(m) outer acceleration** around ``n_inner`` plain multigrid
   V-cycles (or damped Picard).
5. **Shell pinning** (``model_psin_max < 1``): the model source only where
   ``psi_N < model_psin_max``, the measured source in the pedestal shell.

The reproduction lane warm-starts from the file psi and anchors the
normalisation to the file's (psi_axis, psi_bnd) and the measured
plasma-region Ip: a fixed-point consistency check, not blind prediction.
``init="external"`` is the cold start.

Case preparation, metrics and the profile refit's small systems are host
numpy and scipy, carried over from the JAX module.  The outer loop (the JAX
``lax.while_loop``) is a Python loop on the device with one host read of the
update an iteration; every V-cycle is the plain one (the JAX module passes
``use_pallas=False``).  ``refit_profiles`` solves its basis responses in one
``torch.func.vmap`` of the plain ``mg_solve``, as the JAX module ``vmap``s
them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.io.geqdsk import GEqdsk
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl, mg_solve
from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet
from scpn_fusion_tpu_torch.models.equilibrium.topology import gradient

MU0 = 4.0e-7 * np.pi


def delta_star_np(psi: np.ndarray, r: np.ndarray, d_r: float, d_z: float) -> np.ndarray:
    """Five-point ``Delta* = d_rr - (1/R) d_r + d_zz`` (NumPy, f64 host twin).

    Matches ``ops/stencil.py:gs_operator`` and the reference's
    ``build_delta_star`` (``validate_real_diiid_145419.py:180-198``).
    Boundary ring is zero (the ring is Dirichlet, never sourced).
    """
    out = np.zeros_like(psi)
    rc = r[None, 1:-1]
    out[1:-1, 1:-1] = (
        (psi[1:-1, 2:] - 2.0 * psi[1:-1, 1:-1] + psi[1:-1, :-2]) / d_r**2
        - (psi[1:-1, 2:] - psi[1:-1, :-2]) / (2.0 * d_r * rc)
        + (psi[2:, 1:-1] - 2.0 * psi[1:-1, 1:-1] + psi[:-2, 1:-1]) / d_z**2
    )
    return out


@dataclasses.dataclass(frozen=True)
class ReconCase:
    """Host-prepared (NumPy f64) static data for one g-file reconstruction."""

    r: np.ndarray               # (NR,)
    z: np.ndarray               # (NZ,)
    psi: np.ndarray             # (NZ, NR) psi-peaked convention
    lap: np.ndarray             # measured Delta* psi
    plasma: np.ndarray          # bool: axis-connected psi_N<1 above X-point
    model_region: np.ndarray    # bool: plasma & psi_N < model_psin_max
    external: np.ndarray        # measured source outside the model region
    ip_model: float             # measured current integral over model_region
    psi_axis: float
    psi_bnd: float
    span: float                 # |psi_axis - psi_bnd|
    pprime: np.ndarray          # sign-adjusted file profiles on uniform psi_N
    ffprime: np.ndarray
    flipped: bool
    model_psin_max: float
    has_x_point: bool
    source_convention: str         # snapped convention name
    source_scale: float            # multiplier applied to p'/FF'
    source_best_fit_scale: float   # raw best-fit (deep region)
    source_best_fit_rel_l2: float  # shape residual after best-fit scaling


def prepare_case(eq: GEqdsk, *, model_psin_max: float = 1.0) -> ReconCase:
    """Host-side case preparation (static masks from the FILE psi only)."""
    r = np.asarray(eq.r, np.float64)
    z = np.asarray(eq.z, np.float64)
    psi = np.asarray(eq.psirz, np.float64)
    pprime = np.asarray(eq.pprime, np.float64)
    ffprime = np.asarray(eq.ffprime, np.float64)
    psi_axis, psi_bnd = float(eq.simag), float(eq.sibry)

    flipped = psi_axis < psi_bnd  # file stores psi ascending -> flip to peaked
    if flipped:
        psi, pprime, ffprime = -psi, -pprime, -ffprime
        psi_axis, psi_bnd = -psi_axis, -psi_bnd

    d_r, d_z = float(r[1] - r[0]), float(z[1] - z[0])
    nz, nr = psi.shape
    lap = delta_star_np(psi, r, d_r, d_z)
    span = abs(psi_axis - psi_bnd)
    psin_map = (psi - psi_axis) / (psi_bnd - psi_axis)

    # Axis: interior argmax of the peaked psi.
    iz_ax, ir_ax = np.unravel_index(np.argmax(psi[2:-2, 2:-2]), (nz - 4, nr - 4))
    iz_ax += 2
    ir_ax += 2

    # X-point: min |grad psi|^2 among near-separatrix cells below the axis
    # (reference :258-266; the 0.3 m offset generalised to 15 % of the Z
    # extent so SPARC-scale machines work too).
    gz, gr = np.gradient(psi, d_z, d_r)
    g2 = gz**2 + gr**2
    zzg = np.broadcast_to(z[:, None], psi.shape)
    z_off = 0.15 * (z[-1] - z[0])
    sep = (np.abs(psin_map - 1.0) < 0.02) & (zzg < z[iz_ax] - z_off)
    has_x = bool(sep.any())
    if has_x:
        iz_x, _ = np.unravel_index(np.argmin(np.where(sep, g2, np.inf)), g2.shape)
        above = zzg > z[iz_x]
    else:  # limited plasma: no Z cut
        above = np.ones_like(psi, dtype=bool)

    from scipy import ndimage

    lab, _ = ndimage.label((psin_map < 1.0) & above)
    plasma = lab == lab[iz_ax, ir_ax]

    model_region = plasma & (psin_map < model_psin_max) if model_psin_max < 1.0 else plasma
    dA = d_r * d_z
    rrg = np.broadcast_to(r[None, :], psi.shape)
    ip_model = float(np.sum(-lap[model_region] / (MU0 * rrg[model_region])) * dA)
    external = np.where(model_region, 0.0, lap)

    # Source-convention attribution (reference `_source_best_fit_attribution`,
    # benchmark_sparc_geqdsk_rmse.py:59-100, + the named public-SPARC 2pi
    # adapter eqdsk.py:45-54): best-fit a global scale between the measured
    # Delta*psi and the profile source over the deep plasma, snap to a
    # documented convention factor when within 15 %, and rescale p'/FF'.
    deep_attr = plasma & (psin_map < 0.8)
    prof_src = -(MU0 * rrg**2 * np.interp(np.clip(psin_map, 0, 1),
                                          np.linspace(0, 1, pprime.size), pprime)
                 + np.interp(np.clip(psin_map, 0, 1),
                             np.linspace(0, 1, ffprime.size), ffprime))
    a_v, b_v = lap[deep_attr], prof_src[deep_attr]
    bb = float(np.dot(b_v, b_v))
    best_scale = float(np.dot(a_v, b_v) / bb) if bb > 1e-30 else float("nan")
    rel_l2 = (float(np.linalg.norm(a_v - best_scale * b_v) / max(np.linalg.norm(a_v), 1e-30))
              if np.isfinite(best_scale) else float("inf"))
    candidates = {
        "canonical": 1.0, "negated": -1.0,
        "scaled_by_2pi": 2.0 * np.pi, "scaled_by_minus_2pi": -2.0 * np.pi,
        "scaled_by_inv_2pi": 1.0 / (2.0 * np.pi),
        "scaled_by_minus_inv_2pi": -1.0 / (2.0 * np.pi),
    }
    convention = min(candidates, key=lambda n: abs(best_scale - candidates[n]))
    if abs(best_scale - candidates[convention]) / abs(candidates[convention]) > 0.15:
        convention = "unclassified_global_scale"
        scale_applied = 1.0
    else:
        scale_applied = candidates[convention]
    pprime = pprime * scale_applied
    ffprime = ffprime * scale_applied

    return ReconCase(
        r=r, z=z, psi=psi, lap=lap, plasma=plasma, model_region=model_region,
        external=external, ip_model=ip_model, psi_axis=psi_axis,
        psi_bnd=psi_bnd, span=span, pprime=pprime, ffprime=ffprime,
        flipped=flipped, model_psin_max=float(model_psin_max), has_x_point=has_x,
        source_convention=convention, source_scale=scale_applied,
        source_best_fit_scale=best_scale, source_best_fit_rel_l2=rel_l2,
    )


def _model_source(
    psi: torch.Tensor,
    rr: torch.Tensor,
    d_r: float,
    psi_axis: torch.Tensor,
    psi_bnd: torch.Tensor,
    pprime: torch.Tensor,
    ffprime: torch.Tensor,
    subcell: int,
    cutoff_width: torch.Tensor,
) -> torch.Tensor:
    """``S = -(mu0 R^2 p' + FF')`` with soft LCFS weight and sub-cell averaging:
    sub-samples shift psi by the local gradient and R by the sub-offset; the
    support weight is evaluated once on the unshifted field."""
    n_tab = pprime.shape[0]
    denom = psi_bnd - psi_axis
    denom = torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)

    def psin_raw(p):
        return (p - psi_axis) / denom

    def interp(psi_n, table):
        x = torch.clamp(psi_n, 0.0, 1.0) * (n_tab - 1)
        i0 = torch.clamp(x.to(torch.int32), 0, n_tab - 2).long()
        frac = x - i0.to(x.dtype)
        return table[i0] * (1.0 - frac) + table[i0 + 1] * frac

    pn0 = psin_raw(psi)
    support = torch.sigmoid((1.0 - pn0) / cutoff_width)

    if subcell <= 1:
        src = -(MU0 * rr**2 * interp(pn0, pprime) + interp(pn0, ffprime))
        return src * support

    g_z, g_r = gradient(psi, 1.0, 0), gradient(psi, 1.0, 1)  # per index step
    offsets = (torch.arange(subcell, dtype=psi.dtype, device=psi.device) + 0.5) / subcell - 0.5
    acc = torch.zeros_like(psi)
    for a in offsets:
        for b in offsets:
            psi_s = psi + a * g_r + b * g_z
            r_s = torch.clamp(rr + a * d_r, min=1e-6)
            pn = psin_raw(psi_s)
            acc = acc + -(MU0 * r_s**2 * interp(pn, pprime) + interp(pn, ffprime))
    return (acc / (subcell * subcell)) * support


class ReconResult(NamedTuple):
    """``iterations`` is a host value."""

    psi: torch.Tensor
    iterations: int
    step: torch.Tensor


def _reconstruct_impl(
    grid: Grid,
    x0: torch.Tensor,
    psi_ring: torch.Tensor,
    model_mask: torch.Tensor,
    external: torch.Tensor,
    pprime: torch.Tensor,
    ffprime: torch.Tensor,
    psi_axis: torch.Tensor,
    psi_bnd: torch.Tensor,
    ip_model: torch.Tensor,
    tol: torch.Tensor,
    picard_omega: torch.Tensor,
    cutoff_width: torch.Tensor,
    *,
    max_iter: int,
    anderson_m: int,
    subcell: int,
    n_inner: int,
    accel: str,
) -> ReconResult:
    """The outer Anderson (or Picard) loop on ``x0``'s device: the JAX
    ``while_loop`` with ``cond = k < max_iter & step >= tol & finite(step)``
    read on the host once an iteration."""
    r_1d, rr = grid.R, grid.RR
    d_r, d_z = grid.dR, grid.dZ
    dtype, device = x0.dtype, x0.device
    shape = grid.shape
    n_flat = shape[0] * shape[1]
    d_a = d_r * d_z
    zero = torch.zeros((), dtype=dtype, device=device)

    def step_map(x: torch.Tensor) -> torch.Tensor:
        psi = x.reshape(shape)
        src_model = _model_source(psi, rr, d_r, psi_axis, psi_bnd, pprime, ffprime,
                                  subcell, cutoff_width)
        ipm = torch.where(model_mask, -src_model / (MU0 * rr), zero).sum() * d_a
        scale = torch.where(ipm.abs() > 1e-30, ip_model / ipm, torch.ones_like(ipm))
        src = torch.where(model_mask, src_model * scale, external)
        out = psi
        for _ in range(n_inner):
            out = _vcycle_impl(out, src, r_1d, d_r, d_z, 1.0, 3, 3, 5, 50, False)
        return apply_dirichlet(out, psi_ring).reshape(-1)

    m = anderson_m
    tol_h = float(tol)
    k, x, n_valid = 0, x0, 0
    step = torch.full((), 1e30, dtype=dtype, device=device)   # finite: the loop starts
    hist_x = torch.zeros((m, n_flat), dtype=dtype, device=device)
    hist_f = torch.zeros((m, n_flat), dtype=dtype, device=device)
    eye = 1e-12 * torch.eye(m - 1, dtype=dtype, device=device) if m > 1 else None
    idx = torch.arange(m, device=device)
    step_h = float(step)
    while k < max_iter and step_h >= tol_h and np.isfinite(step_h):
        f = step_map(x) - x
        if accel == "picard":
            x_new = x + picard_omega * f
        else:
            hist_x = torch.roll(hist_x, -1, 0)
            hist_x[-1] = x
            hist_f = torch.roll(hist_f, -1, 0)
            hist_f[-1] = f
            n_valid = min(n_valid + 1, m)
            if n_valid >= 2:
                pair_ok = (idx[:-1] >= (m - n_valid))[:, None]
                d_f = torch.where(pair_ok, hist_f[1:] - hist_f[:-1], zero)
                d_x = torch.where(pair_ok, hist_x[1:] - hist_x[:-1], zero)
                gram = d_f @ d_f.T + eye
                gamma = torch.linalg.solve(gram, d_f @ f)
                x_new = x + f - (d_x + d_f).T @ gamma
            else:
                x_new = x + 0.5 * f
            x_new = torch.where(torch.isfinite(x_new).all(), x_new, x + 0.3 * f)
        step = (x_new - x).abs().max()
        x, k = x_new, k + 1
        step_h = float(step)
    return ReconResult(psi=x.reshape(shape), iterations=k, step=step)


def _ring_mask(shape) -> np.ndarray:
    ring = np.zeros(shape, dtype=bool)
    ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = True
    return ring


def _case_grid(case: "ReconCase", dtype: torch.dtype, device) -> Grid:
    return Grid.from_bounds(
        case.psi.shape[1], case.psi.shape[0], float(case.r[0]), float(case.r[-1]),
        float(case.z[0]), float(case.z[-1]), dtype=dtype, device=device)


def reconstruct(
    case: ReconCase,
    *,
    init: str = "reference",
    accel: str = "anderson",
    anderson_m: int = 8,
    picard_omega: float = 0.5,
    subcell: int = 1,
    n_inner: int = 3,
    max_iter: int = 200,
    tol_rel: float = 1e-9,
    cutoff_width: float = 0.03,
    device: torch.device | str = "cuda",
) -> dict:
    """Run the reproduction lane in float64 on ``device`` (the JAX module's
    type with x64 on); returns psi_fit + the reference metric set.

    ``init="reference"`` warm-starts from the file psi (disclosed reproduction
    mode); ``init="external"`` starts from the external-source-only solve
    (zero plasma current, the basin probe).
    """
    device = torch.device(device)
    dtype = torch.float64
    grid = _case_grid(case, dtype, device)
    psi_ref = torch.as_tensor(case.psi, dtype=dtype).to(device)
    ring = _ring_mask(case.psi.shape)

    if init == "reference":
        x0 = psi_ref.reshape(-1)
    elif init == "external":
        # External-source-only start: solve Delta* psi = external with the
        # file ring (many V-cycles from the ring-padded zero field).
        rhs = torch.as_tensor(np.where(case.model_region, 0.0, case.lap), dtype=dtype).to(device)
        p0 = torch.as_tensor(np.where(ring, case.psi, 0.0), dtype=dtype).to(device)
        p0 = mg_solve(p0, rhs, grid.R, grid.dR, grid.dZ, n_cycles=60)
        x0 = apply_dirichlet(p0, psi_ref).reshape(-1)
    else:
        raise ValueError(f"unknown init {init!r}")

    def t(v):
        return torch.tensor(np.asarray(v), dtype=dtype).to(device)

    res = _reconstruct_impl(
        grid, x0, psi_ref, torch.as_tensor(case.model_region).to(device), t(case.external),
        t(case.pprime), t(case.ffprime), t(case.psi_axis), t(case.psi_bnd), t(case.ip_model),
        t(tol_rel * case.span), t(picard_omega), t(cutoff_width),
        max_iter=max_iter, anderson_m=anderson_m, subcell=subcell, n_inner=n_inner,
        accel=accel)
    psi_fit = res.psi.detach().cpu().numpy().astype(np.float64)
    return {
        "psi_fit": psi_fit,
        "iterations": int(res.iterations),
        "final_step": float(res.step),
        **metrics(case, psi_fit),
    }


def metrics(case: ReconCase, psi_fit: np.ndarray) -> dict:
    """The reference's full-domain metric set (``_full_domain_metrics``)."""
    diff = psi_fit - case.psi
    span = case.span
    psin_map = (case.psi - case.psi_axis) / (case.psi_bnd - case.psi_axis)
    deep = (psin_map < 0.8) & case.plasma
    deep[:2, :] = deep[-2:, :] = False
    deep[:, :2] = deep[:, -2:] = False
    pl_i = case.plasma.copy()
    pl_i[:2, :] = pl_i[-2:, :] = False
    pl_i[:, :2] = pl_i[:, -2:] = False
    rng = float(case.psi.max() - case.psi.min())
    return {
        "deep_rms_rel_span": float(np.sqrt(np.mean(diff[deep] ** 2))) / span
        if deep.any() else float("nan"),
        "deep_max_rel_span": float(np.max(np.abs(diff[deep]))) / span
        if deep.any() else float("nan"),
        "plasma_rms_rel_span": float(np.sqrt(np.mean(diff[pl_i] ** 2))) / span
        if pl_i.any() else float("nan"),
        "axis_value_rel_err": abs(float(np.max(psi_fit[2:-2, 2:-2])) - case.psi_axis) / span,
        "global_max_rel_span": float(np.max(np.abs(diff))) / span,
        "full_domain_rms_rel_span": float(np.sqrt(np.mean(diff**2))) / span,
        "nrmse_range": float(np.sqrt(np.mean(diff**2))) / max(rng, 1e-30),
    }


def _file_model_source(case: ReconCase, device) -> np.ndarray:
    """``_model_source`` of the file psi (subcell 1, cutoff 0.03) in float64
    on ``device``, as numpy."""
    rr = np.broadcast_to(case.r[None, :], case.psi.shape)

    def t(v):
        return torch.tensor(np.asarray(v), dtype=torch.float64).to(device)

    src = _model_source(t(case.psi), t(rr), float(case.r[1] - case.r[0]), t(case.psi_axis),
                        t(case.psi_bnd), t(case.pprime), t(case.ffprime), 1, t(0.03))
    return src.cpu().numpy()


def _mg_solve_np(case: ReconCase, psi0: np.ndarray, rhs: np.ndarray, n_cycles: int,
                 device) -> np.ndarray:
    """``mg_solve`` on the case's grid in float64 on ``device``, as numpy."""
    grid = _case_grid(case, torch.float64, device)
    out = mg_solve(torch.as_tensor(psi0, dtype=torch.float64).to(device),
                   torch.as_tensor(rhs, dtype=torch.float64).to(device),
                   grid.R, grid.dR, grid.dZ, n_cycles=n_cycles)
    return out.cpu().numpy()


def attribution_prediction(case: ReconCase, *, n_cycles: int = 40,
                           device: torch.device | str = "cuda") -> float:
    """First-order prediction of the full-domain reproduction error from the
    fixture's own non-self-consistency.

    The strict fixed point differs from the file psi because inside the
    model region the source is the profile model instead of the measured
    ``Delta* psi``; to first order ``psi* - psi ~ L^{-1} Pi_model
    (S_model(psi) - Delta* psi)``.  One zero-Dirichlet multigrid solve of
    that defect (float64 on ``device``) gives the predicted deep-RMS
    (span-relative).
    """
    rr = np.broadcast_to(case.r[None, :], case.psi.shape)
    d_r = float(case.r[1] - case.r[0])
    d_z = float(case.z[1] - case.z[0])
    src = _file_model_source(case, device)
    dA = d_r * d_z
    ipm = float(np.sum(np.where(case.model_region, -src / (MU0 * rr), 0.0)) * dA)
    scale = case.ip_model / ipm if abs(ipm) > 1e-30 else 1.0
    rhs = np.where(case.model_region, src * scale - case.lap, 0.0)
    e = _mg_solve_np(case, np.zeros(case.psi.shape), rhs, n_cycles, device)
    psin_map = (case.psi - case.psi_axis) / (case.psi_bnd - case.psi_axis)
    deep = (psin_map < 0.8) & case.plasma
    deep[:2, :] = deep[-2:, :] = False
    deep[:, :2] = deep[:, -2:] = False
    if not deep.any():
        return float("nan")
    return float(np.sqrt(np.mean(e[deep] ** 2))) / case.span


def gs_project(
    eq: GEqdsk,
    *,
    rounds_a: int = 10,
    rounds_b: int = 6,
    tol_a: float = 3e-3,
    tol_b: float = 1e-4,
    subcell: int = 4,
    anderson_m: int = 8,
    max_iter: int = 200,
    device: torch.device | str = "cuda",
) -> tuple[GEqdsk, dict]:
    """Project a (possibly non-self-consistent) g-file onto the nearest
    self-consistent GS equilibrium at the same machine parameters.

    Iterates (prepare_case -> reconstruct -> write psi back) until the
    plasma/model masks settle (phase A), re-anchors ``simag`` to the
    projected field's own axis with the profile tables re-sampled onto the
    new psi_N (phase B settles again), and returns a GEQDSK whose psi map,
    anchors and profiles satisfy the GS equation together.  Every
    reconstruction runs in float64 on ``device``.
    """
    def _rounds(cur, max_rounds, tol):
        prev_psi = None
        case = out = None
        for k in range(max_rounds):
            case = prepare_case(cur)
            out = reconstruct(case, subcell=subcell, anderson_m=anderson_m,
                              max_iter=max_iter, device=device)
            psi_star = out["psi_fit"]
            ref = prev_psi if prev_psi is not None else case.psi
            shift = float(np.sqrt(np.mean((psi_star - ref) ** 2))) / case.span
            prev_psi = psi_star
            cur = dataclasses.replace(cur, psirz=(-psi_star if case.flipped else psi_star))
            if shift < tol:
                break
        return cur, case, out, k + 1, shift

    def _reanchor(cur, case, out):
        psi_star = out["psi_fit"]
        axis_new = float(psi_star[2:-2, 2:-2].max())
        bnd = case.psi_bnd
        a = (axis_new - case.psi_axis) / (bnd - case.psi_axis)
        b = (bnd - axis_new) / (bnd - case.psi_axis)
        n = case.pprime.size
        pn_new = np.linspace(0.0, 1.0, n)
        pn_old = np.clip(a + b * pn_new, 0.0, 1.0)
        grid01 = np.linspace(0.0, 1.0, n)
        return dataclasses.replace(
            cur, psirz=psi_star, simag=axis_new, sibry=bnd,
            pprime=np.interp(pn_old, grid01, case.pprime),
            ffprime=np.interp(pn_old, grid01, case.ffprime),
            description=f"gs-projected {cur.description}".strip()[:48])

    cur, case, out, k1, s1 = _rounds(eq, rounds_a, tol_a)
    cur = _reanchor(cur, case, out)
    cur, case, out, k2, s2 = _rounds(cur, rounds_b, tol_b)
    final = _reanchor(cur, case, out)
    info = {"rounds_a": k1, "shift_a": s1, "rounds_b": k2, "shift_b": s2,
            "projection_distance_deep_rms": out["deep_rms_rel_span"]}
    return final, info


def operator_residual(case: ReconCase, *, device: torch.device | str = "cuda") -> dict:
    """Step-1 lane: does the file psi satisfy OUR discrete operator with the
    file profiles?  (the model source in float64 on ``device``)."""
    src = _file_model_source(case, device)
    res = case.lap - src
    lap_scale = float(np.max(np.abs(case.lap[2:-2, 2:-2])))
    psin_map = (case.psi - case.psi_axis) / (case.psi_bnd - case.psi_axis)
    deep = psin_map < 0.8
    deep[:2, :] = deep[-2:, :] = False
    deep[:, :2] = deep[:, -2:] = False
    return {
        "interior_rms_rel": float(np.sqrt(np.mean(res[2:-2, 2:-2] ** 2))) / lap_scale,
        "deep_rms_rel": float(np.sqrt(np.mean(res[deep] ** 2))) / lap_scale,
        "deep_max_rel": float(np.max(np.abs(res[deep]))) / lap_scale,
    }


def refit_profiles(
    case: ReconCase,
    *,
    n_p: int = 4,
    n_f: int = 4,
    n_outer: int = 30,
    n_cycles: int = 30,
    relax: float = 0.7,
    ridge: float = 1e-9,
    ip_weight_scale: float = 1e3,
    cutoff_width: float = 0.03,
    tol_rel: float = 1e-10,
    fit_region: str = "plasma",
    device: torch.device | str = "cuda",
) -> dict:
    """Kinetic-EFIT-style joint p'/FF' re-fit against the RAW file psi.

    * p'(psi_N) and FF'(psi_N) are expanded in monomials ``{psi_N^i}``;
    * at a frozen psi_N map the GS operator is linear in the coefficients,
      so the flux response of every basis element is one zero-Dirichlet
      multigrid solve (plus one file-ring solve of the measured external
      source), float64 on ``device``, all elements in one vmapped solve;
    * the coefficients minimise ``|psi(theta) - psi_file|^2`` over the
      plasma interior with a soft measured-Ip row and a small ridge (host
      ``np.linalg.lstsq``), and the psi_N map is Picard-updated to
      self-consistency, keeping the best iterate.

    Returns the fitted tables on the uniform psi_N grid, the fitted flux map
    with the reference metric set, and the residual decomposition: the part
    of the measured ``Delta* psi`` no flux-function source can represent vs
    the part the fit closes.
    """
    psi_file = case.psi
    rr = np.broadcast_to(case.r[None, :], psi_file.shape)
    d_r = float(case.r[1] - case.r[0])
    d_z = float(case.z[1] - case.z[0])
    dA = d_r * d_z
    span = case.span
    device = torch.device(device)
    grid = _case_grid(case, torch.float64, device)
    r_1d = grid.R

    def solve_many(p0_, sources):
        """All basis responses in one ``torch.func.vmap`` of ``mg_solve``, as
        the JAX module; the start field is mapped too, because the plain sweep
        writes the batched update into a copy of it."""
        solve = torch.func.vmap(
            lambda p, s: mg_solve(p, s, r_1d, grid.dR, grid.dZ, n_cycles=n_cycles))
        return solve(p0_.expand(sources.shape), sources).cpu().numpy()

    ring = _ring_mask(psi_file.shape)
    mask = case.model_region

    # theta-independent part: measured external source, file-ring Dirichlet.
    p0 = torch.as_tensor(np.where(ring, psi_file, 0.0), dtype=torch.float64).to(device)
    u0 = solve_many(p0, torch.as_tensor(case.external, dtype=torch.float64).to(device)[None])[0]

    # Fit region: plasma interior (2-cell border excluded).
    psin_file = (psi_file - case.psi_axis) / (case.psi_bnd - case.psi_axis)
    region = case.plasma.copy() if fit_region == "plasma" else (
        case.plasma & (psin_file < 0.8))
    region[:2, :] = region[-2:, :] = False
    region[:, :2] = region[:, -2:] = False

    n_basis = n_p + n_f
    psi = psi_file.copy()
    history = []
    theta = np.zeros(n_basis)
    denom = case.psi_bnd - case.psi_axis
    zeros = torch.zeros_like(p0)

    for outer in range(n_outer):
        psin = (psi - case.psi_axis) / denom
        support = 1.0 / (1.0 + np.exp(-(1.0 - psin) / cutoff_width))
        x = np.clip(psin, 0.0, 1.0)

        cols_src = []
        for i in range(n_p):
            cols_src.append(np.where(mask, -(MU0 * rr**2 * x**i) * support, 0.0))
        for j in range(n_f):
            cols_src.append(np.where(mask, -(x**j) * support, 0.0))

        # Exact linear responses: L u_i = S_i, zero Dirichlet ring.
        resp = solve_many(zeros, torch.as_tensor(np.stack(cols_src), dtype=torch.float64)
                          .to(device))
        resp = [resp[i] for i in range(n_basis)]

        a = np.stack([u[region] for u in resp], axis=1)
        b = (psi_file - u0)[region]
        # Soft measured-Ip constraint row (kinetic-EFIT style).
        i_rows = np.array([float(np.sum(-s[mask] / (MU0 * rr[mask])) * dA)
                           for s in cols_src])
        w_ip = ip_weight_scale * np.linalg.norm(b) / max(abs(case.ip_model), 1e-30)
        a_aug = np.vstack([a, w_ip * i_rows[None, :]])
        b_aug = np.concatenate([b, [w_ip * case.ip_model]])
        # Column-equilibrated ridge lstsq.
        col = np.maximum(np.linalg.norm(a_aug, axis=0), 1e-300)
        a_n = a_aug / col[None, :]
        theta_n, *_ = np.linalg.lstsq(
            np.vstack([a_n, np.sqrt(ridge) * np.eye(n_basis)]),
            np.concatenate([b_aug, np.zeros(n_basis)]), rcond=None)
        theta = theta_n / col

        psi_lin = u0 + sum(t * u for t, u in zip(theta, resp))
        shift = float(np.sqrt(np.mean((psi_lin - psi)[region] ** 2))) / span
        # Best-iterate safeguard: the Picard map need not contract on a
        # fixture whose source is mostly non-flux-function; keep the iterate
        # whose exact linear solve best matches the file.
        fit_rms = float(np.sqrt(np.mean((psi_lin - psi_file)[region] ** 2))) / span
        if outer == 0 or fit_rms < best_rms:
            best_rms, best_theta, best_psi = fit_rms, theta.copy(), psi_lin
        psi = psi + relax * (psi_lin - psi)
        history.append(shift)
        if shift < tol_rel:
            break

    theta, psi = best_theta, best_psi

    # Fitted tables on the uniform psi_N grid (drop-in for ReconCase).
    xg = np.linspace(0.0, 1.0, case.pprime.size)
    pprime_fit = sum(theta[i] * xg**i for i in range(n_p))
    ffprime_fit = sum(theta[n_p + j] * xg**j for j in range(n_f))

    # Residual decomposition at the FITTED flux map: what part of the
    # measured Delta*psi inside the model region is representable by ANY
    # flux-function source of this basis (fit closes it) vs the fixture's
    # irreducible non-flux-function content.
    psin = (psi - case.psi_axis) / denom
    support = 1.0 / (1.0 + np.exp(-(1.0 - psin) / cutoff_width))
    x = np.clip(psin, 0.0, 1.0)
    s_fit = -(MU0 * rr**2 * sum(theta[i] * x**i for i in range(n_p))
              + sum(theta[n_p + j] * x**j for j in range(n_f))) * support
    deep = case.plasma & (psin_file < 0.8)
    deep[:2, :] = deep[-2:, :] = False
    deep[:, :2] = deep[:, -2:] = False
    lap_norm = float(np.linalg.norm(case.lap[deep]))
    res_fit_rel = float(np.linalg.norm((case.lap - s_fit)[deep])) / max(lap_norm, 1e-30)

    return {
        "psi_fit": psi,
        "theta": theta,
        "pprime_fit": pprime_fit,
        "ffprime_fit": ffprime_fit,
        "outer_iterations": len(history),
        "final_shift": history[-1] if history else float("nan"),
        "best_fit_rms_rel_span": best_rms,
        "nonflux_residual_rel_l2_deep": res_fit_rel,
        "table_residual_rel_l2_deep": case.source_best_fit_rel_l2,
        "flux_function_floor_rel_l2_deep": flux_function_floor(case),
        **metrics(case, psi),
    }


def flux_function_floor_field(case: ReconCase, *, n_bins: int = 16, n_cycles: int = 40,
                              device: torch.device | str = "cuda") -> dict:
    """Flux error of the SOURCE-space-optimal flux-function fit.

    Computes the least-squares-optimal free-per-bin flux-function source
    over the model region, solves the zero-Dirichlet error equation for its
    residual (``psi_file - psi_fit = L^-1 Pi_model(lap - S_fit)``; float64
    on ``device``) and returns that error's deep-RMS / NRMSE.  A reference
    point, not a lower bound: the refit optimises in flux space and may land
    below it."""
    psin = (case.psi - case.psi_axis) / (case.psi_bnd - case.psi_axis)
    deep = case.plasma & (psin < 0.8)
    deep[:2, :] = deep[-2:, :] = False
    deep[:, :2] = deep[:, -2:] = False
    mask = case.model_region
    rr = np.broadcast_to(case.r[None, :], case.psi.shape)
    x = np.clip(psin, 0.0, 1.0)
    bins = np.clip((x * n_bins).astype(int), 0, n_bins - 1)
    s_fit = np.zeros_like(case.psi)
    for b in range(n_bins):
        m = mask & (bins == b)
        if m.sum() < 3:
            continue
        a_m = np.stack([-(MU0 * rr**2)[m], -np.ones(int(m.sum()))], axis=1)
        coef, *_ = np.linalg.lstsq(a_m, case.lap[m], rcond=None)
        s_fit[m] = a_m @ coef
    rho = np.where(mask, case.lap - s_fit, 0.0)
    e = _mg_solve_np(case, np.zeros(case.psi.shape), rho, n_cycles, device)
    return {
        "floor_deep_rms_rel_span": (float(np.sqrt(np.mean(e[deep] ** 2)))
                                    / case.span if deep.any()
                                    else float("nan")),
        "floor_nrmse_range": float(np.sqrt(np.mean(e**2))) / max(
            float(case.psi.max() - case.psi.min()), 1e-30),
    }


def flux_function_floor(case: ReconCase, *, n_bins: int = 16) -> float:
    """MODEL-FREE flux-function representability floor of the fixture.

    Best-fits ``Delta* psi = -(mu0 R^2 a(psi_N) + b(psi_N))`` over the deep
    plasma with FREE per-psi_N-bin coefficients (a, b) — the least-squares
    optimum over ALL flux-function source pairs, no basis restriction —
    and returns the relative L2 residual.  A large value proves the
    measured source is structurally NOT a flux function (the
    damped-Solov'ev fixtures violate the GS ansatz itself), so NO profile
    re-fit of any richness can reproduce the file psi below the
    corresponding elliptic-smoothed floor: this is the quantified
    "irreducible floor" of the ``diiid_jet_refit_strict`` lane.
    """
    psin = (case.psi - case.psi_axis) / (case.psi_bnd - case.psi_axis)
    deep = case.plasma & (psin < 0.8)
    deep[:2, :] = deep[-2:, :] = False
    deep[:, :2] = deep[:, -2:] = False
    if not deep.any():
        return float("nan")
    rr = np.broadcast_to(case.r[None, :], case.psi.shape)
    bins = np.clip((psin[deep] * n_bins).astype(int), 0, n_bins - 1)
    lap_d = case.lap[deep]
    r2 = (MU0 * rr**2)[deep]
    resid2 = 0.0
    tot2 = float(np.sum(lap_d**2))
    for b in range(n_bins):
        m = bins == b
        if m.sum() < 3:
            resid2 += float(np.sum(lap_d[m] ** 2))
            continue
        a_m = np.stack([-r2[m], -np.ones(int(m.sum()))], axis=1)
        coef, *_ = np.linalg.lstsq(a_m, lap_d[m], rcond=None)
        resid2 += float(np.sum((lap_d[m] - a_m @ coef) ** 2))
    return float(np.sqrt(resid2 / max(tot2, 1e-300)))
