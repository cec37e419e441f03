"""Batched equilibrium ensembles (port of
``scpn_fusion_tpu/parallel/ensemble.py``).

Whole nonlinear Picard solves over coil-current / target-current
ensembles, as one batched loop: the JAX module vmaps the compiled solve;
here the loop carries every field of JAX's ``_Carry`` with a leading batch
axis, and each iteration is one step of the whole batch and one host read of
the (B,) activity mask.  The step is the single solve's own
(``fixed_boundary._Picard``: seed, source, elliptic dispatch, relaxation,
Anderson cadence and mix) given batched callables; only the carry is kept
differently.  An element is active while ``k < max_iter``, it has not
converged and its update norm is finite; the step is computed for every
element and an inactive one keeps its old carry (``torch.where`` of the
whole carry, JAX's ``guarded_body``), so every element follows its
standalone solve's trajectory and stops at its standalone iteration count.
Active elements share one iteration count, so the Anderson history depth and
the every-third-step mix stay host decisions, and the mix is batched
(``torch.linalg.solve_ex`` on (B, m-1, m-1)).

Kernels: with ``cfg.solver.use_pallas`` on a CUDA float32 batch (the
port's rule for a single solve), each iteration runs the batched kernel 2,
``ops/cuda_source.fused_topology_source_batched`` (three launches for the
whole batch, each element its own I_target), and, for the ``multigrid`` /
``anderson_mg`` methods on a square 2^k+1 grid up to 257^2, the batched
kernel 3, ``ops/cuda_mg.fused_coarse_vcycle_batched`` (one launch of B
clusters): the counterpart of JAX's vmapped ``pallas_call``\\ s.  Where the
batch is not batched: above 257^2 (the fine legs at 513^2, the tiled legs
beyond), on other grids, and for the ``sor`` / ``anderson`` methods (the SOR
kernel), the elliptic step launches the single-solve kernels once an
element.  Without kernels (the CPU, float64, ``use_pallas`` off) every step
is the single solve's plain step over the batch by ``torch.func.vmap``.

With a ``mesh`` the batch is cut into one chunk a device of its batch axis.
The chunks are stepped in lockstep: each iteration is queued on every
running chunk's device before one host read of all their masks, so the
devices work at the same time, as JAX's shards do; a chunk whose elements
have all stopped drops out, and the frozen semantics make that JAX's global
loop.  Results are gathered on the mesh's first device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import torch
from torch.func import vmap

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
    _as_dtype,
    _elliptic,
    _Picard,
    _plain_source,
    _seed_psi,
)
from scpn_fusion_tpu_torch.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import coil_response_table
from scpn_fusion_tpu_torch.ops.cuda_mg import MAX_ENTRY, is_pow2_plus1_square
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl
from scpn_fusion_tpu_torch.ops.stencil import gs_residual, gs_residual_rms
from scpn_fusion_tpu_torch.parallel.mesh import Mesh


class BatchResult(NamedTuple):
    """``solve_equilibrium_batch``'s result (JAX's tuple)."""

    psi: torch.Tensor          # (B, NZ, NR)
    converged: torch.Tensor    # (B,) bool
    iterations: torch.Tensor   # (B,) int64


class MixedBatchResult(NamedTuple):
    """``solve_equilibrium_batch_mixed``'s result (JAX's tuple)."""

    psi: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    gs_residual_best: torch.Tensor


class _Carry(NamedTuple):
    """JAX's ``_Carry`` with a leading batch axis on every field (the shared
    iteration count and history depth live on the host)."""

    psi: torch.Tensor
    diff: torch.Tensor
    gs_res: torch.Tensor
    converged: torch.Tensor
    best_diff: torch.Tensor
    best_psi: torch.Tensor
    gs_best: torch.Tensor
    res_hist: torch.Tensor
    gs_hist: torch.Tensor
    psi_buf: torch.Tensor
    f_buf: torch.Tensor
    iterations: torch.Tensor


def _batched(one, psi: torch.Tensor, source: torch.Tensor, use_pallas: bool) -> torch.Tensor:
    """``one(psi, source)`` on every element of a batch: once an element
    where it launches kernels, by ``vmap`` in plain ops."""
    if use_pallas:
        return torch.stack([one(p, s) for p, s in zip(psi, source)])
    return vmap(one)(psi, source)


def batched_vcycle(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, d_r: float,
                   d_z: float, *, use_pallas: bool, pre_smooth: int = 3, post_smooth: int = 3,
                   min_grid: int = 5) -> torch.Tensor:
    """One V-cycle (omega 1, 50 coarse sweeps) on every element of a (B, NZ,
    NR) batch: one launch of the batched kernel 3 where the single solve
    takes kernel 3, the single solve's kernel route once an element on other
    kernel paths, the plain cycle by ``vmap`` without kernels."""
    nz, nr = psi.shape[1:]
    if use_pallas and is_pow2_plus1_square((nz, nr)) and min_grid < nz <= MAX_ENTRY:
        from scpn_fusion_tpu_torch.ops import cuda_mg
        return cuda_mg.fused_coarse_vcycle_batched(psi, source, r_1d, d_r, d_z, 1.0,
                                                   pre_smooth=pre_smooth,
                                                   post_smooth=post_smooth, min_grid=min_grid,
                                                   coarse_sweeps=50)
    return _batched(lambda p, s: _vcycle_impl(p, s, r_1d, d_r, d_z, 1.0, pre_smooth,
                                              post_smooth, min_grid, 50, use_pallas),
                    psi, source, use_pallas)


def make_refinement_elliptic_batched(grid: Grid, *, n_refine: int = 2,
                                     use_pallas: bool = False):
    """``mixed_precision.make_refinement_elliptic`` for a batch: ``n_refine``
    rounds of { f64 defect of every element -> one f32 V-cycle on every
    element (:func:`batched_vcycle`) -> f64 update }."""
    r64 = grid.R.to(torch.float64)
    r32 = grid.R.to(torch.float32)
    d_r, d_z = float(grid.dR), float(grid.dZ)
    defect = vmap(lambda p, s: gs_residual(p, s, r64, d_r, d_z))

    def elliptic(psi64: torch.Tensor, source64: torch.Tensor) -> torch.Tensor:
        p64 = psi64
        for _ in range(n_refine):
            defect32 = defect(p64, source64).to(torch.float32)
            e32 = batched_vcycle(torch.zeros_like(defect32), defect32, r32, d_r, d_z,
                                 use_pallas=use_pallas)
            p64 = p64 + e32.to(torch.float64)
        return p64

    return elliptic


class _BatchPicard:
    """``fixed_boundary.solve_fixed_boundary_impl`` on a batch of boundary
    fluxes ``psi_bc`` (B, NZ, NR) and target currents ``i_t`` (B,), each
    element seeded from its own vacuum field and stepped by the single
    solve's ``_Picard`` with batched callables.  :meth:`step` queues one
    iteration of the whole batch and returns its (B,) activity mask on the
    device; :meth:`advance` takes that mask read on the host."""

    def __init__(self, grid: Grid, psi_bc: torch.Tensor, i_t: torch.Tensor, p_coeffs, ff_coeffs,
                 tol: float, gs_tol: float, alpha_relax: float, omega: float, *,
                 solver_method: str, max_iter: int, h_mode: bool, inner_sweeps: int,
                 anderson_m: int, mu0: float, use_gs_criterion: bool, use_pallas: bool,
                 elliptic_fn=None, anderson_gram_f32: bool = False):
        r_1d, d_r, d_z = grid.R, grid.dR, grid.dZ
        dtype, device = psi_bc.dtype, psi_bc.device
        n_b = psi_bc.shape[0]
        use_anderson = solver_method in ("anderson", "anderson_mg")
        m_hist = anderson_m if use_anderson else 1
        self.device, self.tol, self.gs_tol, self.max_iter = device, tol, gs_tol, max_iter
        self.use_gs_criterion = use_gs_criterion

        psi = vmap(lambda p, it: _seed_psi(grid, p, it, mu0))(psi_bc, i_t)

        if elliptic_fn is None:
            def one(p, s):
                return _elliptic(p, s, r_1d, d_r, d_z, solver_method=solver_method,
                                 inner_sweeps=inner_sweeps, omega=omega, use_pallas=use_pallas)

            def elliptic_fn(p: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
                if solver_method in ("multigrid", "anderson_mg"):
                    return batched_vcycle(p, source, r_1d, d_r, d_z, use_pallas=use_pallas)
                return _batched(one, p, source, use_pallas)

        if use_pallas:
            from scpn_fusion_tpu_torch.ops import cuda_source
            divertor_mask = (grid.ZZ < (grid.Z_min * 0.5)).to(dtype).contiguous()
            params = cuda_source.pack_source_params_batched(p_coeffs, ff_coeffs, i_t, like=psi)

            def picard_source(p: torch.Tensor) -> torch.Tensor:
                return cuda_source.fused_topology_source_batched(
                    p, r_1d, divertor_mask, params, d_r=d_r, d_z=d_z, mu0=mu0, h_mode=h_mode)
        else:
            plain = vmap(lambda p, it: _plain_source(p, it, grid, p_coeffs, ff_coeffs, mu0,
                                                     h_mode))

            def picard_source(p: torch.Tensor) -> torch.Tensor:
                return plain(p, i_t)

        self.picard = _Picard(picard_source, elliptic_fn,
                              vmap(lambda p, s: gs_residual_rms(p, s, r_1d, d_r, d_z)), psi_bc,
                              alpha_relax, use_anderson, anderson_gram_f32, use_gs_criterion)

        def full(value, dt=dtype):
            return torch.full((n_b,), value, dtype=dt, device=device)

        hist = torch.full((n_b, max_iter), math.nan, dtype=dtype, device=device)
        buf = torch.zeros((n_b, m_hist) + tuple(psi.shape[1:]), dtype=dtype, device=device)
        self.c = _Carry(
            psi=psi, diff=full(1e30), gs_res=full(math.inf), converged=full(False, torch.bool),
            best_diff=full(math.inf), best_psi=psi, gs_best=full(math.inf), res_hist=hist,
            gs_hist=hist.clone(), psi_buf=buf, f_buf=buf.clone(),
            iterations=full(0, torch.int64))
        self.nan = full(math.nan)
        self.k, self.n_valid = 0, 0
        self.active = torch.ones(n_b, dtype=torch.bool, device=device)
        self.all_active = True
        self.running = max_iter > 0

    def step(self) -> torch.Tensor:
        """Queue iteration ``k`` of every element; returns the new (B,)
        activity mask (not converged, a finite update norm) on the device."""
        c, k = self.c, self.k
        psi_next, diff, gs_res, psi_buf, f_buf, self.n_valid = self.picard.step(
            c.psi, c.psi_buf, c.f_buf, self.n_valid, k)
        if self.use_gs_criterion:
            gs_best = torch.minimum(gs_res, c.gs_best)
            converged = (diff < self.tol) & (gs_res < self.gs_tol)
        else:
            gs_res, gs_best = self.nan, c.gs_best
            converged = diff < self.tol
        improved = diff < c.best_diff
        res_hist, gs_hist = c.res_hist.clone(), c.gs_hist.clone()
        res_hist[:, k] = diff
        gs_hist[:, k] = gs_res
        new = _Carry(
            psi=psi_next, diff=diff, gs_res=gs_res, converged=converged,
            best_diff=torch.where(improved, diff, c.best_diff),
            best_psi=torch.where(improved[:, None, None], psi_next, c.best_psi),
            gs_best=gs_best, res_hist=res_hist, gs_hist=gs_hist, psi_buf=psi_buf, f_buf=f_buf,
            iterations=c.iterations + 1)
        if self.all_active:
            self.c = new
        else:   # guarded_body: a finished element keeps its carry
            self.c = _Carry(*(torch.where(self.active.reshape((-1,) + (1,) * (a.dim() - 1)),
                                          a, b) for a, b in zip(new, c)))
        self.k += 1
        self.active = ~self.c.converged & torch.isfinite(self.c.diff)
        return self.active

    def advance(self, active_h: torch.Tensor) -> bool:
        """Take the host copy of :meth:`step`'s mask; whether the batch runs
        on (``k < max_iter`` and an element still active)."""
        self.all_active = bool(active_h.all())
        self.running = self.k < self.max_iter and bool(active_h.any())
        return self.running

    def result(self):
        """The final carry, the returned psi (the best state of a diverged
        element) and the divergence flags."""
        diverged = ~torch.isfinite(self.c.diff)
        return self.c, torch.where(diverged[:, None, None], self.c.best_psi, self.c.psi), diverged


def _on(device: torch.device):
    """The CUDA device context of ``device`` (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _run_lockstep(loops: list[_BatchPicard]) -> None:
    """Step every batch to its end: each iteration is queued on every
    running batch's device before one host read of all their masks."""
    running = [lp for lp in loops if lp.running]
    while running:
        masks = []
        for lp in running:
            with _on(lp.device):
                masks.append(lp.step())
        running = [lp for lp, m in zip(running, masks) if lp.advance(m.cpu())]


def _chunks(mesh: Mesh | None, batch_axis: str, device: torch.device, *tensors):
    """The batch cut into one chunk a device of ``mesh[batch_axis]`` (the
    whole batch on ``device`` without a mesh): ``[(device, tensors), ...]``."""
    if mesh is None:
        return [(device, tuple(t.to(device) for t in tensors))]
    n = mesh.shape[batch_axis]
    if n != mesh.size:
        raise ValueError(f"ensemble: {mesh} is not a mesh over {batch_axis!r} alone")
    parts = [t.tensor_split(n) for t in tensors]
    return [(d, tuple(p[i].to(d) for p in parts)) for i, d in enumerate(mesh.devices)
            if parts[0][i].shape[0] > 0]


def _problem(cfg: ReactorConfig, grid: Grid, dtype: torch.dtype, device: torch.device):
    grid = dataclasses.replace(grid, dtype=dtype, device=device)
    coil_r = torch.tensor([c.r for c in cfg.coils], dtype=dtype, device=device)
    coil_z = torch.tensor([c.z for c in cfg.coils], dtype=dtype, device=device)
    mu0 = float(cfg.physics.vacuum_permeability)
    table = coil_response_table(grid, coil_r, coil_z, mu0)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype, device)
    return grid, table, p_c, ff_c, mu0


def _solve_chunks(cfg, grid, coil_currents, i_targets, mesh, batch_axis, *, mixed: bool,
                  n_refine: int = 2):
    dtype = torch.float64 if mixed else coil_currents.dtype
    sol = cfg.solver
    h_mode = cfg.physics.profile_mode == "h-mode"
    chunks = []
    for device, (cur, i_t) in _chunks(mesh, batch_axis, grid.device,
                                      coil_currents.to(dtype), i_targets.to(dtype)):
        g, table, p_c, ff_c, mu0 = _problem(cfg, grid, dtype, device)
        psi_bc = (cur[:, :, None, None] * table[None]).sum(1)
        kernels = sol.use_pallas and device.type == "cuda"
        if mixed:
            gs_tol = sol.gs_residual_threshold if sol.gs_residual_threshold > 0 else math.inf
            extra = dict(use_gs_criterion=sol.gs_residual_threshold > 0, use_pallas=False,
                         elliptic_fn=make_refinement_elliptic_batched(g, n_refine=n_refine,
                                                                      use_pallas=kernels),
                         anderson_gram_f32=True)
        else:
            gs_tol = math.inf
            extra = dict(use_gs_criterion=False,
                         use_pallas=kernels and dtype == torch.float32)
        with _on(device):
            loop = _BatchPicard(
                g, psi_bc, i_t, p_c, ff_c, _as_dtype(sol.convergence_threshold, dtype),
                _as_dtype(gs_tol, dtype), _as_dtype(sol.relaxation_factor, dtype),
                _as_dtype(sol.sor_omega, dtype), solver_method=sol.solver_method,
                max_iter=sol.max_iterations, h_mode=h_mode, inner_sweeps=sol.inner_sweeps,
                anderson_m=sol.anderson_depth, mu0=mu0, **extra)
        chunks.append((g, i_t, p_c, ff_c, mu0, loop))
    _run_lockstep([chunk[-1] for chunk in chunks])
    outs = []
    for g, i_t, p_c, ff_c, mu0, loop in chunks:
        c, psi_out, diverged = loop.result()
        out = [psi_out, c.converged & ~diverged, c.iterations]
        if mixed:
            src = vmap(lambda p, it: _plain_source(p, it, g, p_c, ff_c, mu0, h_mode))(psi_out,
                                                                                     i_t)
            gs_final = vmap(lambda p, s: gs_residual_rms(p, s, g.R, g.dR, g.dZ))(psi_out, src)
            out.append(torch.minimum(c.gs_best, gs_final))
        outs.append(out)
    home = grid.device if mesh is None else mesh.first
    return [torch.cat([o[i].to(home) for o in outs]) for i in range(len(outs[0]))]


def solve_equilibrium_batch(cfg: ReactorConfig, grid: Grid, coil_currents: torch.Tensor,
                            i_targets: torch.Tensor, *, mesh: Mesh | None = None,
                            batch_axis: str = "batch") -> BatchResult:
    """Solve a batch of fixed-boundary equilibria: element b has the
    effective coil currents ``coil_currents[b]`` (B, n_coils) and the target
    current ``i_targets[b]``.  The solve runs on ``grid``'s device (CUDA by
    default) in ``coil_currents``' dtype, or, with ``mesh``, each chunk of
    the batch on its device, the chunks in lockstep.  Returns ``(psi (B, NZ,
    NR), converged (B,), iterations (B,))``."""
    return BatchResult(*_solve_chunks(cfg, grid, coil_currents, i_targets, mesh, batch_axis,
                                      mixed=False))


def solve_equilibrium_batch_mixed(cfg: ReactorConfig, grid: Grid, coil_currents: torch.Tensor,
                                  i_targets: torch.Tensor, *, n_refine: int = 2,
                                  mesh: Mesh | None = None,
                                  batch_axis: str = "batch") -> MixedBatchResult:
    """Batched mixed-precision solves: the f64 master iterate, source,
    Anderson mix (Gram in f32) and criterion, with an f32 multigrid
    defect-correction elliptic step (:func:`make_refinement_elliptic_batched`).

    JAX keeps its Pallas V-cycle off here because Mosaic cannot legalise
    the i64 batch-grid indices that vmap adds under x64; nothing of that
    holds on CUDA.  So on a CUDA grid with ``cfg.solver.use_pallas`` the f32
    V-cycles of the refinement take the batched kernel 3 (one launch for
    the batch, up to 257^2), as the unbatched mixed solve takes kernel 3;
    the f64 parts are plain ops.  Returns ``(psi, converged, iterations,
    gs_residual_best)``."""
    return MixedBatchResult(*_solve_chunks(cfg, grid, coil_currents, i_targets, mesh,
                                           batch_axis, mixed=True, n_refine=n_refine))
