"""Sharding of the 5D nonlinear gyrokinetic state over a device mesh (port
of ``scpn_fusion_tpu/parallel/gk_shard.py``).

JAX lays f(s, kx, ky, theta, vpar, mu) out with a ``NamedSharding`` and lets
GSPMD partition the one jitted stepper, inserting the collectives.  PyTorch
has no partitioner, so this module writes the same program out on the
port's single-controller mesh (``parallel/mesh.py``): a sharded f is a list
of per-shard blocks, f cut along kx ('sx'), ky ('sy') and mu ('v'), and each
RK4 step runs ``nonlinear._rk4_step``'s order on the blocks, with the
collective contract that JAX's docstrings state:

* **velocity moments** (the field solves, the conservative collision
  moments, the diagnostics): partial sums on each shard, then a ``psum``
  over 'v'; phi, A_par and B_par stay (sx, sy)-sharded, and the (kx, ky) =
  (0, 0) mode is zeroed only on the shard that holds it;
* **CFL dt**: a ``pmax`` of max |phi| over the (kx, ky) tiles; the grid
  maxima come from the whole grids;
* **ExB bracket**: a pencil transform, two ``all_to_all`` transposes inside
  each (sx, sy) group (theta planes out, kx in over 'sx'; then ky in over
  'sy'), so each shard holds whole (kx, ky) planes for its share of theta,
  runs the batched ``ifft2`` / ``fft2`` and the dealias mask there, and the
  inverse transposes bring the result back; phi goes through the same
  transposes;
* **ballooning twist**: an ``all_gather`` along 'sx' of the four boundary
  theta planes, the kx FFT and the phase, then the shard's kx rows; parallel
  streaming stays local, because theta is not sharded;
* **the stage**: one :func:`~scpn_fusion_tpu_torch.ops.cuda_gk.gk_stage`
  launch of row G (``csrc/gk_rhs.cu``) a shard a stage, on the shard's
  blocks and its own ``GKGrids`` (the tables sliced at its global kx, ky and
  mu indices) and ``GKStageSpec``; on CPU shards its plain version;
* **diagnostics**: partial sums, then a ``psum`` over every axis; the trace
  is replicated (kept on the mesh's first device).

The sharded runs are not bit-equal to the monolithic one: the ``psum``
changes the order of the reductions.  A mesh of shards of one card
(``Mesh.of(("cuda:0",) * 8, ...)``) checks the arithmetic and the launch
structure, not an interconnect.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import (
    GKGrids,
    GKState,
    GKTrace,
    NonlinearGKConfig,
    build_grids,
    init_state,
)
from scpn_fusion_tpu_torch.ops import cuda_gk
from scpn_fusion_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_to_all,
    make_mesh,
    pmax,
    psum,
)


def _mesh(devices, n: int, axes: tuple[str, ...], sizes: tuple[int, ...], device) -> Mesh:
    if devices is None:
        return make_mesh(n, axes, sizes, device)
    return Mesh.of(list(devices)[:n], axes, sizes)


def velocity_mesh(n_devices: int | None = None, devices=None,
                  device: torch.device | str = "cuda") -> Mesh:
    """1D mesh over the 'v' (velocity / mu) axis: ``n_devices`` of
    ``device``'s type (every CUDA device by default), or ``devices``."""
    if devices is not None:
        devices = list(devices)[:n_devices]
        return Mesh.of(devices, ("v",))
    return make_mesh(n_devices, ("v",), None, device)


def spatial_velocity_mesh(n_ky: int, n_v: int, devices=None,
                          device: torch.device | str = "cuda") -> Mesh:
    """2D (sy, v) mesh: toroidal spectral axis x velocity axis."""
    return _mesh(devices, n_ky * n_v, ("sy", "v"), (n_ky, n_v), device)


def spatial_mesh_3d(n_kx: int, n_ky: int, n_v: int, devices=None,
                    device: torch.device | str = "cuda") -> Mesh:
    """3D (sx, sy, v) mesh: radial x toroidal spectral axes x velocity."""
    return _mesh(devices, n_kx * n_ky * n_v, ("sx", "sy", "v"), (n_kx, n_ky, n_v), device)


def ensemble_mesh(n_data: int, n_v: int, devices=None,
                  device: torch.device | str = "cuda") -> Mesh:
    """2D (data, v) mesh for sharded flux-tube ensembles."""
    return _mesh(devices, n_data * n_v, ("data", "v"), (n_data, n_v), device)


# ---------------------------------------------------------------------------
# Layout and sharded state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """f of one run cut into n_sx x n_sy x n_v blocks, shard (i, j, k) on
    ``mesh.devices[(i * n_sy + j) * n_v + k]``."""

    mesh: Mesh
    n_sx: int
    n_sy: int
    n_v: int

    @classmethod
    def of(cls, mesh: Mesh) -> "_Layout":
        shape = mesh.shape
        extra = set(shape) - {"sx", "sy", "v"}
        if extra:
            raise ValueError(f"a GK state mesh has axes among sx, sy, v; got {mesh.axis_names}")
        return cls(mesh, shape.get("sx", 1), shape.get("sy", 1), shape.get("v", 1))

    @property
    def index(self) -> list[tuple[int, int, int]]:
        """(i, j, k) of each shard, in mesh order."""
        return [(i, j, k) for i in range(self.n_sx) for j in range(self.n_sy)
                for k in range(self.n_v)]

    def groups(self, axis: str) -> list[list[int]]:
        """The shards of each group along ``axis`` ('sx', 'sy' or 'v'): the
        shards that differ only in that axis's index, in that index's order."""
        pos = {"sx": 0, "sy": 1, "v": 2}[axis]
        out: dict = {}
        for s, ijk in enumerate(self.index):
            out.setdefault(ijk[:pos] + ijk[pos + 1:], []).append(s)
        return list(out.values())


@dataclasses.dataclass(frozen=True)
class ShardedGKState:
    """A GK state sharded over a mesh: ``shards`` are f's blocks (S, n_kx /
    sx, n_ky / sy, n_theta, n_vpar, n_mu / v), each on its shard's device, in
    mesh order; ``time`` is replicated (on the mesh's first device).  ``f``
    is the global array, gathered on the mesh's first device, as a sharded
    ``jax.Array`` is one global array."""

    shards: tuple[torch.Tensor, ...]
    time: torch.Tensor
    layout: _Layout

    @property
    def f(self) -> torch.Tensor:
        lay, home = self.layout, self.layout.mesh.first
        it = iter(self.shards)
        rows = []
        for _ in range(lay.n_sx):
            cols = [torch.cat([next(it).to(home) for _ in range(lay.n_v)], 5)
                    for _ in range(lay.n_sy)]
            rows.append(torch.cat(cols, 2))
        return torch.cat(rows, 1)


def _shard_f(f: torch.Tensor, layout: _Layout) -> tuple[torch.Tensor, ...]:
    blocks = [kb for xb in f.chunk(layout.n_sx, 1) for yb in xb.chunk(layout.n_sy, 2)
              for kb in yb.chunk(layout.n_v, 5)]
    return tuple(b.contiguous().to(d) for b, d in zip(blocks, layout.mesh.devices))


def _sharded(state, mesh: Mesh, axes: tuple[str, ...]) -> ShardedGKState:
    layout = _Layout.of(mesh)
    if set(mesh.axis_names) != set(axes):
        raise ValueError(f"a mesh with axes {axes} expected, got {mesh.axis_names}")
    return ShardedGKState(_shard_f(state.f, layout), state.time.to(mesh.first), layout)


def state_sharding(mesh: Mesh) -> tuple:
    """f is sharded along mu (last axis); time replicated: the partition
    spec, one mesh axis (or None) a dim of f."""
    return (None, None, None, None, None, "v")


def shard_state(state, mesh: Mesh) -> ShardedGKState:
    return _sharded(state, mesh, ("v",))


def spatial_state_sharding(mesh: Mesh) -> tuple:
    """f(S, kx, ky, theta, vpar, mu) sharded along ky ('sy') and mu ('v'):
    the partition spec.  The collective contract is this module's
    docstring's: the bracket's pencil transposes over 'sy', the velocity
    moments' psum over 'v', the diagnostics' over both."""
    return (None, None, "sy", None, None, "v")


def shard_state_spatial(state, mesh: Mesh) -> ShardedGKState:
    return _sharded(state, mesh, ("sy", "v"))


def spatial_state_sharding_3d(mesh: Mesh) -> tuple:
    """f(S, kx, ky, theta, vpar, mu) sharded along kx ('sx'), ky ('sy') and
    mu ('v'): the partition spec.  Beyond :func:`spatial_state_sharding`'s
    contract: the bracket's first transpose over 'sx', and the ballooning
    twist's all_gather of the four boundary theta planes along 'sx'."""
    return (None, "sx", "sy", None, None, "v")


def shard_state_spatial_3d(state, mesh: Mesh) -> ShardedGKState:
    return _sharded(state, mesh, ("sx", "sy", "v"))


def per_device_state_bytes(state: ShardedGKState) -> dict:
    """Memory footprint of the sharded 5D state: bytes held by each shard
    (``numel() * element_size()`` of its block) against the monolithic
    array."""
    shard_bytes = sorted({s.numel() * s.element_size() for s in state.shards})
    lay = state.layout
    first = state.shards[0]
    mono = (first.numel() * first.element_size()) * lay.n_sx * lay.n_sy * lay.n_v
    return {
        "monolithic_bytes": int(mono),
        "bytes_per_device": int(shard_bytes[-1]),
        "n_shards": len(state.shards),
        "reduction_factor": float(mono) / float(shard_bytes[-1]),
    }


# ---------------------------------------------------------------------------
# The sharded program
# ---------------------------------------------------------------------------

class _Plane(NamedTuple):
    """Whole-(kx, ky) tables for ``nonlinear.exb_bracket`` on a shard."""

    kx: torch.Tensor
    ky: torch.Tensor
    dealias_mask: torch.Tensor


def _shard_grids(g: GKGrids, xs: slice, ys: slice, ms: slice, dev) -> GKGrids:
    """``g`` at the shard's global (kx, ky, mu) indices, on ``dev``."""
    def on(t):
        return t.contiguous().to(dev)
    return GKGrids(**{name: on(t) for name, t in g._asdict().items()})._replace(
        kx=on(g.kx[xs]), ky=on(g.ky[ys]), kperp2=on(g.kperp2[xs, ys]),
        dealias_mask=on(g.dealias_mask[xs, ys]), ball_phase_fwd=on(g.ball_phase_fwd[xs, ys]),
        ball_phase_bwd=on(g.ball_phase_bwd[xs, ys]), mu=on(g.mu[ms]),
        maxwellian=on(g.maxwellian[:, ms]), energy=on(g.energy[:, ms]))


class _ShardedRun:
    """One run's grids, specs and collectives over a :class:`_Layout`, built
    once a run; :meth:`step` is ``nonlinear._rk4_step`` on the blocks."""

    def __init__(self, cfg: NonlinearGKConfig, g: GKGrids, layout: _Layout):
        self.cfg, self.g, self.layout = cfg, g, layout
        nx, ny, nm = cfg.n_kx // layout.n_sx, cfg.n_ky // layout.n_sy, cfg.n_mu // layout.n_v
        self.nx = nx
        self.devices = layout.mesh.devices
        self.index = layout.index
        self.grids, self.planes, self.twist = [], [], []
        for (i, j, k), dev in zip(self.index, self.devices):
            xs, ys = slice(i * nx, (i + 1) * nx), slice(j * ny, (j + 1) * ny)
            self.grids.append(_shard_grids(g, xs, ys, slice(k * nm, (k + 1) * nm), dev))
            self.planes.append(_Plane(g.kx.to(dev), g.ky.to(dev), g.dealias_mask.to(dev)))
            bwd, fwd = g.ball_phase_bwd[:, ys], g.ball_phase_fwd[:, ys]
            self.twist.append(torch.stack([bwd, bwd, fwd, fwd], dim=-1).to(dev))
        self.specs = [nl.stage_spec(cfg, gs) for gs in self.grids]
        cdt = nl._dtypes(cfg)[0]
        gram_inv = nl._gram_inv(cfg, g, cdt)
        self.gram_inv = [None if gram_inv is None else gram_inv.to(d) for d in self.devices]
        # the shards that hold the (kx, ky) = (0, 0) mode, and one shard a
        # (kx, ky) tile (its v index 0) for the tile sums of replicated fields
        self.origin = [i == 0 and j == 0 for i, j, _ in self.index]
        self.tile_rep = [s for s, (_, _, k) in enumerate(self.index) if k == 0]
        self.v_groups = layout.groups("v")
        self.sx_groups = layout.groups("sx")
        self.sy_groups = layout.groups("sy")
        self.n_act = 2 if (cfg.n_species >= 2 and cfg.kinetic_electrons) else 1

    # -- collectives over groups ------------------------------------------

    def _over(self, groups, parts, collective, *args) -> list:
        """``collective`` over each group of ``groups``, the parts of every
        shard handed back in shard order."""
        out = [None] * len(parts)
        for grp in groups:
            for s, r in zip(grp, collective([parts[s] for s in grp], *args)):
                out[s] = r
        return out

    def _vmoment(self, fs_species: list, weight) -> list:
        """``velocity_moment`` of each shard's species block: its partial sum
        over (vpar, its mu), ``psum`` over 'v', times dvpar dmu;
        ``weight(g)`` is the shard's weight."""
        parts = [torch.sum(f_s * weight(gs), dim=(-2, -1))
                 for f_s, gs in zip(fs_species, self.grids)]
        return [t * (gs.d_vpar * gs.d_mu)
                for t, gs in zip(self._over(self.v_groups, parts, psum), self.grids)]

    def _total(self, parts: list) -> torch.Tensor:
        """The ``psum`` of ``parts`` (one a shard, or one a (kx, ky) tile for
        the fields that 'v' replicates), in order, on the first part's
        device: the mesh's first device."""
        return psum(parts)[0]

    # -- the program -------------------------------------------------------

    def field(self, fs: list) -> list:
        """``nonlinear.field_solve`` of each shard: its phi tile, from the
        density moments' ``psum`` over 'v'."""
        cfg = self.cfg
        n_ion = self._vmoment([f[0] for f in fs], lambda gs: 1.0)
        n_elec = (self._vmoment([f[1] for f in fs], lambda gs: 1.0)
                  if cfg.kinetic_electrons else [None] * len(fs))
        phis = [nl.phi_of_moments(cfg, gs, a, b) for gs, a, b in zip(self.grids, n_ion, n_elec)]
        return self._zero_origin(phis)

    def _zero_origin(self, fields: list) -> list:
        for t, at_origin in zip(fields, self.origin):
            if at_origin:
                t[0, 0, :] = 0.0
        return fields

    def _em(self, fs: list) -> tuple[list, list]:
        """(A_par, B_par) tiles of the electromagnetic mode."""
        cfg = self.cfg
        kinetic = cfg.kinetic_electrons
        none = [None] * len(fs)

        def vpar_w(gs):
            return gs.vpar[:, None]

        def mu_w(gs):
            return gs.mu[None, :]

        j_i = self._vmoment([f[0] for f in fs], vpar_w)
        j_e = self._vmoment([f[1] for f in fs], vpar_w) if kinetic else none
        p_i = self._vmoment([f[0] for f in fs], mu_w)
        p_e = self._vmoment([f[1] for f in fs], mu_w) if kinetic else none
        a_par = [nl.a_par_of_current(cfg, gs, a, b) for gs, a, b in zip(self.grids, j_i, j_e)]
        b_par = [nl.b_par_of_pressure(cfg, gs, a, b) for gs, a, b in zip(self.grids, p_i, p_e)]
        return self._zero_origin(a_par), self._zero_origin(b_par)

    def dt(self, phis: list) -> torch.Tensor:
        """The CFL dt on the mesh's first device: ``pmax`` of the tiles'
        max |phi|, the grid maxima from the whole grids."""
        top = pmax([torch.max(torch.abs(phis[s])) for s in self.tile_rep])[0]
        return nl.cfl_dt_of_max(self.cfg, self.g, top.to(self.layout.mesh.first))

    def bracket(self, phis: list, fins: list) -> list:
        """The ExB bracket by pencil transposes: whole (kx, ky) planes for a
        share of theta on each shard of an (sx, sy) group, the bracket there,
        then back."""
        lay = self.layout
        f, phi = fins, phis
        if lay.n_sx > 1:       # theta out, kx in, over 'sx'
            f = self._over(self.sx_groups, f, all_to_all, 3, 1)
            phi = self._over(self.sx_groups, phi, all_to_all, 2, 0)
        if lay.n_sy > 1:       # theta out, ky in, over 'sy'
            f = self._over(self.sy_groups, f, all_to_all, 3, 2)
            phi = self._over(self.sy_groups, phi, all_to_all, 2, 1)
        b = [nl.exb_bracket(pl, p, fs) for pl, p, fs in zip(self.planes, phi, f)]
        if lay.n_sy > 1:
            b = self._over(self.sy_groups, b, all_to_all, 2, 3)
        if lay.n_sx > 1:
            b = self._over(self.sx_groups, b, all_to_all, 1, 3)
        return [t.contiguous() for t in b]

    def twisted(self, fins: list) -> list:
        """``nonlinear.ballooning_planes`` of each shard: the four boundary
        theta planes gathered along 'sx', twisted, the shard's kx rows kept."""
        n_theta = self.cfg.n_theta
        planes = [f[:, :, :, [0, 1, n_theta - 2, n_theta - 1]] for f in fins]
        if self.layout.n_sx > 1:
            planes = self._over(self.sx_groups, planes, all_gather, 1)
        out = []
        for (i, _, _), p, phase in zip(self.index, planes, self.twist):
            fx = torch.fft.ifft(p, dim=1) * phase[:, :, :, None, None]
            tw = torch.fft.fft(fx, dim=1)
            out.append(tw[:, i * self.nx:(i + 1) * self.nx].contiguous()
                       if self.layout.n_sx > 1 else tw.contiguous())
        return out

    def collisions(self, fins: list) -> list:
        """The conservative collision term: its moments' sums ``psum`` over
        'v' before the projection."""
        parts = [nl.conservative_sums(self.cfg, gs, f) for gs, f in zip(self.grids, fins)]
        sums = self._over(self.v_groups, [p[1] for p in parts], psum)
        return [nl.conservative_finish(gs, cf, sm, gi).contiguous()
                for gs, (cf, _), sm, gi in zip(self.grids, parts, sums, self.gram_inv)]

    def terms(self, fs: list, phis: list) -> list:
        """``nonlinear.stage_terms`` of each shard."""
        cfg = self.cfg
        act = [f[:self.n_act] for f in fs]
        none = [None] * len(fs)
        br = self.bracket(phis, act) if cfg.nonlinear else none
        coll = (self.collisions(act)
                if cfg.collisions and cfg.collision_model == "conservative" else none)
        a_par, b_par = self._em(fs) if cfg.electromagnetic else (none, none)
        tw = self.twisted(act)
        return [cuda_gk.StageTerms(phi=p.contiguous(), tw=t, bracket=b, coll=c, a_par=a, b_par=bp)
                for p, t, b, c, a, bp in zip(phis, tw, br, coll, a_par, b_par)]

    def step(self, fs: list, time: torch.Tensor):
        """One RK4 step: (the new blocks, time + dt)."""
        phis = self.field(fs)
        dt = self.dt(phis)
        dts = [dt.to(d) for d in self.devices]
        fins, accs = fs, [None] * len(fs)
        for stage in range(4):
            phi_s = phis if stage == 0 else self.field(fins)
            out = [cuda_gk.gk_stage(stage, f0, fin, acc, t, d, spec)
                   for f0, fin, acc, t, d, spec in
                   zip(fs, fins, accs, self.terms(fins, phi_s), dts, self.specs)]
            fins, accs = [o[0] for o in out], [o[1] for o in out]
        return fins, time + dt

    def diagnostics(self, fs: list):
        """``nonlinear.diagnostics`` on the blocks: the replicated values on
        the mesh's first device."""
        cfg, reps = self.cfg, self.tile_rep
        phis = self.field(fs)
        p_i = self._vmoment([f[0] for f in fs], lambda gs: gs.energy)
        q_i = self._total([nl.flux_of_pressure(self.grids[s], phis[s], p_i[s]) for s in reps])
        if cfg.kinetic_electrons:
            p_e = self._vmoment([f[1] for f in fs], lambda gs: gs.energy)
            q_e = self._total([nl.flux_of_pressure(self.grids[s], phis[s], p_e[s])
                               for s in reps])
        else:
            q_e = 0.5 * q_i
        n_modes = cfg.n_kx * cfg.n_ky * cfg.n_theta
        phi_rms = torch.sqrt(self._total([torch.sum(torch.abs(phis[s]) ** 2) for s in reps])
                             / n_modes)
        # ky index 0 (argmin |ky|) is on the j = 0 tiles, their first column
        ky0 = [s for s in reps if self.index[s][1] == 0]
        zonal = torch.sqrt(self._total([torch.sum(torch.abs(phis[s][:, 0, :]) ** 2)
                                        for s in ky0]) / (cfg.n_kx * cfg.n_theta))
        w_parts = [torch.sum(torch.abs(f) ** 2
                             / torch.clamp(gs.maxwellian[None, None, None, :, :], min=1e-30))
                   for f, gs in zip(fs, self.grids)]
        w = self._total(w_parts) * self.g.d_vpar * self.g.d_mu
        return q_i, q_e, phi_rms, zonal, 0.5 * w

    def run(self, state: ShardedGKState):
        fs, time = list(state.shards), state.time
        rows = []
        for _ in range(max(self.cfg.n_steps // self.cfg.save_interval, 1)):
            for _ in range(self.cfg.save_interval):
                fs, time = self.step(fs, time)
            rows.append((time, *self.diagnostics(fs)))
        return ShardedGKState(tuple(fs), time, self.layout), _trace(rows)


def _trace(rows) -> GKTrace:
    t, qi, qe, pr, zr, w = (torch.stack(col) for col in zip(*rows))
    return GKTrace(times=t, q_ion=qi, q_elec=qe, phi_rms=pr, zonal_rms=zr, free_energy=w)


def _run_sharded(cfg: NonlinearGKConfig, g: GKGrids, state: ShardedGKState):
    """The sharded run from ``state``: (final ShardedGKState, GKTrace)."""
    return _ShardedRun(cfg, g, state.layout).run(state)


def _check(n: int, name: str, parts: int, axis: str) -> None:
    if n % parts != 0:
        raise ValueError(f"{name}={n} not divisible by {axis}={parts}")


def run_nonlinear_gk_sharded(cfg: NonlinearGKConfig, mesh: Mesh, geometry=None,
                             state: GKState | None = None, amplitude: float = 1e-5,
                             seed: int = 42):
    """The single-chip program, over a 'v' mesh: (final ShardedGKState,
    GKTrace).  cfg.n_mu must be divisible by the mesh size."""
    if cfg.n_mu % mesh.size != 0:
        raise ValueError(f"n_mu={cfg.n_mu} not divisible by mesh size {mesh.size}")
    g = build_grids(cfg, geometry, device=mesh.first)
    if state is None:
        state = init_state(cfg, g, amplitude=amplitude, seed=seed)
    return _run_sharded(cfg, g, shard_state(state, mesh))


def run_nonlinear_gk_spatial_sharded(cfg: NonlinearGKConfig, mesh: Mesh, geometry=None,
                                     state: GKState | None = None, amplitude: float = 1e-5,
                                     seed: int = 42):
    """The same program over a (sy, v) = (ky, mu) mesh.  cfg.n_ky must
    divide by mesh['sy'] and cfg.n_mu by mesh['v']."""
    _check(cfg.n_ky, "n_ky", mesh.shape["sy"], "sy")
    _check(cfg.n_mu, "n_mu", mesh.shape["v"], "v")
    g = build_grids(cfg, geometry, device=mesh.first)
    if state is None:
        state = init_state(cfg, g, amplitude=amplitude, seed=seed)
    return _run_sharded(cfg, g, shard_state_spatial(state, mesh))


def run_nonlinear_gk_spatial_sharded_3d(cfg: NonlinearGKConfig, mesh: Mesh, geometry=None,
                                        state: GKState | None = None,
                                        amplitude: float = 1e-5, seed: int = 42):
    """The same program over a (sx, sy, v) = (kx, ky, mu) mesh.  cfg.n_kx
    must divide by mesh['sx'], cfg.n_ky by mesh['sy'], cfg.n_mu by
    mesh['v']."""
    _check(cfg.n_kx, "n_kx", mesh.shape["sx"], "sx")
    _check(cfg.n_ky, "n_ky", mesh.shape["sy"], "sy")
    _check(cfg.n_mu, "n_mu", mesh.shape["v"], "v")
    g = build_grids(cfg, geometry, device=mesh.first)
    if state is None:
        state = init_state(cfg, g, amplitude=amplitude, seed=seed)
    return _run_sharded(cfg, g, shard_state_spatial_3d(state, mesh))


# ---------------------------------------------------------------------------
# Ensembles
# ---------------------------------------------------------------------------

def run_gk_ensemble_sharded(cfg: NonlinearGKConfig, mesh: Mesh, seeds,
                            amplitude: float = 1e-5, geometry=None):
    """Ensemble members split over the (data, v) mesh's 'data' axis, each
    member's mu over 'v', the members stepped in lockstep: (GKState with f
    (M, S, ...) and time (M,), GKTrace of (M, n_saves) fields).  Each member
    starts from the seed-0 initial state plus ``0.1 * amplitude`` of its own
    complex noise, drawn from a CPU ``torch.Generator`` seeded with the
    member's seed (JAX folds the seed into ``PRNGKey(0)``: those bits cannot
    be reproduced; :func:`_run_gk_ensemble_sharded` takes the draws)."""
    g = build_grids(cfg, geometry, device=mesh.first)
    base = init_state(cfg, g, amplitude=amplitude, seed=0).f
    noise = torch.stack([member_noise(int(seed), base.shape)
                         for seed in np.asarray(seeds).reshape(-1)])
    return _run_gk_ensemble_sharded(cfg, mesh, base, noise, amplitude, geometry)


def member_noise(seed: int, shape) -> torch.Tensor:
    """A member's complex noise: float64 normals, real then imaginary, from
    a CPU ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=gen, dtype=torch.float64),
                         torch.randn(shape, generator=gen, dtype=torch.float64))


def _run_gk_ensemble_sharded(cfg: NonlinearGKConfig, mesh: Mesh, f0: torch.Tensor,
                             noise: torch.Tensor, amplitude: float = 1e-5, geometry=None):
    """:func:`run_gk_ensemble_sharded` from the base f ``f0`` (S, ...) and the
    members' complex noise (M, S, ...)."""
    n_data, n_v = mesh.shape["data"], mesh.shape["v"]
    n_members = noise.shape[0]
    _check(n_members, "members", n_data, "data")
    _check(cfg.n_mu, "n_mu", n_v, "v")
    cdt, fdt, _ = nl._dtypes(cfg)
    per_row = n_members // n_data
    runs, members = [], []
    for d in range(n_data):
        row = Mesh(mesh.devices[d * n_v:(d + 1) * n_v], ("v",), (n_v,))
        run = _ShardedRun(cfg, build_grids(cfg, geometry, device=row.first), _Layout.of(row))
        for m in range(d * per_row, (d + 1) * per_row):
            f = f0.to(row.first) + (amplitude * 0.1) * noise[m].to(row.first, cdt)
            st = shard_state(GKState(f, torch.zeros((), dtype=fdt, device=row.first)), row)
            runs.append(run)
            members.append([list(st.shards), st.time])
    rows = [[] for _ in members]
    for _ in range(max(cfg.n_steps // cfg.save_interval, 1)):
        for _ in range(cfg.save_interval):
            for run, member in zip(runs, members):
                member[:] = run.step(*member)
        for run, member, r in zip(runs, members, rows):
            r.append((member[1], *run.diagnostics(member[0])))
    home = mesh.first
    finals = [ShardedGKState(tuple(fs), t, run.layout) for run, (fs, t) in zip(runs, members)]
    traces = [_trace(r) for r in rows]
    state = GKState(f=torch.stack([s.f.to(home) for s in finals]),
                    time=torch.stack([s.time.to(home) for s in finals]))
    trace = GKTrace(*(torch.stack([getattr(t, name).to(home) for t in traces])
                      for name in GKTrace._fields))
    return state, trace
