"""A single-controller device mesh: the port's counterpart of
``jax.sharding.Mesh`` for ``parallel/``.

JAX's ``shard_map`` / ``NamedSharding`` are single-controller: one process
drives every device of the mesh, and the entry points take and return global
arrays (``sharded_vcycle(psi, source, ..., mesh=mesh)``,
``solve_equilibrium_sharded(cfg, mesh)``).  The port keeps that model and
those signatures:

* a :class:`Mesh` is a tuple of ``torch.device``\\ s, laid out row-major over
  a shape with named axes;
* a sharded field is a list of per-shard tensors, each on its shard's
  device (:func:`shard_rows`, :func:`shard_tiles`);
* JAX's collectives become copies that this one process makes: a halo
  ``ppermute`` is a neighbour's edge row ``.to(dst_device)`` (zeros where
  there is no neighbour), ``psum`` a sum of the per-shard partials taken in
  shard order on the first shard's device and handed back to every shard
  (:func:`psum`), ``all_gather(tiled=True)`` a ``torch.cat`` on the
  receiving shard's device (:func:`gather_rows`, :func:`gather_tiles`).

``torch.distributed`` is not used: its one-process-a-rank model would change
every JAX signature (each rank would hold its shard, not the global array),
and the CPU tests would have to spawn gloo ranks.

A mesh may name one device several times: ``Mesh((cuda:0,) * 8, ("z",))``
runs the 8-shard program on one card.  That checks the arithmetic of the
exchanges and the launch structure of an n-shard solve; it does not check an
interconnect.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over ``axis_sizes``, one name an axis.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"Mesh: axes {self.axis_names} and sizes {self.axis_sizes} differ")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"Mesh: {len(self.devices)} devices do not fill {self.axis_sizes}")

    @classmethod
    def of(cls, devices, axis_names, axis_sizes=None) -> "Mesh":
        """A mesh over ``devices`` (devices or names), one axis unless
        ``axis_sizes`` is given."""
        devs = tuple(_resolved(torch.device(d)) for d in devices)
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        sizes = (len(devs),) if axis_sizes is None else tuple(int(s) for s in axis_sizes)
        return cls(devs, names, sizes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device that holds global arrays and reduced scalars."""
        return self.devices[0]


def _resolved(device: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index, so that a mesh's devices
    compare equal to its tensors' devices."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def devices_of(n: int | None, device) -> tuple[torch.device, ...]:
    """The first ``n`` devices of ``device``'s type (``"cuda"``: the CUDA
    devices, raising where there are fewer; ``"cpu"``: ``n`` CPU shards)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (dev,) * (1 if n is None else n)
    if dev.type != "cuda":
        raise ValueError(f"mesh devices must be cuda or cpu, got {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else n
    if have < n or n < 1:
        raise RuntimeError(f"requested {n} CUDA devices, the host has {have}; build a "
                           "Mesh by hand to place several shards on one card")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(n: int | None, axes: tuple[str, ...], sizes: tuple[int, ...] | None,
              device) -> Mesh:
    devs = devices_of(n if sizes is None else math.prod(sizes), device)
    return Mesh(devs, axes, (len(devs),) if sizes is None else sizes)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``x`` cut into ``mesh.size`` equal row blocks, each on its shard's
    device (the rows must divide)."""
    return [blk.to(d) for blk, d in zip(x.chunk(mesh.size, 0), mesh.devices)]


def gather_rows(shards: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``all_gather(tiled=True)`` over row blocks, on ``device``."""
    return torch.cat([s.to(device) for s in shards], 0)


def shard_tiles(x: torch.Tensor, pz: int, pr: int, mesh: Mesh) -> list[torch.Tensor]:
    """``x`` cut into a ``pz`` x ``pr`` grid of equal tiles, row-major, each
    on its shard's device."""
    tiles = [t for rows in x.chunk(pz, 0) for t in rows.chunk(pr, 1)]
    return [t.contiguous().to(d) for t, d in zip(tiles, mesh.devices)]


def gather_tiles(tiles: list[torch.Tensor], pz: int, pr: int,
                 device: torch.device) -> torch.Tensor:
    """The two-axis ``all_gather(tiled=True)``: the global field on ``device``."""
    rows = [torch.cat([t.to(device) for t in tiles[i * pr:(i + 1) * pr]], 1) for i in range(pz)]
    return torch.cat(rows, 0)


def psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.psum`` of per-shard partials: summed in shard order on the first
    partial's device, the total handed back to every shard's device."""
    home = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(home)
    return [total.to(p.device) for p in parts]
