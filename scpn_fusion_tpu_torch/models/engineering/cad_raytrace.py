"""CAD surface-loading raytrace (STL -> line-of-sight heat map) (port of
``scpn_fusion_tpu/models/engineering/cad_raytrace.py``).

ASCII/binary STL parsing and mesh validation (numpy, carried over as they
are), and reduced line-of-sight loading ``P cos(theta) / (4 pi d^2)`` per
triangle with optional self-shadowing occlusion.  The Moller-Trumbore
segment-triangle test runs over (face, blocker) pairs as batched PyTorch
ops, as JAX's ``vmap`` of ``vmap`` does, in chunks of faces of at most
:data:`OCCLUSION_PAIRS` pairs, so that a mesh of 10^4 faces fits in a few
hundred megabytes (``any`` over blockers is exact, so the chunking does not
change the mask).  The cross products are ``torch.linalg.cross`` and the
dot products sums in JAX's order.  :func:`estimate_surface_loading` takes
``dtype`` (JAX reads its x64 flag; float32 by default here) and ``device``.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import xla_mean

#: (face, blocker) pairs an occlusion chunk holds at most: ~0.3 GB of
#: float64 intermediates a chunk.
OCCLUSION_PAIRS = 1 << 22


class CADLoadReport(NamedTuple):
    face_loading_w_m2: np.ndarray
    peak_loading_w_m2: float
    mean_loading_w_m2: float


# ── STL parsing (host-side, reference :42-124) ───────────────────────────


def _parse_ascii_stl(path: Path) -> tuple[np.ndarray, np.ndarray]:
    vertices: list[list[float]] = []
    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            vertices.append([float(parts[1]), float(parts[2]),
                             float(parts[3])])
    if not vertices or len(vertices) % 3 != 0:
        raise ValueError("ASCII STL must contain whole triangles")
    verts = np.asarray(vertices, dtype=np.float64)
    faces = np.arange(len(vertices), dtype=np.int64).reshape(-1, 3)
    return verts, faces


def _parse_binary_stl(path: Path) -> tuple[np.ndarray, np.ndarray]:
    blob = path.read_bytes()
    if len(blob) < 84:
        raise ValueError("binary STL too short for header")
    (n_tri,) = struct.unpack_from("<I", blob, 80)
    expected = 84 + 50 * n_tri
    if len(blob) < expected:
        raise ValueError(
            f"binary STL truncated: need {expected} bytes, got {len(blob)}")
    verts = np.zeros((3 * n_tri, 3), dtype=np.float64)
    for i in range(n_tri):
        off = 84 + 50 * i + 12           # skip the normal
        tri = struct.unpack_from("<9f", blob, off)
        verts[3 * i:3 * i + 3] = np.asarray(tri).reshape(3, 3)
    faces = np.arange(3 * n_tri, dtype=np.int64).reshape(-1, 3)
    return verts, faces


def load_cad_mesh(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Load an STL mesh (auto ASCII/binary); returns (vertices, faces)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    head = path.read_bytes()[:5]
    if head == b"solid":
        try:
            return _parse_ascii_stl(path)
        except ValueError:
            # Some binary files begin with "solid"; fall through.
            pass
    return _parse_binary_stl(path)


def triangle_normals_and_areas(vertices: np.ndarray, faces: np.ndarray):
    tri = vertices[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(cross, axis=1)
    areas = 0.5 * norm
    normals = cross / np.maximum(norm, 1e-300)[:, None]
    return normals, areas


def validate_mesh(vertices: np.ndarray, faces: np.ndarray) -> None:
    """Fail-closed mesh validation (reference ``_validate_mesh``)."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError("vertices must have shape (M, 3)")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError("faces must have shape (K, 3)")
    if vertices.shape[0] == 0 or faces.shape[0] == 0:
        raise ValueError("mesh must be non-empty")
    if not np.all(np.isfinite(vertices)):
        raise ValueError("vertices must be finite")
    if np.any(faces < 0) or np.any(faces >= vertices.shape[0]):
        raise ValueError("faces reference out-of-bounds vertices")
    _, areas = triangle_normals_and_areas(vertices, faces)
    if not np.all(np.isfinite(areas)) or np.any(areas <= 0.0):
        raise ValueError("faces must define non-degenerate triangles")


# ── Batched Moller-Trumbore occlusion ────────────────────────────────────


def _dot(a, b):
    """``jnp.dot`` of 3-vectors along the last axis, summed in index order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _segment_hits_triangle(p0, p1, tri, eps):
    """Strictly-interior segment-triangle intersection, broadcasting over the
    leading axes of ``p0``/``p1`` (..., 3) and ``tri`` (..., 3, 3)."""
    d = p1 - p0
    edge1 = tri[..., 1, :] - tri[..., 0, :]
    edge2 = tri[..., 2, :] - tri[..., 0, :]
    d, edge2 = torch.broadcast_tensors(d, edge2)
    h = torch.linalg.cross(d, edge2)
    a = _dot(edge1, h)
    safe_a = torch.where(torch.abs(a) > eps, a, 1.0)
    f = 1.0 / safe_a
    s = p0 - tri[..., 0, :]
    u = f * _dot(s, h)
    s, edge1 = torch.broadcast_tensors(s, edge1)
    q = torch.linalg.cross(s, edge1)
    v = f * _dot(d, q)
    t = f * _dot(edge2, q)
    return ((torch.abs(a) > eps)
            & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (u + v <= 1.0)
            & (t > eps) & (t < 1.0 - eps))


def _occlusion_mask(src, centroids, tris, eps):
    """(F,) bool: centroid i is shadowed by ANY other triangle, over chunks
    of faces of at most :data:`OCCLUSION_PAIRS` (face, blocker) pairs."""
    n_faces = centroids.shape[0]
    rows = max(1, OCCLUSION_PAIRS // max(n_faces, 1))
    blockers = torch.arange(n_faces, device=centroids.device)
    out = []
    for start in range(0, n_faces, rows):
        c = centroids[start:start + rows]
        hit = _segment_hits_triangle(src, c[:, None, :], tris[None], eps)
        own = blockers[None, :] == torch.arange(start, start + c.shape[0],
                                                device=centroids.device)[:, None]
        out.append(torch.any(torch.where(own, False, hit), dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool, device=centroids.device)


def estimate_surface_loading(
    vertices: np.ndarray,
    faces: np.ndarray,
    source_points_xyz: np.ndarray,
    source_strength_w: np.ndarray,
    *,
    occlusion_cull: bool = False,
    occlusion_epsilon: float = 1e-9,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> CADLoadReport:
    """Line-of-sight loading per face (reference :194-268 semantics), in
    ``dtype`` on ``device``.

    Radiation loads both sides of thin surfaces, so the incidence factor
    is |cos theta| (neutron/photon transport, not optics).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    src = np.atleast_2d(np.asarray(source_points_xyz, dtype=np.float64))
    strength = np.asarray(source_strength_w, dtype=np.float64).reshape(-1)
    if src.shape[1] != 3:
        raise ValueError("source_points_xyz must have shape (N, 3)")
    if strength.size != src.shape[0]:
        raise ValueError("source_strength_w length mismatch")
    if not np.all(np.isfinite(src)) or not np.all(np.isfinite(strength)):
        raise ValueError("sources must be finite")
    if np.any(strength < 0.0):
        raise ValueError("source strengths must be non-negative")
    if not (np.isfinite(occlusion_epsilon) and occlusion_epsilon > 0.0):
        raise ValueError("occlusion_epsilon must be finite and > 0")
    validate_mesh(vertices, faces)

    tris = torch.tensor(vertices[faces], dtype=dtype, device=device)
    centroids = xla_mean(tris, dim=1)
    normals, _ = triangle_normals_and_areas(vertices, faces)
    normals_t = torch.tensor(normals, dtype=dtype, device=device)

    loading = torch.zeros(faces.shape[0], dtype=dtype, device=device)
    for p, power in zip(src, strength):
        p_t = torch.tensor(p, dtype=dtype, device=device)
        ray = centroids - p_t[None, :]
        dist2 = _dot(ray, ray)
        dirs = ray / torch.sqrt(torch.clamp(dist2, min=1e-12))[:, None]
        cos_abs = torch.abs(_dot(normals_t, dirs))
        visible = cos_abs > 0.0
        if occlusion_cull:
            shadowed = _occlusion_mask(
                p_t, centroids, tris,
                torch.tensor(occlusion_epsilon, dtype=dtype, device=device))
            visible = visible & ~shadowed
        contrib = torch.where(visible, cos_abs, 0.0) * float(power) \
            / (4.0 * math.pi * torch.clamp(dist2, min=1e-12))
        loading = loading + contrib

    out = loading.cpu().numpy()
    return CADLoadReport(
        face_loading_w_m2=out,
        peak_loading_w_m2=float(out.max()) if out.size else 0.0,
        mean_loading_w_m2=float(out.mean()) if out.size else 0.0)
