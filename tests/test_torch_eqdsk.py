"""Port parity: the G-EQDSK reader (carried over) and the G-EQDSK
reconstruction (``models/equilibrium/eqdsk_solve``).

``scpn_fusion_tpu_torch/io/geqdsk.py`` is a copy of the JAX package's
numpy-only reader and writer: it is held equal to its source text down to
``geqdsk_from_solution`` (which reads the port's tensors and is held to the
JAX function on the same solution), and both fuzz seeds read field for field
equal through either package.  ``solve_from_geqdsk`` on both seeds -- the
public SPARC L-mode equilibrium on its 129 x 129 grid, and the 9 x 9 file --
runs the full default loop (``max_iter`` 300; 82 and 98 iterations) in
float64 on the CPU: the same iteration count and convergence as JAX, psi
within 1e-9 span-relative, the RMSE metrics within 1e-9 relative.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_parity import as_np, free_boundary_cfgs, rel, rng, span_rel

from scpn_fusion_tpu.io import geqdsk as jgq
from scpn_fusion_tpu.models.equilibrium import eqdsk_solve as jes
from scpn_fusion_tpu_torch.io import geqdsk as tgq
from scpn_fusion_tpu_torch.models.equilibrium import eqdsk_solve as tes

ROOT = Path(__file__).resolve().parent.parent
SEEDS = sorted((ROOT / "fuzz" / "seeds" / "geqdsk").glob("*.geqdsk"))
SPLIT = "def geqdsk_from_solution"


def test_copy_equals_source():
    ours = (ROOT / "scpn_fusion_tpu_torch" / "io" / "geqdsk.py").read_text()
    ref = (ROOT / "scpn_fusion_tpu" / "io" / "geqdsk.py").read_text()
    assert ours.split(SPLIT)[0] == ref.split(SPLIT)[0]
    assert "jax" not in ours.split(SPLIT)[1]


@pytest.mark.parametrize("path", SEEDS, ids=lambda p: p.stem)
def test_reader_matches_jax(path):
    ours, ref = tgq.read_geqdsk(path), jgq.read_geqdsk(path)
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name


def test_geqdsk_from_solution_matches_jax(tmp_path):
    ref_cfg, cfg = free_boundary_cfgs(17)
    psi = rng(15).standard_normal((17, 17))
    j_phi = rng(16).random((17, 17))
    ref = jgq.geqdsk_from_solution(ref_cfg, SimpleNamespace(psi=psi, j_phi=j_phi))
    ours = tgq.geqdsk_from_solution(cfg, SimpleNamespace(psi=torch.from_numpy(psi),
                                                         j_phi=torch.from_numpy(j_phi)))
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.shape == b.shape and np.allclose(a, b, rtol=1e-12, atol=0.0), field.name
        else:
            assert a == pytest.approx(b, rel=1e-12), field.name
    tgq.write_geqdsk(ours, tmp_path / "out.geqdsk")
    assert np.array_equal(tgq.read_geqdsk(tmp_path / "out.geqdsk").psirz,
                          jgq.read_geqdsk(tmp_path / "out.geqdsk").psirz)


@pytest.mark.parametrize("path", SEEDS, ids=lambda p: p.stem)
def test_solve_from_geqdsk_matches_jax(path):
    eq = tgq.read_geqdsk(path)
    ref = jes.solve_from_geqdsk(jgq.read_geqdsk(path))    # float64: x64 is on
    ours = tes.solve_from_geqdsk(eq, dtype=torch.float64, device="cpu")
    assert ours.iterations == int(ref.iterations)
    assert ours.converged == bool(ref.converged) and ours.converged
    assert ours.psi.shape == (eq.nh, eq.nw) and ours.psi.dtype == torch.float64
    assert span_rel(ours.psi, ref.psi) <= 1e-9
    assert span_rel(ours.j_phi, ref.j_phi) <= 1e-9
    for name in ("span_rel_rmse", "span_rel_rmse_core"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= 1e-9, name
    span = float(np.ptp(as_np(ref.psi)))
    assert abs(float(ours.residual) - float(ref.residual)) <= 2e-9 * span


def test_sampled_profile_matches_jax():
    table = rng(17).standard_normal(33)
    psi_n = np.concatenate([rng(18).uniform(-0.5, 1.5, 200), [0.0, 1.0]])
    ref = jes._sampled_profile(np.asarray(psi_n), np.asarray(table))
    ours = tes._sampled_profile(torch.from_numpy(psi_n), torch.from_numpy(table))
    assert rel(ours, ref) <= 1e-14
