"""Port parity: realtime EFIT (``control/realtime_efit.py``).

In float64 on the CPU, on the layout and 33^2 grid of
``tests/test_realtime_efit.py``, every array of the built model (basis psi
maps, sensor and coil responses -- the B probes through autograd on the
observation point where JAX takes ``jax.grad`` -- coil maps, the Tikhonov
solve operator) is within 1e-9 of JAX, the psi maps also when taken in many
small chunks (the byte budget that bounds the O(N^4) sum at large grids), and
``reconstruct`` and ``synthetic_measurements`` agree within 1e-9; the gates of
``tests/test_realtime_efit.py`` hold for the port.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import realtime_efit as je
from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu_torch.control import realtime_efit as te
from scpn_fusion_tpu_torch.core.grid import Grid

TOL = 1e-9
F64 = torch.float64
BUILD = dict(r_axis=6.5, a_minor=1.6, kappa=1.5)


def _layout(m):
    loops = tuple((r, z) for r in (4.0, 9.0) for z in (-3.5, 0.0, 3.5))
    probes = tuple((r, z, d) for (r, z) in ((3.8, -2.0), (3.8, 2.0), (9.2, 0.0), (6.5, 4.0),
                                            (6.5, -4.0)) for d in ("R", "Z"))
    return m.MagneticsLayout(flux_loops=loops, b_probes=probes, coil_r=(3.5, 9.5, 9.5, 3.5),
                             coil_z=(4.5, 2.5, -2.5, -4.5))


GRID = dict(NR=33, NZ=33, R_min=4.5, R_max=8.5, Z_min=-2.5, Z_max=2.5)


@pytest.fixture(scope="module")
def models():
    ref = je.build_efit_model(JGrid(**GRID, dtype=np.dtype("float64")), _layout(je), **BUILD)
    ours = te.build_efit_model(Grid(**GRID, dtype=F64, device=torch.device("cpu")),
                               _layout(te), **BUILD)
    return ref, ours


def test_build_matches_jax(models):
    ref, ours = models
    for name in ("basis_maps", "basis_sensor", "basis_ip", "coil_sensor", "coil_maps",
                 "solve_op", "r_1d", "z_1d"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    assert float(ours.ip_weight) == float(ref.ip_weight)


def test_psi_maps_chunked_equal_whole(models, monkeypatch):
    _, ours = models
    monkeypatch.setattr(te, "PSI_MAP_BYTES", 33 * 33 * 8 * 50)     # 50 points a chunk
    small = te.build_efit_model(Grid(**GRID, dtype=F64, device=torch.device("cpu")),
                                _layout(te), **BUILD)
    # the same sums; the BLAS may block a 50-row product otherwise than a 1089-row one
    assert rel(small.basis_maps, ours.basis_maps) <= 1e-14


@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruct_matches_jax(models, seed):
    ref, ours = models
    g = np.random.default_rng(seed)
    coeffs = g.uniform(-1e6, 2e6, 6)
    coil_i = g.uniform(-2e5, 2e5, 4)
    meas_j = je.synthetic_measurements(ref, jnp.asarray(coeffs), jnp.asarray(coil_i))
    meas_t = te.synthetic_measurements(ours, torch.tensor(coeffs), torch.tensor(coil_i))
    assert rel(meas_t, meas_j) <= TOL
    noisy = np.asarray(meas_j) * (1.0 + 0.01 * g.standard_normal(meas_j.shape))
    ip = float(ref.basis_ip @ jnp.asarray(coeffs))
    r_j = je.reconstruct(ref, jnp.asarray(noisy), jnp.asarray(coil_i), jnp.asarray(ip))
    r_t = te.reconstruct(ours, torch.tensor(noisy), torch.tensor(coil_i), ip)
    for name in ("psi", "coeffs", "ip_reconstructed", "residual_norm"):
        assert rel(getattr(r_t, name), getattr(r_j, name)) <= TOL, name
    assert float(r_t.axis_r) == float(r_j.axis_r) and float(r_t.axis_z) == float(r_j.axis_z)


class TestGates:
    """``tests/test_realtime_efit.py`` on the port."""

    def test_shapes(self, models):
        _, m = models
        assert m.basis_sensor.shape == (16, 6)
        assert m.coil_sensor.shape == (16, 4)
        assert m.basis_maps.shape == (6, 33, 33)
        assert m.solve_op.shape == (6, 17)
        assert bool(torch.isfinite(m.basis_maps).all()) and bool(torch.isfinite(
            m.basis_sensor).all())

    def test_layout_validation(self):
        with pytest.raises(ValueError, match="at least 4"):
            te.MagneticsLayout(flux_loops=((1.0, 0.0),), b_probes=(), coil_r=(), coil_z=())
        with pytest.raises(ValueError, match="direction"):
            te.MagneticsLayout(flux_loops=((1, 0), (2, 0), (3, 0), (4, 0)),
                               b_probes=((1.0, 0.0, "phi"),), coil_r=(), coil_z=())

    def test_forward_inverse_roundtrip(self, models):
        _, m = models
        true_coeffs = torch.tensor([1.2e6, -0.3e6, 0.1e6, 0.5e6, 0.0, 0.0], dtype=F64)
        coil_i = torch.tensor([1e5, -2e5, -2e5, 1e5], dtype=F64)
        meas = te.synthetic_measurements(m, true_coeffs, coil_i)
        ip_true = m.basis_ip @ true_coeffs
        res = te.reconstruct(m, meas, coil_i, ip_true)
        assert float(res.ip_reconstructed) == pytest.approx(float(ip_true), rel=0.05)
        assert float(res.residual_norm) < 0.03 * float(torch.linalg.norm(meas))

    def test_psi_peak_near_axis(self, models):
        _, m = models
        true_coeffs = torch.tensor([2e6, 0.0, 0.0, 1e6, 0.0, 0.0], dtype=F64)
        coil_i = torch.zeros(4, dtype=F64)
        meas = te.synthetic_measurements(m, true_coeffs, coil_i)
        res = te.reconstruct(m, meas, coil_i, m.basis_ip @ true_coeffs)
        assert abs(float(res.axis_r) - 6.5) < 0.8
        assert abs(float(res.axis_z)) < 0.8

    def test_noise_robustness(self, models):
        _, m = models
        rng = np.random.default_rng(0)
        true_coeffs = torch.tensor([1.5e6, 0.2e6, 0.0, 0.8e6, 0.0, 0.0], dtype=F64)
        coil_i = torch.tensor([5e4, -1e5, -1e5, 5e4], dtype=F64)
        meas = te.synthetic_measurements(m, true_coeffs, coil_i)
        noisy = meas * (1.0 + 0.01 * torch.tensor(rng.standard_normal(meas.shape)))
        ip = m.basis_ip @ true_coeffs
        res = te.reconstruct(m, noisy, coil_i, ip)
        assert float(res.ip_reconstructed) == pytest.approx(float(ip), rel=0.1)

    def test_reconstruction_is_fast_warm(self, models):
        _, m = models
        coil_i, meas = torch.zeros(4, dtype=F64), torch.ones(16, dtype=F64)
        te.reconstruct(m, meas, coil_i, 1e6)
        t0 = time.perf_counter()
        for _ in range(50):
            te.reconstruct(m, meas, coil_i, 1e6)
        assert (time.perf_counter() - t0) / 50 * 1e3 < 50.0
