"""Port parity: the design scan and the compact-reactor search
(``models/physics/design_scan``) and row E's plain twin
(``ops/cuda_burn.burn_relax_plain``, the relaxation of
``scaling_burn.burn_equilibrium_0d``).

In float64 on the CPU every field of ``evaluate_design`` is within 1e-9 of
JAX's (its net power is float32 in both, within 1e-6 relative).
``scan_designs`` runs float32, as JAX casts it; its fields are within 1e-5
relative of JAX's (float32 through 200 relaxation steps: ~5e-7 seen), and
its feasibility mask, ``best_index`` and ``n_feasible`` are equal.  The
compact search is fed JAX's draws (``jax.random`` keyed as the JAX function
keys them) at 256 samples; the JAX test's 512 runs on the port's own draws.  The gates of
``tests/test_scenario_design.py:124-152`` hold for the port, the compact
search on the port's own draws.  Row E's plain twin equals, bit for bit,
the module's step looped by hand, and a batch equals its points one by one;
the kernel's argument block lists the C struct field for field, and an
input that requires a gradient raises.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, c_struct_fields, ctypes_fields, rel

from scpn_fusion_tpu.models.physics import design_scan as jds
from scpn_fusion_tpu_torch.models.physics import design_scan as tds
from scpn_fusion_tpu_torch.models.physics import scaling_burn as sb
from scpn_fusion_tpu_torch.ops import cuda_burn as cbn

TOL = 1e-9
F32_TOL = 1e-5       # scan_designs is float32 in both: 200 relaxation steps of float32 rounding
F64 = torch.float64
CSRC = Path(cbn.__file__).resolve().parent.parent / "csrc"
ITER = (6.2, 2.0, 5.3, 15.0, 10.0, 50.0)


def _points(ours, ref, tol):
    for name in ref._fields:
        a, b = getattr(ours, name), getattr(ref, name)
        if np.asarray(b).dtype == bool:
            assert np.array_equal(as_np(a).astype(bool), np.asarray(b)), name
        elif name == "p_net_mw":
            assert rel(a, b) <= max(tol, 1e-6), (name, rel(a, b))   # float32 in both
        else:
            assert rel(a, b) <= tol, (name, rel(a, b))


def _jax_draws(n: int, seed: int):
    """compact_reactor_search's uniforms, keyed as design_scan.py:150-155 keys them."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    return [torch.from_numpy(np.array(jax.random.uniform(k, (n,), minval=lo, maxval=hi)))
            for k, (lo, hi) in zip(ks, ((1.5, 7.0), (0.25, 0.36), (4.0, 14.0), (0.3, 1.0)))]


@pytest.mark.parametrize("point", [ITER, (3.0, 0.97, 12.0, 7.0, 14.0, 30.0),
                                   (9.0, 2.9, 4.5, 20.0, 6.0, 80.0)])
def test_evaluate_design_matches_jax(point):
    ref = jds.evaluate_design(*point, kappa=1.8)
    ours = tds.evaluate_design(*point, kappa=1.8, dtype=F64, device="cpu")
    assert ours.q_fusion.dtype == F64 and ours.p_net_mw.dtype == torch.float32
    _points(ours, ref, TOL)


def test_scan_designs_matches_jax_in_float32():
    r = np.asarray([3.0, 6.2, 9.0, 4.5, 7.5])
    kw_j = dict(r_m=jnp.asarray(r), a_m=jnp.asarray(r / 3.1), b0_t=5.3,
                ip_ma=jnp.asarray(15.0 * r / 6.2), ne19=10.0, p_aux_mw=50.0)
    ref = jds.scan_designs(**kw_j)
    ours = tds.scan_designs(**{k: torch.from_numpy(np.array(v)) if isinstance(v, jax.Array)
                               else v for k, v in kw_j.items()}, device="cpu")
    # JAX's burn carry is float32 here: the weakly typed initial temperature takes the loop's
    assert ref.points.t_kev.dtype == np.float32 and ours.points.t_kev.dtype == torch.float32
    _points(ours.points, ref.points, F32_TOL)
    assert int(ours.best_index) == int(ref.best_index)
    assert int(ours.n_feasible) == int(ref.n_feasible)


@pytest.mark.parametrize("n, seed", [(256, 1)])
def test_compact_search_matches_jax_on_its_draws(n, seed):
    ref = jds.compact_reactor_search(n_samples=n, seed=seed)
    ours = tds._compact_reactor_search(*_jax_draws(n, seed))
    _points(ours.points, ref.points, F32_TOL)
    assert int(ours.best_index) == int(ref.best_index)
    assert int(ours.n_feasible) == int(ref.n_feasible)


def test_all_infeasible_scan_gives_jax_best_index():
    tight = jds.DesignLimits(beta_n_max=0.0)
    r = np.asarray([3.0, 6.2, 9.0])
    ref = jds.scan_designs(r_m=jnp.asarray(r), a_m=jnp.asarray(r / 3.1), b0_t=5.3, ip_ma=15.0,
                           ne19=10.0, p_aux_mw=50.0, limits=tight)
    ours = tds.scan_designs(r_m=torch.from_numpy(r), a_m=torch.from_numpy(r / 3.1), b0_t=5.3,
                            ip_ma=15.0, ne19=10.0, p_aux_mw=50.0,
                            limits=tds.DesignLimits(beta_n_max=0.0), device="cpu")
    assert int(ref.n_feasible) == 0 and int(ours.n_feasible) == 0
    assert int(ours.best_index) == int(ref.best_index)


class TestDesignScanGates:
    """tests/test_scenario_design.py:124-152 on the port."""

    def test_iter_like_point_feasible_q10(self):
        pt = tds.evaluate_design(*ITER, kappa=1.8, dtype=F64, device="cpu")
        assert float(pt.q_fusion) > 5.0
        assert bool(pt.feasible)

    def test_scan_picks_feasible_best(self):
        r = torch.tensor([3.0, 6.2, 9.0], dtype=F64)
        pts = tds.scan_designs(r_m=r, a_m=r / 3.1, b0_t=5.3, ip_ma=15.0 * r / 6.2, ne19=10.0,
                               p_aux_mw=50.0)
        assert int(pts.n_feasible) >= 1
        assert bool(pts.points.feasible[int(pts.best_index)])

    def test_compact_search_finds_devices(self):
        res = tds.compact_reactor_search(n_samples=512, seed=1, device="cpu")
        assert int(res.n_feasible) > 0
        best = int(res.best_index)
        assert bool(res.points.feasible[best])
        assert float(res.points.q_fusion[best]) >= 10.0
        assert float(res.points.r_m[best]) < 7.0

    def test_limits_mask(self):
        pt = tds.evaluate_design(*ITER, limits=tds.DesignLimits(beta_n_max=0.1), dtype=F64,
                                 device="cpu")
        assert not bool(pt.feasible)


def _constants(dtype, n: int = 9):
    g = np.random.default_rng(3)
    r = g.uniform(1.5, 7.0, n)
    a = g.uniform(0.25, 0.36, n) * r
    b = g.uniform(4.0, 14.0, n)
    ip = g.uniform(0.3, 1.0, n) * 5.0 * a**2 * b / r
    ne = 0.8 * 10.0 * ip / (np.pi * a**2)
    cols = [ne, np.full(n, 50.0), ip, b, r, a, np.full(n, 1.8)]
    return [torch.tensor(c, dtype=dtype) for c in cols]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_burn_relax_plain_is_the_module_loop(dtype):
    cols = _constants(dtype)
    k = sb.burn_constants(*cols, 0.8, 2.0)
    got = cbn.burn_relax_plain(k, 8.0, 200)
    t = torch.tensor(8.0, dtype=dtype)
    for _ in range(200):
        t = t + sb.RELAX * (sb.balance(k, t)[3] - t)
    assert got.dtype == dtype and torch.equal(got, t)
    one = torch.stack([cbn.burn_relax(sb.burn_constants(*(c[i] for c in cols), 0.8, 2.0), 8.0,
                                      200) for i in range(cols[0].shape[0])])
    assert torch.equal(got, one)
    pt = sb.burn_equilibrium_0d(ne19=cols[0], p_aux_mw=cols[1], ip_ma=cols[2], bt_t=cols[3],
                                r_m=cols[4], a_m=cols[5], kappa=cols[6], dtype=dtype,
                                device="cpu")
    assert torch.equal(pt.t_kev, torch.clamp(got, 0.5, 100.0))


def test_row_e_refuses_gradients_and_host_tensors():
    cols = _constants(F64, 3)
    cols[4] = cols[4].requires_grad_()
    k = sb.burn_constants(*cols, 0.8, 2.0)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        cbn.check_inputs(k)
    # the CPU path keeps autograd
    g, = torch.autograd.grad(cbn.burn_relax(k, 8.0, 20).sum(), cols[4])
    assert torch.all(torch.isfinite(g))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cbn.check_inputs(sb.burn_constants(*_constants(F64, 3), 0.8, 2.0))


def test_argument_block_lists_the_c_source():
    src = (CSRC / "burn.cu").read_text()
    assert ctypes_fields(cbn._Args) == c_struct_fields(src, "BurnArgs")
    args, _, out = cbn.launch_args(sb.burn_constants(*_constants(F64, 5), 0.8, 2.0), 8.0, 200)
    assert args.n == 5 and args.n_iter == 200 and out.shape == (5,)
    assert args.e_ploss == sb.IPB98Y2_EXP["ploss_mw"] and args.relax == sb.RELAX
