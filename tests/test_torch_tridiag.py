"""Port parity: the Thomas solver (``ops/tridiag.py``).

The plain row loop (the CPU path, and the version the CUDA kernel
``csrc/tridiag.cu`` equals bit for bit on the card) against JAX's
``lax.scan`` solver on seeded random systems and on systems that trip each
guard (a zero pivot, an inf, a NaN): within 1e-13 in float64 and 1e-6 in
float32.  The CUDA wrapper's input checks run here too; its launches are
checked by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rng

from scpn_fusion_tpu.ops import tridiag as jtd
from scpn_fusion_tpu_torch.ops import cuda_tridiag, tridiag

TOL = {np.float64: 1e-13, np.float32: 1e-6}


def _systems(seed, n_sys, n, dtype, dominant=True):
    g = rng(seed)
    a = g.standard_normal((n_sys, n - 1))
    c = g.standard_normal((n_sys, n - 1))
    b = g.standard_normal((n_sys, n)) + (4.0 if dominant else 0.0)
    d = g.standard_normal((n_sys, n))
    return [x.astype(dtype) for x in (a, b, c, d)]


def _degenerate(dtype):
    """Four systems of n = 6 that trip the guards: a zero first pivot, a zero
    last pivot (b_5 - a_4 cp_4 with c_4 = b_5 = 0), an inf in d and a NaN in
    a.  The floored pivot (1e-30) makes values near 1e30; these systems keep
    them out of a difference of two such values, where one rounding of
    either side (XLA contracts b - a cp into an FMA, PyTorch does not) would
    change the answer wholesale."""
    a, b, c, d = _systems(7, 4, 6, dtype)
    b[0, 0] = 0.0
    c[0, 0] = 0.0
    c[1, 4] = 0.0
    b[1, 5] = 0.0
    d[2, 3] = np.inf
    a[3, 2] = np.nan
    return a, b, c, d


def _check(a, b, c, d, dtype):
    ref = np.asarray(jtd.thomas_solve_batched(*(jnp.asarray(x) for x in (a, b, c, d))))
    ours = tridiag.thomas_solve_batched(*(torch.from_numpy(x) for x in (a, b, c, d))).numpy()
    assert ours.dtype == ref.dtype == dtype
    assert np.array_equal(np.isfinite(ours), np.isfinite(ref))
    scale = max(np.max(np.abs(ref)), 1e-300)
    assert np.max(np.abs(ours - ref)) / scale <= TOL[dtype]
    return ours, ref


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_sys,n", [(1, 50), (3, 50), (11, 50), (50, 11), (2, 2)])
def test_random_systems_match_jax(n_sys, n, dtype):
    _check(*_systems(n_sys * 100 + n, n_sys, n, dtype), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_degenerate_systems_match_jax(dtype):
    a, b, c, d = _degenerate(dtype)
    ours, ref = _check(a, b, c, d, dtype)
    assert np.all(np.isfinite(ours))           # every guard ends in a finite answer
    assert np.all(np.abs(ours[0]) > 1e20)      # the floored pivots (1e-30) show
    assert np.abs(ours[1, -1]) > 1e20


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_single_system_and_batch_agree(dtype):
    a, b, c, d = _systems(5, 3, 17, dtype, dominant=False)
    batch = tridiag.thomas_solve_batched(*(torch.from_numpy(x) for x in (a, b, c, d)))
    for k in range(3):
        one = tridiag.thomas_solve(*(torch.from_numpy(x[k]) for x in (a, b, c, d)))
        assert torch.equal(one, batch[k])
        ref = jtd.thomas_solve(*(jnp.asarray(x[k]) for x in (a, b, c, d)))
        assert np.max(np.abs(one.numpy() - np.asarray(ref))) <= \
            TOL[dtype] * np.max(np.abs(np.asarray(ref)))


def test_solution_solves_the_system():
    a, b, c, d = _systems(9, 1, 40, np.float64)
    x = tridiag.thomas_solve(*(torch.from_numpy(v[0]) for v in (a, b, c, d))).numpy()
    dense = np.diag(b[0]) + np.diag(a[0], -1) + np.diag(c[0], 1)
    np.testing.assert_allclose(dense @ x, d[0], rtol=0, atol=1e-12)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    a, b, c, d = (torch.from_numpy(x) for x in _systems(3, 2, 8, np.float64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_tridiag.thomas_solve_batched(a, b, c, d)


def test_jax_solver_is_a_scan_not_a_pallas_kernel():
    """No Pallas kernel to port: the JAX solve is a traced scan."""
    a, b, c, d = (jnp.asarray(x[0]) for x in _systems(1, 1, 6, np.float64))
    text = str(jax.make_jaxpr(jtd.thomas_solve)(a, b, c, d))
    assert "scan" in text and "pallas_call" not in text
