"""Port parity: the GyroSwin surrogate and the GENE-like proxy
(``models/surrogates/gyro_swin.py``) with row W's plain twin
(``ops/cuda_proxy.gene_proxy_plain``).

The closure is within 1e-12 of JAX's in float64; the dataset's features are
JAX's (both draw with numpy) and its targets within 1e-7.  The surrogate's
float32 features are within 1e-5 of JAX's.  Its Gram system is
ill-conditioned (a one-ulp change of a feature moves the weights a lot), so
the fits are compared by their predictions (within 1e-3 of the target's
scale) and by the JAX tests' RMSE gates, not by their weights.  Row W's
plain twin is within 1e-12 of ``gene_proxy_predict`` in float64 at the JAX
test's 64 x 2000 and within 1e-5 in float32 (XLA's float32 tanh is its own
approximation; the fixed point contracts, so the difference does not grow),
and equals the closure looped by hand.  ``interop.gyro_swin_surrogate``
carries JAX's fitted model across with its predictions.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import c_struct_fields, ctypes_fields, rel

from scpn_fusion_tpu.models.surrogates import gyro_swin as jgs
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.surrogates import gyro_swin as tgs
from scpn_fusion_tpu_torch.ops import cuda_proxy as cp

ROOT = Path(__file__).resolve().parent.parent
F64 = torch.float64


def _features(seed: int, n: int) -> np.ndarray:
    return jgs.generate_synthetic_dataset(seed, n)[0].astype(np.float64)


def test_closure_matches_jax():
    x = _features(0, 500)
    x[::7, 4] = -0.3     # negative shear: the clamp
    got = tgs.synthetic_core_turbulence_target(torch.from_numpy(x))
    ref = jgs.synthetic_core_turbulence_target(jnp.asarray(x))
    assert rel(got, ref) <= 1e-12
    one = tgs.synthetic_core_turbulence_target(torch.from_numpy(x[0]))
    assert one.shape == (1,) and float(one[0]) == float(got[0])


def test_dataset_matches_jax():
    x_j, y_j = jgs.generate_synthetic_dataset(5, 300)
    x_t, y_t = tgs.generate_synthetic_dataset(5, 300, dtype=F64)
    assert x_t.dtype == y_t.dtype == np.float32
    assert np.array_equal(x_t, x_j)
    assert rel(y_t, y_j) <= 1e-7


def test_fit_features_and_predictions_match_jax():
    x, y = jgs.generate_synthetic_dataset(0, 2000)
    ref = jgs.fit_gyro_swin(x, y, ridge=5e-3)
    got = tgs.fit_gyro_swin(x, y, ridge=5e-3, device="cpu")
    for name in ("w_random", "b_random"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    assert rel(got.x_mean, ref.x_mean) <= 1e-6 and rel(got.x_std, ref.x_std) <= 1e-6
    x_test, y_test = jgs.generate_synthetic_dataset(99, 500)
    assert rel(got._features(torch.from_numpy(x_test)), ref._features(jnp.asarray(x_test))) <= 1e-5
    pred_t = got.predict(torch.from_numpy(x_test)).numpy()
    pred_j = np.asarray(ref.predict(jnp.asarray(x_test)))
    assert np.max(np.abs(pred_t - pred_j)) <= 1e-3 * np.max(np.abs(y_test))


def test_interop_round_trip():
    x, y = jgs.generate_synthetic_dataset(2, 300)
    ref = jgs.fit_gyro_swin(x, y, hidden=16)
    model = interop.gyro_swin_surrogate(ref, device="cpu")
    for name in tgs.GyroSwinSurrogate._fields:
        assert np.array_equal(getattr(model, name).numpy(), np.asarray(getattr(ref, name)))
    back = interop.gyro_swin_surrogate(model, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, model))
    assert rel(model.predict(torch.from_numpy(x)), ref.predict(jnp.asarray(x))) <= 1e-5


def test_fit_meets_the_jax_gates():
    """``tests/test_force_balance_gyroswin.py``'s fit gates: RMSE < 7% on the
    8000 training samples, < 8% on 500 held out."""
    x, y = tgs.generate_synthetic_dataset(0, 8000)
    model = tgs.fit_gyro_swin(x, y, ridge=5e-3, device="cpu")
    assert tgs.rmse_percent(y, model.predict(torch.from_numpy(x)).numpy()) < 7.0
    x_test, y_test = tgs.generate_synthetic_dataset(99, 500)
    assert tgs.rmse_percent(y_test, model.predict(torch.from_numpy(x_test)).numpy()) < 8.0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_row_w_twin_matches_gene_proxy_predict(dtype, tol):
    x, y = jgs.generate_synthetic_dataset(3, 64)
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    ref = jgs.gene_proxy_predict(jnp.asarray(x, jdt), 2000)
    got = tgs.gene_proxy_predict(torch.from_numpy(x).to(dtype), 2000)
    assert got.dtype == dtype and got.shape == (64,)
    assert rel(got, ref) <= tol
    assert tgs.rmse_percent(y, got.numpy()) < 5.0


def test_row_w_twin_is_the_closure_looped():
    x = torch.from_numpy(_features(4, 33))
    chi = torch.zeros(33, dtype=F64)
    for _ in range(25):
        eff = x * (1.0 + 0.005 * torch.tanh(chi)[:, None])
        chi = chi + 0.05 * (tgs.synthetic_core_turbulence_target(eff) - chi)
    assert torch.equal(cp.gene_proxy_plain(x, 25), chi)
    assert torch.equal(cp.gene_proxy(x, 25), chi)


def test_speed_benchmark_on_the_cpu():
    bench = tgs.run_speed_benchmark(samples=256, iterations=2000, device="cpu")
    assert bench.speedup > 2.0
    assert bench.rmse_percent < 5.0
    assert bench.surrogate_s_per_sample > 0.0


def test_row_w_refuses_gradients_and_host_tensors():
    x = torch.from_numpy(_features(1, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cp.check_inputs(x)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        cp.check_inputs(x.clone().requires_grad_())
    with pytest.raises(TypeError, match="float32 or float64"):
        cp.check_inputs(x.to(torch.float16))


def test_row_w_argument_block_lists_the_c_source():
    src = (ROOT / "scpn_fusion_tpu_torch" / "csrc" / "gene_proxy.cu").read_text()
    assert ctypes_fields(cp._Args) == c_struct_fields(src, "ProxyArgs")


def test_default_device_is_the_card():
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    x, y = tgs.generate_synthetic_dataset(0, 64)
    calls = (lambda: tgs.fit_gyro_swin(x, y, hidden=8).weights,
             lambda: tgs.run_speed_benchmark(samples=16, iterations=2) and
             torch.zeros(1, device="cuda"))
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
