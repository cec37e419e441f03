"""Port parity: the neural equilibrium kernel (``control/neural_kernel.py``)
on the committed surrogate (``weights/neural_equilibrium.npz``, loaded by
``pretrained.load_equilibrium_artifact``) and the equilibrium surrogate's
forward pass (``models/surrogates/equilibrium_surrogate.py``).

The artifact is float32 and its MLP sums in another order in PyTorch and in
XLA, so the predicted psi is held at 1e-5 of its span; the softmax axis
locator at 1e-12 on the same psi; the closed shape loop (the JAX test's PI
gains, 60 ticks) at 1e-5.  The loader refuses an artifact whose checksum
does not match, as JAX's does.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.control import neural_kernel as jk
from scpn_fusion_tpu.models.surrogates import pretrained as jp
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import neural_kernel as tk
from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp

BASE_I = np.asarray([-1.0, 4.0, 6.0, 4.0, -1.0, 3.0], np.float32)


@pytest.fixture(scope="module")
def surrogates():
    sur_j, m_j = jp.load_equilibrium_artifact()
    sur_t, m_t = tp.load_equilibrium_artifact(device="cpu")
    assert m_t == m_j
    return sur_j, sur_t


def test_loaded_artifact_equals_jax(surrogates):
    sur_j, sur_t = surrogates
    for f in ("components", "psi_mean", "x_mean", "x_std", "coeff_scale"):
        assert np.array_equal(getattr(sur_t, f).numpy(), np.asarray(getattr(sur_j, f)))
    assert sur_t.shape == sur_j.shape
    carried = interop.equilibrium_surrogate(sur_j, device="cpu")
    assert torch.equal(carried.mlp.weights[0], sur_t.mlp.weights[0])


def test_predict_and_axis_match_jax(surrogates):
    sur_j, sur_t = surrogates
    n = sur_j.shape[0]
    r1, z1 = np.linspace(2.0, 10.0, n), np.linspace(-4.0, 4.0, n)
    psi_j = sur_j.predict(jnp.asarray(BASE_I))
    psi_t = sur_t.predict(torch.from_numpy(BASE_I))
    span = float(jnp.max(psi_j) - jnp.min(psi_j))
    assert float(np.max(np.abs(as_np(psi_t) - as_np(psi_j)))) <= 1e-5 * span
    psi = np.asarray(psi_j, np.float64)
    ax_j = jk.soft_axis_position(jnp.asarray(psi), jnp.asarray(r1), jnp.asarray(z1))
    ax_t = tk.soft_axis_position(torch.from_numpy(psi), torch.from_numpy(r1), torch.from_numpy(z1))
    for a, b in zip(ax_t, ax_j):
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))


def test_shape_loop_matches_jax(surrogates):
    sur_j, sur_t = surrogates
    n = sur_j.shape[0]
    r1, z1 = np.linspace(2.0, 10.0, n), np.linspace(-4.0, 4.0, n)
    steer = np.asarray([0, 0, 1.0, 0, 1.0, 0.0], np.float32)
    steer = steer / np.linalg.norm(steer)
    kw = dict(target_r=6.3, n_ticks=60, kp=2.0, ki=0.2)
    ref = jk.run_neural_shape_loop(sur_j, jnp.asarray(BASE_I), jnp.asarray(r1), jnp.asarray(z1),
                                   steer=jnp.asarray(steer), **kw)
    ours = tk.run_neural_shape_loop(sur_t, torch.from_numpy(BASE_I), torch.from_numpy(r1),
                                    torch.from_numpy(z1), steer=torch.from_numpy(steer), **kw)
    for f in ("axis_r", "axis_z", "currents"):
        assert rel(getattr(ours, f), getattr(ref, f)) <= 1e-5, f
    assert float(np.max(np.abs(as_np(ours.err_r) - as_np(ref.err_r)))) <= 1e-5


def test_checksum_mismatch_refused(tmp_path):
    for f in ("neural_equilibrium.npz", "neural_equilibrium.metrics.json"):
        shutil.copy(tp.WEIGHTS_DIR / f, tmp_path / f)
    with open(tmp_path / "neural_equilibrium.npz", "ab") as fh:
        fh.write(b"x")
    with pytest.raises(RuntimeError, match="checksum"):
        tp.load_equilibrium_artifact(weights_dir=tmp_path, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tp.load_equilibrium_artifact()[0].components.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tp.load_equilibrium_artifact()
