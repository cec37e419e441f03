"""Port parity: the neural-transport surrogate and adaptive time stepping
(``models/surrogates/{mlp,pretrained}.py``, ``models/transport/adaptive.py``).

The committed artifact loads fail-closed (sha256 against its metrics file)
into the same arrays as JAX's loader, and through ``interop``; its fluxes on
in-distribution points agree with JAX's float32 MLP to float32 rounding
(both sum in an order of the backend's choosing), the OOD index exactly, and
OOD points take the analytic closure.  The adaptive run matches JAX in
float64 without the surrogate (dt trace and state within 1e-12) and to
float32 rounding with it.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import span_rel

from scpn_fusion_tpu.models.surrogates import pretrained as jpre
from scpn_fusion_tpu.models.transport import adaptive as jad
from scpn_fusion_tpu.models.transport import solver as js
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.surrogates import pretrained as tpre
from scpn_fusion_tpu_torch.models.transport import adaptive as tad
from scpn_fusion_tpu_torch.models.transport import solver as ts

NR = 40
F32_TOL = 2e-6     # float32 sums in another order (JAX's dot, torch's addmm)


@pytest.fixture(scope="module")
def surrogates():
    ref, ref_metrics = jpre.load_transport_surrogate_pytree()
    ours, metrics = tpre.load_transport_surrogate_pytree(device="cpu")
    assert metrics == ref_metrics and metrics["test_rel_l2"] < 0.25
    return ref, ours


def _params():
    return js.TransportParams(nr=NR), ts.TransportParams(nr=NR)


def _states(dtype_j=jnp.float64, dtype_t=torch.float64):
    ref_p, p = _params()
    return js.initial_state(ref_p, dtype_j), ts.initial_state(p, dtype_t, "cpu")


def test_load_matches_jax_and_interop(surrogates):
    ref, ours = surrogates
    carried = interop.transport_surrogate(ref._asdict(), device="cpu")
    for a, b, c in zip(ref.params.weights + ref.params.biases,
                       ours.params.weights + ours.params.biases,
                       carried.params.weights + carried.params.biases):
        assert b.dtype == torch.float32 and np.array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        assert getattr(ours, name).dtype == torch.float32
        assert np.array_equal(np.asarray(getattr(ref, name)), getattr(ours, name).numpy())
        assert torch.equal(getattr(ours, name), getattr(carried, name))


def test_load_is_fail_closed(tmp_path):
    src = tpre.WEIGHTS_DIR
    shutil.copy(src / "neural_transport.npz", tmp_path / "neural_transport.npz")
    metrics = json.loads((src / "neural_transport.metrics.json").read_text())
    metrics["sha256"] = "0" * 64
    (tmp_path / "neural_transport.metrics.json").write_text(json.dumps(metrics))
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        tpre.load_transport_surrogate_pytree(weights_dir=tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError):
        tpre.load_transport_surrogate_pytree("absent", weights_dir=tmp_path, device="cpu")


def test_fluxes_and_ood_index_match_jax(surrogates):
    ref, ours = surrogates
    ref_p, p = _params()
    js0, ts0 = _states()
    x_ref = js._local_surrogate_inputs(ref_p, js0, ref_p.rho(jnp.float64))
    x = ts._local_surrogate_inputs(p, ts0, p.rho(torch.float64, "cpu"))
    assert span_rel(x, x_ref) <= 1e-13
    # in-distribution and far outside the training envelope
    g = np.random.default_rng(6)
    inside = np.array(x_ref)
    wild = inside * (1.0 + 4.0 * g.random(inside.shape))
    for pts in (inside, wild):
        y_ref = np.asarray(ref.fluxes_gb(jnp.asarray(pts)))
        y = ours.fluxes_gb(torch.from_numpy(pts))
        assert y.dtype == torch.float32
        assert float(np.max(np.abs(y.numpy() - y_ref))) <= F32_TOL * float(np.max(y_ref))
        assert span_rel(ours.max_abs_z(torch.from_numpy(pts)),
                        ref.max_abs_z(jnp.asarray(pts))) <= 1e-14
    z = ours.max_abs_z(x).numpy()
    assert (z <= ref_p.ood_sigma).sum() > 5 and (ours.max_abs_z(torch.from_numpy(wild)).numpy()
                                                 > ref_p.ood_sigma).any()


def test_closure_in_and_out_of_distribution(surrogates):
    ref, ours = surrogates
    ref_p, p = _params()
    js0, ts0 = _states()
    got = ts._transport_coefficients(p, ts0, ours)
    want = js._transport_coefficients(ref_p, js0, ref)
    for a, b in zip(got, want):
        assert span_rel(a, b) <= 1e-5
    analytic = ts._transport_coefficients(p, ts0)
    assert float((got[1] - analytic[1]).abs().max()) > 1e-4     # the network is used
    # q far outside the training envelope: every point takes the analytic closure
    js_ood = js0._replace(q=jnp.full_like(js0.q, 40.0))
    ts_ood = ts0._replace(q=torch.full_like(ts0.q, 40.0))
    got = ts._transport_coefficients(p, ts_ood, ours)
    for a, b, c in zip(got, ts._transport_coefficients(p, ts_ood),
                       js._transport_coefficients(ref_p, js_ood, ref)):
        assert torch.equal(a, b) and span_rel(a, c) <= 1e-12


def test_adaptive_matches_jax_f64():
    ref_p, p = _params()
    js0, ts0 = _states()
    cfg = jad.AdaptiveConfig(dt_init=0.01, tol=1e-3)
    ref, ref_tr = jad.run_transport_adaptive(js0, jnp.asarray(50.0), ref_p, cfg=cfg, n_steps=8)
    ours, tr = tad.run_transport_adaptive(ts0, 50.0, p, cfg=tad.AdaptiveConfig(**vars(cfg)),
                                          n_steps=8)
    for name in ("dt", "error", "time", "ti0"):
        assert span_rel(getattr(tr, name), getattr(ref_tr, name)) <= 1e-12, name
    assert float(tr.dt.std()) > 0.0
    for name in ("ti", "te", "ne", "n_he"):
        assert span_rel(getattr(ours, name), getattr(ref, name)) <= 1e-12, name
    for err in (1e-12, 1e3):
        e = torch.tensor(err, dtype=torch.float64)
        assert float(tad._pi_factor(tad.AdaptiveConfig(**vars(cfg)), e, e)) == pytest.approx(
            float(jad._pi_factor(cfg, jnp.asarray(err), jnp.asarray(err))), rel=1e-15)


def test_adaptive_with_surrogate_matches_jax(surrogates):
    ref_sur, ours_sur = surrogates
    ref_p, p = _params()
    js0, ts0 = _states()
    ref, ref_tr = jad.run_transport_adaptive(js0, jnp.asarray(50.0), ref_p, n_steps=6,
                                             surrogate=ref_sur)
    ours, tr = tad.run_transport_adaptive(ts0, 50.0, p, n_steps=6, surrogate=ours_sur)
    for name in ("dt", "time", "ti0"):
        assert span_rel(getattr(tr, name), getattr(ref_tr, name)) <= 1e-5, name
    for name in ("ti", "te", "chi_i", "chi_e", "d_n"):
        assert span_rel(getattr(ours, name), getattr(ref, name)) <= 1e-5, name
    assert bool(torch.isfinite(ours.ti).all())
