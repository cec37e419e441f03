"""Port parity: phase observability (``models/phase/monitor``) -- the
snapshot recorder, the stream codec, the GK -> UPDE bridge -- and the
interop converters of the monitor and the polynomial chaos.

float64 on the CPU.  Snapshots of the port's monitored run equal JAX's in
their integers and booleans and agree within 1e-12 in their numbers; a
trace saved with ``save_npz`` loads back bit for bit; the codec's frames,
token checks and bounds behave as JAX's (pure Python on both sides); the GK
bridge within 1e-15 of JAX, on the port's native TGLF fluxes as on JAX's.
The interop converters carry a JAX ``MonitorState`` (with its
``GuardState``), the monitor's arrays, a ``PCEModel`` and a
``TransportState`` across and back bit for bit.
"""

import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, to_torch

from scpn_fusion_tpu.models.phase import knm as jk
from scpn_fusion_tpu.models.phase import monitor as jm
from scpn_fusion_tpu.models.transport import solver as jsol
from scpn_fusion_tpu.models.uq import pce as jp
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.phase import knm as tk
from scpn_fusion_tpu_torch.models.phase import monitor as tm
from scpn_fusion_tpu_torch.models.uq import pce as tp

F64 = torch.float64


@pytest.fixture(scope="module")
def traces():
    js, ja = jm.init_monitor(jk.build_knm_plasma("baseline", 8), n_per=20, seed=3,
                             dtype=jnp.float64)
    ts = interop.monitor_state(js, dtype=F64, device="cpu")
    ta = interop.monitor_arrays(ja, dtype=F64, device="cpu")
    _, jt = jm.run_monitor(js, ja, n_ticks=40)
    _, tt = tm.run_monitor(ts, ta, n_ticks=40)
    return jt, tt


def test_snapshots_match_jax(traces):
    jt, tt = traces
    assert tt.n_ticks == jt.n_ticks == 40
    for i in (0, 17, 39):
        a, b = tt.snapshot(i), jt.snapshot(i)
        assert a.keys() == b.keys()
        for key in ("tick", "guard_approved", "guard_violations"):
            assert a[key] == b[key] and type(a[key]) is type(b[key]), key
        for key in ("R_global", "V_global", "lambda_exp", "R_layer", "V_layer"):
            assert rel(np.asarray(a[key]), np.asarray(b[key])) <= 1e-12, key


def test_save_npz_round_trip(traces, tmp_path):
    _, tt = traces
    path = tt.save_npz(tmp_path / "trace.npz")
    data = np.load(path)
    assert sorted(data.files) == sorted(tt._fields)
    for name in tt._fields:
        assert np.array_equal(data[name], getattr(tt, name).numpy()), name
    assert data["guard_violations"].dtype == np.int32 and data["guard_approved"].dtype == bool


def test_stream_frames_match_jax(traces):
    jt, tt = traces
    codec_t, codec_j = tm.PhaseStreamCodec(token="s3cret"), jm.PhaseStreamCodec(token="s3cret")
    buf_t, buf_j = io.BytesIO(), io.BytesIO()
    assert tm.stream_trace(tt, codec_t, buf_t) == jm.stream_trace(jt, codec_j, buf_j) == 40
    lines_t, lines_j = buf_t.getvalue().splitlines(), buf_j.getvalue().splitlines()
    assert len(lines_t) == len(lines_j) == 40
    for lt, lj in zip(lines_t, lines_j):
        pt, pj = codec_t.decode(lt), codec_j.decode(lj)
        assert pt.keys() == pj.keys() and pt["tick"] == pj["tick"]
        assert pt["guard_violations"] == pj["guard_violations"]


def test_codec_rejections_match_jax():
    codec = tm.PhaseStreamCodec(token="right", command_bounds=(-1.0, 1.0))
    frame = tm.PhaseStreamCodec(token="wrong").encode_snapshot({"tick": 1})
    with pytest.raises(tm.StreamAuthError, match="token"):
        codec.decode(frame)
    with pytest.raises(tm.StreamAuthError, match="size"):
        tm.PhaseStreamCodec(token="right", max_frame_bytes=64).decode(b"x" * 100)
    with pytest.raises(tm.StreamAuthError, match="malformed"):
        codec.decode(b"not json")
    ok = json.dumps({"type": "command", "token": "right", "name": "zeta", "value": 0.5}).encode()
    assert codec.decode_command(ok) == ("zeta", 0.5)
    bad = json.dumps({"type": "command", "token": "right", "name": "zeta", "value": 5.0}).encode()
    with pytest.raises(tm.StreamAuthError, match="bounds"):
        codec.decode_command(bad)
    for frame in (b"[1, 2]", json.dumps({"type": "snapshot", "token": "right"}).encode()):
        with pytest.raises(tm.StreamAuthError):
            codec.decode_command(frame)
    assert jm.PhaseStreamCodec(token="right").encode_snapshot({"tick": 1}) == \
        tm.PhaseStreamCodec(token="right").encode_snapshot({"tick": 1})
    for host in ("127.0.0.1", "::1", "localhost", "0.0.0.0", "10.0.0.1"):
        assert tm.is_loopback_host(host) == jm.is_loopback_host(host)
    assert tm.constant_time_token_eq("a", "a") and not tm.constant_time_token_eq("a", "b")


@pytest.mark.parametrize("gamma, chi_e, ped", [(0.5, 0.0, False), (0.0, 0.0, False),
                                               (1.2, 3.0, True), (-0.3, 0.7, True)])
def test_gk_bridge_matches_jax(gamma, chi_e, ped):
    k_j = jk.build_knm_plasma("baseline", 8).arrays(jnp.float64)[0]
    k_t = tk.build_knm_plasma("baseline", 8).arrays(F64, "cpu")[0]
    chi = np.ones(30)
    chi[-6:] = 3.0
    kw_j = dict(chi_i_profile=jnp.asarray(chi)) if ped else {}
    kw_t = dict(chi_i_profile=to_torch(chi)) if ped else {}
    ours = tm.adaptive_knm_from_gk(k_t, gamma, chi_e, **kw_t)
    ref = jm.adaptive_knm_from_gk(k_j, gamma, chi_e, **kw_j)
    assert float(np.max(np.abs(ours.numpy() - np.asarray(ref)))) <= 1e-15
    assert torch.equal(k_t, tk.build_knm_plasma("baseline", 8).arrays(F64, "cpu")[0])
    omega = np.asarray(jk.plasma_omega(8))
    assert rel(tm.gk_natural_frequencies(to_torch(omega), gamma),
               jm.gk_natural_frequencies(jnp.asarray(omega), gamma)) <= 1e-15
    small = torch.ones(4, 4, dtype=F64)
    assert tm.adaptive_knm_from_gk(small, 1.0, 1.0) is small


def test_gk_bridge_on_native_tglf():
    """End to end: the port's native TGLF fluxes drive the K_nm modulation
    (``tests/test_phase_monitor.py``'s last case)."""
    from scpn_fusion_tpu_torch.models.gyrokinetics.tglf_native import (
        TGLFNativeConfig,
        tglf_native_fluxes,
    )
    r = tglf_native_fluxes(9.0, 6.9, 2.2, 1.4, 0.8, 0.16, 1.0, 0.1, 2.0, 5.3, 6.2, 8.0,
                           cfg=TGLFNativeConfig(n_ky_ion=6, n_energy=16, n_lambda=12),
                           device="cpu")
    k_base = tk.build_knm_plasma("baseline", 8).arrays(F64, "cpu")[0]
    k_mod = tm.adaptive_knm_from_gk(k_base, torch.max(r.gamma_net), r.chi_e)
    assert bool(torch.isfinite(k_mod).all()) and float(k_mod[0, 1]) > float(k_base[0, 1])


def test_interop_monitor_round_trip():
    js, ja = jm.init_monitor(jk.build_knm_plasma("elm", 8), n_per=12, seed=9, dtype=jnp.float64)
    jf, _ = jm.run_monitor(js, ja, n_ticks=5)
    for state in (js, jf):
        ts = interop.monitor_state(state, dtype=F64, device="cpu")
        assert np.array_equal(ts.theta.numpy(), np.asarray(state.theta))
        assert np.array_equal(ts.guard.v_buffer.numpy(), np.asarray(state.guard.v_buffer))
        assert ts.guard.n_seen.dtype == torch.int32 and int(ts.guard.n_seen) == \
            int(state.guard.n_seen)
        assert int(ts.guard.consecutive) == int(state.guard.consecutive)
        assert int(ts.tick) == int(state.tick)
        fields = {"theta": np.asarray(state.theta), "tick": np.asarray(state.tick),
                  "guard": {k: np.asarray(v) for k, v in state.guard._asdict().items()}}
        again = interop.monitor_state(fields, dtype=F64, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            (again.theta, *again.guard, again.tick), (ts.theta, *ts.guard, ts.tick)))
    ta = interop.monitor_arrays(ja, dtype=F64, device="cpu")
    assert ta.keys() == ja.keys()
    for key in ja:
        assert np.array_equal(ta[key].numpy(), np.asarray(ja[key])), key


def test_interop_pce_and_transport_round_trip():
    x = np.random.default_rng(0).normal(size=(60, 2))
    model = jp.fit_pce(jnp.asarray(x), jnp.asarray(x[:, :1] * 2.0 + x[:, 1:] ** 2), order=2)
    ours = interop.pce_model(model, device="cpu")
    assert ours.coefficients.dtype == F64 and ours.multi_index == model.multi_index
    assert np.array_equal(ours.coefficients.numpy(), np.asarray(model.coefficients))
    pt = tp.predict_pce(ours, to_torch(x))
    assert rel(pt, jp.predict_pce(model, jnp.asarray(x))) <= 1e-13
    params = jsol.TransportParams(nr=16)
    s0 = jsol.initial_state(params, jnp.float64)
    ts0 = interop.transport_state(s0._asdict(), dtype=F64, device="cpu")
    for name, a in ts0._asdict().items():
        assert np.array_equal(a.numpy(), np.asarray(getattr(s0, name))), name
    assert interop.transport_params(dataclasses.asdict(params)).nr == 16
