"""Port parity: row L (``ops/cuda_ladder.py``, ``csrc/ladder.cu``) and row
N's linear-plant variant (``ops/cuda_closed_loop.closed_loop_linear``).

On the CPU the wrappers run their plain versions.  ``ladder_plain`` (the
batched tick loop of the PID, H-inf and MPC lanes) and
``closed_loop_linear_plain`` (the SNN lane's per-tick loop) are held to the
JAX package's ``disturbance_ladder._run_loop`` on the VDE scenario at full
length (20,000 ticks) in float64: the z trace, ISE, overshoot and control
effort within 1e-9, the settling index equal.  Lanes of different lengths
in one call equal the same lanes one at a time.  The ctypes argument blocks
list the C structs field for field and point every field at its tensor; the
guards refuse CPU tensors and inconsistent lanes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import disturbance_ladder as jl
from scpn_fusion_tpu_torch.control import disturbance_ladder as tl
from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
from scpn_fusion_tpu_torch.ops import cuda_ladder as cl

CSRC = Path(cl.__file__).resolve().parent.parent / "csrc"
F64 = torch.float64
JAX_RUN = {"PID": jl.run_pid, "H-infinity": jl.run_hinf, "MPC": jl.run_mpc, "SNN": jl.run_snn}


def _same_metrics(ours, ref):
    assert rel(ours.z_trace, ref.z_trace) <= 1e-9
    for f in ("ise", "overshoot", "control_effort"):
        assert rel(getattr(ours, f), getattr(ref, f)) <= 1e-9, f
    assert float(ours.settling_time_s) == float(ref.settling_time_s)
    assert bool(ours.stable) == bool(ref.stable)


@pytest.mark.parametrize("controller", ["PID", "H-infinity", "MPC"])
def test_ladder_plain_matches_jax_on_vde(controller):
    z, u = cl.ladder(tl.linear_lanes([(controller, "VDE")], F64, "cpu"), dt=tl.DT,
                     u_max=tl.U_MAX)
    assert z.shape == (20_000,)
    _same_metrics(tl._metrics(z, u), JAX_RUN[controller]("VDE", dtype=jnp.float64))


def test_snn_plain_matches_jax_on_vde():
    ctrl = tl._build_z_net(2e3, F64, "cpu")
    cs, xf, tr = ccl.closed_loop_linear(ctrl, tl.snn_config(), tl.initial_state("VDE", F64, "cpu"),
                                        tl.snn_plant("VDE", F64, "cpu"))
    assert tr["firing"].shape == (20_000, 4) and xf.shape == (2,)
    assert torch.equal(tr["u"], torch.clamp(tr["actions"][:, 0], -tl.U_MAX, tl.U_MAX))
    _same_metrics(tl._metrics(tr["z"], tr["u"]), jl.run_snn("VDE", dtype=jnp.float64))


def _cut(spec: cl.LadderLanes, n_ticks) -> cl.LadderLanes:
    """The lanes' first ``n_ticks`` ticks."""
    return spec._replace(n_ticks=torch.tensor(n_ticks, dtype=torch.int32))


def test_lanes_of_different_lengths_pack_and_unpack():
    lanes = [("MPC", "elm_pacing"), ("PID", "VDE"), ("H-infinity", "density_ramp"),
             ("MPC", "VDE")]
    spec = tl.linear_lanes(lanes, F64, "cpu")
    assert spec.n_ticks.tolist() == [30_000, 20_000, 40_000, 20_000]
    cut = [700, 300, 500, 200]
    z, u = cl.ladder_plain(_cut(spec, cut), dt=tl.DT, u_max=tl.U_MAX)
    for i, (zl, ul) in enumerate(zip(cl.unpack(z, cut), cl.unpack(u, cut))):
        one = spec._replace(**{f: getattr(spec, f)[i:i + 1] for f in
                               ("kind", "params", "x0", "d_off")})
        z1, u1 = cl.ladder_plain(_cut(one, [cut[i]]), dt=tl.DT, u_max=tl.U_MAX)
        assert torch.equal(zl, z1) and torch.equal(ul, u1)


def _c_fields(source: str, struct: str):
    body = source[source.index(f"struct {struct} {{"):source.index("};", source.index(struct))]
    fields = []
    for ctype, names in re.findall(r"^\s*(const void\*|void\*|const int\*|int\*|const long "
                                   r"long\*|const unsigned char\*|int|double)\s+([\w, ]+);",
                                   body, re.M):
        fields += [(n.strip(), "ptr" if "*" in ctype else ctype) for n in names.split(",")]
    return fields


def test_ladder_argument_block_matches_the_kernel_source():
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_double": "double"}
    src = (CSRC / "ladder.cu").read_text()
    assert _c_fields(src, "LadderArgs") == [(n, kinds[t.__name__]) for n, t in cl._Args._fields_]
    assert f"constexpr int N_PARAMS = {cl.N_PARAMS};" in src
    spec = tl.linear_lanes([("PID", "VDE"), ("H-infinity", "density_ramp")], F64, "cpu")
    args, (z, u, out_off) = cl.launch_args(spec, dt=tl.DT, u_max=tl.U_MAX)
    assert out_off.tolist() == [0, 20_000] and z.shape == u.shape == (60_000,)
    assert args.params == spec.params.data_ptr() and args.trace_u == u.data_ptr()
    assert args.n_lanes == 2 and args.dt == tl.DT and args.integ_max == cl.INTEG_MAX
    assert spec.d_off.tolist() == [0, 20_000] and spec.params[1, 12] == tl.GAMMA_GROWTH * tl.DT


def test_closed_loop_linear_argument_block():
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_double": "double"}
    src = (CSRC / "closed_loop.cu").read_text()
    assert _c_fields(src, "ClosedLoopArgs") == [(n, kinds[t.__name__])
                                                for n, t in ccl._Args._fields_]
    ctrl = tl._build_z_net(2e3, F64, "cpu")
    plant = tl.snn_plant("VDE", F64, "cpu")
    x0 = tl.initial_state("VDE", F64, "cpu")
    args, state, trace, threads = ccl.launch_args(ctrl, tl.snn_config(), (x0[0], x0[1]),
                                                  n_ticks=20_000, dt=plant.dt, linear=plant)
    assert args.plant_kind == 1 and args.u_max == tl.U_MAX and args.plant_dt == tl.DT
    assert args.lin_plant == plant.matrices.data_ptr() and args.lin_d == plant.d.data_ptr()
    assert state[4].tolist() == [0.01, 0.0] and threads == 32


def test_guards():
    spec = tl.linear_lanes([("PID", "VDE")], F64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cl.check_ladder(spec)
    ctrl = tl._build_z_net(2e3, F64, "cpu")
    plant = tl.snn_plant("VDE", F64, "cpu")
    x0 = tl.initial_state("VDE", F64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ccl.check_closed_loop(ctrl, tl.snn_config(), (x0[0], x0[1]), 20_000, plant)
    from scpn_fusion_tpu_torch.bench_config import RZ_SPECS, rz_net
    from scpn_fusion_tpu_torch.scpn.controller import build_controller
    from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet
    rz = build_controller(rz_net(StochasticPetriNet), dtype=F64, device="cpu", **RZ_SPECS)
    with pytest.raises(ValueError, match="one action"):
        ccl.check_closed_loop(rz, tl.snn_config(), (x0[0], x0[1]), 20_000, plant)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tl.linear_lanes([("PID", "VDE")]).params.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tl.linear_lanes([("PID", "VDE")])
