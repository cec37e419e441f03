"""Port parity: the FPGA register-level export of the compiled SCPN
controller (``control/fpga_export.py``).

On the R/Z controller of ``validation/run_control_latency.py`` the port's
register map, ROM images and Verilog header equal JAX's (the quantisation is
numpy in both), and the quantisation report (two 200-tick runs of the plain
``controller_step``, float and quantised weights) is within 1e-9 of JAX's in
float64; the gates of ``tests/test_fpga_export.py:29-88`` hold in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import fpga_export as jfe
from scpn_fusion_tpu.scpn import controller as jc
from scpn_fusion_tpu.scpn.structure import StochasticPetriNet as JNet
from scpn_fusion_tpu_torch.bench_config import RZ_SPECS, rz_net
from scpn_fusion_tpu_torch.control import fpga_export as tfe
from scpn_fusion_tpu_torch.scpn import controller as tc
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet as TNet

TOL = 1e-9


def _pair(dtype_j, dtype_t):
    return (jc.build_controller(rz_net(JNet), dtype=dtype_j, **RZ_SPECS),
            tc.build_controller(rz_net(TNet), dtype=dtype_t, device="cpu", **RZ_SPECS))


def _cfgs():
    kw = dict(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    return jc.ControllerConfig(**kw), tc.ControllerConfig(**kw)


@pytest.mark.parametrize("fmt", [(16, 14), (8, 4), (24, 10)])
def test_register_map_and_exports_equal_jax(fmt):
    ref_ctrl, ctrl = _pair(jnp.float32, torch.float32)
    f_j, f_t = jfe.FixedPointFormat(*fmt), tfe.FixedPointFormat(*fmt)
    reg_j = jfe.generate_register_map(ref_ctrl, clock_mhz=250.0, dt_us=40.0, fmt=f_j)
    reg_t = tfe.generate_register_map(ctrl, clock_mhz=250.0, dt_us=40.0, fmt=f_t)
    for field in reg_j._fields:
        a, b = getattr(reg_t, field), getattr(reg_j, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        elif field != "fmt":
            assert a == b, field
    assert tfe.export_weight_hex(reg_t) == jfe.export_weight_hex(reg_j)
    assert tfe.export_verilog_header(reg_t) == jfe.export_verilog_header(reg_j)


@pytest.mark.parametrize("fmt", [(16, 14), (8, 4)])
def test_quantization_report_matches_jax_f64(fmt):
    ref_ctrl, ctrl = _pair(jnp.float64, torch.float64)
    cfg_j, cfg_t = _cfgs()
    ref = jfe.quantization_report(ref_ctrl, cfg_j, fmt=jfe.FixedPointFormat(*fmt))
    ours = tfe.quantization_report(ctrl, cfg_t, fmt=tfe.FixedPointFormat(*fmt))
    for field in ("max_action_dev", "rms_action_dev", "action_scale"):
        assert rel(np.float64(getattr(ours, field)), np.float64(getattr(ref, field))) <= TOL
    assert ours.acceptable == ref.acceptable


def test_fixed_point_format():
    fmt = tfe.FixedPointFormat()
    x = np.asarray([0.35, -1.0, 1.5, 0.0])
    np.testing.assert_allclose(fmt.dequantize(fmt.quantize(x)), x, atol=1.0 / fmt.scale)
    q = fmt.quantize(np.asarray([100.0, -100.0]))
    assert q[0] == fmt.max_int and q[1] == fmt.min_int
    assert fmt.to_hex(np.asarray([-1, 1])) == ["ffff", "0001"]
    with pytest.raises(ValueError, match="frac_bits"):
        tfe.FixedPointFormat(total_bits=16, frac_bits=16)


def test_jax_gates_hold_in_float32():
    _, ctrl = _pair(jnp.float32, torch.float32)
    _, cfg = _cfgs()
    reg = tfe.generate_register_map(ctrl)
    assert reg.w_in_q.shape == tuple(ctrl.w_in.shape)
    assert reg.dt_ticks == int(100.0 * 100e6 / 1e6)
    assert len(reg.input_ports) == 4 and len(reg.output_ports) == 2
    np.testing.assert_allclose(reg.fmt.dequantize(reg.w_in_q), ctrl.w_in.numpy(),
                               atol=1.0 / reg.fmt.scale)
    images = tfe.export_weight_hex(reg)
    assert len(images["w_in.hex"].strip().splitlines()) == reg.w_in_q.size
    v = tfe.export_verilog_header(reg)
    assert v.count("input  wire signed") == 4 and v.strip().endswith("endmodule")
    fine = tfe.quantization_report(ctrl, cfg)
    coarse = tfe.quantization_report(ctrl, cfg, fmt=tfe.FixedPointFormat(total_bits=8,
                                                                          frac_bits=4))
    assert fine.acceptable and fine.max_action_dev <= 0.02 * fine.action_scale
    assert coarse.rms_action_dev > fine.rms_action_dev
