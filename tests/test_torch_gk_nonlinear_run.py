"""Port parity: whole runs of the nonlinear 5D flux-tube GK solver
(``models/gyrokinetics/nonlinear.py``), through row G's plain version.

At the JAX tests' small sizes (``tests/test_gk_nonlinear.py:27-30``: 8^5, 2
species, 20 steps, complex128) the run from JAX's own initial state matches
the final f and every trace field within 1e-10 relative, in the default,
kinetic-electron, electromagnetic, conservative-collision, zonal-damped and
Miller-geometry variants and all of them at once; a complex64 run within
1e-5; and the linear ITG lane of ``validation/run_gk_scenario.py`` passes
its gate from the validation's own draw.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gk_nonlinear import RUN_TOL, VARIANTS, _pair
from torch_parity import crel as rel

from scpn_fusion_tpu.models.gyrokinetics import nonlinear as jnl
from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as tnl


@pytest.mark.parametrize("variant", list(VARIANTS) + ["miller"])
def test_run_matches_jax(variant):
    """The whole 20-step run from JAX's initial state: final f and every
    trace field within 1e-10 relative."""
    (jc, jg, st), (tc, tg, f) = _pair(VARIANTS.get(variant, {}), geometry=variant == "miller")
    j_final, j_trace = jnl._run_compiled(jc, jg, st)
    t_final, t_trace = tnl._run(tc, tg, tnl.GKState(f, torch.tensor(0.0, dtype=torch.float64)))
    assert t_trace.times.shape == (4,)
    assert rel(t_final.f, j_final.f) <= RUN_TOL
    assert rel(t_final.time, j_final.time) <= RUN_TOL
    for name in j_trace._fields:
        assert rel(getattr(t_trace, name), getattr(j_trace, name)) <= RUN_TOL, name


def test_complex64_run_matches_jax():
    """The 20-step run in complex64 (JAX x64 on, its f32 grids): 1e-5."""
    (jc, jg, st), (tc, tg, _) = _pair(dict(dtype="complex64"))
    assert st.f.dtype == jnp.complex64
    j_final, j_trace = jnl._run_compiled(jc, jg, st)
    f = torch.from_numpy(np.array(st.f))
    t_final, t_trace = tnl._run(tc, tg, tnl.GKState(f, torch.tensor(0.0)))
    assert t_final.f.dtype == torch.complex64 and t_trace.times.dtype == torch.float32
    assert rel(t_final.f, j_final.f) <= 1e-5
    for name in j_trace._fields:
        assert rel(getattr(t_trace, name), getattr(j_trace, name)) <= 1e-5, name


def test_linear_itg_lane_grows_from_the_validation_draw():
    """The linear ITG lane of ``validation/run_gk_scenario.py:78-90`` (gate:
    phi_rms[-1] / phi_rms[0] > 1) on the port, from the validation's own
    initial f (``bench_config.GK_LINEAR_ITG_JAX_F0``, JAX's draw at seed 3,
    held here to ``jnl.init_state``), equal to JAX's run within 1e-5."""
    from scpn_fusion_tpu_torch.bench_config import (
        GK_LINEAR_ITG, GK_LINEAR_ITG_JAX_F0, GK_LINEAR_ITG_RUN,
    )
    jc, tc = jnl.NonlinearGKConfig(**GK_LINEAR_ITG), tnl.NonlinearGKConfig(**GK_LINEAR_ITG)
    jg = jnl.build_grids(jc)
    st = jnl.init_state(jc, jg, **GK_LINEAR_ITG_RUN)
    f0 = np.load(GK_LINEAR_ITG_JAX_F0)
    assert f0.dtype == np.complex64 and np.array_equal(f0, np.asarray(st.f))
    _, j_trace = jnl._run_compiled(jc, jg, st)
    _, t_trace = tnl.run_nonlinear_gk(
        tc, state=tnl.GKState(torch.from_numpy(f0), torch.tensor(0.0)), device="cpu")
    assert float(t_trace.phi_rms[-1]) / float(t_trace.phi_rms[0]) > 1.0
    assert rel(t_trace.phi_rms, j_trace.phi_rms) <= 1e-5
