"""Port parity: the SOC sandpile (``models/physics/sandpile``) and row S's
plain twin (``ops/cuda_sandpile.sandpile_run_plain``).

JAX draws a drive cell a step from a split threefry key (``randint`` under
x64 draws int64); the test draws the same cells with ``jax.random`` and feeds
them to the port's ``_run_sandpile``.  In float64 on the CPU the final
heights, the avalanche sizes and the edge flux are EQUAL to JAX's, and so is
the mean slope (a sum of integers times 1/(n - 1) rounded once: XLA turns
``jnp.mean``'s division into that product): 32 cells x 300 drives, the
mass-conservation case of ``tests/test_sandpile_property.py`` (32 x 500,
seed 1) and a core drive.  That test's mass gate holds for the port's own
draws (its marginal-slope gate at 24 x 6000 drives:
``tests/test_torch_sandpile_marginal.py``); float32 gives the same integers.  The plain twin equals
the module's sweep looped by hand, bit for bit, also off the integers; the
kernel's argument block lists the C struct field for field.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_parity import c_struct_fields, ctypes_fields

from scpn_fusion_tpu.models.physics import sandpile as js
from scpn_fusion_tpu_torch.models.physics import sandpile as ts
from scpn_fusion_tpu_torch.ops import cuda_sandpile as cs

F64 = torch.float64
CSRC = Path(cs.__file__).resolve().parent.parent / "csrc"
KW = dict(dtype=F64, device="cpu")


def jax_drive_indices(cfg, seed: int) -> torch.Tensor:
    """The drive cells of ``js.run_sandpile(cfg, seed)``: its split chain
    (``sandpile.py:66-75``), drawn as JAX draws them."""
    def body(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.randint(sub, (), 0, cfg.n_cells // 2)

    _, idx = jax.lax.scan(body, jax.random.PRNGKey(seed), None, length=cfg.n_steps)
    return torch.from_numpy(np.array(idx, dtype=np.int64))


def _equal_to_jax(ours, ref):
    for name, a, b in zip(ref._fields, ours, ref):
        assert a.dtype == F64 and np.array_equal(a.numpy(), np.asarray(b)), name


@pytest.mark.parametrize("n_cells, n_steps, seed", [(32, 300, 0), (32, 500, 1), (17, 200, 5)])
def test_run_equals_jax(n_cells, n_steps, seed):
    cfg_j = js.SandpileConfig(n_cells=n_cells, n_steps=n_steps)
    cfg = ts.SandpileConfig(n_cells=n_cells, n_steps=n_steps)
    ref = js.run_sandpile(cfg_j, seed=seed)
    ours = ts._run_sandpile(cfg, jax_drive_indices(cfg_j, seed), **KW)
    _equal_to_jax(ours, ref)
    assert ts.avalanche_statistics(ours) == js.avalanche_statistics(ref)


def test_core_drive_equals_jax():
    """``drive_location="core"``: JAX still splits its key every step, the
    port draws nothing; every grain lands on cell 0 on both sides."""
    cfg_j = js.SandpileConfig(n_cells=20, n_steps=250, drive_location="core")
    cfg = ts.SandpileConfig(n_cells=20, n_steps=250, drive_location="core")
    idx = ts.drive_indices(cfg, seed=3)
    assert idx.dtype == torch.int64 and not idx.any()
    _equal_to_jax(ts.run_sandpile(cfg, seed=3, **KW), js.run_sandpile(cfg_j, seed=3))


def test_draws_follow_the_seed():
    cfg = ts.SandpileConfig(n_cells=40, n_steps=500)
    a, b = ts.drive_indices(cfg, 7), ts.drive_indices(cfg, 7)
    assert torch.equal(a, b) and not torch.equal(a, ts.drive_indices(cfg, 8))
    assert int(a.min()) >= 0 and int(a.max()) < 20


def test_mass_conservation():
    cfg = ts.SandpileConfig(n_cells=32, n_steps=500)
    trace = ts.run_sandpile(cfg, seed=1, **KW)
    held, out = float(torch.sum(trace.heights_final)), float(torch.sum(trace.flux_out))
    assert held + out == pytest.approx(cfg.drive_amount * cfg.n_steps, rel=1e-6)


def test_config_validation():
    with pytest.raises(ValueError):
        ts.SandpileConfig(topple_amount=5.0, critical_slope=4.0)


def test_float32_gives_the_same_integers():
    cfg = ts.SandpileConfig(n_cells=24, n_steps=300)
    a = ts.run_sandpile(cfg, seed=2, dtype=torch.float32, device="cpu")
    b = ts.run_sandpile(cfg, seed=2, **KW)
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == torch.float32 and torch.equal(x.double(), y)
    sums = torch.round(b.mean_slope * (cfg.n_cells - 1)).float()
    assert torch.equal(a.mean_slope, sums * torch.reciprocal(torch.tensor(cfg.n_cells - 1.0)))


def _hand_loop(cfg, h, idx):
    rows = []
    for k in range(idx.shape[0]):
        h = h.clone()
        h[int(idx[k])] += cfg.drive_amount
        n_top, out = h.new_zeros(()), h.new_zeros(())
        for _ in range(cfg.relax_sweeps):
            h, n_top, out = ts.sweep(cfg, h, n_top, out)
        rows.append((n_top, out, torch.sum(h[:-1] - h[1:])
                     * (torch.ones((), dtype=h.dtype) / (cfg.n_cells - 1))))
    return (h, *(torch.stack(c) for c in zip(*rows)))


@pytest.mark.parametrize("cfg", [ts.SandpileConfig(n_cells=30, n_steps=120),
                                 ts.SandpileConfig(n_cells=30, n_steps=120, drive_amount=0.75,
                                                   topple_amount=1.5, critical_slope=2.2,
                                                   relax_sweeps=9)])
def test_plain_twin_is_the_sweep_loop(cfg):
    for dtype in (torch.float32, F64):
        idx = ts.drive_indices(cfg, 4)
        h0 = torch.zeros(cfg.n_cells, dtype=dtype)
        for a, b in zip(cs.sandpile_run_plain(cfg, h0, idx), _hand_loop(cfg, h0, idx)):
            assert torch.equal(a, b)


def test_argument_block_matches_the_kernel_source():
    src = (CSRC / "sandpile.cu").read_text()
    assert c_struct_fields(src, "SandpileArgs") == ctypes_fields(cs._Args)
    cfg = ts.SandpileConfig(n_cells=40, n_steps=9)
    h0, idx = torch.zeros(40, dtype=F64), ts.drive_indices(cfg)
    args, outs = cs.launch_args(cfg, h0, idx)
    assert (args.n, args.n_steps, args.sweeps) == (40, 9, 64) and args.idx == idx.data_ptr()
    assert [o.shape for o in outs] == [(40,), (9,), (9,), (9,)] and args.slope == outs[3].data_ptr()
    assert (args.critical, args.topple, args.drive) == (4.0, 2.0, 1.0)
    assert [cs.threads_for(n) for n in (2, 24, 128, 1000, 5000)] == [32, 32, 128, 1024, 1024]


def test_guards_and_default_device():
    cfg = ts.SandpileConfig(n_cells=16, n_steps=4)
    with pytest.raises(ValueError, match="CUDA"):
        cs.check_sandpile(cfg, torch.zeros(16, dtype=F64), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        cs.check_sandpile(cfg, torch.zeros(16, dtype=torch.int32),
                          torch.zeros(4, dtype=torch.int64))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            ts.run_sandpile(cfg)
