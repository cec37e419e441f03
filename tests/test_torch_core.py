"""Port parity: config, grid, special functions and vacuum field.

Holds ``scpn_fusion_tpu_torch.core`` and ``models/equilibrium/vacuum.py``
against ``scpn_fusion_tpu.core`` and ``scpn_fusion_tpu.models.equilibrium
.vacuum`` on the same inputs.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, span_rel, to_torch

from scpn_fusion_tpu.core import config as jcfg
from scpn_fusion_tpu.core import special as jsp
from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium import vacuum as jvac
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.core import config as tcfg
from scpn_fusion_tpu_torch.core import special as tsp
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.equilibrium import vacuum as tvac

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "validation" / "configs")
                 .glob("*_config.json"))
DTYPES = [(np.float32, jnp.float32, torch.float32), (np.float64, jnp.float64, torch.float64)]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_matches_jax(path):
    """load_config: port == scpn_fusion_tpu.core.config.load_config."""
    ours = tcfg.load_config(path)
    ref = jcfg.load_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert interop.config_from_asdict(dataclasses.asdict(ref)) == ours


def test_config_rejects_like_jax():
    raw = {"dimensions": {"R_min": 2.0, "R_max": 1.0, "Z_min": -1.0, "Z_max": 1.0}}
    with pytest.raises(jcfg.ConfigError):
        jcfg.config_from_dict(raw)
    with pytest.raises(tcfg.ConfigError):
        tcfg.config_from_dict(raw)


def _grid_cases():
    cases = [((n, n), (2.0, 10.0, -4.0, 4.0)) for n in (17, 65, 129, 257, 513)]
    for path in CONFIGS:
        cfg = jcfg.load_config(path)
        d = cfg.dimensions
        cases.append((cfg.grid_resolution, (d.R_min, d.R_max, d.Z_min, d.Z_max)))
    return cases


@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("res,bounds", _grid_cases())
def test_grid_bit_identical(res, bounds, dts):
    """Grid.R/Z/RR/ZZ == scpn_fusion_tpu.core.grid.Grid (jnp.linspace),
    bit for bit, and so is the divertor mask ZZ < Z_min/2."""
    npdt, jdt, tdt = dts
    jg = JGrid.from_bounds(res[0], res[1], *bounds, dtype=npdt)
    tg = TGrid.from_bounds(res[0], res[1], *bounds, dtype=tdt)
    for name in ("R", "Z", "RR", "ZZ"):
        ref = np.asarray(getattr(jg, name))
        ours = getattr(tg, name).numpy()
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        assert np.array_equal(ours, ref), name
    assert (tg.dR, tg.dZ, tg.shape) == (jg.dR, jg.dZ, jg.shape)
    np.testing.assert_array_equal((tg.ZZ < tg.Z_min * 0.5).numpy(),
                                  np.asarray(jg.ZZ < jg.Z_min * 0.5))


@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n", [4, 33, 48, 333])
def test_grid_other_sizes_within_one_ulp(n, dts):
    """Off the 2^k+1 grids XLA's own eager and jitted jnp.linspace differ by
    an ulp (fused multiply-add placement); the port stays within one ulp of
    the bounds' magnitude, with the end points exact."""
    npdt, _, tdt = dts
    for a, b in ((2.0, 10.0), (-1.6, 1.6), (0.9, 2.6)):
        ref = np.asarray(jnp.linspace(a, b, n, dtype=npdt))
        ours = TGrid.from_bounds(n, n, a, b, a, b, dtype=tdt).R.numpy()
        assert np.all(np.abs(ours - ref) <= np.spacing(npdt(max(abs(a), abs(b)))))
        assert ours[0] == ref[0] and ours[-1] == ref[-1]


def test_special_functions_f64():
    """ellipk/ellipe/green_coil_psi == scpn_fusion_tpu.core.special (f64)."""
    m = np.concatenate([np.linspace(0.0, 0.999999, 2001), [1.0 - 1e-13, 1.0]])
    for name in ("ellipk", "ellipe"):
        ref = np.asarray(getattr(jsp, name)(jnp.asarray(m)))
        ours = getattr(tsp, name)(to_torch(m)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    g = np.random.default_rng(3)
    r_obs, z_obs = g.uniform(1.0, 10.0, 500), g.uniform(-5.0, 5.0, 500)
    r_obs[0], z_obs[0] = 4.0, 1.0   # self-observation -> 0
    ref = np.asarray(jsp.green_coil_psi(4.0, 1.0, jnp.asarray(r_obs), jnp.asarray(z_obs), 1.3))
    ours = tsp.green_coil_psi(to_torch(4.0), to_torch(1.0), to_torch(r_obs),
                              to_torch(z_obs), 1.3).numpy()
    assert ours[0] == 0.0 == ref[0]
    assert span_rel(ours, ref) <= 1e-12


@pytest.mark.parametrize("path", CONFIGS[:2], ids=lambda p: p.stem)
def test_vacuum_psi_from_config_f64(path):
    """vacuum_psi_from_config == the JAX vacuum field, f64, at 65^2."""
    ref_cfg = dataclasses.replace(jcfg.load_config(path), grid_resolution=(65, 65))
    cfg = interop.config_from_asdict(dataclasses.asdict(ref_cfg))
    ref = jvac.vacuum_psi_from_config(JGrid.from_config(ref_cfg, dtype=np.float64), ref_cfg)
    ours = tvac.vacuum_psi_from_config(TGrid.from_config(cfg, dtype=torch.float64), cfg)
    assert span_rel(ours, ref) <= 1e-12
    r, z, i_eff = jvac.coil_arrays_from_config(ref_cfg, jnp.float64)
    tr, tz, ti = interop.coil_arrays(r, z, i_eff, dtype=torch.float64, device="cpu")
    table = tvac.coil_response_table(TGrid.from_config(cfg, dtype=torch.float64), tr, tz, 1.0)
    ref_table = jvac.coil_response_table(JGrid.from_config(ref_cfg, dtype=np.float64),
                                         r, z, 1.0)
    assert span_rel(table, ref_table) <= 1e-12
    assert span_rel(tvac.vacuum_psi_from_table(table, ti),
                    as_np(jvac.vacuum_psi_from_table(ref_table, i_eff))) <= 1e-12
