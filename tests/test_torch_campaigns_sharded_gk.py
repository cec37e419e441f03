"""Lane 7 of the port's ``sharded_convergence`` (``gk_shard_memory``) and
its ``main`` on the CPU at reduced sizes.

The script's lane 7 (2 x 32 x 32 x 16 x 16 x 8 c128, 50 steps, monolithic
and on the (2, 2, 2) mesh) takes minutes on one CPU thread, so the test
passes a small spec (8 x 8 x 8 x 6 x 8, 6 steps, c128; the mesh and seed as
the script's): the lane passes its gates, its memory numbers are the
spec's, and the monolithic run is held to JAX's ``run_nonlinear_gk`` at the
same spec from JAX's initial state (final f within 1e-9 of its max).  ``main`` runs end to
end at 129^2 / 33^2 with that spec (the campaign's other lanes are held to
the committed report at the script's sizes in
``tests/test_torch_campaigns_sharded.py``)."""

import json

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import run_sharded_convergence as sc

SMALL = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=6, n_mu=8, n_steps=6, save_interval=3,
             nonlinear=True, collisions=True, dtype="complex128")


def test_gk_lane_at_a_small_spec_against_jax():
    from scpn_fusion_tpu.models.gyrokinetics import nonlinear as jnl
    from scpn_fusion_tpu.models.gyrokinetics.nonlinear import (
        NonlinearGKConfig as JaxConfig, run_nonlinear_gk as jax_run,
    )
    from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import (
        GKState, NonlinearGKConfig, run_nonlinear_gk,
    )
    lane = sc.lane_gk(sc.gk_runs(torch.device("cpu"), SMALL))
    m = lane.metrics
    assert lane.name == "gk_shard_memory" and lane.status == "pass"
    assert m["state_rel_dev_tile_vs_monolithic"] < 1e-12 and m["trace_rel_dev_max"] < 1e-9
    n_f = 2 * 8 * 8 * 8 * 6 * 8
    assert (m["monolithic_state_bytes"], m["bytes_per_device"],
            m["memory_reduction_factor"]) == (16 * n_f, 16 * n_f // 8, 8.0)
    assert m["shape"] == "S2 x 8kx x 8ky x 8th x 6vpar x 8mu, 6 steps"
    # the packages draw their initial states from different generators:
    # the port's run starts from JAX's
    jcfg = JaxConfig(**SMALL)
    st0 = jnl.init_state(jcfg, jnl.build_grids(jcfg), seed=sc.GK_SEED)
    ours, _ = run_nonlinear_gk(NonlinearGKConfig(**SMALL), device="cpu", state=GKState(
        torch.from_numpy(np.asarray(st0.f)), torch.tensor(float(st0.time), dtype=torch.float64)))
    ref, _ = jax_run(jcfg, state=st0)
    f_ref = np.asarray(ref.f)
    assert float(np.max(np.abs(ours.f.numpy() - f_ref))) / float(np.max(np.abs(f_ref))) <= 1e-9


def test_main_end_to_end_at_small_sizes(tmp_path):
    assert sc.main(device="cpu", out_dir=tmp_path, n=129, n_fb=33, gk_spec=SMALL) == 0
    report = json.loads((tmp_path / "sharded_convergence.json").read_text())
    assert [lane["name"] for lane in report["lanes"]] == [
        "sharded_headline_convergence", "sharded_linear_residual_gate",
        "sharded_scaling_shape_513", "sharded_fmg_cascade",
        "tile2d_grid_invariant_convergence", "sharded_free_boundary_forward", "gk_shard_memory"]
    assert report["overall_status"] == "pass"
    assert report["lanes"][0]["metrics"]["grid"] == "129x129"
