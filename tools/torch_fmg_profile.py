#!/usr/bin/env python3
"""Where the time goes in the port's FMG solves on one NVIDIA GPU.

Runs the bench configuration's 129^2 -> 257^2 -> 513^2 FMG cascade
(``scpn_fusion_tpu_torch.bench_config``) with the hand-written kernels, or
with ``--mixed`` the resolution-scaling cascade 129^2 -> ... -> 1025^2 ending
in the mixed-precision 2049^2 solve gated on the f64 GS residual (3e-5), once
to warm up and once under ``torch.profiler``, and prints:

* wall time of the profiled solve and the summed device-kernel time, hence
  the device's idle share;
* device time by kernel name (top 20), the count of device launches, and
  the device time in the port's own kernels and in float64 PyTorch ops;
* the spread of each of the port's kernels over its launches;
* the chrome trace, written to ``chiprun_out/torch_fmg_trace.json``
  (``torch_mixed_trace.json`` with ``--mixed``).

With ``--kernels`` it profiles, instead of a solve, single calls of the
one-launch kernels and of their predecessors (the fused V-cycle at 257^2 and
129^2, the fused source at 513^2 and 1025^2, the tiled legs at 2049^2 (3,3)
and 1025^2 (1,2), the fine legs at 513^2 (1,2) and (3,3), ``sor_sweeps`` at
129^2 with 50 sweeps), and
prints for each the device launches a call and the device time a call, summed
over every device kernel the call ran (mean of 5 profiled calls after a
warm-up).

With ``--tiled`` it takes the tiled legs alone: for each level and smoothing
count, the launch plan and its occupancy, whether psi (and the coarse defect)
equal the predecessor's bit for bit, and the device time of one launch of the
kernel, of the kernel cut short after each of its stages (launch alone, up
to the load, up to the sweeps, ...) and of its predecessor, profiled in turns (new, earlier,
new, ...; median of 7 each).  ``--tiles 32x64,128x128`` adds other tile shapes (rows x
columns) of the new kernels to the turns.

With ``--fine`` it takes the one-launch fine legs (levels up to 513^2) alone,
at 513^2 with (1,2) and (3,3) smoothing: the launch plan and its occupancy,
whether the results equal the staged route's bit for bit, and the device time
of one call of the kernel, of the kernel cut short after each of its stages,
of the staged route (three and five launches at (1,2)) and of the tiled legs
at the same shape, profiled in turns.  ``--tiles 32x64,16x32`` and ``--bands
4,8`` add other tile shapes and band lengths of the fine kernels to the turns.

With ``--sor`` it takes ``sor_sweeps`` alone, at the shapes and counts
its paths give it and at each route's limits: the route the plan picks, the
launch plan and its occupancy, whether each route's result equals the staged
route's bit for bit, and the device time and launches of one call on every
route that takes the shape (A: one CTA holds the level; B: tiles; D: the
staged half-sweeps without the copy) and on the staged route, profiled in
turns (median of 7), with routes A and B also cut short after each stage
(launch alone, up to the load, up to the sweeps).

With ``--rect`` it profiles, instead of the FMG cascade, the rectangular
solve of the DIII-D-like machine on the 257 x 129 grid
(``bench_config.rect_config``), where every level of the V-cycle smooths
through ``sor_sweeps``: wall time, device-kernel time, idle share and
launches of one solve.

With ``--free-boundary`` it profiles the free-boundary forward of the
ITER-like machine (``bench_config.free_boundary_config``) one solve at a
time: 257^2 and 129^2 in float32 with the kernels, 129^2 in float64 mixed
(float32 V-cycles through the kernel), and 129^2 float32 with the coil
currents re-fitted every outer iteration and the plasma's wall flux in the
ring; then one call of that coil fit alone (31 power iterations and 300
FISTA steps of tiny ops), whose device launches an outer iteration are the
fit's share of the last solve's launches.  With ``--eqdsk`` it profiles the
G-EQDSK reconstruction of the SPARC L-mode file in ``fuzz/seeds/geqdsk``.
With ``--adjoint`` it profiles one Picard step and one adjoint iteration of
the 65^2 float64 adjoint lane (``validation/run_adjoint_fd.py``'s model) and
times its IFT gradient at 300 + 300 iterations and one forward solve; with
``--recon`` it profiles the float64 real-shot reconstruction of the same
SPARC file (``reconstruction.reconstruct``, subcell 4) and times its profile
refit.  With ``--transport`` it profiles the transport paths: ten steps of
the TORAX-parity coarse tier (``bench_config.TORAX_COARSE``, float64) from
its step 40 and the whole coupled GS <-> transport solve at 257^2 in
float32 (``bench_config.COUPLED``), each as one solve, with the launches a
transport step, and times the tier's 400 steps with CUDA events.  With
``--learned`` it profiles one AdamW step of the causal-transformer
disruption predictor at full width (d32/h4/ff64/L2, batch 16 of the
256-shot training family, float32) and one launch of row L
(``csrc/ladder.cu``: the whole disturbance-rejection ladder's nine linear
lanes, float32): launches, device time and idle share of each.  With ``--gk``
it profiles one RK4 step of the nonlinear gyrokinetic run
(``models/gyrokinetics/nonlinear.py``) at the default ``NonlinearGKConfig()``
and at the 32^3 complex128 spec (``bench_config.GK_SPEC_32``), on plain ops
and through row G (``csrc/gk_rhs.cu``, four launches a step), times ms a
step of each in turns with CUDA events, and times the host µs of one row-G
wrapper call and of its parts.  With ``--twin`` it profiles control slice
4a's three kernel paths, each on its plain loop and through its kernel: the
fueling shot (``run_fueling_mode``, 3000 ticks; row N's plant kind 2), the
TORAX-style campaign (16 episodes x 220 ticks; kind 3) and the digital twin
(48^2 x 200 steps; row D, ``csrc/digital_twin.cu``), all float32, and one
default realtime twin session (``twin_ingest``, plain ops).  With
``--ballooning`` it profiles control slice 4b: row B (``csrc/ballooning.cu``)
on the two shapes of ``chip_smoke.newcomb_cases`` (the scan, 10 x 48 lines x
4000 steps; the DIII-D bootstrap path, 65 lines x 2000 steps; float64), the
kernel at full length and its plain RK4 loop at a tenth of the steps
(launches a step and idle share are a step's), with the kernel also timed by
CUDA events; then the same profiler over one launch each of rows B, D and N
(kind 2), to show whether it records a kernel launched through ``ctypes``;
then the plain loops of the slice at their defaults: the RMF spin-up, the
PLL, the detachment loop, the control-room session and an rt-EFIT
reconstruct at 129^2.  With ``--disruption`` it checks rows Q
(``csrc/disruption.cu``) and S (``csrc/sandpile.cu``) ``torch.equal`` to their
plain loops at short lengths, profiles each plain at a tenth of its length
(the default disruption sequence, 400 of 4000 ticks, float64; the default
sandpile, 200 of 2000 drives, float32; launches and idle share a tick or a
sweep) and times each kernel at full length by CUDA events, then profiles
the slice's plain loops at their JAX tests' lengths (SPI injection and
sweep, Fokker-Planck, fluid runaway, the ELM cycle, the Rutherford island,
the locked mode, the pellet) and the eigen lane.  With ``--frc`` it checks
row P (``csrc/compression.cu``) ``torch.equal`` to its plain loop (3000
steps at 4000 V, float32 and float64), its adjoint against autograd through
the plain loop (d min(radius) / d V at 500 steps, random cotangents on the
fifteen trace rows at 200 steps) and ``gradcheck`` at 30 steps in float64,
profiles the plain loop at a tenth of its length (400 of 4000 steps,
float64) and autograd's backward through it (500 steps), times the kernel
at full length and its adjoint by CUDA events, then profiles the slice's
plain loops: the pulsed Hall-MHD carrier (200 steps), ``run_hall_mhd`` (300
steps), ``parameter_sweep`` (3 x 3 x 250) and ``find_tearing_threshold`` (6 x
300) at 64^2, all float64.  With ``--orbits`` it checks row F
(``csrc/orbits.cu``) ``torch.equal`` to its plain twins at short lengths in
float32 and float64, profiles the ensemble's plain twin at a tenth of its
length (2048 particles x 400 of 4000 steps, float64), times row F at full
length by CUDA events, then profiles the slice's plain loops: the
lambda-field guiding centre, the Boris E x B drift, the ICRH bundle, a
drift-wave run, the vapor shield and the stellarator ripple.  With
``--plant`` it checks rows E (``csrc/burn.cu``) and H (``csrc/quench.cu``)
``torch.equal`` to their plain twins at short lengths in float32 and
float64 (the JAX test's 512 designs x 20 iterations, a 300-step transient),
profiles each plain twin at a tenth of its length (4096 designs x 20 of 200
iterations, float32; 200 of 2000 steps, float64) and its kernel's path at
full length (the compact search, the quench screen), times both kernels at
full length by CUDA events, then profiles the slice's plain loops with
their row-T launches: the TEMHD transient (600 steps) and flux scan (3
fluxes x 200 steps), the MCNP-lite estimate (2000 histories), the
volumetric blanket (24 x 72 x 48), a heating-neutronics candidate and the
occluded CAD loading of the 10,368-face torus, float64.  With ``--phase``
it checks row U (``csrc/phase.cu``) ``torch.equal`` to its plain twin at 300
ticks in float32 and float64 (the monitor at 8 x 50, the replay
certificate's monitor at 4 x 32, ``run_upde`` at 4 x 32 in both psi modes),
profiles the monitor's plain twin at 100 of its ticks and its run through
row U at 1000, times row U by CUDA events on every case at full length
(1000, 500 and 3000 ticks), then profiles the whole-device discharge
(``WDMConfig()``, 20 steps, float32) with its row-T launches.  With
``--surrogates`` it checks row W (``csrc/gene_proxy.cu``) ``torch.equal`` to
its plain twin at 1024 samples x 200 steps in float32 and float64, profiles
the plain twin at those 200 steps (float32) and times row W at the
benchmark's full 20,000 by CUDA events, then profiles one training step of
``train_fno_turbulence``'s FNO (64^2, width 24, modes 12, 3 layers, batch 16)
and one 65^2 float32 free-boundary solve of ``train_equilibrium_artifact``
(kernels 2 and 3 counted against its inner Picard iterations).  With
``--ensemble`` it profiles the B = 1 and B = 256 ensembles of
``validation/run_batched_amortisation.py`` (129^2 float32) through the
batched kernels 2 and 3, each as one solve, with the device launches and the
port's kernel launches an iteration, then the mixed B = 64 ensemble.  Each
prints what the solves above print.  With ``--gk-shard`` it profiles one RK4
step of ``validation/run_sharded_convergence.py`` lane 7 (the 32^3 complex128
spec) sharded over a (sx, sy, v) = (2, 2, 2) mesh of 8 virtual shards of the
card (``parallel/gk_shard.py``, row G on every shard) against the monolithic
step: device launches, idle share, row G's device µs a shard and a stage
(CUDA events around one launch on every shard), and what the collectives
move (calls and the bytes that would cross between shards, by collective;
the copy kernels they leave on the one card); then the device µs of one call
of each batched kernel (rows 2b and 3b at 129^2, B = 16) by CUDA events.
With ``--cli`` it profiles the CLI's ``kernel`` mode on the bench
configuration at 513^2 (the direct solve through kernels 2-5 and the npz of
host copies) and one tick of the live server at its 65^2 default and at
513^2, and times each by CUDA events.

Run from the repository root on a machine with a CUDA device:
``python3 tools/torch_fmg_profile.py [--mixed | --kernels | --tiled | --fine | --sor | --rect
| --free-boundary | --eqdsk | --adjoint | --recon | --transport | --learned | --gk
| --twin | --ballooning | --disruption | --frc | --orbits | --plant | --phase
| --surrogates | --ensemble | --gk-shard | --cli]``.
Exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


CALLS_PROFILED = 5


PORT_PREFIX = "(anonymous namespace)::"   # the port's kernels live in anonymous namespaces


def is_port_kernel(name: str) -> bool:
    """The port's kernels, templates among them ("void (anonymous namespace)::..."),
    not PyTorch's own kernels of an anonymous namespace (``torch.arange``'s
    ``elementwise_kernel_with_index``)."""
    return (name.removeprefix("void ").startswith(PORT_PREFIX)
            and "elementwise_kernel" not in name)


def kernel_name(name: str) -> str:
    """A device event's name without namespaces, template and argument lists."""
    name = name.removeprefix("void ").replace(PORT_PREFIX, "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def device_events(prof):
    import torch
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def coarse_error(rand, n):
    """A compact coarse error for an n x n level, zero on its ring."""
    e = rand((n + 1) // 2, (n + 1) // 2)
    e[0, :] = 0.0
    e[-1, :] = 0.0
    e[:, 0] = 0.0
    e[:, -1] = 0.0
    return e


def profile_tiled_legs(card: str, tiles: list[tuple[int, int]]) -> None:
    """Plan, occupancy, identity with the predecessor and device time in
    turns of the tiled legs at the shapes the paths give them."""
    import dataclasses
    import statistics

    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_mg_tiled as mt

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    cb.library()
    for line in cb.BUILD_LOG.get("tiled_legs.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas tiled_legs.cu: {line.strip()}")
    turns = 7
    for n, pre, post in ((2049, 3, 3), (1025, 3, 3), (1025, 1, 2), (513, 1, 2), (4097, 3, 3)):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        psi, src, e_c = rand(n, n), rand(n, n), coarse_error(rand, n)
        down_args = (psi, src, g.R, g.dR, g.dZ, 1.0)
        up_args = (psi, src, e_c, g.R, g.dR, g.dZ, 1.0)
        ref_down = mt._tiled_presmooth_restrict_slab(*down_args, pre_smooth=pre)
        ref_up = mt._tiled_prolong_smooth_slab(*up_args, post_smooth=post)
        calls = {"down earlier": lambda: mt._tiled_presmooth_restrict_slab(*down_args,
                                                                          pre_smooth=pre),
                 "up earlier": lambda: mt._tiled_prolong_smooth_slab(*up_args, post_smooth=post)}
        for shape in [None, *tiles]:
            t_rows, t_cols = shape or (None, None)
            for leg, sweeps in (("down", pre), ("up", post)):
                plan = mt.launch_plan(leg, n, n, sweeps, t_rows, t_cols)
                occ = mt.launch_occupancy(plan)
                if leg == "down":
                    got = mt._launch_down(plan, *down_args)
                    same = torch.equal(got[0], ref_down[0]) and torch.equal(got[1], ref_down[1])
                    call = lambda plan=plan: mt._launch_down(plan, *down_args)   # noqa: E731
                else:
                    got = mt._launch_up(plan, *up_args)
                    same = torch.equal(got, ref_up)
                    call = lambda plan=plan: mt._launch_up(plan, *up_args)   # noqa: E731
                label = f"{leg} {plan.tile_rows}x{plan.tile_cols}"
                calls[label] = call
                if shape is None:
                    # the leg cut short after each stage (results incomplete, times only)
                    names = ("launch alone", "up to the load", "up to the sweeps",
                             "up to the defect", "up to the core's store")
                    for stages, name in enumerate(names[:5 if leg == "down" else 3]):
                        part = dataclasses.replace(plan, stages=stages)
                        calls[f"{label}, {name}"] = (
                            (lambda part=part: mt._launch_down(part, *down_args))
                            if leg == "down"
                            else (lambda part=part: mt._launch_up(part, *up_args)))
                print(f"{n}^2 ({pre},{post}) {label}: halo {plan.halo}, bands {plan.n_seg} x "
                      f"{plan.seg_len} rows, {plan.threads} threads, {plan.smem_bytes} B shared; "
                      f"{occ['ctas_per_sm']} CTAs an SM, {occ['resident']} resident, grid "
                      f"{occ['grid']} = {occ['waves']:.2f} waves; equal to the predecessor "
                      f"{same}")
        for label, ts in device_us_in_turns(calls, turns).items():
            print(f"{n}^2 ({pre},{post}) {label}: device {statistics.median(ts):.3f} us a launch "
                  f"(median of {turns} in turns; min {min(ts):.3f}, max {max(ts):.3f}) [{card}]")


def device_us_in_turns(calls: dict, turns: int) -> dict[str, list[float]]:
    """Summed device time (us) of each call, profiled ``turns`` times in turns."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    times: dict[str, list[float]] = {label: [] for label in calls}
    for _ in range(turns):
        for label, call in calls.items():
            with torch.profiler.profile(activities=acts) as prof:
                call()
                torch.cuda.synchronize()
            times[label].append(sum(e.device_time for e in device_events(prof)))
    return times


def profile_fine_legs(card: str, tiles: list[tuple[int, int]], bands: list[int]) -> None:
    """Plan, occupancy, identity with the staged route and device time in
    turns of the one-launch fine legs at 513^2."""
    import dataclasses
    import statistics

    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_mg_tiled, leg_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    cb.library()
    for line in cb.BUILD_LOG.get("fine_legs.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas fine_legs.cu: {line.strip()}")
    turns = 7
    n = 513
    g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
    psi, src, e_c = rand(n, n), rand(n, n), coarse_error(rand, n)
    down_args = (psi, src, g.R, g.dR, g.dZ, 1.0)
    up_args = (psi, src, e_c, g.R, g.dR, g.dZ, 1.0)
    for pre, post in ((1, 2), (3, 3)):
        ref_down = cuda_mg._presmooth_restrict_launch(*down_args, pre_smooth=pre)
        ref_up = cuda_mg._prolong_smooth_launch(*up_args, post_smooth=post)
        calls = {
            "down staged": lambda: cuda_mg._presmooth_restrict_launch(*down_args, pre_smooth=pre),
            "up staged": lambda: cuda_mg._prolong_smooth_launch(*up_args, post_smooth=post),
            "down tiled 64x64": lambda: cuda_mg_tiled.tiled_presmooth_restrict(*down_args,
                                                                             pre_smooth=pre),
            "up tiled 64x64": lambda: cuda_mg_tiled.tiled_prolong_smooth(*up_args,
                                                                         post_smooth=post),
        }
        shapes = [(None, None)] + [(tile, band) for tile in tiles or [None]
                                   for band in bands or [None] if (tile, band) != (None, None)]
        for tile, band in shapes:
            for leg, sweeps in (("down", pre), ("up", post)):
                try:
                    plan = cuda_mg.fine_launch_plan(leg, n, n, sweeps, tile, band)
                except ValueError as exc:
                    print(f"{n}^2 ({pre},{post}) {leg} tile {tile} band {band}: no plan ({exc})")
                    continue
                occ = cuda_mg.fine_launch_occupancy(plan)
                ints = plan.as_ints()
                if leg == "down":
                    call = lambda ints=ints: leg_plan.launch_down(   # noqa: E731
                        "scpn_fine_pre", ints, *down_args)
                    got = call()
                    same = torch.equal(got[0], ref_down[0]) and torch.equal(got[1], ref_down[1])
                else:
                    call = lambda ints=ints: leg_plan.launch_up(   # noqa: E731
                        "scpn_fine_post", ints, *up_args)
                    same = torch.equal(call(), ref_up)
                label = f"{leg} {plan.tile_rows}x{plan.tile_cols} bands of {plan.seg_len}"
                if tile is None and band is None:
                    label += " (the plan's choice)"
                    # the leg cut short after each stage (results incomplete, times only)
                    names = ("launch alone", "up to the load", "up to the sweeps",
                             "up to the defect", "up to the core's store")
                    for stages, name in enumerate(names[:5 if leg == "down" else 3]):
                        part = dataclasses.replace(plan, stages=stages).as_ints()
                        calls[f"{label}, {name}"] = (
                            (lambda part=part: leg_plan.launch_down("scpn_fine_pre", part,
                                                                    *down_args))
                            if leg == "down"
                            else (lambda part=part: leg_plan.launch_up("scpn_fine_post", part,
                                                                       *up_args)))
                calls[label] = call
                warps = plan.threads // 32
                print(f"{n}^2 ({pre},{post}) {label}: halo {plan.halo}, bands {plan.n_seg} x "
                      f"{plan.seg_len} rows, {plan.threads} threads, {plan.smem_bytes} B shared; "
                      f"{occ['ctas_per_sm']} CTAs an SM, {occ['resident']} resident, grid "
                      f"{occ['grid']} = {occ['waves']:.2f} waves, {occ['grid'] * warps / 132:.1f} "
                      f"warps an SM; equal to the staged route {same}")
        for label, ts in device_us_in_turns(calls, turns).items():
            print(f"{n}^2 ({pre},{post}) {label}: device {statistics.median(ts):.3f} us a call "
                  f"(median of {turns} in turns; min {min(ts):.3f}, max {max(ts):.3f}) [{card}]")


# (nz, nr, sweeps) of the --sor profile: the anderson path (129^2, 50), the
# rectangular V-cycle's levels at (1,2) and its 9 x 5 coarsest solve, the
# default sor method's one sweep, a ragged level, and 257^2 / 513^2, where
# no one-launch route takes 50 sweeps
SOR_CASES = ((129, 129, 50), (129, 129, 1), (129, 129, 2), (257, 129, 1), (257, 129, 2),
             (129, 65, 1), (129, 65, 2), (65, 33, 2), (17, 9, 2), (9, 5, 50), (5, 5, 50),
             (65, 65, 50), (300, 700, 2), (513, 513, 1), (513, 513, 3), (513, 513, 4),
             (257, 257, 50), (513, 513, 50))


def profile_sor(card: str) -> None:
    """Route, plan, occupancy, identity with the staged route and device
    time in turns of ``sor_sweeps`` on every route that takes a shape."""
    import dataclasses
    import statistics

    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_stencil, leg_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    cb.library()
    for line in cb.BUILD_LOG.get("sor_band.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas sor_band.cu: {line.strip()}")
    turns = 7
    for nz, nr, sweeps in SOR_CASES:
        g = Grid.from_bounds(nr, nz, 0.9, 2.6, -1.5, 1.5, dtype=torch.float32, device=dev)
        args = (rand(nz, nr), rand(nz, nr), g.R, g.dR, g.dZ, 1.9 if sweeps == 50 else 1.0,
                sweeps)
        cb.reset_launch_counts()
        ref = cuda_stencil._sor_sweeps_staged(*args)
        staged_launches = cb.kernel_launches()
        calls = {"staged": lambda a=args: cuda_stencil._sor_sweeps_staged(*a)}
        chosen = leg_plan.sor_launch_plan(nz, nr, sweeps).route
        tag = f"{nz}x{nr} n={sweeps}"
        print(f"{tag}: the plan takes route {chosen}; staged route {staged_launches} launches")
        for route in leg_plan.ROUTES:
            try:
                plan = leg_plan.sor_launch_plan(nz, nr, sweeps, route)
            except ValueError as exc:
                print(f"{tag} route {route}: not taken ({exc})")
                continue
            if plan.launch is None:
                call = lambda a=args: cuda_stencil._sweeps_route_d(*a)   # noqa: E731
            else:
                ints = plan.launch.as_ints()
                call = lambda ints=ints, a=args: leg_plan.launch_sweeps(   # noqa: E731
                    "scpn_sor_band", ints, *a[:-1])
            cb.reset_launch_counts()
            same = torch.equal(call(), ref)
            launches = cb.kernel_launches()
            label = f"route {route}" + (" (the plan's choice)" if route == chosen else "")
            calls[label] = call
            detail = f"{launches} launches a call"
            if plan.launch is not None:
                lp = plan.launch
                occ = leg_plan.launch_occupancy("scpn_sor_ctas_per_sm", lp)
                detail += (f", tile {lp.tile_rows}x{lp.tile_cols}, halo {lp.halo}, bands "
                           f"{lp.n_seg} x {lp.seg_len} rows (variant {lp.variant}), "
                           f"{lp.threads} threads, {lp.smem_bytes} B shared; "
                           f"{occ['ctas_per_sm']} CTAs an SM, grid {occ['grid']} = "
                           f"{occ['waves']:.2f} waves")
                if route == chosen:
                    for stages, name in enumerate(("launch alone", "up to the load",
                                                   "up to the sweeps")):
                        part = dataclasses.replace(lp, stages=stages).as_ints()
                        calls[f"route {route}, {name}"] = (
                            lambda part=part, a=args: leg_plan.launch_sweeps(
                                "scpn_sor_band", part, *a[:-1]))
            print(f"{tag} {label}: {detail}; equal to the staged route {same}")
        for label, ts in device_us_in_turns(calls, turns).items():
            print(f"{tag} {label}: device {statistics.median(ts):.3f} us a call (median of "
                  f"{turns} in turns; min {min(ts):.3f}, max {max(ts):.3f}) [{card}]")


def profile_kernel_calls(card: str) -> None:
    """Device launches and device time of one call of each one-launch kernel
    and of its predecessor (new and earlier one after the other, case by
    case)."""
    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_mg_tiled, cuda_source, cuda_stencil

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    cases = []
    for n, pre, post in ((257, 1, 2), (257, 3, 3), (129, 1, 2)):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        args = (rand(n, n), rand(n, n), g.R, g.dR, g.dZ, 1.0)
        kw = dict(pre_smooth=pre, post_smooth=post, min_grid=5, coarse_sweeps=50)
        for label, fn in (("one launch", cuda_mg.fused_coarse_vcycle),
                          ("staged", cuda_mg._fused_coarse_vcycle_staged)):
            cases.append((f"fused_coarse_vcycle {n}^2 ({pre},{post}) {label}",
                          lambda fn=fn, a=args, kw=kw: fn(*a, **kw)))
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=torch.float32, device=dev).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=torch.float32, device=dev).unbind())
    params = cuda_source.pack_source_params(p_c, ff_c, 15.0, like=rand(1))
    for n in (513, 1025):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        psi = 3.0 * torch.exp(-(((g.RR - 6.0) / 2.0) ** 2 + (g.ZZ / 2.0) ** 2)) \
            + 0.01 * rand(n, n)
        mask = (g.ZZ < g.Z_min * 0.5).to(torch.float32).contiguous()
        kw = dict(d_r=g.dR, d_z=g.dZ, mu0=1.0, h_mode=False)
        for label, fn in (("one launch", cuda_source.fused_topology_source),
                          ("staged", cuda_source._fused_topology_source_staged)):
            cases.append((f"fused_topology_source {n}^2 L-mode {label}",
                          lambda fn=fn, a=(psi, g.R, mask, params), kw=kw: fn(*a, **kw)))

    for n, pre, post in ((2049, 3, 3), (1025, 1, 2)):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        psi, src, e_c = rand(n, n), rand(n, n), coarse_error(rand, n)
        down = (psi, src, g.R, g.dR, g.dZ, 1.0)
        up = (psi, src, e_c, g.R, g.dR, g.dZ, 1.0)
        for label, fn_down, fn_up in (
                ("one launch", cuda_mg_tiled.tiled_presmooth_restrict,
                 cuda_mg_tiled.tiled_prolong_smooth),
                ("earlier design", cuda_mg_tiled._tiled_presmooth_restrict_slab,
                 cuda_mg_tiled._tiled_prolong_smooth_slab)):
            cases.append((f"tiled_presmooth_restrict {n}^2 pre={pre} {label}",
                          lambda fn=fn_down, a=down, k=pre: fn(*a, pre_smooth=k)))
            cases.append((f"tiled_prolong_smooth {n}^2 post={post} {label}",
                          lambda fn=fn_up, a=up, k=post: fn(*a, post_smooth=k)))
    g = Grid.from_bounds(513, 513, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
    psi, src, e_c = rand(513, 513), rand(513, 513), coarse_error(rand, 513)
    down = (psi, src, g.R, g.dR, g.dZ, 1.0)
    up = (psi, src, e_c, g.R, g.dR, g.dZ, 1.0)
    for pre, post in ((1, 2), (3, 3)):
        for label, fn_down, fn_up in (
                ("one launch", cuda_mg.fine_presmooth_restrict, cuda_mg.fine_prolong_smooth),
                ("staged", cuda_mg._presmooth_restrict_launch, cuda_mg._prolong_smooth_launch)):
            cases.append((f"fine_presmooth_restrict 513^2 pre={pre} {label}",
                          lambda fn=fn_down, a=down, k=pre: fn(*a, pre_smooth=k)))
            cases.append((f"fine_prolong_smooth 513^2 post={post} {label}",
                          lambda fn=fn_up, a=up, k=post: fn(*a, post_smooth=k)))
    g = Grid.from_bounds(129, 129, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
    sor_args = (rand(129, 129), rand(129, 129), g.R, g.dR, g.dZ, 1.9, 50)
    for label, fn in (("one launch", cuda_stencil.sor_sweeps),
                      ("staged", cuda_stencil._sor_sweeps_staged)):
        cases.append((f"sor_sweeps 129^2 n=50 omega=1.9 {label}",
                      lambda fn=fn, a=sor_args: fn(*a)))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, call in cases:
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS_PROFILED):
                call()
            host_us = (time.perf_counter() - t0) * 1e6 / CALLS_PROFILED
            torch.cuda.synchronize()
        events = device_events(prof)
        names = sorted({kernel_name(e.name) for e in events})
        print(f"{label}: {len(events) / CALLS_PROFILED:g} device launches a call, device "
              f"{sum(e.device_time for e in events) / CALLS_PROFILED:.3f} us a call, host "
              f"{host_us:.1f} us a call to enqueue (profiler on) [{card}]; kernels {names}")


def profile_solve(card: str, label: str, solve, trace: str | None) -> dict:
    """``solve()`` once to warm up and once under ``torch.profiler``: prints
    the wall time, device-kernel time, idle share, device launches, the
    largest kernels by device time and the spread of the port's kernels;
    writes the chrome trace to ``chiprun_out/<trace>``.  ``solve`` returns
    what to print about the solve.  Returns the numbers it printed."""
    import torch
    solve()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        info = solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = device_events(prof)
    dev_us = sum(e.device_time for e in events)
    port_us = sum(e.device_time for e in events if is_port_kernel(e.name))
    f64_us = sum(e.device_time for e in events if "double" in e.name)
    port_launches = sum(is_port_kernel(e.name) for e in events)
    print(f"{label}: {info}")
    print(f"{label}: wall {wall_ms:.3f} ms, device kernels {dev_us / 1e3:.3f} ms, idle share "
          f"{1.0 - dev_us / 1e3 / wall_ms:.3f}, device launches {len(events)} ({port_launches} "
          f"of the port's kernels) [{card}]")
    print(f"{label}: device ms in the port's kernels {port_us / 1e3:.3f}, in float64 PyTorch ops "
          f"{f64_us / 1e3:.3f}")
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in rows[:20]:
        print(f"  {sum(ts) / 1e3:9.3f} ms  {len(ts):6d}x  {name[:90]}")
    print("the port's kernels per launch (us): min / median / max, launches within 5% of max")
    for name, ts in rows:
        if is_port_kernel(name):
            ts = sorted(ts)
            near_max = sum(t >= 0.95 * ts[-1] for t in ts)
            print(f"  {ts[0]:8.3f} / {ts[len(ts) // 2]:8.3f} / {ts[-1]:8.3f}  {near_max:5d} of "
                  f"{len(ts):5d}  {kernel_name(name)}")
    if trace is not None:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(out / trace))
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))
    return {"wall_ms": wall_ms, "device_ms": dev_us / 1e3, "launches": len(events),
            "port_launches": port_launches, "port_ms": port_us / 1e3}


def profile_cli(card: str) -> None:
    """The CLI's ``kernel`` mode on the bench configuration at 513^2
    (``cli.main(["kernel", <json>, "--output", <npz>])``: load, the direct
    513^2 solve through kernels 2-5, the npz of host copies) and one tick of
    the live server at its 65^2 default and at 513^2 (a cold
    ``solve_equilibrium`` and the host copy of psi), each warmed up once,
    then profiled; CUDA events around an unprofiled call, median of 5."""
    import contextlib
    import io
    import json
    import statistics
    import tempfile

    import torch

    from scpn_fusion_tpu_torch import cli
    from scpn_fusion_tpu_torch.bench_config import BENCH_SOLVER, config_dict
    from scpn_fusion_tpu_torch.core.config import load_config
    from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium
    from scpn_fusion_tpu_torch.ui.live_server import LiveSolveWorker

    with tempfile.TemporaryDirectory(prefix="cli_profile_") as tmp_dir:
        tmp = Path(tmp_dir)
        cfg_path = tmp / "bench_513.json"
        cfg_path.write_text(json.dumps(config_dict(513, **BENCH_SOLVER)))

        def kernel_mode():
            with contextlib.redirect_stdout(io.StringIO()) as out:
                cli.main(["kernel", str(cfg_path), "--output", str(tmp / "psi.npz")])
            return json.loads(out.getvalue())

        def tick(cfg):
            def run():
                res = solve_equilibrium(cfg, i_target=15.0, device="cuda")
                psi = res.psi.detach().cpu().numpy()
                return {"shape": psi.shape, "iterations": int(res.iterations),
                        "converged": bool(res.converged)}
            return run

        cases = (("kernel mode 513^2", kernel_mode),
                 ("live tick 65^2", tick(LiveSolveWorker()._default_cfg())),
                 ("live tick 513^2", tick(load_config(cfg_path))))
        for label, run in cases:
            profile_solve(card, label, run, None)
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            print(f"{label}: {statistics.median(times):.3f} ms by CUDA events (median of 5, "
                  f"unprofiled) [{card}]")


def profile_free_boundary(card: str) -> None:
    """The free-boundary forward of ``bench_config.free_boundary_config``:
    257^2 and 129^2 in float32 with the kernels, 129^2 in float64 mixed with
    the kernels, and 129^2 float32 with ``optimize_shape`` and
    ``use_wall_response``, each profiled as one solve; for the last, also one
    call of the coil fit (``ops/lstsq.tikhonov_coil_lstsq``: 31 power
    iterations and 300 FISTA steps) at its shape, whose device launches
    times the outer iterations are the fit's share of the solve's launches."""
    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.bench_config import FREE_BOUNDARY_MU0_GREEN, free_boundary_config
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import (
        coilset_from_config, mutual_inductance_matrix, solve_free_boundary,
    )
    from scpn_fusion_tpu_torch.ops.lstsq import tikhonov_coil_lstsq

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64

    def fb(n, dtype, **kw):
        def solve():
            res = solve_free_boundary(free_boundary_config(n), mu0_green=FREE_BOUNDARY_MU0_GREEN,
                                      dtype=dtype, device=dev, **kw)
            return {"outer_iterations": res.outer_iterations, "converged": res.converged,
                    "last_inner_iterations": res.equilibrium.iterations}
        return solve

    profile_solve(card, "free boundary 257^2 f32", fb(257, f32, max_outer_iter=40, tol=3e-4),
                  "torch_fb257_trace.json")
    profile_solve(card, "free boundary 129^2 f32", fb(129, f32, max_outer_iter=16, tol=2.5e-4),
                  "torch_fb129_trace.json")
    profile_solve(card, "free boundary 129^2 f64 mixed",
                  fb(129, f64, max_outer_iter=16, tol=1e-4, anderson_gram_f32=True,
                     mixed_n_refine=2), None)
    cfg = free_boundary_config(129)
    theta = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    pts = torch.tensor(np.stack([6.0 + 2.0 * np.cos(theta), 2.4 * np.sin(theta)], 1),
                       dtype=f32, device=dev)
    coils = coilset_from_config(cfg, f32, dev)._replace(
        target_flux_points=pts, current_limits=torch.full((6,), 8.0, device=dev))
    shape = profile_solve(card, "free boundary 129^2 f32 optimize_shape + wall",
                          fb(129, f32, coils=coils, max_outer_iter=16, tol=2.5e-4,
                             optimize_shape=True, use_wall_response=True), None)
    m_t = mutual_inductance_matrix(coils.r, coils.z, coils.turns, pts,
                                   FREE_BOUNDARY_MU0_GREEN).T.contiguous()
    target = torch.full((16,), 0.5, dtype=f32, device=dev)
    lim = coils.current_limits

    def fit():
        tikhonov_coil_lstsq(m_t, target, 1e-4, -lim, lim)

    fit()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS_PROFILED):
            fit()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / CALLS_PROFILED
    events = device_events(prof)
    per_call = len(events) / CALLS_PROFILED
    print(f"coil fit (tikhonov_coil_lstsq, 16 points x 6 coils, 31 power iterations + 300 FISTA "
          f"steps): {per_call:g} device launches a call, device "
          f"{sum(e.device_time for e in events) / CALLS_PROFILED / 1e3:.3f} ms a call, wall "
          f"{host_ms:.3f} ms a call (profiler on) [{card}]")
    print(f"coil fit's share of the optimize_shape + wall solve: {per_call:g} launches an outer "
          f"iteration against {shape['launches']} device launches in the whole solve")


def profile_eqdsk(card: str) -> None:
    """The G-EQDSK reconstruction of the SPARC L-mode file in
    ``fuzz/seeds/geqdsk`` on its 129 x 129 grid, float32 with the kernels
    (one fused V-cycle an iteration), profiled as one solve."""
    import torch
    from scpn_fusion_tpu_torch.io.geqdsk import read_geqdsk
    from scpn_fusion_tpu_torch.models.equilibrium.eqdsk_solve import solve_from_geqdsk

    eq = read_geqdsk(ROOT / "fuzz" / "seeds" / "geqdsk" / "sparc_lmode_hv.geqdsk")

    def solve():
        res = solve_from_geqdsk(eq, dtype=torch.float32, device="cuda")
        return {"iterations": res.iterations, "converged": res.converged,
                "span_rel_rmse": float(res.span_rel_rmse)}

    profile_solve(card, "SPARC g-file 129x129 f32", solve, "torch_eqdsk_trace.json")


def cuda_events_ms(fn) -> float:
    """Wall time of one call of ``fn`` between two CUDA events (host time
    included); no warm-up (plain ops compile nothing, and the caller has
    run the same ops already)."""
    import torch
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profile_adjoint(card: str) -> None:
    """The adjoint lane (``validation/run_adjoint_fd.py``'s 65^2 float64
    predictive model: six coils, relax 0.5, one plain V-cycle a Picard
    step).  Profiles one Picard step (forward) and one adjoint iteration
    (one call of the reused ``torch.func.vjp``), each as a solve; times with
    CUDA events the IFT gradient of ``mean(psi^2) * 1e12`` at n_fwd = n_bwd
    = 300 and one forward solve of the FD check."""
    from functools import partial

    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium import differentiable as dm

    f64, dev = torch.float64, torch.device("cuda")
    grid = Grid.from_bounds(65, 65, 2.0, 10.0, -4.0, 4.0, dtype=f64, device=dev)
    model = dm.build_predictive_model(grid, [3.5, 8.0, 10.8, 8.0, 3.5, 10.8],
                                      [4.8, 4.8, 0.0, -4.8, -4.8, 2.5], relax=0.5,
                                      use_vcycle=True)
    theta = dm.PredictiveTheta(torch.tensor([-1.0, 4.0, 6.0, 4.0, -1.0, 3.0], dtype=f64, device=dev),
                               torch.tensor([1.0, 0.4, 0.08, 0.02], dtype=f64, device=dev),
                               torch.tensor(15.0, dtype=f64, device=dev))
    step = partial(dm._predictive_step, model)
    psi = dm.solve_predictive_diff(model, theta, n_fwd=300)
    profile_solve(card, "adjoint lane 65^2 f64, one Picard step",
                  lambda: {"shape": tuple(step(theta, psi).shape)}, None)
    _, vjp_fn = torch.func.vjp(lambda p, *lv: step(dm.PredictiveTheta(*lv), p), psi, *theta)
    profile_solve(card, "adjoint lane 65^2 f64, one adjoint iteration",
                  lambda: {"outputs": len(vjp_fn(psi))}, None)

    def gradient():
        c = theta.coil_currents.clone().requires_grad_(True)
        out = dm.solve_predictive_diff(model, theta._replace(coil_currents=c), n_fwd=300,
                                       n_bwd=300)
        torch.autograd.grad((out * out).mean() * 1e12, c)

    def forward():
        with torch.no_grad():
            dm.solve_predictive_diff(model, theta, n_fwd=300)

    print(f"adjoint lane 65^2 f64: IFT gradient (300 forward steps, 300 adjoint iterations) "
          f"{cuda_events_ms(gradient):.3f} ms; one forward solve (300 steps) "
          f"{cuda_events_ms(forward):.3f} ms (CUDA events, one call each) [{card}]")


def profile_recon(card: str) -> None:
    """The real-shot reconstruction of the SPARC L-mode file in
    ``fuzz/seeds/geqdsk`` (``reconstruction.prepare_case`` then
    ``reconstruct(subcell=4, anderson_m=8, max_iter=200)``, float64),
    profiled as one solve; ``refit_profiles`` with its defaults timed with
    CUDA events (its whole run is too many launches to profile)."""
    import torch
    from scpn_fusion_tpu_torch.io.geqdsk import read_geqdsk
    from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as rc

    case = rc.prepare_case(read_geqdsk(ROOT / "fuzz" / "seeds" / "geqdsk"
                                       / "sparc_lmode_hv.geqdsk"))

    def solve():
        out = rc.reconstruct(case, subcell=4, anderson_m=8, max_iter=200, device="cuda")
        return {"iterations": out["iterations"], "nrmse_range": out["nrmse_range"]}

    profile_solve(card, "SPARC g-file 129x129 f64 reconstruction", solve, None)
    refit = {}

    def fit():
        refit.update(rc.refit_profiles(case, device="cuda"))

    ms = cuda_events_ms(fit)
    print(f"SPARC refit_profiles (defaults: 8 basis responses in one vmapped solve, 30 V-cycles each, "
          f"n_outer 30): {ms:.3f} ms, {refit['outer_iterations']} outer iterations, fitted "
          f"nrmse {refit['nrmse_range']!r} (CUDA events, one call) [{card}]")


def profile_transport(card: str) -> None:
    """(k) ten steps of the TORAX coarse tier from its step 40, profiled as
    one solve (launches and device time a step, idle share), and its 400
    steps timed with CUDA events; (j) the coupled solve at 257^2 f32
    profiled as one solve."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import COUPLED, TORAX_COARSE, bench_config
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
    from scpn_fusion_tpu_torch.models.transport.coupling import run_self_consistent
    from scpn_fusion_tpu_torch.models.transport.solver import (
        TransportParams, initial_state, run_transport,
    )

    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    tp = TransportParams()
    dt, p_aux, n_steps = TORAX_COARSE["dt"], TORAX_COARSE["p_aux_mw"], TORAX_COARSE["n_steps"]
    s40 = run_transport(initial_state(tp, f64, dev), dt, p_aux, tp, 40)[0]

    def ten_steps():
        tr = run_transport(s40, dt, p_aux, tp, 10)[1]
        return {"picard": tr["picard"].tolist()}

    out = profile_solve(card, "TORAX coarse tier f64, steps 41-50", ten_steps,
                        "torch_transport_trace.json")
    print(f"TORAX coarse tier: {out['launches'] / 10:.1f} device launches, "
          f"{out['device_ms'] / 10:.4f} ms of device time and {out['wall_ms'] / 10:.3f} ms of "
          f"wall time a step (profiled) [{card}]")
    ms = cuda_events_ms(lambda: run_transport(initial_state(tp, f64, dev), dt, p_aux, tp,
                                              n_steps))
    print(f"TORAX coarse tier, {n_steps} steps: {ms:.3f} ms ({ms / n_steps:.3f} ms a step; CUDA "
          f"events, one call) [{card}]")

    cfg = bench_config(COUPLED["n"])
    grid = Grid.from_config(cfg, dtype=f32, device=dev)
    bc = vacuum_psi_from_config(grid, cfg).to(f32)
    kw = {k: v for k, v in COUPLED.items() if k != "n"}

    def coupled():
        res = run_self_consistent(cfg, grid, tp, initial_state(tp, f32, dev), bc, bc, **kw)
        return {"outer_iterations": res.outer_iterations, "converged": res.converged}

    profile_solve(card, f"coupled GS <-> transport {COUPLED['n']}^2 f32", coupled, None)


def profile_learned(card: str) -> None:
    """One training step of the causal transformer at full width (the
    200th of a run, so the optimiser's moments are warm) and one launch of
    row L over the whole ladder, each profiled as one solve."""
    import torch
    from scpn_fusion_tpu_torch.control import disruption_seq as ds
    from scpn_fusion_tpu_torch.control import disturbance_ladder as dl
    from scpn_fusion_tpu_torch.ops import cuda_ladder as cl

    dev, f32 = torch.device("cuda"), torch.float32
    fam, _, noisy, onsets = ds.generate_training_family(7)
    shots = torch.from_numpy(fam).to(dev)
    labels, ons = torch.from_numpy(noisy).to(dev), torch.from_numpy(onsets).to(dev)
    gen = torch.Generator().manual_seed(0)
    p0 = ds.init_seq_predictor(gen, 3, shots.shape[1], dtype=f32, device=dev)
    idx = torch.randint(0, shots.shape[0], (201, 16), generator=gen).to(dev)
    warm = ds._train_seq_predictor(shots, labels, ons, p0, idx[:200]).params

    def one_step():
        res = ds._train_seq_predictor(shots, labels, ons, warm, idx[200:])
        return {"loss": float(res.loss_history[-1])}

    out = profile_solve(card, "causal transformer, one AdamW step (batch 16 x 240, f32)",
                        one_step, "torch_seq_step_trace.json")
    print(f"transformer step: {out['launches']} device launches, {out['device_ms']:.4f} ms of "
          f"device time, {out['wall_ms']:.3f} ms of wall time (profiled) [{card}]")
    lanes = dl.linear_lanes([(c, s) for s in dl.SCENARIOS for c in ("PID", "H-infinity", "MPC")],
                            f32, dev)

    def ladder():
        z, _ = cl.ladder(lanes, dt=dl.DT, u_max=dl.U_MAX)
        return {"ticks": int(z.shape[0]), "finite": bool(torch.isfinite(z).all())}

    out = profile_solve(card, "row L, the ladder's 9 linear lanes (f32)", ladder, None)
    print(f"row L launch: {out['launches']} device launches, {out['device_ms']:.4f} ms of device "
          f"time, idle share {1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")


GK_STEPS_TIMED = 10


def gk_cases():
    """(label, config, seed) of the two configurations ``--gk`` profiles: the
    default NonlinearGKConfig() and the 32^3 complex128 spec."""
    from scpn_fusion_tpu_torch.bench_config import GK_SPEC_32, GK_SPEC_32_SEED
    from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import NonlinearGKConfig
    return (("default 2x16x16x32x16x8 c64", NonlinearGKConfig(), 42),
            ("32^3 spec 2x32x32x16x16x8 c128", NonlinearGKConfig(**GK_SPEC_32), GK_SPEC_32_SEED))


def profile_gk(card: str) -> None:
    """One RK4 step of the nonlinear GK run at each configuration, profiled
    on plain ops (``cuda_gk.gk_stage_plain``) and through row G, from the
    state after 3 steps; then ms a step of each (CUDA events around 10 steps,
    median of 5, in turns) and the peak device memory of a 10-step run."""
    import statistics

    import torch
    from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
    from scpn_fusion_tpu_torch.ops import cuda_gk

    for label, cfg, seed in gk_cases():
        g = nl.build_grids(cfg, device="cuda")
        spec = nl.stage_spec(cfg, g)
        gram_inv = nl._gram_inv(cfg, g, nl._dtypes(cfg)[0])
        state = nl.init_state(cfg, g, seed=seed)
        for _ in range(3):
            state = nl._rk4_step(cfg, g, spec, state, gram_inv)
        print(f"{label}: f {tuple(state.f.shape)} {state.f.dtype}, "
              f"{state.f.numel() * state.f.element_size() / 1e6:.1f} MB")
        outs = {}
        for name, stage_fn in (("plain ops", cuda_gk.gk_stage_plain), ("row G", cuda_gk.gk_stage)):
            def step(stage_fn=stage_fn):
                new = nl._rk4_step(cfg, g, spec, state, gram_inv, stage_fn)
                return {"max |f|": float(new.f.abs().max())}
            outs[name] = profile_solve(card, f"{label}, one RK4 step, {name}", step, None)
        for name, out in outs.items():
            print(f"{label}, {name}: {out['launches']} device launches a step, "
                  f"{out['device_ms']:.4f} ms of device time, {out['wall_ms']:.3f} ms of wall "
                  f"time (profiled), idle share {1.0 - out['device_ms'] / out['wall_ms']:.3f} "
                  f"[{card}]")

        def steps(stage_fn):
            s = state
            for _ in range(GK_STEPS_TIMED):
                s = nl._rk4_step(cfg, g, spec, s, gram_inv, stage_fn)
            return s

        times = {"plain ops": [], "row G": []}
        steps(cuda_gk.gk_stage_plain)
        steps(cuda_gk.gk_stage)
        for _ in range(5):
            for name, fn in (("plain ops", cuda_gk.gk_stage_plain), ("row G", cuda_gk.gk_stage)):
                times[name].append(cuda_events_ms(lambda fn=fn: steps(fn)) / GK_STEPS_TIMED)
        peaks = {}
        for name, fn in (("plain ops", cuda_gk.gk_stage_plain), ("row G", cuda_gk.gk_stage)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps(fn)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 2**20
        for name in times:
            print(f"{label}, {name}: {statistics.median(times[name]):.4f} ms a step (CUDA "
                  f"events around {GK_STEPS_TIMED} steps, median of 5 in turns; all "
                  f"{[round(t, 4) for t in times[name]]}), peak memory {peaks[name]:.1f} MiB "
                  f"[{card}]")
        gk_wrapper_host(label, cfg, g, spec, gram_inv, state, card)


def profile_twin(card: str) -> None:
    """Control slice 4a's kernel paths, float32, each profiled as one solve on
    its plain loop and through its kernel (launches, device time, idle
    share), and one default realtime twin session on plain ops."""
    import torch
    from scpn_fusion_tpu_torch.control import digital_twin as dtw
    from scpn_fusion_tpu_torch.control import fueling_torax as ft
    from scpn_fusion_tpu_torch.control import twin_ingest as ti
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
    from scpn_fusion_tpu_torch.ops import cuda_twin
    from scpn_fusion_tpu_torch.scpn import controller as sc

    dev, f32 = "cuda", torch.float32
    ctrl = ft._build_axis_controller(5000.0, f32, dev)
    cfg = sc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    plant = ccl.FuelingPlant(target=1.0, density0=0.82, dt=1e-3)
    gen = torch.Generator().manual_seed(0)
    amps = (0.25 + 0.5 * torch.rand(16, generator=gen, dtype=torch.float64)).to(dev, f32)
    noise = torch.randn((16, 220, 2), generator=gen, dtype=torch.float64).to(dev, f32)
    dist = ft.torax_disturbance(amps, 220)
    plant0 = tuple(torch.full((16,), v, dtype=f32, device=dev) for v in (1.7, 5.1, 0.95, 140.0))
    tcfg = dtw.TwinConfig()
    r_map, mask = dtw._geometry(tcfg, f32, dev)
    s0 = dtw.twin_init(tcfg, f32, dev)
    zero = torch.zeros(200, dtype=f32, device=dev)
    paths = (
        ("fueling shot, 3000 ticks (row N kind 2)",
         lambda: ccl.closed_loop_fueling_plain(ctrl, cfg, plant, n_ticks=3000),
         lambda: ccl.closed_loop_fueling(ctrl, cfg, plant, n_ticks=3000)),
        ("TORAX-style campaign, 16 x 220 ticks (row N kind 3)",
         lambda: ccl.closed_loop_torax_plain(ctrl, cfg, plant0, dist, noise),
         lambda: ccl.closed_loop_torax(ctrl, cfg, plant0, dist, noise)),
        ("digital twin, 48^2 x 200 steps (row D)",
         lambda: cuda_twin.twin_shot_plain(tcfg, r_map, mask, s0, zero),
         lambda: cuda_twin.twin_shot(tcfg, r_map, mask, s0, zero)),
    )
    for label, plain, kernel in paths:
        out = profile_solve(card, f"{label}, plain loop",
                            lambda run=plain: {"ran": run() is not None}, None)
        print(f"{label}, plain loop: {out['launches']} device launches, {out['device_ms']:.4f} ms "
              f"of device time, {out['wall_ms']:.3f} ms of wall time (profiled), idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")
        # the one launch: its count from the wrapper's launch counter, its
        # device time from CUDA events around it, its wall time from the host
        kernel()
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        device_ms = cuda_events_ms(kernel)
        wall_ms = (time.perf_counter() - t0) * 1e3
        print(f"{label}, kernel: {cb.kernel_launches()} device launch(es), {device_ms:.4f} ms "
              f"between CUDA events around it, {wall_ms:.3f} ms of wall time, idle share "
              f"{1.0 - device_ms / wall_ms:.3f} [{card}]")

    def session():
        _, info = ti.run_realtime_twin_session("SPARC", device=dev)
        return {"plans": info["n_plans"], "all pass": float(info["all_pass_rate"])}

    out = profile_solve(card, "realtime twin session, SPARC, 39 plans x 24 ticks (plain ops)",
                        session, None)
    print(f"realtime twin session: {out['launches']} device launches, {out['device_ms']:.4f} ms "
          f"of device time, {out['wall_ms']:.3f} ms of wall time (profiled), idle share "
          f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")


def profile_ballooning(card: str) -> None:
    """Control slice 4b's paths: row B plain (a tenth of the steps) and
    through the kernel, the profiler over one launch of rows B, D and N, and
    the slice's plain loops at their defaults."""
    import torch
    from chip_smoke import EFIT_COEFFS, EFIT_COILS, efit_model, newcomb_cases
    from scpn_fusion_tpu_torch.control import control_room as cr
    from scpn_fusion_tpu_torch.control import digital_twin as dtw
    from scpn_fusion_tpu_torch.control import fueling_torax as ft
    from scpn_fusion_tpu_torch.control import plasma_controllers as pc
    from scpn_fusion_tpu_torch.control import realtime_efit as ef
    from scpn_fusion_tpu_torch.control import rmf
    from scpn_fusion_tpu_torch.models.physics.ballooning import THETA_MAX
    from scpn_fusion_tpu_torch.ops import cuda_ballooning as cbal
    from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
    from scpn_fusion_tpu_torch.ops import cuda_twin
    from scpn_fusion_tpu_torch.scpn import controller as sc

    dev, f32, f64 = "cuda", torch.float32, torch.float64
    for op, (s, a, tables, n_steps, label) in newcomb_cases(f64, dev).items():
        tenth = n_steps // 10
        out = profile_solve(card, f"row B {op}, {label}, plain loop at {tenth} steps",
                            lambda: {"lines": cbal.newcomb_min_xi_plain(
                                op, s, a, tables, THETA_MAX, tenth).numel()}, None)
        print(f"row B {op} plain: {out['launches'] / tenth:.1f} device launches a step, idle "
              f"share {1.0 - out['device_ms'] / out['wall_ms']:.3f}, {out['wall_ms'] / tenth:.4f} "
              f"ms a step of wall time (profiled) [{card}]")
        run = functools.partial(cbal.newcomb_min_xi, op, s, a, tables, THETA_MAX, n_steps)
        out = profile_solve(card, f"row B {op}, {label}, kernel (after a fill)",
                            lambda run=run: {"fill": torch.zeros(1, device=dev).numel(),
                                             "lines": run().numel()}, None)
        ms = [cuda_events_ms(run) for _ in range(5)]
        print(f"row B {op} kernel: {out['port_launches']} launch(es) of row B recorded by the "
              f"profiler, {out['port_ms']:.4f} ms of device time there, idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}; CUDA events around the one "
              f"launch, median of 5: {sorted(ms)[2]:.4f} ms [{card}]")

    # the profiler over one launch of each ctypes-launched row, float32: alone
    # in the profiled window, and after a one-element PyTorch fill on the card
    # in the same window
    ctrl = ft._build_axis_controller(5000.0, f32, dev)
    cfg = sc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    plant = ccl.FuelingPlant(target=1.0, density0=0.82, dt=1e-3)
    tcfg = dtw.TwinConfig()
    r_map, mask = dtw._geometry(tcfg, f32, dev)
    s0, zero = dtw.twin_init(tcfg, f32, dev), torch.zeros(200, dtype=f32, device=dev)
    s, a, _, _, _ = newcomb_cases(f32, dev)["circular"]
    for label, run in (("row B", lambda: cbal.newcomb_min_xi("circular", s, a, None, THETA_MAX,
                                                              4000)),
                       ("row D", lambda: cuda_twin.twin_shot(tcfg, r_map, mask, s0, zero)),
                       ("row N kind 2", lambda: ccl.closed_loop_fueling(ctrl, cfg, plant,
                                                                        n_ticks=3000))):
        alone = profile_solve(card, f"{label}, one launch alone under the profiler",
                              lambda run=run: {"ran": run() is not None}, None)
        fill = profile_solve(card, f"{label}, one launch after a fill under the profiler",
                             lambda run=run: {"ran": torch.zeros(1, device=dev) is not None
                                              and run() is not None}, None)
        print(f"{label}: the profiler recorded {alone['port_launches']} launch(es) of the "
              f"port's kernel ({alone['port_ms']:.4f} ms) when the launch was alone in the "
              f"window, {fill['port_launches']} ({fill['port_ms']:.4f} ms) after a PyTorch fill "
              f"in the same window [{card}]")

    model = efit_model(dev)
    coils = torch.tensor(EFIT_COILS, dtype=f64, device=dev)
    coeffs = torch.tensor(EFIT_COEFFS, dtype=f64, device=dev)
    meas = ef.synthetic_measurements(model, coeffs, coils)
    ip = model.basis_ip @ coeffs
    loops = (
        ("RMF spin-up, 20,000 ticks f64", lambda: rmf.run_rmf_spinup(
            rmf.RMFParams(), dtype=f64, device=dev)),
        ("PLL, 5000 ticks f64", lambda: rmf.run_phase_lock(rmf.PLLParams(), dtype=f64,
                                                           device=dev)),
        ("detachment loop, 200 ticks f64", lambda: pc.run_detachment_loop(
            pc.DetachmentControllerParams(), p_sol_mw=100.0, n_u_19=3.0, dtype=f64,
            device=dev)),
        ("control room, 200 steps 60^2 f32", lambda: cr.run_control_room_session(device=dev)),
        ("rt-EFIT reconstruct 129^2 f64", lambda: ef.reconstruct(model, meas, coils, ip)),
    )
    for label, run in loops:
        out = profile_solve(card, label, lambda run=run: {"ran": run() is not None}, None)
        print(f"{label}: {out['launches']} device launches, {out['device_ms']:.4f} ms of device "
              f"time, {out['wall_ms']:.3f} ms of wall time (profiled), idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")


def profile_disruption(card: str) -> None:
    """The MHD, disruption and runaway slice: rows Q and S first checked
    ``torch.equal`` to their plain loops at short lengths in float32 and
    float64, then each plain at a tenth of its length (row Q: the default
    sequence at 400 of its 4000 ticks, float64; row S: the default pile at
    200 of its 2000 drives, float32) and through its kernel at full length
    (CUDA events around the one launch, median of 5), then the slice's
    plain loops at their JAX tests' lengths, and the eigen lane (two
    launches of row B among plain ops)."""
    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.models.physics import disruption_sequence as ds
    from scpn_fusion_tpu_torch.models.physics import edge_events as ev
    from scpn_fusion_tpu_torch.models.physics import elm
    from scpn_fusion_tpu_torch.models.physics import fokker_planck_re as fp
    from scpn_fusion_tpu_torch.models.physics import mhd_modes as mm
    from scpn_fusion_tpu_torch.models.physics import runaway_fluid as rf
    from scpn_fusion_tpu_torch.models.physics import sandpile as sp
    from scpn_fusion_tpu_torch.models.physics import spi_ablation as spi
    from scpn_fusion_tpu_torch.models.physics import stability_mhd as st
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_disruption as cdis
    from scpn_fusion_tpu_torch.ops import cuda_sandpile as csp

    dev, f32, f64 = "cuda", torch.float32, torch.float64
    short_q = ds.DisruptionParams(n_steps=400)
    short_s = sp.SandpileConfig(n_cells=64, n_steps=20)
    for dtype in (f32, f64):
        q = torch.tensor([0.0, 200.0, 5.0], dtype=dtype, device=dev)
        same_q = all(torch.equal(a, b) for a, b in zip(
            cdis.disruption_sequence(short_q, q, 0.2),
            cdis.disruption_sequence_plain(short_q, q, 0.2)))
        h0, idx = torch.zeros(64, dtype=dtype, device=dev), sp.drive_indices(short_s, 0).to(dev)
        same_s = all(torch.equal(a, b) for a, b in zip(csp.sandpile_run(short_s, h0, idx),
                                                       csp.sandpile_run_plain(short_s, h0, idx)))
        print(f"{dtype}: row Q (3 sequences x 400 ticks) torch.equal to its plain loop {same_q}; "
              f"row S (64 cells x 20 drives) {same_s} [{card}]")

    p, q1 = ds.DisruptionParams(), torch.zeros(1, dtype=f64, device=dev)
    tenth = ds.DisruptionParams(n_steps=400)
    full = sp.SandpileConfig()
    part = sp.SandpileConfig(n_steps=200)
    idx_full, idx_part = (sp.drive_indices(c, 0).to(dev) for c in (full, part))
    h0 = torch.zeros(full.n_cells, device=dev)
    rows = (("row Q, the default sequence f64", tenth.n_steps, "tick",
             lambda: cdis.disruption_sequence_plain(tenth, q1, 0.0),
             lambda: cdis.disruption_sequence(p, q1, 0.0)),
            ("row S, the default sandpile f32", part.n_steps * part.relax_sweeps, "sweep",
             lambda: csp.sandpile_run_plain(part, h0, idx_part),
             lambda: csp.sandpile_run(full, h0, idx_full)))
    for label, units, unit, plain, kernel in rows:
        out = profile_solve(card, f"{label}, plain loop at a tenth of its length",
                            lambda run=plain: {"ran": run() is not None}, None)
        print(f"{label}, plain: {out['launches'] / units:.2f} device launches a {unit}, idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}, {1e3 * out['wall_ms'] / units:.2f} "
              f"us a {unit} of wall time (profiled) [{card}]")
        kernel()
        cb.reset_launch_counts()
        ms = sorted(cuda_events_ms(kernel) for _ in range(5))
        print(f"{label}, kernel at full length: {cb.kernel_launches()} launches in 5 calls, "
              f"{ms[2]:.4f} ms between CUDA events around the one launch (median of 5; all "
              f"{[round(m, 4) for m in ms]}) [{card}]")

    rho33 = torch.tensor(np.linspace(0.0, 1.0, 33), dtype=f64, device=dev)
    ne19 = torch.tensor(np.linspace(8.0, 2.0, 33), dtype=f64, device=dev)
    te = torch.tensor(np.linspace(8.0, 0.05, 33), dtype=f64, device=dev)
    grid = fp.FokkerPlanckGrid(64)
    p64 = grid.p(f64, "cpu")
    f0 = (1e12 * torch.exp(-((torch.log10(p64) + 1.0) ** 2) / 0.1)).to(dev)
    n = 7
    qp = st.QProfile(*(torch.tensor(np.asarray(x, dtype=np.float64), device=dev) for x in (
        np.linspace(0.1, 1.0, n), np.linspace(1.0, 4.0, n), np.full(n, 0.4), np.full(n, 3.5),
        1.0, 0.1, 4.0)))
    cfg = spi.SpiConfig(n_fragments=64, injector_pos=(8.4, 0.0, 0.0), velocity_mps=500.0)
    loops = (
        ("run_spi_injection, 64 fragments x 600 steps f64", lambda: spi.run_spi_injection(
            cfg, torch.Generator().manual_seed(1), ne19, te, dt_s=5e-5, n_steps=600)),
        ("spi_quantity_sweep, 3 inventories x 500 steps f64", lambda: spi.spi_quantity_sweep(
            cfg, torch.Generator().manual_seed(4), torch.tensor([0.002, 0.01, 0.03], dtype=f64,
                                                                device=dev), ne19, te,
            dt_s=5e-5, n_steps=500)),
        ("run_fokker_planck, 64 points x 300 steps f64", lambda: fp.run_fokker_planck(
            grid, f0, 1e-6, 10.0, 5e19, 5000.0, 1.5, n_steps=300)),
        ("run_fluid_runaway, 100 steps f64", lambda: rf.run_fluid_runaway(
            0.5, 0.1, 50.0, 1.0, n_re_seed=1e16, t_max_s=1.0, n_steps=100,
            max_runaway_fraction=0.05, dtype=f64, device=dev)),
        ("run_elm_cycle, 3000 steps f64", lambda: elm.run_elm_cycle(
            t_ped0_kev=1.0, n_ped_1e19=8.0, w_ped_mj=10.0, heat_rate_kev_s=50.0,
            alpha_per_kev=1.0, s_edge=1.5, j_edge_norm=0.1, dt=1e-3, n_steps=3000, dtype=f64,
            device=dev)),
        ("rutherford_island_evolution, 5000 steps f64", lambda: mm.rutherford_island_evolution(
            delta_prime=5.0, r_s_m=1.2, eta_ohm_m=1e-7, n_steps=5000, dt=1e-2, dtype=f64,
            device=dev)),
        ("locked_mode_evolution, 3000 steps f64", lambda: mm.locked_mode_evolution(
            w_island_m=0.12, b_error_mt=5.0, omega0_hz=100.0, dtype=f64, device=dev)),
        ("pellet_ablation, 400 ticks f64", lambda: ev.pellet_ablation(
            te_profile_kev=10.0 * (1 - 0.9 * rho33 ** 2),
            ne_profile_19=8.0 * (1 - 0.7 * rho33 ** 2))),
        ("ballooning_stability_eigen, 7 points (row B twice)",
         lambda: st.ballooning_stability_eigen(qp)),
    )
    for label, run in loops:
        out = profile_solve(card, label, lambda run=run: {"ran": run() is not None}, None)
        cb.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        print(f"{label}: {out['launches']} device launches ({cb.kernel_launches()} of the port's "
              f"kernels, counted), {out['device_ms']:.4f} ms of device time, "
              f"{out['wall_ms']:.3f} ms of wall time (profiled), idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")


def profile_frc(card: str) -> None:
    """The FRC and pulsed slice: row P ``torch.equal`` to its plain loop in
    float32 and float64 (the JAX test's 3000-step drive at 4000 V), its
    adjoint against autograd through the plain loop and ``gradcheck``, the
    plain loop at a tenth of its length and autograd's backward through 500
    steps profiled, row P and its adjoint at full length by CUDA events, then
    the slice's plain loops on 64^2 and 65 points, float64."""
    import torch
    import chip_smoke as smoke
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_compression as ccp

    dev, f64 = "cuda", torch.float64
    cfg = pc.CompressionConfig()
    for dtype in (torch.float32, f64):
        c, s0, table = smoke.compression_inputs(cfg, dict(radius_m=0.25), lambda t: 4000.0, 2e-8,
                                                3000, 0.0, dtype, dev)
        same = torch.equal(ccp.compression_run(c, s0, table), ccp.compression_run_plain(c, s0, table))
        print(f"{dtype}: row P (3000 steps at 4000 V) torch.equal to its plain loop {same} [{card}]")
        print(f"{dtype}: adjoint against autograd through the plain loop: "
              f"{smoke.adjoint_gaps(dtype, dev)} [{card}]")
    print(f"gradcheck of row P and its adjoint, float64, 30 steps: {smoke.compression_gradcheck(dev)}"
          f" [{card}]")

    c, s0, table = smoke.compression_inputs(cfg, dict(radius_m=0.25), lambda t: 4000.0, 2e-8,
                                            4000, 0.0, f64, dev)
    out = profile_solve(card, "row P, the 4000-step drive f64, plain loop at 400 of its steps",
                        lambda: {"ran": ccp.compression_run_plain(c, s0, table[:400]) is not None},
                        None)
    print(f"row P plain: {out['launches'] / 400:.2f} device launches a step, idle share "
          f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}, {1e3 * out['wall_ms'] / 400:.2f} us a "
          f"step of wall time (profiled) [{card}]")
    v = table[:500].clone().requires_grad_()
    trace = ccp.compression_run_plain(c, s0, v)
    grad = torch.zeros_like(trace)
    grad[1, int(trace[1].argmin())] = 1.0
    out = profile_solve(card, "row P's adjoint, autograd through the plain loop (500 steps f64)",
                        lambda: {"ran": torch.autograd.grad(trace, v, grad, retain_graph=True)
                                 is not None}, None)
    print(f"row P adjoint plain: {out['launches'] / 500:.2f} device launches a step backward, idle "
          f"share {1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")
    v_k = table[:500].clone().requires_grad_()
    trace_k = ccp.compression_run(c, s0, v_k)
    for label, run in (("row P, 4000 steps f64", lambda: ccp.compression_run(c, s0, table)),
                       ("row P's adjoint, 500 steps f64",
                        lambda: torch.autograd.grad(trace_k, v_k, grad, retain_graph=True))):
        run()
        cb.reset_launch_counts()
        ms = sorted(cuda_events_ms(run) for _ in range(5))
        print(f"{label}: {cb.kernel_launches()} launches in 5 calls, {ms[2]:.4f} ms between CUDA "
              f"events around the one launch (median of 5; all {[round(m, 4) for m in ms]}) "
              f"[{card}]")

    profile_hall_loops(card)


def profile_orbits(card: str) -> None:
    """The heating, orbit, divertor and stellarator slice: row F's
    ``gc_ensemble`` and ``gc_orbit`` first checked ``torch.equal`` to their
    plain twins at short lengths (256 particles x 200 steps, one orbit of 200
    steps) in float32 and float64, then the ensemble's plain twin profiled at
    a tenth of its length (2048 particles x 400 of 4000 steps, float64) and
    row F timed at full length by CUDA events (2048 x 4000 and the
    20,000-step orbit, float64); then the slice's plain loops: the
    lambda-field guiding centre (2000 of its 20,000 steps), the Boris E x B
    drift (4000 of 40,000 steps), the ICRH bundle (10 x 160), a drift-wave run
    (64^2, 100 steps, float32), the vapor shield and the stellarator ripple,
    float64 but for the drift waves."""
    import torch
    import chip_smoke as smoke
    from scpn_fusion_tpu_torch.models.physics import divertor_lab as dl
    from scpn_fusion_tpu_torch.models.physics import drift_wave as dw
    from scpn_fusion_tpu_torch.models.physics import orbits
    from scpn_fusion_tpu_torch.models.physics import rf_heating as rf
    from scpn_fusion_tpu_torch.models.physics import stellarator as st
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_orbits as co

    dev, f64 = "cuda", torch.float64
    field = smoke.fast_field()
    for dtype in (torch.float32, f64):
        c = smoke.fast_constants(dtype, dev)
        s = smoke.packed(smoke.fast_population("central 256", dtype, dev))
        same = all(torch.equal(a, b) for a, b in zip(co.gc_ensemble(c, field, s, 200),
                                                     co.gc_ensemble_plain(c, field, s, 200)))
        c_o, s0 = smoke.orbit_state(dtype, dev)
        same_o = all(torch.equal(a, b) for a, b in zip(co.gc_orbit(c_o, field, s0, 200),
                                                       co.gc_orbit_plain(c_o, field, s0, 200)))
        print(f"{dtype}: row F torch.equal to its plain twin: ensemble (256 x 200) {same}, orbit "
              f"(200 steps) {same_o} [{card}]")
    c = smoke.fast_constants(f64, dev)
    s = smoke.packed(smoke.fast_population(smoke.FAST_TIMED, f64, dev))
    out = profile_solve(card, "row F, 2048 particles f64, plain twin at 400 of its 4000 steps",
                        lambda: {"ran": co.gc_ensemble_plain(c, field, s, 400) is not None}, None)
    print(f"row F plain: {out['launches'] / 400:.2f} device launches a step, idle share "
          f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}, {1e3 * out['wall_ms'] / 400:.2f} us a "
          f"step of wall time (profiled) [{card}]")
    c_o, s0 = smoke.orbit_state(f64, dev)
    for label, run in (("row F gc_ensemble, 2048 x 4000 steps f64",
                        lambda: co.gc_ensemble(c, field, s, smoke.FAST_STEPS)),
                       ("row F gc_orbit, 20,000 steps f64",
                        lambda: co.gc_orbit(c_o, field, s0, smoke.GC_STEPS))):
        run()
        cb.reset_launch_counts()
        ms = sorted(cuda_events_ms(run) for _ in range(5))
        print(f"{label}: {cb.kernel_launches()} launches in 5 calls, {ms[2]:.4f} ms between CUDA "
              f"events around the one launch (median of 5; all {[round(m, 4) for m in ms]}) "
              f"[{card}]")

    qm = 1.602176634e-19 / (2.0 * 1.66053906660e-27)
    gc0 = orbits.init_guiding_center(smoke.lambda_field, **smoke.GC, dtype=f64, device=dev)
    e1 = torch.tensor([0.0, 1e4, 0.0], dtype=f64, device=dev)
    b2 = torch.tensor([0.0, 0.0, 2.0], dtype=f64, device=dev)
    boris0 = orbits.BorisState(torch.zeros(3, dtype=f64, device=dev),
                               torch.zeros(3, dtype=f64, device=dev))
    cfg64 = dw.DriftWaveConfig(n=64)
    drift0 = dw.initial_state(torch.Generator().manual_seed(2), cfg64, device=dev)
    loops = (
        ("lambda-field guiding centre, 2000 steps f64", 2000, lambda: orbits.run_guiding_center(
            gc0, smoke.lambda_field, m_amu=2.0, charge_z=1, dt=1e-8, n_steps=2000)),
        ("Boris E x B, 4000 steps f64", 4000, lambda: orbits.run_boris(
            boris0, lambda x: (e1, b2), q_over_m=qm, dt=5e-9, n_steps=4000)),
        ("ICRH bundle, 10 rays x 160 steps f64", 160, lambda: rf.trace_icrh_rays(
            rf.ICRHParams(), dtype=f64, device=dev)),
        ("drift waves, 64^2 x 100 steps c64", 100, lambda: dw.simulate_probes(
            drift0, cfg64, dw.default_probe_indices(64, 16, device=dev), 0, 100)),
        ("vapor shield at 1.9 GW/m^2 f64", 27, lambda: dl.lithium_vapor_shield(
            1.9e9, dtype=f64, device=dev)),
        ("stellarator ripple, 96 x 80 f64", 1, lambda: st.effective_ripple(
            st.w7x_config(), 0.5, dtype=f64, device=dev)),
    )
    for label, steps, run in loops:
        out = profile_solve(card, label, lambda run=run: {"ran": run() is not None}, None)
        cb.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        print(f"{label}: {out['launches']} device launches ({out['launches'] / steps:.1f} a step; "
              f"{cb.kernel_launches()} of the port's kernels, counted), {out['device_ms']:.4f} ms "
              f"of device time, {out['wall_ms']:.3f} ms of wall time (profiled), idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")


def profile_plant(card: str) -> None:
    """The engineering and nuclear slice: rows E and H checked ``torch.equal``
    to their plain twins at short lengths, each plain twin profiled at a
    tenth of its length and its kernel's path at full length, both kernels
    timed by CUDA events, then the slice's plain loops (see the module's
    docstring)."""
    import numpy as np
    import torch
    import chip_smoke as smoke
    from scpn_fusion_tpu_torch.models.engineering import cad_raytrace as cad
    from scpn_fusion_tpu_torch.models.engineering import hts_quench as hq
    from scpn_fusion_tpu_torch.models.nuclear import blanket as bk
    from scpn_fusion_tpu_torch.models.nuclear import heating_neutronics as hn
    from scpn_fusion_tpu_torch.models.nuclear import temhd as te
    from scpn_fusion_tpu_torch.models.physics import design_scan as ds
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_burn as cbn
    from scpn_fusion_tpu_torch.ops import cuda_quench as cq

    dev, f32, f64 = "cuda", torch.float32, torch.float64
    for dtype in (f32, f64):
        k = smoke.burn_case("JAX test 512 (seed 1)", dtype, dev)
        same_e = torch.equal(cbn.burn_relax(k, 8.0, 20), cbn.burn_relax_plain(k, 8.0, 20))
        values, c, _ = smoke.quench_case(smoke.QUENCH_TIMED, dtype, dev)
        same_h = all(torch.equal(a, b) for a, b in zip(cq.quench_run(values, c, 300),
                                                       cq.quench_run_plain(c, 300)))
        print(f"{dtype}: row E (512 designs x 20 iterations) torch.equal to its plain twin "
              f"{same_e}; row H (300 steps) {same_h} [{card}]")
    k = smoke.burn_case(smoke.BURN_TIMED, f32, dev)
    values, c, n_steps = smoke.quench_case(smoke.QUENCH_TIMED, f64, dev)
    rows = (("row E, the compact search's 4096 designs f32", 20, "iteration",
             lambda: cbn.burn_relax_plain(k, 8.0, 20),
             lambda: cbn.burn_relax(k, 8.0, 200),
             lambda: ds.compact_reactor_search(device=dev)),
            ("row H, the default transient f64", 200, "step",
             lambda: cq.quench_run_plain(c, 200),
             lambda: cq.quench_run(values, c, n_steps),
             lambda: hq.evaluate_rebco_quench(dtype=f64, device=dev)))
    for label, units, unit, plain, kernel, path in rows:
        out = profile_solve(card, f"{label}, plain twin at a tenth of its length",
                            lambda run=plain: {"ran": run() is not None}, None)
        print(f"{label}, plain: {out['launches'] / units:.2f} device launches a {unit}, idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}, {1e3 * out['wall_ms'] / units:.2f} "
              f"us a {unit} of wall time (profiled) [{card}]")
        out = profile_solve(card, f"{label}, its path through the kernel",
                            lambda run=path: {"ran": run() is not None}, None)
        kernel()
        cb.reset_launch_counts()
        ms = sorted(cuda_events_ms(kernel) for _ in range(5))
        print(f"{label}, kernel at full length: {cb.kernel_launches()} launches in 5 calls, "
              f"{ms[2]:.4f} ms between CUDA events around the one launch (median of 5; all "
              f"{[round(m, 4) for m in ms]}) [{card}]")

    vertices, faces = smoke.torus_mesh()
    (source, power) = smoke.CAD_SOURCE
    cand = hn.quick_candidate(torch.Generator().manual_seed(11), 0, dtype=f64, device=dev)
    loops = (
        ("run_temhd, 600 steps of 0.05 s f64", 600, lambda: te.run_temhd(
            te.TEMHDParams(), 10.0, dt=0.05, n_steps=600, dtype=f64, device=dev)),
        ("temhd_flux_scan, 3 fluxes x 200 steps f64", 200, lambda: te.temhd_flux_scan(
            te.TEMHDParams(), torch.tensor([1.0, 5.0, 20.0], dtype=f64, device=dev), n_steps=200,
            dtype=f64, device=dev)),
        ("mcnp_lite_transport_tbr, 2000 histories x 48 rounds f64", 48,
         lambda: hn.mcnp_lite_transport_tbr(
             torch.Generator().manual_seed(7), histories=2000, thickness_cm=100.0,
             li6_enrichment=0.9, be_multiplier_fraction=0.5, reflector_albedo=0.3, dtype=f64,
             device=dev)),
        ("volumetric_tbr, 24 x 72 x 48 f64", 1, lambda: bk.volumetric_tbr(
            bk.BlanketConfig(), dtype=f64, device=dev)),
        ("refine_candidate_tbr (the volumetric blanket, MCNP-lite at 700) f64", 1,
         lambda: hn.refine_candidate_tbr(
            cand, torch.Generator().manual_seed(111), dtype=f64, device=dev)),
        (f"estimate_surface_loading, {len(faces)} faces with occlusion f64", 1,
         lambda: cad.estimate_surface_loading(vertices, faces, np.asarray([source]),
                                              np.asarray([power]), occlusion_cull=True,
                                              dtype=f64, device=dev)),
    )
    for label, steps, run in loops:
        out = profile_solve(card, label, lambda run=run: {"ran": run() is not None}, None)
        cb.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        print(f"{label}: {out['launches']} device launches ({out['launches'] / steps:.1f} a step; "
              f"{cb.kernel_launches()} of the port's kernels, counted), {out['device_ms']:.4f} ms "
              f"of device time, {out['wall_ms']:.3f} ms of wall time (profiled), idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")


def profile_phase(card: str) -> None:
    """The phase, UQ, diagnostics, WDM and quasi-3D slice: row U checked
    ``torch.equal`` to its plain twin on every case of the smoke's
    ``PHASE_CASES`` at 300 ticks in float32 and float64, the monitor's plain
    twin profiled at 100 of its ticks and its run through row U at 1000, row
    U timed by CUDA events on every case at full length, then the discharge
    of ``models/wdm.py`` at 20 steps (see the module's docstring)."""
    import torch
    import chip_smoke as smoke
    from scpn_fusion_tpu_torch.models import wdm
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_phase as cp

    dev = "cuda"
    cb.library()
    for line in cb.BUILD_LOG.get("phase.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas phase.cu: {line.strip()}")
    for dtype in (torch.float32, torch.float64):
        print(f"{dtype}: row U's block holds at most {cp.max_threads(dtype)} threads")
        for label, *_ in smoke.PHASE_CASES:
            kernel, plain, _ = smoke.phase_case(label, dtype, dev)
            cb.reset_launch_counts()
            got = kernel(300)
            calls = dict(cb.CALLS)
            same = smoke.phase_equal(got, plain(300))
            print(f"{dtype} {label} x 300 ticks: {calls} launches, torch.equal to its plain twin "
                  f"{same} [{card}]")
    label = smoke.PHASE_TIMED
    kernel, plain, n_ticks = smoke.phase_case(label, torch.float32, dev)
    out = profile_solve(card, f"{label} f32, plain twin at 100 ticks",
                        lambda: {"ran": plain(100) is not None}, None)
    print(f"{label} f32, plain: {out['launches'] / 100:.2f} device launches a tick, idle share "
          f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}, {1e3 * out['wall_ms'] / 100:.2f} us a "
          f"tick of wall time (profiled) [{card}]")
    out = profile_solve(card, f"{label} f32, {n_ticks} ticks through row U",
                        lambda: {"ran": kernel(n_ticks) is not None}, None)
    for dtype in (torch.float32, torch.float64):
        for label, *_ in smoke.PHASE_CASES:
            kernel, _, n = smoke.phase_case(label, dtype, dev)
            kernel(n)
            ms = sorted(cuda_events_ms(lambda: kernel(n)) for _ in range(5))
            print(f"{dtype} {label} x {n} ticks through row U: {ms[2]:.4f} ms between CUDA "
                  f"events around the call (median of 5; all {[round(m, 4) for m in ms]}) "
                  f"[{card}]")
    cfg = wdm.WDMConfig()
    s0 = wdm.default_initial_state(cfg, torch.float32, dev)
    out = profile_solve(card, "run_discharge, WDMConfig(), 20 steps f32",
                        lambda: {"ran": wdm.run_discharge(cfg, s0, 20) is not None}, None)
    cb.reset_launch_counts()
    wdm.run_discharge(cfg, s0, 20)
    torch.cuda.synchronize()
    print(f"run_discharge 20 steps f32: {out['launches']} device launches "
          f"({out['launches'] / 20:.1f} a step; {dict(cb.CALLS)} of the port's kernels, counted), "
          f"{out['device_ms']:.4f} ms of device time, {out['wall_ms']:.3f} ms of wall time "
          f"(profiled), idle share {1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")

def profile_surrogates(card: str) -> None:
    """The surrogates slice: row W checked ``torch.equal`` to its plain twin at
    1024 x 200 steps in float32 and float64, the plain twin profiled at those
    200 steps, row W timed by CUDA events at 20,000, then one FNO training
    step and one 65^2 free-boundary solve of the equilibrium trainer (see the
    module's docstring)."""
    import numpy as np
    import torch
    import chip_smoke as smoke
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium import free_boundary as fb
    from scpn_fusion_tpu_torch.models.surrogates import fno
    from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_proxy as cp

    dev = "cuda"
    cb.library()
    for line in cb.BUILD_LOG.get("gene_proxy.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas gene_proxy.cu: {line.strip()}")
    label = smoke.PROXY_TIMED
    for dtype in (torch.float32, torch.float64):
        x, _ = smoke.proxy_case(label, dtype, dev)
        cb.reset_launch_counts()
        got = cp.gene_proxy(x, 200)
        calls = dict(cb.CALLS)
        print(f"{dtype} row W, 1024 samples x 200 steps: {calls} launches, torch.equal to its "
              f"plain twin {torch.equal(got, cp.gene_proxy_plain(x, 200))} [{card}]")
    x, iterations = smoke.proxy_case(label, torch.float32, dev)
    out = profile_solve(card, "the proxy's plain twin, 1024 x 200 steps f32",
                        lambda: {"ran": cp.gene_proxy_plain(x, 200) is not None}, None)
    print(f"the proxy's plain twin f32: {out['launches'] / 200:.2f} device launches a step, idle "
          f"share {1.0 - out['device_ms'] / out['wall_ms']:.3f}, {1e3 * out['wall_ms'] / 200:.2f} "
          f"us a step of wall time (profiled) [{card}]")
    for dtype in (torch.float32, torch.float64):
        xd, _ = smoke.proxy_case(label, dtype, dev)
        cp.gene_proxy(xd, iterations)
        ms = sorted(cuda_events_ms(lambda: cp.gene_proxy(xd, iterations)) for _ in range(5))
        print(f"{dtype} row W, 1024 x {iterations} steps: {ms[2]:.4f} ms between CUDA events "
              f"around the one launch (median of 5; all {[round(m, 4) for m in ms]}) [{card}]")

    gen = torch.Generator().manual_seed(0)
    params = fno.init_fno(gen, width=24, modes=12, n_layers=3, device=dev)
    g = np.random.default_rng(0)
    xs = torch.from_numpy(g.standard_normal((64, 64, 64, 1)).astype(np.float32)).to(dev)
    ys = torch.from_numpy(g.standard_normal((64, 64, 64, 1)).astype(np.float32)).to(dev)
    idx = torch.randint(0, 64, (1, 16), generator=gen).to(dev)
    fno._train_fno(params, xs, ys, idx, lr=3e-3, schedule="cosine", total_steps=2500)
    out = profile_solve(card, "one FNO training step (64^2, width 24, modes 12, 3 layers, "
                              "batch 16) f32",
                        lambda: {"ran": fno._train_fno(params, xs, ys, idx, lr=3e-3,
                                                       schedule="cosine",
                                                       total_steps=2500) is not None}, None)
    ms = sorted(cuda_events_ms(lambda: fno._train_fno(params, xs, ys, idx, lr=3e-3,
                                                      schedule="cosine", total_steps=2500))
                for _ in range(5))
    print(f"one FNO training step: {out['launches']} device launches, idle share "
          f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}; {ms[2]:.3f} ms between CUDA events "
          f"(median of 5, unprofiled) [{card}]")

    cfg = tp.equilibrium_training_config(65)
    grid = Grid.from_config(cfg, dtype=torch.float32, device=dev)
    coils = fb.coilset_from_config(cfg, torch.float32, dev)

    def solve():
        return fb.solve_free_boundary(cfg, coils, grid=grid, mu0_green=1.0,
                                      dtype=torch.float32, device=dev)

    out = profile_solve(card, "one 65^2 free-boundary solve of the equilibrium trainer f32",
                        lambda: {"ran": solve() is not None}, None)
    log = []
    cb.reset_launch_counts()
    with smoke.inner_iterations(log):
        res = solve()
    torch.cuda.synchronize()
    ms = sorted(cuda_events_ms(solve) for _ in range(3))
    print(f"one 65^2 solve: {res.outer_iterations} outer, inner {log} ({sum(log)}); kernel calls "
          f"{dict(cb.CALLS)}; {out['launches']} device launches, idle share "
          f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}; {ms[1]:.1f} ms between CUDA events "
          f"(median of 3, unprofiled), ~{180 * ms[1] / 1e3:.0f} s for the trainer's 180 [{card}]")


def profile_ensemble(card: str) -> None:
    """The ensembles of ``parallel/ensemble.py``: the B = 1 and B = 256
    batches of ``validation/run_batched_amortisation.py`` (129^2 f32,
    ``bench_config.amortisation_draws``) through the batched kernels 2 and 3,
    each profiled as one solve: device time by kernel, idle share, device
    launches and the port's kernel launches an iteration; then the mixed B =
    64 batch (f64, its f32 V-cycles through the batched kernel 3)."""
    import torch
    import chip_smoke as smoke
    from scpn_fusion_tpu_torch.bench_config import amortisation_config
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch

    dev = "cuda"
    cb.library()
    cfg = amortisation_config(129)
    grid = Grid.from_config(cfg, dtype=torch.float32, device=dev)
    for b in (1, 256):
        cur, tgt = smoke.ensemble_case(b, torch.float32, dev)

        def solve(cur=cur, tgt=tgt):
            res = solve_equilibrium_batch(cfg, grid, cur, tgt)
            return {"iterations": int(res.iterations.max()),
                    "converged": bool(res.converged.all())}

        out = profile_solve(card, f"ensemble B = {b}, 129^2 f32", solve, None)
        cb.reset_launch_counts()
        info = solve()
        torch.cuda.synchronize()
        loop = info["iterations"]
        print(f"ensemble B = {b}: {loop} iterations; {out['launches'] / loop:.1f} device launches "
              f"an iteration ({out['port_launches'] / loop:.2f} of the port's kernels; wrapper "
              f"calls {dict(cb.CALLS)}, C-entry launches {dict(cb.LAUNCHES)}), "
              f"{out['wall_ms'] / loop:.3f} ms an iteration, {out['wall_ms'] / b:.4f} ms a "
              f"solve (profiled); idle share {1.0 - out['device_ms'] / out['wall_ms']:.3f} "
              f"[{card}]")
    out = profile_solve(card, "mixed ensemble B = 64, 129^2 f64 with f32 V-cycles",
                        lambda: {"iterations": int(smoke.mixed_batch(dev, ("mixed", 64))
                                                   .iterations.max())}, None)
    print(f"mixed ensemble B = 64: {out['launches']} device launches, idle share "
          f"{1.0 - out['device_ms'] / out['wall_ms']:.3f}, {out['wall_ms'] / 64:.4f} ms a solve "
          f"(profiled) [{card}]")


def collective_ledger(gs) -> tuple[dict, list]:
    """Counters of ``parallel/gk_shard``'s collectives by name: calls and the
    bytes that would cross between shards on a mesh of several cards (psum /
    pmax: every part but the first to it and the total back; all_gather:
    every receiver's parts from the others; all_to_all: every block that
    leaves its shard).  Returns (the ledger, a function that puts the
    collectives back)."""
    ledger = {name: {"calls": 0, "bytes": 0} for name in ("psum", "pmax", "all_gather",
                                                          "all_to_all")}
    saved = {name: getattr(gs, name) for name in ledger}

    def nbytes(t):
        return t.numel() * t.element_size()

    def moved(name, parts, *args):
        n = len(parts)
        if name in ("psum", "pmax"):
            return 2 * sum(nbytes(p) for p in parts[1:])
        if name == "all_gather":
            return (n - 1) * sum(nbytes(p) for p in parts)
        return sum(nbytes(p) - nbytes(p.tensor_split(n, args[0])[r]) for r, p in enumerate(parts))

    def wrap(name):
        def counted(parts, *args):
            ledger[name]["calls"] += 1
            ledger[name]["bytes"] += moved(name, parts, *args)
            return saved[name](parts, *args)
        return counted

    for name in ledger:
        setattr(gs, name, wrap(name))
    return ledger, lambda: [setattr(gs, k, v) for k, v in saved.items()]


def profile_gk_shard(card: str) -> None:
    """One RK4 step of lane 7 (``bench_config.GK_SPEC_32``, 2x32x32x16x16x8
    c128) from the state after 3 steps, monolithic and on the (2, 2, 2) mesh
    of 8 virtual shards of the card, each profiled: device launches, idle
    share, the port's kernels; row G's device µs a shard and a stage by CUDA
    events (one launch on each shard, median of 5); the collectives' calls
    and bytes in one step; ms a step of each (CUDA events around 5 steps,
    median of 3, in turns)."""
    import statistics

    import torch
    from scpn_fusion_tpu_torch.bench_config import GK_SPEC_32, GK_SPEC_32_SEED
    from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_gk
    from scpn_fusion_tpu_torch.parallel import gk_shard as gs
    from scpn_fusion_tpu_torch.parallel.mesh import Mesh

    cfg = nl.NonlinearGKConfig(**GK_SPEC_32)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh.of([dev] * 8, ("sx", "sy", "v"), (2, 2, 2))
    g = nl.build_grids(cfg, device=dev)
    spec, gram_inv = nl.stage_spec(cfg, g), nl._gram_inv(cfg, g, nl._dtypes(cfg)[0])
    state = nl.init_state(cfg, g, seed=GK_SPEC_32_SEED)
    for _ in range(3):
        state = nl._rk4_step(cfg, g, spec, state, gram_inv)
    sharded = gs.shard_state_spatial_3d(state, mesh)
    run = gs._ShardedRun(cfg, g, sharded.layout)

    def mono_step():
        return nl._rk4_step(cfg, g, spec, state, gram_inv)

    def shard_step():
        return run.step(list(sharded.shards), sharded.time)

    outs = {"monolithic": profile_solve(
                card, "lane 7, one RK4 step, monolithic",
                lambda: {"max |f|": float(mono_step().f.abs().max())}, None),
            "8 shards": profile_solve(
                card, "lane 7, one RK4 step, (2, 2, 2) virtual shards",
                lambda: {"max |f|": max(float(f.abs().max()) for f in shard_step()[0])},
                "torch_gk_shard_trace.json")}
    for name, out in outs.items():
        print(f"lane 7 {name}: {out['launches']} device launches a step ({out['port_launches']} "
              f"of the port's kernels, {out['port_ms']:.4f} ms), {out['device_ms']:.4f} ms of "
              f"device time, {out['wall_ms']:.3f} ms of wall time (profiled), idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")
    cb.reset_launch_counts()
    ledger, restore = collective_ledger(gs)
    try:
        shard_step()
    finally:
        restore()
    torch.cuda.synchronize()
    print(f"lane 7, 8 shards, one step: row G wrapper calls {cb.CALLS['gk_rhs']}, launches "
          f"{dict(cb.LAUNCHES)}; collectives (calls, bytes between shards): "
          + ", ".join(f"{k} {v['calls']} / {v['bytes'] / 1e6:.3f} MB" for k, v in ledger.items())
          + f" [{card}]")

    # row G alone: stage 2 on every shard's inputs, and the monolithic stage
    fs = list(sharded.shards)
    phis = run.field(fs)
    dt = run.dt(phis)
    terms = run.terms(fs, phis)
    accs = [cuda_gk.gk_stage(0, f, f, None, t, dt, sp)[1]
            for f, t, sp in zip(fs, terms, run.specs)]
    m_terms = nl.stage_terms(cfg, g, state.f, nl.field_solve(cfg, g, state.f), gram_inv)
    m_acc = cuda_gk.gk_stage(0, state.f, state.f, None, m_terms, dt, spec)[1]

    def shard_launches():
        for f, t, a, sp in zip(fs, terms, accs, run.specs):
            cuda_gk.gk_stage(1, f, f, a, t, dt, sp)

    def mono_launch():
        cuda_gk.gk_stage(1, state.f, state.f, m_acc, m_terms, dt, spec)

    shard_launches()
    mono_launch()
    us_s = statistics.median(cuda_events_ms(shard_launches) for _ in range(5)) * 1e3
    us_m = statistics.median(cuda_events_ms(mono_launch) for _ in range(5)) * 1e3
    print(f"lane 7 row G, stage 2: 8 shard launches {us_s:.1f} µs ({us_s / 8:.1f} µs a shard), "
          f"the monolithic launch {us_m:.1f} µs (CUDA events, median of 5) [{card}]")

    def steps(fn):
        def go():
            for _ in range(5):
                fn()
        return go

    times = {"monolithic": [], "8 shards": []}
    for _ in range(3):
        for name, fn in (("monolithic", steps(mono_step)), ("8 shards", steps(shard_step))):
            times[name].append(cuda_events_ms(fn) / 5)
    print("lane 7 ms a step: " + ", ".join(
        f"{k} {statistics.median(v):.4f} (all {[round(t, 4) for t in v]})"
        for k, v in times.items()) + f" (CUDA events around 5 steps, median of 3, in turns) "
        f"[{card}]")
    batched_rows_events(card)


def batched_rows_events(card: str) -> None:
    """Device µs of one call of each batched entry of kernels 2 and 3 (rows
    2b, 3b) at the kernels line's shape, 129^2 and B = 16, L-mode source and
    (3,3) V-cycle: CUDA events around one call after a warm-up, median of 5."""
    import statistics

    import numpy as np
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_source

    dev, f32, n, b = "cuda", torch.float32, 129, 16
    rng = np.random.default_rng(23)
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=f32, device=dev).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=f32, device=dev).unbind())
    g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=f32, device=dev)
    mask = (g.ZZ < g.Z_min * 0.5).to(f32).contiguous()
    psi = torch.tensor(rng.standard_normal((b, n, n)), dtype=f32, device=dev)
    src = torch.tensor(rng.standard_normal((b, n, n)), dtype=f32, device=dev)
    i_t = torch.tensor(14.0 + rng.random(b), dtype=f32, device=dev)
    params = cuda_source.pack_source_params_batched(p_c, ff_c, i_t, like=psi)
    calls = {
        "2b fused_topology_source_batched (3 launches)": lambda: cuda_source.
        fused_topology_source_batched(psi, g.R, mask, params, d_r=g.dR, d_z=g.dZ, mu0=1.0,
                                      h_mode=False),
        "3b fused_coarse_vcycle_batched (1 launch)": lambda: cuda_mg.fused_coarse_vcycle_batched(
            psi, src, g.R, g.dR, g.dZ, 1.0),
    }
    for name, fn in calls.items():
        fn()
        cb.reset_launch_counts()
        us = statistics.median(cuda_events_ms(fn) for _ in range(5)) * 1e3
        print(f"row {name} at {n}^2, B = {b}: {us:.1f} µs a call (CUDA events around one call, "
              f"median of 5; C-entry launches {dict(cb.LAUNCHES)} over the 5) [{card}]")


def profile_hall_loops(card: str) -> None:
    """The FRC and pulsed slice's plain loops (the carrier, a sandbox run,
    the sweep and the bisection) profiled, float64."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import hall_mhd_discovery as hd
    from scpn_fusion_tpu_torch.models.physics import hall_mhd_pulsed as hp
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb

    dev, f64 = "cuda", torch.float64
    rho = torch.linspace(0.01, 0.5, 65, dtype=f64, device=dev)
    psi0 = 0.02 * torch.sin(torch.pi * rho / 0.5)
    params = hp.HallMHDPulsedParams(tau_psi_s=1e-3, electron_temperature_ev=50.0, r_null_m=0.3)
    normals = torch.randn((2, 64, 64), generator=torch.Generator().manual_seed(4),
                          dtype=f64).to(dev)
    loops = (
        ("run_hall_mhd_pulsed, 65 points x 200 steps f64", lambda: hp.run_hall_mhd_pulsed(
            params, psi0, rho, torch.zeros_like(rho), lambda t: 0.1, 1e-5, n_steps=200)),
        ("run_hall_mhd, 64^2 x 300 steps c128", lambda: hd.run_hall_mhd(
            hd._init_hall_mhd(normals), n_steps=300)),
        ("parameter_sweep, 3 x 3 x 250 steps at 64^2 c128", lambda: hd._parameter_sweep(
            normals, eta_range=(1e-5, 3e-3), nu_range=(1e-5, 1e-4), n_points=3, sim_steps=250)),
        ("find_tearing_threshold, 6 x 300 steps at 64^2 c128",
         lambda: hd._find_tearing_threshold(normals, eta_range=(1e-6, 1e-2), n_bisect=6,
                                            sim_steps=300)),
    )
    for label, run in loops:
        out = profile_solve(card, label, lambda run=run: {"ran": run() is not None}, None)
        cb.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        print(f"{label}: {out['launches']} device launches ({cb.kernel_launches()} of the port's "
              f"kernels, counted), {out['device_ms']:.4f} ms of device time, "
              f"{out['wall_ms']:.3f} ms of wall time (profiled), idle share "
              f"{1.0 - out['device_ms'] / out['wall_ms']:.3f} [{card}]")


def gk_wrapper_host(label, cfg, g, spec, gram_inv, state, card: str) -> None:
    """Host µs of one row-G wrapper call at stage 2 of 4 (perf_counter around
    200 calls, queued without a sync; median of 5), and of its parts: the
    per-call check of the stage's tensors and the argument block from the
    run's template, beside the whole check and the template that a run
    makes once."""
    import statistics
    import time

    import torch
    from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
    from scpn_fusion_tpu_torch.ops import cuda_gk

    f = state.f
    dt = nl.cfl_dt(cfg, g, nl.field_solve(cfg, g, f))
    terms = nl.stage_terms(cfg, g, f, nl.field_solve(cfg, g, f), gram_inv)
    _, acc = cuda_gk.gk_stage(0, f, f, None, terms, dt, spec)
    template = cuda_gk.args_template(spec, f.shape)
    n = 200
    parts = {
        "wrapper call (gk_stage)": lambda: cuda_gk.gk_stage(1, f, f, acc, terms, dt, spec),
        "check_inputs (per call)": lambda: cuda_gk.check_inputs(1, f, f, acc, terms, dt, spec),
        "check_stage (whole)": lambda: cuda_gk.check_stage(1, f, f, acc, terms, dt, spec),
        "launch_args from the run's template": lambda: cuda_gk.launch_args(
            1, f, f, acc, terms, dt, spec, template),
        "args_template (once a run)": lambda: cuda_gk.args_template(spec, f.shape),
    }
    for name, fn in parts.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        print(f"{label}, host {name}: {statistics.median(runs):.1f} µs a call (perf_counter "
              f"around {n} calls, median of 5; all {[round(r, 1) for r in runs]}) [{card}]")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--mixed", action="store_true",
                       help="profile the 2049^2 mixed-precision cascade")
    group.add_argument("--kernels", action="store_true",
                       help="profile single calls of the one-launch kernels and their "
                            "staged predecessors")
    group.add_argument("--tiled", action="store_true",
                       help="plan, occupancy, identity and device time in turns of the "
                            "tiled legs and their predecessors")
    group.add_argument("--fine", action="store_true",
                       help="plan, occupancy, identity and device time in turns of the "
                            "one-launch fine legs, the staged route and the tiled legs at 513^2")
    group.add_argument("--sor", action="store_true",
                       help="route, plan, occupancy, identity and device time in turns of "
                            "sor_sweeps on every route and the staged route")
    group.add_argument("--rect", action="store_true",
                       help="profile the rectangular 257 x 129 DIII-D-like solve")
    group.add_argument("--free-boundary", action="store_true",
                       help="profile the free-boundary forward (257^2, 129^2 f32 and mixed, "
                            "129^2 with optimize_shape and the wall response) and the coil fit")
    group.add_argument("--eqdsk", action="store_true",
                       help="profile the G-EQDSK reconstruction of the SPARC file")
    group.add_argument("--adjoint", action="store_true",
                       help="profile a Picard step and an adjoint iteration of the 65^2 f64 "
                            "adjoint lane; time its IFT gradient and a forward solve")
    group.add_argument("--recon", action="store_true",
                       help="profile the SPARC f64 real-shot reconstruction; time its "
                            "profile refit")
    group.add_argument("--transport", action="store_true",
                       help="profile ten steps of the TORAX coarse tier and the coupled "
                            "GS <-> transport solve at 257^2; time the tier's 400 steps")
    group.add_argument("--learned", action="store_true",
                       help="profile one AdamW step of the causal transformer at full width "
                            "and one launch of row L over the whole ladder")
    group.add_argument("--gk", action="store_true",
                       help="profile one RK4 step of the nonlinear GK run at the default "
                            "config and the 32^3 spec, on plain ops and through row G")
    group.add_argument("--twin", action="store_true",
                       help="profile the fueling shot, the TORAX-style campaign and the digital "
                            "twin on their plain loops and through rows N and D, and one "
                            "realtime twin session")
    group.add_argument("--ballooning", action="store_true",
                       help="profile row B on the scan and the bootstrap path (plain at a "
                            "tenth of the steps, and the kernel), the profiler over one "
                            "launch of rows B, D and N, and slice 4b's plain loops")
    group.add_argument("--disruption", action="store_true",
                       help="check rows Q and S against their plain loops, profile each plain "
                            "(a tenth of its length) and through its kernel, and the MHD, "
                            "disruption and runaway slice's plain loops")
    group.add_argument("--frc", action="store_true",
                       help="row P and its adjoint against their plain versions, then the FRC "
                            "and pulsed slice's plain loops")
    group.add_argument("--orbits", action="store_true",
                       help="row F against its plain twins, then the heating, orbit, divertor "
                            "and stellarator slice's plain loops")
    group.add_argument("--plant", action="store_true",
                       help="rows E and H against their plain twins, then the engineering and "
                            "nuclear slice's plain loops")
    group.add_argument("--phase", action="store_true",
                       help="row U against its plain twin, the monitor plain and through row U, "
                            "then the whole-device discharge")
    group.add_argument("--surrogates", action="store_true",
                       help="row W against its plain twin, the proxy plain and through row W, "
                            "then an FNO training step and a 65^2 solve of the equilibrium "
                            "trainer")
    group.add_argument("--ensemble", action="store_true",
                       help="the B = 1 and B = 256 ensembles through the batched kernels 2 "
                            "and 3, then the mixed B = 64 ensemble")
    group.add_argument("--cli", action="store_true",
                       help="the CLI's kernel mode at 513^2 and one live-server tick at 65^2 "
                            "and 513^2")
    group.add_argument("--gk-shard", action="store_true",
                       help="one step of the sharded 32^3 GK run (lane 7) on 8 virtual shards "
                            "against the monolithic step")
    parser.add_argument("--tiles", default="",
                        help="with --tiled or --fine: other tile shapes to time, as "
                             "ROWSxCOLS,...")
    parser.add_argument("--bands", default="",
                        help="with --fine: other band lengths (rows a thread) to time, as N,...")
    opts = parser.parse_args()
    mixed = opts.mixed
    import torch
    if not torch.cuda.is_available():
        print("torch_fmg_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    if opts.kernels:
        profile_kernel_calls(card)
        return 0
    tiles = [tuple(int(v) for v in item.split("x")) for item in opts.tiles.split(",") if item]
    if opts.tiled:
        profile_tiled_legs(card, tiles)
        return 0
    if opts.fine:
        profile_fine_legs(card, tiles, [int(v) for v in opts.bands.split(",") if v])
        return 0
    if opts.sor:
        profile_sor(card)
        return 0
    if opts.free_boundary:
        profile_free_boundary(card)
        return 0
    if opts.eqdsk:
        profile_eqdsk(card)
        return 0
    if opts.adjoint:
        profile_adjoint(card)
        return 0
    if opts.recon:
        profile_recon(card)
        return 0
    if opts.transport:
        profile_transport(card)
        return 0
    if opts.learned:
        profile_learned(card)
        return 0
    if opts.gk:
        profile_gk(card)
        return 0
    if opts.twin:
        profile_twin(card)
        return 0
    if opts.ballooning:
        profile_ballooning(card)
        return 0
    if opts.disruption:
        profile_disruption(card)
        return 0
    if opts.frc:
        profile_frc(card)
        return 0
    if opts.orbits:
        profile_orbits(card)
        return 0
    if opts.plant:
        profile_plant(card)
        return 0
    if opts.phase:
        profile_phase(card)
        return 0
    if opts.surrogates:
        profile_surrogates(card)
        return 0
    if opts.ensemble:
        profile_ensemble(card)
        return 0
    if opts.gk_shard:
        profile_gk_shard(card)
        return 0
    if opts.cli:
        profile_cli(card)
        return 0
    from scpn_fusion_tpu_torch.bench_config import bench_config, rect_config
    from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
        solve_equilibrium, solve_equilibrium_fmg,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.mixed_precision import (
        solve_equilibrium_mixed_fmg,
    )

    if opts.rect:
        cfg = rect_config()

        def solve():
            res = solve_equilibrium(cfg, dtype=torch.float32, device="cuda")
            return [{"shape": tuple(res.psi.shape), "iterations": res.iterations,
                     "converged": res.converged}]
    elif mixed:
        cfg = bench_config(2049, use_pallas=True, gs_residual_threshold=3e-5)

        def solve():
            return solve_equilibrium_mixed_fmg(cfg, min_coarse=129, device="cuda")[1]
    else:
        cfg = bench_config(513, use_pallas=True)

        def solve():
            return solve_equilibrium_fmg(cfg, min_coarse=129, dtype=torch.float32,
                                         device="cuda")[1]

    trace = ("torch_rect_trace.json" if opts.rect else "torch_mixed_trace.json" if mixed
             else "torch_fmg_trace.json")
    profile_solve(card, "solve", solve, trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
