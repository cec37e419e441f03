#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths through the hand-written CUDA kernels and checks
them:

* the converged 129^2 -> 257^2 -> 513^2 FMG Anderson-multigrid Picard solve
  of the fixed-boundary Grad-Shafranov equilibrium for the 6-coil ITER-like
  bench configuration (kernels 2-5);
* the resolution scale-out: the FMG cascade 129^2 -> ... -> 1025^2 in f32
  ending in the mixed-precision, GS-residual-gated 2049^2 solve (f64 master
  iterate, f32 V-cycle defect correction), the cascade of the
  ``resolution_scaling`` campaign, which runs kernels 2-7, the tiled 1025^2+
  legs (kernels 6 and 7) included, through ``solve_equilibrium_mixed_fmg``;
  (5b) the campaign itself, after every other phase: 513^2,
  1025^2 against the f64 NumPy FMG twin, the mixed 2049^2 and 4097^2
  cascades (f64 GS residual < 3e-5; their time, iterations and peak device
  memory printed) and the per-point scaling;
* the ``anderson`` solver method (inner SOR sweeps, no multigrid) on the same
  machine at 129^2: 50 sweeps of kernel 1, ``sor_sweeps``, an iteration;
* the rectangular solve: the DIII-D-like machine on the tall 257 x 129 grid
  (``bench_config.rect_config``), not a square 2^k+1, so every level of its
  V-cycle (257 x 129 down to 17 x 9 at (1,2) smoothing, 50 sweeps at 9 x 5)
  smooths through ``sor_sweeps`` and every iteration runs the source kernel
  on the 257 x 129 grid: kernels 1 and 2;
* the free-boundary forward of the ITER-like machine
  (``validation/run_free_boundary_forward.forward_solve``; coil flux on the
  ring <-> inner Picard solve): (a) 257^2 and (b) 129^2 in float32, kernels 2 and 3 once
  each an inner Picard iteration; (c) 129^2 in float64 plain against the
  mixed solve, whose float32 V-cycles take kernel 3; (d) 129^2 float32 with
  the coil currents re-fitted to isoflux points every outer iteration and
  the plasma's wall flux in the ring;
* (e) the G-EQDSK reconstruction of the public SPARC L-mode equilibrium in
  ``fuzz/seeds/geqdsk`` on its 129 x 129 grid: kernel 3 once an iteration;
* (f) the Newton-Krylov solve at 129^2 in float64 (plain ops only) against
  the Picard float64 solve;
* (g) the ``adjoint_fd`` campaign at 65^2 in float64: the IFT coil gradient
  (``fixed_point_ift``, 300 forward steps and 300 adjoint iterations of one
  plain V-cycle a step) of ``mean(psi^2)``, checked against central
  differences on the card (gate 3.244e-6), and lane 2, one normalised
  descent step of the axis-flux tracking loss;
* (h) the real-shot reconstruction of the same SPARC file in float64
  (``reconstruction.reconstruct``, subcell 4, Anderson(8), as
  ``validation/run_real_shot_accuracy.py:94-97``) against the same call on
  the CPU, and ``refit_profiles`` with its defaults;
* (i) the small lanes once each in float64 against the same call on the
  CPU: ``refine_x_point`` on the 513^2 FMG result, ``analyze_rigid_body``
  and ``stability_landscape`` in the coil field of the 129^2 free-boundary
  result, ``solve_force_balance`` and its Newton variant, a field-line trace
  with ``safety_factor_from_trace``, ``solve_vmec_lite`` and
  ``solve_force_balance_3d``;
* (j) the GS <-> transport coupling ``run_self_consistent`` on the bench
  machine at 257^2 in float32 (``bench_config.COUPLED``: the default
  transport, 30 MW, dt 0.02 s, 10 steps an outer iteration): kernels 2 and 3
  on its GS solves and the Thomas kernel (``csrc/tridiag.cu``) on every
  Crank-Nicolson solve;
* (k) the TORAX-parity coarse tier (``bench_config.TORAX_COARSE``): 400
  transport steps of 0.5 s at 50 MW in float64, the Thomas kernel alone;
* (l) the small transport lanes once each in float64 against the same call
  on the CPU: adaptive stepping with the committed neural surrogate,
  current diffusion, the impurity ladder, rotation and the L-H transition,
  the reduced closure, the Aurora-parity step, the 0D burn point and the
  blanket;
* (m) the flight simulator's physics-in-the-loop lane ``run_shot_full`` on
  the bench machine at 513^2 in float32 (``bench_config.FLIGHT_FULL``: 30
  control ticks, a full GS solve a tick): kernels 2-5 on every Picard
  iteration of its 31 solves, against the same shot on plain float32 ops,
  and the same lane at 65^2 in float64 against the CPU;
* (n) the SCPN neuro-symbolic closed loop (``bench_config.CLOSED_LOOP``: the
  R/Z controller of ``validation/run_control_latency.py`` against the
  reduced plant, 10,000 ticks) as ONE launch of the port's kernel
  ``csrc/closed_loop.cu``, against its plain per-tick loop, in binary mode,
  in float64 against the CPU, and the sampled-firing configuration, which
  runs the per-tick loop;
* (o) the control lanes in float64 against the CPU: the reduced flight-sim
  shot (one launch of the reduced-shot kernel, ``csrc/reduced_shot.cu``),
  MPC planning and its receding-horizon loop, the integrated shot,
  ``optimize_shot`` and the free-boundary tracking shot;
* (p) the reduced-shot kernel (row R: every tick of a population of reduced
  flight-sim shots in ONE launch) against its batched plain loop, then the
  1000-shot x 10,000-tick stress campaign of
  ``validation/run_stress_campaign.py`` (one launch) and ``tune_pid`` at its
  defaults (128 candidates x 15 generations: one launch a generation);
* (q) the classical and robust controllers in float64 against the CPU, at
  the plants and sizes of the JAX tests: H-inf synthesis with a closed-loop
  rollout, mu-synthesis and its structured D-K iteration, the RWM feedback
  design, the sliding-mode shot, the gain scheduler over the ITER-like
  waveforms, the EKF, the fault-tolerant shot and ``tune_hinf``; and the
  vertical-stability chain on the 513^2 FMG psi (n-index at the magnetic
  axis, the RZIP state space of ``bench_config.RZIP_VESSEL``, its growth
  rate, the LQR gain and the closed-loop eigenvalues);
* (r) the disturbance-rejection ladder of ``validation/run_control_ladder.py``
  (PID, H-inf, MPC and SNN on the linearised vertical plant, VDE / density
  ramp / ELM pacing at dt 1e-4: 360,000 ticks): the PID, H-inf and MPC lanes
  of every scenario in ONE launch of row L (``csrc/ladder.cu``,
  ``ops/cuda_ladder.ladder``: one thread a lane), the SNN lane one launch a
  scenario of row N's linear-plant variant (``closed_loop_linear``); rows L
  and N ``torch.equal`` to their plain loops on VDE at full length in f32,
  the validation's gates in f32, the whole ladder in f64 against the CPU;
* (s) the disruption predictors trained on the card at the validations'
  sizes in f32 (the windowed MLP of ``run_control_ladder.py`` and of
  ``run_disruption_roc.py`` with its 33-threshold sweep; the causal
  transformer d32/h4/ff64/L2 on the 256-shot training family, 600 AdamW
  steps, scored on the 64-shot held-out cohort) with the validations' gates,
  and 100 + 20 training steps in f64 against the CPU;
* (t) the learned controllers in f64 against the CPU at the JAX tests'
  sizes: the surrogate MPC, the shot replay, federated training, safe RL,
  the SOC learner, the spiking push-pull shot, the NEF channel and the
  neural shape loop on the committed equilibrium surrogate;
* (u) the nonlinear 5D flux-tube gyrokinetic run (``run_nonlinear_gk``) at
  the default ``NonlinearGKConfig()`` (2 x 16 x 16 x 32 x 16 x 8 complex64,
  200 steps) and at the 32^3 complex128 spec of
  ``validation/run_sharded_convergence.py:350-354`` (50 steps), each RK4
  stage one launch of row G (``csrc/gk_rhs.cu``, ``ops/cuda_gk.gk_stage``),
  against the same runs with the plain stage on the card; the linear ITG
  lane of ``validation/run_gk_scenario.py:78-90`` with its gate; a
  kinetic-electron, electromagnetic, conservative, zonal-damped Miller
  variant in float64 against the CPU;
* (v) the reduced GK lanes in float64 against the CPU: the linear scan
  (the card's initial-value lane against the CPU's ``eig``), the ITG
  spectrum and rate of ``validation/run_gk_growth_rates.py``, the native
  TGLF profile, the QL closure, the Maxwell evolution and one hybrid
  scheduler-corrector round;
* (w) row N's plant kinds 2 and 3: ``run_fueling_mode`` (3000 ticks) in ONE
  launch of kind 2 and ``run_torax_hybrid_campaign`` (16 episodes x 220
  ticks, one CTA an episode) in ONE launch of kind 3, each against its plain
  loop in float32 and float64, with the JAX tests' gates, and the float64
  lanes against the CPU;
* (x) row D, the digital twin (``run_digital_twin``, 48^2 x 200 steps) in
  ONE launch of ``csrc/digital_twin.cu`` against the loop of ``twin_step``
  in float32 and float64, uncontrolled and driven, with the JAX test's
  gates; ``twin_ingest``'s default SPARC and NSTX-U sessions (plain ops,
  the plan points one batch), ``quantization_report`` and the Director's
  directed mission over the R/Z controller, in float64 against the CPU;
* (y) the realtime bus: its numpy parity oracle against the port's
  ``run_shot_reduced`` (one launch of row R) in float64 at atol 1e-12, and
  one three-process session of 400 ticks with its gates.
* (z) row B, the Newcomb field-line integration of the ideal ballooning
  equation (``csrc/ballooning.cu``, ``ops/cuda_ballooning.newcomb_min_xi``:
  one thread a line, the RK4 loop inside): the second-stability scan of
  ``tests/test_ballooning.py`` (10 x 48 lines, 4000 steps, circular) and the
  DIII-D bootstrap path (65 lines, 2000 steps, Miller) each in ONE launch,
  ``torch.equal`` to the plain RK4 loop in float32 and float64; that test's
  gates on the card; the s-alpha and shaped EPED tiers at the DIII-D
  inputs, float64 against the CPU at 0.5, 1.0 and 1.5 MA;
* (za) the detachment, RMF, PLL and converter loops and ``sensor_vote`` in
  float64 against the CPU, and the three latency lanes of
  ``validation/run_control_latency.py`` through the port's ``control.hil``
  (the fused lane one launch of row N a call);
* (zb) rt-EFIT built on the JAX test's layout at 129^2 and a round trip, in
  float64 against the CPU; the default control-room session in float32
  against the CPU; its kernel-backed psi lane on the 513^2 FMG psi.
* (zc) row Q, the staged disruption (``csrc/disruption.cu``,
  ``ops/cuda_disruption.disruption_sequence``: one thread a sequence, the
  tick loop inside): the default 4000-tick sequence unmitigated (the CLI's
  disruption mode) and with the whole-plant lane's SPI (200 at 0.2 ms) each
  in ONE launch, the mitigation scan of ``test_disruption_edge_events.py``
  in one launch for its three inventories, ``torch.equal`` to the plain tick
  loop in float32 and float64; the Fokker-Planck, fluid-runaway, SPI
  injection and SPI sweep lanes at the JAX tests' sizes; those tests' gates
  and float64 against the CPU;
* (zd) row S, the SOC sandpile (``csrc/sandpile.cu``,
  ``ops/cuda_sandpile.sandpile_run``: one CTA, the drives and sweeps
  inside): ``torch.equal`` to the plain loop at 64 cells x 100 drives in
  float32 and float64; the default (128 x 2000), CLI (64 x 2000) and JAX test
  (24 x 6000) runs each in ONE launch, equal to the CPU twin; the JAX test's
  gates;
* (ze) the MHD modes, the sawtooth cycle, the stability suite (its eigen lane
  in two launches of row B), the ELM cycle and the edge events in float64
  against the CPU, with their JAX tests' gates.
* (zf) row P, the voltage-driven compression, and its adjoint with the
  rigid rotor, tilt and Faraday lanes; (zg) the pulsed carrier and the
  Hall-MHD sandbox (see :func:`compression_checks`, :func:`hall_checks`);
* (zh) row F, the guiding-centre orbit (``csrc/orbits.cu``,
  ``ops/cuda_orbits.gc_ensemble`` and ``gc_orbit``: one thread a particle,
  the RK4 step loop inside): the JAX tests' fast-ion populations (256, 512,
  512 and 2048 alphas x 4000 steps) and the 20,000-step guiding-centre orbit
  each in ONE launch, ``torch.equal`` to the plain twin in float32 and
  float64; ``validation/run_fast_ions.py``'s lanes (384 x 8000 steps at four
  plasma currents through ``follow_ensemble``); ``TestOrbits``' Boris and
  lambda-field lanes on plain ops; the gates, float64 against the CPU;
* (zi) ICRH ray tracing and deposition, ECRH, current drive, the drift-wave
  runs of ``test_drift_wave_esn.py``, ``run_divertor_ballooning.py`` (its
  ballooning lane through row B) and ``run_stellarator_lane.py``, with
  their gates, float64 against the CPU.
* (zj) rows E and H: the 0-D burn relaxation (``csrc/burn.cu``,
  ``ops/cuda_burn.burn_relax``: one thread a design point, the 200
  iterations inside) on ``compact_reactor_search``'s 4096 designs, the JAX
  test's 512 and the ITER-like point, and the HTS quench transient
  (``csrc/quench.cu``, ``ops/cuda_quench.quench_run``: one thread, the 2000
  steps inside) on the default and the degraded screen, each in ONE launch,
  ``torch.equal`` to the plain twin in float32 and float64; the compact
  searches (float32, as JAX casts the scan), the design chain, lanes 2-4 of
  ``run_confinement_burn.py`` and lanes 2, 3 and 5 of
  ``run_whole_plant_fault.py`` with their gates, float64 against the CPU;
* (zk) the blanket and TEMHD (every group and step one launch of the Thomas
  kernel), wall loading, PWI with lanes 6-7 of ``run_physics_closures.py``,
  the heating proxy, MCNP-lite and lane 5 of ``run_mif_frc.py``, and the
  occluded CAD loading of a generated 10,368-face torus, with the JAX tests'
  gates, float64 against the CPU.
* (zl) the whole-device discharge (``models/wdm.run_discharge``: the CLI's
  200 steps in float32 and float64, ``tests/test_wdm.py``'s three, row T on
  every transport step, the collapse time equal to the CPU's), the Monte
  Carlo UQ at 10,000 and 5000 samples, the PCE fits, Sobol indices and LHS,
  lane 4 of ``run_physics_closures.py``, the CLI's 65^2 forward channels,
  tomography (48 chords, RES 16, three methods at 500 iterations), the
  magnetic probes on (b)'s 129^2 free-boundary psi, the quasi-3D chain at
  its defaults (the 48 TEMHD columns one row-T launch a two-fluid step)
  with ``run_quasi3d_contracts.py``'s force-balance lane, with the JAX
  tests' and the validations' gates, float64 against the CPU; the
  ``multi_machine`` campaign's lane 1 five 65^2 solves in float32 (kernels
  2 and 3 once each a Picard iteration, counted) against the CPU's plain
  float32 solves (the campaign runs in (zs));
* (zm) row U, the monitored UPDE run (``csrc/phase.cu``,
  ``ops/cuda_phase.monitor_run`` / ``upde_run``: one CTA, the tick loop,
  the Lyapunov guard and the recorder inside): the monitor at its
  ``from_plasma`` defaults (8 x 50 x 1000), the replay certificate's
  4 x 32 x 500 and ``tests/test_phase.py``'s ``run_upde`` at 3000 steps in
  both psi modes, each ONE launch, ``torch.equal`` to the plain tick loop in
  float32 and float64; the Kuramoto runs and the monitor's gates of the JAX
  tests, float64 against the CPU; lanes 1 and 3 of
  ``run_replay_certificate.py`` (the combined hash equal across two
  in-process runs and in a fresh process; lane 2, JAX's committed hash, is
  not the port's to give).
* (zn) row W, the GENE-like proxy (``csrc/gene_proxy.cu``,
  ``ops/cuda_proxy.gene_proxy``: one thread a sample, 64 a CTA, the
  relaxation loop inside): ``run_speed_benchmark``'s 1024 x 20,000 and the
  JAX test's 64 x 2000 each in ONE launch, ``torch.equal`` to the plain twin
  in float32 and float64; ``run_speed_benchmark`` at its defaults (speedup >
  2, RMSE < 5%) and the GyroSwin fit's gates; the committed FNO (64^2, width
  32, modes 16, 4 layers) on fresh fields with its gate and within 1e-4 of
  the CPU port, the committed transport closure's gate, the committed 129^2
  equilibrium surrogate against a fresh 129^2 float32 free-boundary solve
  (kernels 2 and 3 once each an inner Picard iteration, counted) and lanes
  1-2 of ``validation/run_surrogate_latency.py``; the trainers at their
  defaults into a temporary directory, each artifact loaded back
  (``train_transport_surrogate``, ``train_qlknn``, and in spawned processes
  ``train_fno_turbulence``, ``train_fno_multi_regime`` and
  ``train_equilibrium_artifact``, whose 180 65^2 float32 solves run kernels 2
  and 3 once each an inner Picard iteration, counted); lane 3 of
  ``validation/run_pulsed_suppression.py``, the gain's gradient, the ESN sine
  lane on the JAX test's reservoir draw and the drift-wave oracle, with the
  JAX tests' and validations' gates; the float64 lanes (heat shadow, QLKNN
  features and targets, multi-regime pairs, the suppression loop and its
  gradient, the ESN readout) against the CPU twin.
* (zo) the batched equilibrium ensembles of ``parallel/ensemble.py``: the
  batched kernels 2 and 3 (``cuda_source.fused_topology_source_batched``,
  three launches for a batch, and ``cuda_mg.fused_coarse_vcycle_batched``,
  one launch of B clusters) ``torch.equal`` to their unbatched launches
  element by element at 33^2, 129^2 and 257^2 with B = 1, 16 and 256 and a
  straggler element, and within 1e-5 of their plain twins; the
  ``batched_amortisation`` campaign at 129^2 (the f32 ensembles of B = 1, 16,
  64 and 256 and the mixed ensembles of B = 16 and 64, one call of each
  batched kernel an iteration; lane 3's cold call the first B = 256 call of
  a fresh process) at the validation's gates; the straggler freeze in f32 against
  standalone solves; the 16-batch over ``Mesh((cuda:0,) * 4)``, its chunks
  in lockstep, against the whole batch; the mixed B = 16 batch against its
  CPU twin;
* (zp) the ``sharded_gs`` campaign on ``Mesh((cuda:0,) * n)`` for n = 1, 2,
  4, 8 (virtual shards of the one card: the exchanges' arithmetic and the
  launch structure, not an interconnect), in float64 in a spawned process;
* (zq) the ``sharded_convergence`` campaign on virtual shards of the card,
  in a spawned process with (zr): lanes 1-6 (513^2, 129^2) in float64, no
  kernel, and lane 7 at its full spec (2x32x32x16x16x8 c128, 50 steps, seed
  5) on a (sx, sy, v) = (2, 2, 2) mesh, row G launched on every shard
  (exactly 8 x 4 x 50) and on its monolithic run (4 x 50) (state 1e-12,
  trace 1e-9, memory factor 8.0), after the pencil bracket is held to
  ``exb_bracket``; ``run_gk_scenario.py`` lanes 1 (the 8-shard velocity
  mesh, c64, phi_rms 1e-5) and 3 (the ITER-like shot's gates); the (sy, v)
  = (2, 4) mesh and the (data, v) = (2, 4) ensemble of 4 members in f64
  against their monolithic runs (1e-10, 1e-9); ms a step sharded and
  monolithic in turns;
* (zr) the carried-over host lanes: the ``implementation_parity`` campaign
  (the port's C++ copy built with g++, ``npref`` and the plain f64
  ``sor_step`` on the card; kernel 1 in f32 in one launch) and
  ``error_audit``, a GKState checkpoint written from the card and loaded on
  the CPU, and (zq)'s lanes' report written by the port's ``write_report``
  into a temporary directory, its checksum read back;
* (zs) the CLI and ``ui/``, in a spawned process on the card: the ``kernel``
  mode (``cli.main(["kernel", <513^2 bench configuration>, "--output", ...])``)
  through kernels 2-5 at 513^2, its wrappers' counts equal to a direct
  ``solve_equilibrium`` call's, its npz psi ``torch.equal`` to that call's,
  1e-3 span-rel from the plain float32 solve (counts within one); the live
  server (``LiveSolveWorker`` + ``make_server(port=0)`` over HTTP) for
  three converged ticks and more at its 65^2 default and at 513^2, the
  security headers on every response, the worker stopped and joined; the
  ``live-dashboard`` mode in a child process ended by SIGINT; the
  ``dashboard`` mode in a temporary directory and ``generate_dashboard``'s
  513^2 snapshot; every other mode once (the exit code the JAX CLI's rule
  gives, the JAX mode's JSON keys); ``validate --campaign <name>`` for each
  campaign no earlier phase runs (``equilibrium_parity`` and ``io_roundtrip``
  through kernels 2 and 3, ``multi_machine`` in float64, and the eight older ones,
  ``gk_eigenvalue_perf``'s 0.3 s a k_y gate included) and
  ``stellarator-replay``.

Every one of the port's 20 campaigns runs once: the phases that hold a
campaign's kernel gates call its module (:data:`PHASE_CAMPAIGNS`: (5b)
``resolution_scaling``, with the 4097^2 mixed solve, through kernels 2-7,
and (8b) ``free_boundary_forward`` through kernels 2 and 3; (g)
``adjoint_fd``; (zo) ``batched_amortisation``; (zp) ``sharded_gs``; (zq) ``sharded_convergence``;
(zr) ``implementation_parity`` and ``error_audit``), (zs) the others, and
after (zs) every report's lanes are held to the committed JAX report's
(:func:`campaign_check`: the statuses equal but :data:`VALIDATE_STANDING`'s,
printed with their numbers beside their gates, and the lanes blocked for
want of the reference's data).  The three campaigns whose lanes gate a time
((zo), (5b), (8b)) run after (zs), in the main line, once every spawned
process has ended: the card does nothing else while they time.  The twentieth, ``tracking_acceptance``
((o)'s; 132 closed-loop ticks of seven f64 plant solves each, host-bound
launches: 463-629 s in each of four processes on an H100), is the smoke's
second command, ``python3 chip_smoke.py tracking``: its shots in four
spawned processes, its lanes built by its module, its status the committed
report's, the same result lines.  In line it took the smoke past 1200 s
(1266.5 s on an H100 with the shots in four processes beside the main
line, every host-bound phase slowed by them).

Paths (g)-(i), (o) other than its reduced shot, (q), (s), (t), (v), (x)'s
sessions, report and mission, (za) but its fused lane, (zb), (zc)'s
Fokker-Planck, fluid and SPI lanes, (ze) but its eigen lane, (zg), (zh)'s
Boris and lambda-field lanes, (zi) but its ballooning lane, (zk) but its
blanket, TEMHD, lane-7 and candidate lanes, (zl)'s UQ, diagnostics and
tomography lanes, (zn) but its row-W lanes and its free-boundary solves, and
(zp), (zq)'s lane 3 and (zr)'s error audit run plain PyTorch ops, as the JAX package runs them without its Pallas kernels; the
script checks that no kernel launched on them.  On (l) only the Thomas kernel may
launch, and it must on every lane that solves a tridiagonal system.

Phases:

1. preflight: a CUDA device, torch/CUDA versions, the card's name and power
   limit (``nvidia-smi``);
2. builds the kernels from ``scpn_fusion_tpu_torch/csrc`` with ``nvcc``;
3. holds every kernel against its plain PyTorch version on the card, in
   float32 on numpy-seeded inputs at the paths' shapes (``sor_sweeps`` on
   each of its routes: the paths' levels and counts, a ragged level and the
   sizes where a route stops; the source also at 2049^2, 4097^2 and on the
   rectangular grid, with its cooperative grid beside the resident limit; the tiled
   legs at 1025^2, 2049^2, 4097^2, a ragged 129^2 tiling and 513^2, and
   against the fine legs at 513^2 and 1025^2; the fine legs at 513^2 with
   (1,2) and (3,3) smoothing, at 1025^2, on a rectangular and on a ragged
   level).  ``sor_sweeps``, the one-launch V-cycle, the one-launch source,
   the fine legs and the tiled legs must also equal their predecessors (one
   launch a half-sweep after a copy; one launch per dependent stage; three
   launches; three and five launches; the first design of the tiled
   kernels) bit for bit, and make one ``__global__`` launch a call
   (``sor_sweeps``: 2 n on its staged route D);
4. runs the 513^2 FMG cascade with the kernels (counters reset just before
   and read just after: every wrapper must have been called as often as the
   cascade's Picard iterations say), against the same cascade with the
   staged kernels and with the staged fine legs (both bit-identical), with
   plain ops in float32 and float64, and the direct 513^2 solve;
5. runs the 2049^2 mixed cascade with the kernels (counters likewise), against
   the same cascade with the staged kernels, with the staged fine legs and
   with the first design of the tiled legs (all bit-identical) and with plain
   ops, and counts one 2049^2 V-cycle;
6. runs the ``anderson`` 129^2 solve with the kernels (counters likewise)
   against the same solve with plain ops and through the staged
   ``sor_sweeps`` (bit-identical);
7. runs the rectangular 257 x 129 solve with the kernels (counters likewise:
   11 ``sor_sweeps`` calls a V-cycle, one launch each) against the same solve
   with plain ops and through the staged ``sor_sweeps`` (bit-identical);
8. runs the free-boundary paths (a)-(d) with the kernels (counters reset
   just before each and read just after: kernels 2 and 3 the same number of
   calls, one launch a call; the mixed solve kernel 3 alone) against plain
   float32 (a, b, d: converged, outer counts within one, psi within 1e-3
   span-relative; d: currents finite and within their limits, the isoflux
   miss no worse than the initial currents') or plain float64 (c: the same
   outer count, psi within 1e-5);
9. runs (e) with the kernels against plain float32 (converged, iterations
   within one, psi within 1e-3, one kernel-3 launch an iteration) and (f)
   (converged in at most 8 iterations, psi within 1e-3 of Picard, no
   kernel);
10. runs (g) and then (g)'s 12 finite-difference solves, and (h), each in a
   spawned process beside (i)-(l), and (i) in line
   (counters likewise: no kernel; each path's wall time between CUDA
   events): (g) the gradient within 3.244e-6 of FD and lane 2's loss lower;
   (h) converged, iterations within one of the CPU run, psi and NRMSE within
   1e-9 of it (the reference's NRMSE < 0.05 is printed: it is a gate of its
   own five SPARC EFIT files, and this file does not meet it in the JAX
   package either), the refit's NRMSE finite and no worse than the
   unfitted one; (i) each lane converged (or within its bar) and within
   1e-9 relative of the CPU run;
11. holds the Thomas kernel against its plain row loop on the card at every
   (systems, length) of the transport paths in float32 and float64, with
   systems that trip each guard (zero pivots, an inf, a NaN): bit for bit,
   one launch a call, and a CUDA input that requires a gradient raises;
   runs (j) with the kernels against the same call on plain ops (GS kernels
   off and the plain Thomas loop: the same outer count, psi within 1e-5
   span-relative, the transport state bit for bit, J_phi within 1e-4 in
   the relative L2 norm and 2e-3 of its span at every pixel;
   kernels 2 and 3 once each an inner Picard iteration, one launch a call),
   (k) against the plain Thomas loop on the card (bit for bit over the
   whole run) and the CPU (within 1e-9, the same Picard count at every
   step), printing the tier's final and peak core Ti and its limit-cycle
   flag, and (l) against the CPU (within 1e-9; the adaptive lane with the
   float32 neural surrogate within 1e-5);
12. runs (m): every solve converged, Picard counts equal or within one tick
   by tick, psi within 1e-3 span-relative and the axis traces within 1e-3 m
   of plain float32, kernels 2-5 each called once a Picard iteration over
   the 31 solves (one launch a call); the 65^2 float64 lane within 1e-9 of
   the CPU with equal counts and no kernel; (n): one launch for the shot,
   traces within 1e-5 span-relative of the plain loop, binary firing equal
   on every tick, float64 within 1e-9 of the CPU, the sampled configuration
   on the per-tick loop (no launch, two runs equal, mean firing at a fixed
   state within 3 sigma of p_fire); (o): each lane within 1e-9 of the CPU,
   the reduced shot in one launch of row R, the others with no kernel;
   (p): row R ``torch.equal`` to its batched plain loop on the card (stress
   variant 1000 x 10,000 float32 on the campaign's draws, reduced variant
   128 x 10,000 float32 on the CEM's first generation of gains, both at 64
   shots in float64) and the float64 runs within 1e-9 of the plain loop on
   the CPU; the campaign in one launch with disruption rate 0 (its p50 /
   p95 / p99, CUDA events median of 5, us a shot-tick); ``tune_pid`` at its
   defaults in 15 launches with a cost no worse than the default gains' (x
   1.0001, ``tests/test_tuning.py:50``); ``tune_pid`` 128 x 2 on the JAX
   test's 1 kHz lane equal with the kernel and with the plain loop; (q):
   each controller lane within 1e-9 of the CPU, no kernel, the n-index, the
   growth rate and the closed-loop max Re(lambda) printed; (r): rows L and N
   ``torch.equal`` to their plain loops (L's three VDE lanes in one launch,
   N's SNN lane in one), the f32 ladder in one L and three N launches with
   every lane stable and VDE ISE MPC < PID < H-inf, SNN > MPC, the f64
   ladder within 1e-9 of the plain loops on the CPU (two spawned processes),
   L's and N's times (median of 5) beside their bounds; (s): each
   validation gate (recall 1.0 / FPR 0.0; AUC >= 0.95 dominating chance;
   zero-FP recall >= 0.9; hard AUC in [0.72, 0.98]; FPR <= 0.13 with recall
   >= 0.45), no kernel, the f64 training within 1e-9 of the CPU, ms a
   training step; (t): each lane within 1e-9 of the CPU (the shape loop,
   whose f32 surrogate sums its MLP in cuBLAS's order, within 1e-5), no
   kernel; (u): row G within 1e-6 (complex64) / 1e-12 (complex128) of max
   |k| of its plain version over four chained stages at both configurations
   in both dtypes, one launch a stage; each run's final f and traces within
   1e-4 / 1e-10 of the plain run, 4 row-G launches a step and no other
   kernel; the ITG lane's amplitude ratio > 1 from the validation's own
   draw; the variant within 1e-10 of the CPU; ms a step in turns and peak
   memory; (v): each lane within 1e-9 of the CPU, the initial-value gamma
   within 1e-3 of the CPU's ``eig``, the growth-rate campaign's gates (lane
   1: converged, ion direction, neighbour jumps < 0.08; lane 2: within a
   factor 2.5 of the fixture), the Maxwell evolution accepted, no kernel;
   (w): row N's kinds 2 and 3 ``torch.equal`` to their plain loops in
   float32 and float64 (one launch a shot, one for the whole campaign), the
   gates of ``tests/test_cad_fueling_torax.py:111-139``, the float64 lanes
   within 1e-9 of the CPU; (x): row D ``torch.equal`` to its step loop in
   both dtypes, the gates of ``tests/test_digital_twin.py:68-100``, the
   float64 twin, sessions, report and mission within 1e-9 of the CPU, the
   chaos-free SPARC session passing every plan, device launches a session;
   (y): the bus oracle within 1e-12 of row R's float64 shot, the
   three-process session's gates (``tests/test_realtime_bus.py:85-97``);
   (z): row B ``torch.equal`` to its plain loop on both shapes in both
   dtypes, one launch a call, the gates of ``tests/test_ballooning.py`` in
   65 counted launches, the EPED gates at 1.0 MA, f64 within 1e-9 of the
   CPU; (za): the loops within 1e-9 of the CPU with their JAX tests' gates,
   no kernel; the latency lanes' gates (PID p50 < 2000 us, SCPN tick p50 <
   5000 us, fused mean < 100 us a tick in four row-N launches); (zb):
   rt-EFIT within 1e-9 of the CPU with its gates, the control room within
   1e-5 of the CPU with its summary's gates, the psi lane zero outside the
   normalised psi's unit level and its z trace equal to the default
   session's, no kernel; (zc)-(ze): rows Q and S ``torch.equal`` to their
   plain loops in both dtypes, one launch a sequence call, a scan or a
   sandpile run, row S's runs equal to the CPU twin's integers (the mean
   slope within an ulp), the JAX tests' gates, every float64 lane within
   1e-9 of the CPU (the SPI deposition, a scatter-add of atomics, 1e-12),
   and on (ze) row B's two eigen-lane launches and no other kernel; (zh):
   row F ``torch.equal`` to its plain twin in both dtypes, one launch a call,
   the gates of ``tests/test_fast_ions.py``, ``TestOrbits`` and
   ``validation/run_fast_ions.py``, float64 within 1e-9 of the CPU with the
   counts and flags equal; (zi): the JAX tests' and validations' gates,
   float64 within 1e-9 of the CPU (ECRH's float32 parts 1e-5), row B's 25
   launches on the ballooning lane and no other kernel; (zj): rows E and H
   ``torch.equal`` to their plain twins in both dtypes, one launch a call, a
   design scan, a burn point or a transient, the gates of the JAX tests and
   validations named above, float64 within 1e-9 of the CPU, the float32
   scans within 1e-5 with their feasibility equal but at a limit, the
   verdicts equal; (zk): row T once a blanket group and a TEMHD step, row E
   on lane 7 and the candidate, no other kernel, the gates, float64 within
   1e-9 of the CPU with the CAD shadows equal, the phase's peak memory;
13. times each kernel beside its plain version at a shape its path gives it
   (the tiled legs also beside the fine legs at 513^2 and 2049^2; the
   one-launch kernels, the fine legs and the tiled legs alternately with
   their predecessors, and as 50 calls back to back; ``sor_sweeps`` at each
   route's shape), the cascades and solves with kernels, with their
   predecessors and with plain ops (CUDA
   events, one warm-up, median of 5; 2 for the plain cascades and the
   plain ``anderson`` and rectangular solves), and
   computes each kernel's bound (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s, whichever is larger, at the timed shape); and times paths
   (a), (b), (c), (e) with kernels and with plain ops in turns, (d) with
   kernels, and (f) in turns with the Picard float64 solve (CUDA events, one
   warm-up, median of 2), (c) beside the original reference's 13.0 ms; the
   Thomas kernel at (1, 50) float64 also beside ``torch.linalg.solve`` of the
   dense system, its bound with float64 operations over 34 TFLOP/s, and at
   the other transport shapes beside its plain loop; (m)'s shot (kernels,
   plain, kernels again), (n)'s kernel (median of 5) beside its plain
   loop (once), and row R's stress launch (median of 5) beside its plain
   loop (once, on (p)'s check);

Run from the repository root: ``python3 chip_smoke.py``, then ``python3
chip_smoke.py tracking``.  Any failure raises and exits non-zero.  Right
after the build it starts, each in a spawned
process, the CPU twins of (k), (o), (v), (z)-(zg) and (zo) and the host-bound
card-side runs of (k)'s plain Thomas loop, (o)'s optimiser and tracking shot and
(zf)'s plain references (before (i), (g) with its FD check and (h) with its CPU
twin; after (l), those of (zh)-(zi) and (zh)'s plain twins and lanes, (zp),
(zq)-(zr) and (zs)), so
that they overlap the earlier paths; every process is joined, or ended, on
the way out.  The last line is the JSON result; the line before it is
the card's name and power limit; the one before that lists the kernels, with
``launches`` counted over the 2049^2 mixed cascade for kernels 4-7 (the path
that runs six of the seven), over the rectangular solve for ``sor_sweeps``,
over the 257^2 free-boundary forward for kernels 2 and 3 and over (j) for
the Thomas kernel, over (n) for the closed-loop kernel, over (p)'s
campaign and tuner for row R, over (r)'s f32 ladder for row L, over
(u)'s default run for row G, over (x)'s default float32 shot for row D,
over (z)'s gates for row B, over (zc)'s counted sequences and scans for
row Q, over (zd)'s counted runs for row S, over (zf)'s runs and gradient
lanes for row P and its adjoint, over (zh)'s counted calls for row F,
over (zj)-(zk)'s counted calls for rows E and H, over (zm)'s for row U,
over (zn)'s for row W and over (zo)'s lanes for the batched kernels 2 and 3,
and ``launches_by_path`` holding each kernel's wrapper calls on every path
(zero on (g)-(i), (q), (s), (t), (v) and (x)'s sessions, row R's one on (o)
and (y), row N's three on (r) and one a shot and a campaign on (w));
the Thomas kernel's ``library_ms`` is
``torch.linalg.solve`` of the same system as a dense matrix.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016
SPAN_TOL = 1e-5      # kernel vs plain version, span-relative, float32
SLICE_TOL = 1e-3     # kernel cascade vs plain cascades, span-relative
GS_TOL = 3e-5        # f64 GS-residual gate of the 2049^2 mixed solve
SOR_SWEEPS, SOR_OMEGA = 50, 1.9   # the ``anderson`` path's inner SOR sweeps
MIXED_FB_TOL = 1e-5  # mixed vs plain f64 free boundary (run_free_boundary_forward.py:208)
NEWTON_MAX_ITERS = 8  # Newton's iterations at 129^2 (tests/test_newton.py's bar)
REFERENCE_FB_FP64_MS = 13.0  # the original reference's warm 129^2 FP64 forward on an H100
# repeats of the times phase's paths whose plain side takes a second or more:
# a median of 2, in turns, keeps the smoke inside its time on slower hosts
SLOW_REPS = 2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# (rows, columns, pre, posts) at which the fine legs are checked: the cascades'
# 513^2 (1,2) and (3,3), 1025^2, a rectangular level, a level that is not
# 2^k+1 (a ragged last tile, even sizes), and 513^2 (4,5), whose halo takes
# the wide-pitch instantiation
FINE_SHAPES = ((513, 513, 1, (2, 0)), (513, 513, 3, (3,)), (1025, 1025, 1, (2,)),
               (257, 385, 1, (2,)), (300, 700, 2, (1, 0)), (513, 513, 4, (5,)))
# (rows, columns, sweeps) at which sor_sweeps is checked: the coarsest levels
# of square and rectangular V-cycles, the rectangular V-cycle's 17 x 9 and
# 257 x 129 levels, the anderson path's 129^2 and the default sor method's
# single sweep there, a ragged level, and the sizes where routes A and B stop
# (65^2 and 257^2 at 50 sweeps, 513^2 at 3 and 50)
SOR_SHAPES = ((5, 5, 50), (9, 5, 50), (17, 9, 1), (65, 65, 50), (129, 129, 1), (129, 129, 2),
              (129, 129, 50), (257, 129, 1), (257, 129, 2), (257, 257, 50), (300, 700, 2),
              (513, 513, 3), (513, 513, 50))
# (rows, columns, label) at which the source kernel is also checked, L-mode
SOURCE_SHAPES = ((2049, 2049, "2049^2"), (4097, 4097, "4097^2"), (257, 129, "257x129"))
# (level, pre, posts, t_rows) at which the tiled legs are checked
TILED_SHAPES = ((1025, 1, (2,), None), (2049, 3, (0, 3), None), (4097, 3, (3,), None),
                (129, 3, (0, 3), 24), (513, 1, (2,), None))
KERNELS = ("sor_sweeps", "fused_topology_source", "fine_presmooth_restrict",
           "fine_prolong_smooth", "fused_coarse_vcycle", "tiled_presmooth_restrict",
           "tiled_prolong_smooth", "thomas_solve_batched", "closed_loop", "reduced_shot",
           "ladder", "gk_rhs", "twin_shot", "newcomb_min_xi", "disruption_sequence",
           "sandpile_run", "compression_run", "compression_adjoint", "gc_ensemble", "gc_orbit",
           "burn_relax", "quench_run", "phase_run", "gene_proxy", "fused_topology_source_batched",
           "fused_coarse_vcycle_batched")
SOURCES = {
    "sor_sweeps": ("csrc/sor_band.cu", "scpn_fusion_tpu/ops/pallas_stencil.py:67"),
    "fused_topology_source": ("csrc/source.cu", "scpn_fusion_tpu/ops/pallas_source.py:59"),
    "fine_presmooth_restrict": ("csrc/fine_legs.cu", "scpn_fusion_tpu/ops/pallas_mg.py:272"),
    "fine_prolong_smooth": ("csrc/fine_legs.cu", "scpn_fusion_tpu/ops/pallas_mg.py:299"),
    "fused_coarse_vcycle": ("csrc/vcycle_fused.cu", "scpn_fusion_tpu/ops/pallas_mg.py:52"),
    "tiled_presmooth_restrict": ("csrc/tiled_legs.cu",
                                 "scpn_fusion_tpu/ops/pallas_mg_tiled.py:97"),
    "tiled_prolong_smooth": ("csrc/tiled_legs.cu", "scpn_fusion_tpu/ops/pallas_mg_tiled.py:123"),
    # no Pallas kernel: the JAX solver is two lax.scan passes in one program
    "thomas_solve_batched": ("csrc/tridiag.cu", "scpn_fusion_tpu/ops/tridiag.py:28"),
    # no Pallas kernel: the JAX closed loop is one lax.scan of controller and plant
    "closed_loop": ("csrc/closed_loop.cu", "scpn_fusion_tpu/control/neuro_closed_loop.py:52"),
    # no Pallas kernel: the JAX shot is one lax.scan, vmapped over a population or a campaign
    "reduced_shot": ("csrc/reduced_shot.cu", "scpn_fusion_tpu/control/flight_sim.py:114"),
    # no Pallas kernel: each JAX closed loop of the ladder is one lax.scan
    "ladder": ("csrc/ladder.cu", "scpn_fusion_tpu/control/disturbance_ladder.py:92"),
    # no Pallas kernel: gk_rhs and rk4_step are one jitted XLA program
    "gk_rhs": ("csrc/gk_rhs.cu", "scpn_fusion_tpu/models/gyrokinetics/nonlinear.py:395"),
    # no Pallas kernel: the JAX twin's shot is one lax.scan of twin_step
    "twin_shot": ("csrc/digital_twin.cu", "scpn_fusion_tpu/control/digital_twin.py:120"),
    # no Pallas kernel: the JAX integration is one lax.scan, vmapped over the field lines
    "newcomb_min_xi": ("csrc/ballooning.cu", "scpn_fusion_tpu/models/physics/ballooning.py:39"),
    # no Pallas kernel: the JAX sequence is one lax.scan, vmapped over SPI inventories
    "disruption_sequence": ("csrc/disruption.cu",
                            "scpn_fusion_tpu/models/physics/disruption_sequence.py:93"),
    # no Pallas kernel: the JAX run is one lax.scan of drives, the sweeps an inner scan
    "sandpile_run": ("csrc/sandpile.cu", "scpn_fusion_tpu/models/physics/sandpile.py:64"),
    # no Pallas kernel: the JAX trajectory is one lax.scan, differentiated by jax.grad
    "compression_run": ("csrc/compression.cu",
                        "scpn_fusion_tpu/models/physics/pulsed_compression.py:154"),
    "compression_adjoint": ("csrc/compression.cu",
                            "scpn_fusion_tpu/models/physics/pulsed_compression.py:154"),
    # no Pallas kernel: the JAX population is one vmap of a lax.scan of RK4 steps
    "gc_ensemble": ("csrc/orbits.cu", "scpn_fusion_tpu/models/physics/fast_ions.py:146"),
    # no Pallas kernel: the JAX orbit is one lax.scan of RK4 steps
    "gc_orbit": ("csrc/orbits.cu", "scpn_fusion_tpu/models/physics/orbits.py:90"),
    # no Pallas kernel: the JAX relaxation is one lax.fori_loop, vmapped over designs
    "burn_relax": ("csrc/burn.cu", "scpn_fusion_tpu/models/physics/scaling_burn.py:114"),
    # no Pallas kernel: the JAX transient is one lax.scan
    "quench_run": ("csrc/quench.cu", "scpn_fusion_tpu/models/engineering/hts_quench.py:165"),
    # no Pallas kernel: the JAX run and monitored run are each one lax.scan of upde_tick
    "phase_run": ("csrc/phase.cu", "scpn_fusion_tpu/models/phase/monitor.py:155"),
    # no Pallas kernel: the JAX proxy is one lax.scan of the closure's relaxation
    "gene_proxy": ("csrc/gene_proxy.cu", "scpn_fusion_tpu/models/surrogates/gyro_swin.py:112"),
    # the batched launches of kernels 2 and 3: JAX's vmap over the same pallas_calls
    "fused_topology_source_batched": ("csrc/source.cu", "scpn_fusion_tpu/ops/pallas_source.py:59"),
    "fused_coarse_vcycle_batched": ("csrc/vcycle_fused.cu", "scpn_fusion_tpu/ops/pallas_mg.py:52"),
}


def span_rel(a, b) -> float:
    span = float(b.max() - b.min()) or 1.0
    return float((a - b).abs().max()) / span


def ring_equal(a, b) -> bool:
    import torch
    return all(torch.equal(a[s], b[s]) for s in
               (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_pair(fn_a, fn_b, reps: int = 5) -> tuple[float, float]:
    """Median device times of two functions timed in turns (a, b, a, b, ...)
    after one warm-up each, so that both see the same state of the host."""
    import torch
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    times: tuple[list[float], list[float]] = ([], [])
    for _ in range(reps):
        for fn, out in ((fn_a, times[0]), (fn_b, times[1])):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def back_to_back_ms(fn, calls: int = 50) -> float:
    """Device time a call of ``calls`` calls between one pair of events: what
    a call costs when the host runs ahead of the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


# ── work of each kernel at its timed shape, for the bound ──
#
# Bytes: every input read once and every output written once (float32).
# Operations: float32 flops of the arithmetic, per interior point: 11 a
# red-black update, 9 a defect, 11 a full weighting (per coarse point), 2 a
# prolongation, 28 the source (|grad psi|, profiles, Ip sum and scale).

def sor_work(nz: int, nr: int, sweeps: int) -> tuple[float, float]:
    """psi, src, R in and psi out; 11 flops an interior point a sweep."""
    return 4.0 * (3 * nz * nr + nr), 11.0 * (nz - 2) * (nr - 2) * sweeps


def ptxas_registers(log: str) -> dict[str, str]:
    """``ptxas`` lines of a source's build, by mangled kernel name: registers
    and spills of each instantiation."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            found[name] = (found.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return found


def leg_work(n: int, sweeps: int, leg: str) -> tuple[float, float]:
    nc = (n + 1) // 2
    inner, inner_c = (n - 2) ** 2, (nc - 2) ** 2
    if leg == "sweeps":       # psi, src, R in; psi out
        return 4.0 * (3 * n * n + n), 11.0 * inner * sweeps
    if leg == "down":         # psi, src, R in; psi_s, d_c out
        return (4.0 * (3 * n * n + n + nc * nc),
                11.0 * inner * sweeps + 9.0 * inner + 11.0 * inner_c)
    if leg == "up":           # psi_s, src, e_c, R in; psi out
        return 4.0 * (3 * n * n + n + nc * nc), 2.0 * inner + 11.0 * inner * sweeps
    raise ValueError(leg)


def vcycle_work(n: int, pre: int, post: int, min_grid: int, coarse_sweeps: int):
    """Bytes of the entry level's in/out fields; flops of the whole V-cycle."""
    from scpn_fusion_tpu_torch.ops.cuda_mg import level_plan
    levels = level_plan(n, min_grid)
    flops = 11.0 * (levels[-1] - 2) ** 2 * coarse_sweeps
    for m in levels[:-1]:
        flops += leg_work(m, pre, "down")[1] + leg_work(m, post, "up")[1]
    return 4.0 * (3 * n * n + n), flops


def vcycle_stages(n: int, pre: int, post: int, min_grid: int, coarse_sweeps: int) -> int:
    """Dependent stages of one V-cycle: per upper level the half-sweeps, one
    restriction and one prolongation; the coarsest level's half-sweeps."""
    from scpn_fusion_tpu_torch.ops.cuda_mg import level_plan
    upper = len(level_plan(n, min_grid)) - 1
    return upper * (2 * pre + 2 * post + 2) + 2 * coarse_sweeps


def bound(work: tuple) -> tuple[float, str]:
    """(bytes, flops) at float32's peak, or (bytes, flops, peak flop/s)."""
    nbytes, flops, rate = (*work, F32_FLOP_PER_S)[:3]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ── the eighth slice: the differentiable equilibrium, the real-shot reconstruction
# and the rest of models/equilibrium/ (plain PyTorch ops on the card, as the
# JAX package runs these paths without its kernels) ──

NRMSE_GATE = 0.05        # run_real_shot_accuracy.py:57 (the reference's SPARC EFIT files)
LANE_TOL = 1e-9          # each lane on the card against the same call on the CPU
# (l)'s surrogate lane: its float32 MLP sums in another order on each device;
# the limit the CPU tests hold the port's surrogate run to against JAX's
SURROGATE_TOL = 1e-5
J_POINT_TOL = 2e-3       # (j)'s J_phi at each pixel, over its span (coupled_lane)


def events_ms(run):
    """(result, wall ms) of one call of ``run`` between two CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_rel(a, b) -> float:
    """max |a - b| over max |b| of two tensors (or tuples of them), on the CPU."""
    import torch
    if isinstance(b, (tuple, list)):
        return max(max_rel(x, y) for x, y in zip(a, b))
    a, b = a.detach().cpu().to(torch.complex128 if b.is_complex() else torch.float64), \
        b.detach().cpu().to(torch.complex128 if b.is_complex() else torch.float64)
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())


@contextlib.contextmanager
def cpu_twin(target, *args):
    """Run ``target(conn, *args)``, a module-level function that computes a
    lane's CPU twin (or a host-bound part of a lane on the card, see
    :func:`early_twins`) and sends its results through ``conn``, in a spawned
    process while the body drives the card; yields a function that waits
    for those results.  The process is joined, or ended, on the way out."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=target, args=(send, *args))
    proc.start()
    send.close()

    def result():
        out = recv.recv()
        proc.join(timeout=600)
        require(proc.exitcode == 0, f"a CPU twin's process ended with {proc.exitcode}")
        return out

    try:
        yield result
    finally:
        if proc.is_alive():
            proc.terminate()
        proc.join()


def on_cpu(threads: int = 4):
    """In a twin's process: the repository on the path, ``threads`` CPU threads."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(threads)
    return torch.device("cpu")


RECON_KW = dict(subcell=4, anderson_m=8, max_iter=200)   # run_real_shot_accuracy.py:94-97


def recon_case():
    from scpn_fusion_tpu_torch.io.geqdsk import read_geqdsk
    from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as rc
    return rc.prepare_case(read_geqdsk(ROOT / "fuzz" / "seeds" / "geqdsk"
                                       / "sparc_lmode_hv.geqdsk"))


def recon_on_cpu(conn) -> None:
    """(h)'s CPU twin: the reconstruction and the refit on the CPU."""
    cpu = on_cpu()
    from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as rc
    case = recon_case()
    conn.send((rc.reconstruct(case, device=cpu, **RECON_KW), rc.refit_profiles(case, device=cpu)))
    conn.close()


def adjoint_on_card(conn, card: str) -> None:
    """(g) in a spawned process beside (i)-(l) (host-bound plain f64 ops):
    the ``adjoint_fd`` campaign (the IFT coil gradient of the 65^2 forward
    against central differences at the reference's 3.244e-6, and the descent
    step), its status the committed report's, no kernel on its path; sends
    the port kernel calls by path."""
    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.validation import REPORTS_DIR, run_adjoint_fd

    cb.reset_launch_counts()
    rc, ms = events_ms(lambda: run_adjoint_fd.main(device="cuda"))
    calls = {name: cb.CALLS[name] for name in KERNELS}
    campaign_check("adjoint_fd", rc, card, "(g)")
    lanes = json.loads((REPORTS_DIR / "adjoint_fd.json").read_text())["lanes"]
    print(f"(g) adjoint_fd on the card, 65^2 f64: IFT gradient against central FD max "
          f"relative component deviation {lanes[0]['metrics']['max_rel_component_dev']:.3e} "
          f"(gate {run_adjoint_fd.REF_TOL}), descent {lanes[1]['metrics']}; {ms:.1f} ms "
          f"(CUDA events), port-kernel calls {sum(calls.values())} [{card}]")
    require(sum(calls.values()) == 0, "adjoint lane: a kernel ran on a plain-ops path")
    sys.stdout.flush()
    conn.send({"adjoint_65": calls})
    conn.close()


def equilibrium_campaigns(card: str) -> dict:
    """(5b) and (8b) on the card: the ``resolution_scaling`` campaign
    (anchor_513 through kernels 2-5, capability_1025 through kernels 2-7
    against the f64 NumPy FMG twin on the host, the mixed 2049^2 and 4097^2
    cascades, on_scaling) and the ``free_boundary_forward`` campaign (the
    129^2 forward in f32 through kernels 2 and 3, in f64, mixed through
    kernel 3, the 257^2 forward, cold against warm, its cold call in a fresh
    process and not counted here), each its status the committed report's;
    prints the 4097^2 solve's time, iterations, GS residual and peak memory;
    returns the kernel calls of each, by path."""
    import torch
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.validation import REPORTS_DIR
    from scpn_fusion_tpu_torch.validation import run_free_boundary_forward as fbf
    from scpn_fusion_tpu_torch.validation import run_resolution_scaling as rs

    dev = torch.device("cuda")
    out = {}
    cb.reset_launch_counts()
    rc, ms_rs = events_ms(lambda: rs.main(device=dev))
    calls_rs = {name: cb.CALLS[name] for name in KERNELS}
    campaign_check("resolution_scaling", rc, card, "(5b)")
    rep_rs = json.loads((REPORTS_DIR / "resolution_scaling.json").read_text())
    lanes_rs = {lane["name"]: lane for lane in rep_rs["lanes"]}
    m4097 = lanes_rs["capability_4097_mixed"]["metrics"]
    peaks = rep_rs["extra"]["peak_device_bytes"]
    print(f"(5b) resolution_scaling: {ms_rs / 1e3:.1f} s (CUDA events); kernel calls "
          f"{ {k: v for k, v in calls_rs.items() if v} }; ms a solve "
          + ", ".join(f"{k} {v['metrics']['device_per_solve_ms']}" for k, v in lanes_rs.items()
                      if "device_per_solve_ms" in v["metrics"])
          + f", on_scaling {lanes_rs['on_scaling']['metrics']}; peak device memory above the "
          f"allocated " + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in peaks.items())
          + f"; the 1025^2 NumPy twin {rep_rs['extra']['numpy_twin_1025_ms'] / 1e3:.1f} s "
          f"[{card}]")
    print(f"(5b) capability_4097_mixed: {m4097.get('device_per_solve_ms')} ms a solve (slope of "
          f"k = 1, 2 chained cascades; walls {rep_rs['extra'].get('wall_ms_4097_mixed_k1_k2')} "
          f"ms), fine iterations {m4097.get('fine_iterations')}, f64 GS residual "
          f"{m4097.get('gs_residual_best_f64')!r} (gate {GS_TOL}), peak "
          f"{peaks.get('4097_mixed', 0) / 1e9:.3f} GB [{card}]")
    require(lanes_rs["capability_4097_mixed"]["status"] == "pass"
            and m4097["gs_residual_best_f64"] < GS_TOL,
            "(5b) the 4097^2 mixed solve did not converge under its f64 GS residual gate")
    require(all(calls_rs[name] > 0 for name in KERNELS[1:7])
            and all(calls_rs[name] == 0 for name in KERNELS if name not in KERNELS[1:7]),
            f"(5b) resolution_scaling: kernels 2-7 not all launched, or others: {calls_rs}")
    out["resolution_scaling"] = calls_rs

    cb.reset_launch_counts()
    rc, ms_fbf = events_ms(lambda: fbf.main(device=dev))
    calls_fbf = {name: cb.CALLS[name] for name in KERNELS}
    campaign_check("free_boundary_forward", rc, card, "(8b)")
    for lane in json.loads((REPORTS_DIR / "free_boundary_forward.json").read_text())["lanes"]:
        print(f"(8b) free_boundary_forward / {lane['name']}: {lane['status']} {lane['metrics']} "
              f"(gates {lane['thresholds']}) [{card}]")
    print(f"(8b) free_boundary_forward: {ms_fbf / 1e3:.1f} s (CUDA events); kernel calls "
          f"{ {k: v for k, v in calls_fbf.items() if v} } [{card}]")
    require(calls_fbf["fused_topology_source"] > 0
            and calls_fbf["fused_coarse_vcycle"] > calls_fbf["fused_topology_source"]
            and sum(calls_fbf.values()) == calls_fbf["fused_topology_source"]
            + calls_fbf["fused_coarse_vcycle"],
            f"(8b) free_boundary_forward: expected kernels 2 and 3 only (3 more, the mixed "
            f"lane's): {calls_fbf}")
    out["free_boundary_forward"] = calls_fbf
    return out


def recon_on_card(conn) -> None:
    """(h) on the card in a spawned process beside (i)-(l) (host-bound plain
    f64 ops, ~120 s): the reconstruction and the refit, each
    timed between CUDA events, with the port's kernel calls of each."""
    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.models.equilibrium import reconstruction as rc
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    dev, case, out = torch.device("cuda"), recon_case(), []
    for run in (lambda: rc.reconstruct(case, device=dev, **RECON_KW),
                lambda: rc.refit_profiles(case, device=dev)):
        cb.reset_launch_counts()
        res, ms = events_ms(run)
        out.append((res, ms, {name: cb.CALLS[name] for name in KERNELS}))
    conn.send(out)
    conn.close()


def recon_lane(card: str, by_path: dict, card_twin, cpu_twin) -> None:
    """(h) the real-shot reconstruction of the SPARC L-mode file in
    ``fuzz/seeds/geqdsk``, float64, the validation's settings
    (run_real_shot_accuracy.py:94-97), against the same call on the CPU;
    then ``refit_profiles`` with its defaults, also against the CPU (the card
    runs in :func:`recon_on_card`, the CPU twins in :func:`recon_on_cpu`,
    both spawned processes started before (i))."""
    case = recon_case()
    kw = RECON_KW
    (out, ms, calls), (fit, ms_fit, calls_fit) = card_twin()
    out_cpu, fit_cpu = cpu_twin()
    span = float(case.psi.max() - case.psi.min())
    dev_psi = float(np.max(np.abs(out["psi_fit"] - out_cpu["psi_fit"]))) / span
    print(f"(h) SPARC g-file 129x129 f64 reconstruction (subcell 4, Anderson(8)): "
          f"{out['iterations']} iterations (CPU {out_cpu['iterations']}), final step "
          f"{out['final_step']!r}, NRMSE {out['nrmse_range']!r} (CPU {out_cpu['nrmse_range']!r}; "
          f"the reference's gate < {NRMSE_GATE}: {out['nrmse_range'] < NRMSE_GATE}, a gate of its "
          f"five SPARC EFIT files, which this file's profiles do not reproduce (source best-fit "
          f"scale {case.source_best_fit_scale:.4f}, {case.source_convention})), deep RMS "
          f"{out['deep_rms_rel_span']!r}; psi vs CPU span-rel {dev_psi:.3e}; wall {ms:.3f} ms "
          f"(CUDA events); port-kernel calls {sum(calls.values())} [{card}]")
    require(np.isfinite(out["psi_fit"]).all() and out["psi_fit"].shape == case.psi.shape,
            "SPARC reconstruction: psi is not a finite 129x129 field")
    require(out["final_step"] < 1e-9 * case.span and out["iterations"] < kw["max_iter"],
            "SPARC reconstruction did not converge")
    require(abs(out["iterations"] - out_cpu["iterations"]) <= 1,
            "SPARC reconstruction: iteration count differs from the CPU run by more than 1")
    require(abs(out["nrmse_range"] - out_cpu["nrmse_range"]) <= LANE_TOL * out_cpu["nrmse_range"]
            and dev_psi <= LANE_TOL, "SPARC reconstruction: the card deviates from the CPU run")
    require(sum(calls.values()) == 0, "SPARC reconstruction: a kernel ran on a plain-ops path")
    by_path["recon_sparc"] = calls
    dev_fit = max(float(np.max(np.abs(fit["psi_fit"] - fit_cpu["psi_fit"]))) / span,
                  float(np.max(np.abs(fit["theta"] - fit_cpu["theta"])
                               / np.max(np.abs(fit_cpu["theta"])))),
                  abs(fit["nrmse_range"] - fit_cpu["nrmse_range"]) / fit_cpu["nrmse_range"])
    print(f"(h) refit_profiles (defaults: n_outer 30, 30 V-cycles, the 8 basis responses in one "
          f"vmapped solve): {fit['outer_iterations']} outer iterations (CPU "
          f"{fit_cpu['outer_iterations']}), final shift {fit['final_shift']!r}, fitted NRMSE "
          f"{fit['nrmse_range']!r} against the unfitted {out['nrmse_range']!r}, deep RMS "
          f"{fit['deep_rms_rel_span']!r}; psi, theta and NRMSE vs CPU max relative "
          f"{dev_fit:.3e}; wall {ms_fit:.3f} ms (CUDA events) [{card}]")
    require(np.isfinite(fit["nrmse_range"]) and fit["nrmse_range"] <= out["nrmse_range"],
            "refit_profiles: the fitted NRMSE is not finite or worse than the unfitted one")
    require(fit["outer_iterations"] == fit_cpu["outer_iterations"] and dev_fit <= LANE_TOL,
            "refit_profiles: the card deviates from the CPU run")
    require(sum(calls_fit.values()) == 0, "refit_profiles: a kernel ran on a plain-ops path")


def small_lanes(dev, card: str, counted, by_path: dict, fmg_result, fmg_cfg, fb_result,
                fb_cfg, mu0_green: float) -> None:
    """(i) each small lane once on the card in float64, against the same call
    on the CPU (within 1e-9 relative), each gated on its own convergence."""
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium import (
        amr, fieldline, force_balance, force_balance_3d, rigid_body_stability as rb, vmec_lite,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import CoilSet
    from scpn_fusion_tpu_torch.models.equilibrium.topology import find_magnetic_axis
    from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi

    f64, cpu = torch.float64, torch.device("cpu")
    lanes: list[tuple[str, object, object]] = []   # (name, card result, CPU result)
    lane_calls = {name: 0 for name in KERNELS}

    def both(name, run):
        """``run(device)`` on the card (timed, counted) and on the CPU."""
        (out, ms), calls, _ = counted(lambda: events_ms(lambda: run(dev)))
        require(sum(calls.values()) == 0, f"{name}: a kernel ran on a plain-ops path")
        for k, v in calls.items():
            lane_calls[k] += v
        lanes.append((name, out, run(cpu)))
        return out, ms

    # AMR patch around the X-point of the 513^2 FMG result (f64 copy)
    g513 = Grid.from_config(fmg_cfg, dtype=f64, device=cpu)
    mu0 = float(fmg_cfg.physics.vacuum_permeability)
    psi513 = fmg_result.psi.detach().to(f64)
    src513 = -mu0 * g513.RR.to(dev) * fmg_result.j_phi.detach().to(f64)

    def patch(d):
        return amr.refine_x_point(psi513.to(d), src513.to(d), g513.R.to(d), g513.Z.to(d))

    res_amr, ms = both("refine_x_point", patch)
    print(f"(i) refine_x_point on the 513^2 FMG result: X-point ({float(res_amr.x_point_r)!r}, "
          f"{float(res_amr.x_point_z)!r}), |grad psi| {float(res_amr.grad_psi_at_x)!r} on a "
          f"{res_amr.psi_fine.shape[0]}^2 patch; {ms:.3f} ms [{card}]")
    require(bool(torch.isfinite(res_amr.psi_fine).all()) and float(res_amr.r_fine[0])
            <= float(res_amr.x_point_r) <= float(res_amr.r_fine[-1]),
            "refine_x_point: the patch is not finite or the X-point left it")

    # rigid-body stability in the vacuum field of the 129^2 free-boundary
    # result's coils, at its magnetic axis
    g129 = Grid.from_config(fb_cfg, dtype=f64, device=cpu)
    coils = [torch.tensor([getattr(c, k) for c in fb_cfg.coils], dtype=f64)
             for k in ("r", "z", "turns")]
    i_eff = fb_result.coil_currents.detach().cpu().to(f64) * coils[2]
    iz, ir, _ = find_magnetic_axis(fb_result.psi.detach().cpu())
    r_ax, z_ax = float(g129.R[ir]), float(g129.Z[iz])
    ip_ma = float(fb_cfg.physics.plasma_current_target)

    def rigid(d):
        g = Grid.from_config(fb_cfg, dtype=f64, device=d)
        pv = vacuum_psi(g, coils[0].to(d), coils[1].to(d), i_eff.to(d), mu0_green)
        rep = rb.analyze_rigid_body(pv, g, r_target=r_ax, z_target=z_ax, ip_ma=ip_ma)
        land = rb.stability_landscape(pv, g, r_points=torch.linspace(r_ax - 1, r_ax + 1, 9,
                                                                      dtype=f64),
                                      z_points=torch.linspace(z_ax - 1, z_ax + 1, 7, dtype=f64),
                                      ip_ma=ip_ma)
        return (*rep.forces, rep.stiffness_n_m, rep.eigenvalues, *land)

    out_rb, ms = both("analyze_rigid_body + stability_landscape", rigid)
    print(f"(i) rigid body at the 129^2 free-boundary axis ({r_ax!r}, {z_ax!r}): F_R "
          f"{float(out_rb[0])!r} N, F_Z {float(out_rb[1])!r} N, decay index "
          f"{float(out_rb[5])!r}, K {out_rb[6].tolist()}, eigenvalues {out_rb[7].tolist()}; "
          f"landscape {tuple(out_rb[8].shape)}; {ms:.3f} ms [{card}]")
    require(all(bool(torch.isfinite(t).all()) for t in out_rb),
            "rigid body: forces, stiffness or landscape not finite")

    # radial force balance of the free-boundary coil set, closed form and Newton
    def balance(d):
        cs = CoilSet(r=coils[0].to(d), z=coils[1].to(d), turns=coils[2].to(d),
                     currents=(i_eff * 1e6).to(d))
        sol = force_balance.solve_force_balance(cs, r_target=r_ax, ip_a=ip_ma * 1e6,
                                                control_indices=(2, 5))
        bump = torch.zeros(6, dtype=f64, device=d)
        bump[2] = bump[5] = 1.0

        def force(delta):
            return force_balance.radial_force(cs._replace(currents=cs.currents + bump * delta),
                                              r_ax, ip_ma * 1e6, 2.0)
        x, f, ok = force_balance.solve_force_balance_newton(
            force, torch.tensor(0.0, dtype=f64, device=d))
        return sol.currents, sol.delta_i, sol.initial_force_n, sol.converged, x, ok

    out_fb, ms = both("solve_force_balance(_newton)", balance)
    print(f"(i) force balance at R {r_ax!r}: closed-form dI {float(out_fb[1])!r} (initial "
          f"force {float(out_fb[2])!r} N, converged {bool(out_fb[3])}); Newton dI "
          f"{float(out_fb[4])!r} (converged {bool(out_fb[5])}); {ms:.3f} ms [{card}]")
    require(bool(out_fb[3]) and bool(out_fb[5]), "force balance did not converge")

    # field lines through the 129^2 free-boundary psi
    psi_fb = fb_result.psi.detach().cpu().to(f64)
    fmodel = fieldline.FieldModel(r_1d=tuple(g129.R.tolist()), z_1d=tuple(g129.Z.tolist()),
                                  psi=tuple(psi_fb.reshape(-1).tolist()), f_tor=6.2 * 5.3,
                                  axis_r=r_ax, axis_z=z_ax)
    seeds = [r_ax - 0.1, r_ax - 0.2, r_ax - 0.3]     # inside this machine's small plasma

    def trace(d):
        tr = fieldline.trace_field_lines(fmodel, seeds, [z_ax] * 3, n_turns=10,
                                         steps_per_turn=64, device=d)
        return tr.r, tr.z, fieldline.safety_factor_from_trace(tr, r_ax, z_ax, 64)

    out_tr, ms = both("trace_field_lines + safety_factor_from_trace", trace)
    print(f"(i) field lines: 3 lines x 10 turns x 64 RK4 steps, q {out_tr[2].tolist()}; "
          f"{ms:.3f} ms [{card}]")
    require(bool(torch.isfinite(out_tr[2]).all()) and bool((out_tr[2].abs() > 0).all())
            and float(out_tr[0].min()) >= fb_cfg.dimensions.R_min
            and float(out_tr[0].max()) <= fb_cfg.dimensions.R_max,
            "field lines: q is not finite or a line left the grid")

    # VMEC-lite on tests/test_vmec_lite.py's shaped boundary
    def vmec(d):
        basis = vmec_lite.SpectralBasis(m_pol=3, n_tor=2, n_fp=1)
        r_b, z_b = vmec_lite.tokamak_boundary(6.2, 2.0, 1.7, 0.33, basis, device=d)
        s = torch.linspace(0.0, 1.0, 21, dtype=f64, device=d)
        res = vmec_lite.solve_vmec_lite(basis, r_b, z_b, 1e5 * (1 - s ** 2), 0.9 - 0.5 * s ** 2,
                                        max_iter=3000, tol=1e-3)
        return res.r_mn, res.z_mn, res.b_mn, res.converged, torch.tensor(res.iterations)

    out_vm, ms = both("solve_vmec_lite", vmec)
    print(f"(i) VMEC-lite: converged {bool(out_vm[3])} in {int(out_vm[4])} iterations; "
          f"{ms:.3f} ms [{card}]")
    require(bool(out_vm[3]), "VMEC-lite did not converge")

    # the reduced 3D force balance (tests/test_equilibrium_3d.py's shaped geometry)
    def fb3d(d):
        geom = force_balance_3d.Geometry3D(r_axis=6.2, a_minor=2.0, kappa=1.6,
                                           triangularity=0.3)
        res = force_balance_3d.solve_force_balance_3d(
            geom, force_balance_3d.ForceBalanceConfig(max_iterations=20),
            torch.zeros((geom.n_modes, 4), dtype=f64, device=d))
        return res.amplitudes, res.residual, res.initial_residual, torch.tensor(res.iterations)

    out_3d, ms = both("solve_force_balance_3d", fb3d)
    reduction = float(out_3d[2]) / float(out_3d[1])
    print(f"(i) 3D force balance: residual {float(out_3d[2])!r} -> {float(out_3d[1])!r} "
          f"({reduction:.3f}x) in {int(out_3d[3])} iterations; {ms:.3f} ms [{card}]")
    require(reduction >= 3.5, "3D force balance: residual fell less than 3.5x in 20 iterations "
                              "(tests/test_equilibrium_3d.py's bar)")

    for name, on_card, on_cpu in lanes:
        dev_l = max_rel(on_card, on_cpu)
        print(f"(i) {name}: card vs CPU max relative deviation {dev_l:.3e} (limit {LANE_TOL:.0e})")
        require(dev_l <= LANE_TOL, f"{name}: the card deviates from the CPU run")
    by_path["small_lanes"] = lane_calls


# ── the ninth slice: 1.5D transport and the GS <-> transport coupling ──

# (systems, length) of the Thomas solves on the transport paths: a thermal
# channel or a current-diffusion / rotation step (1, 50), the three species
# (3, 50), the impurity charge states in radius (11, 50) and the impurity
# ladder in charge at each radius (50, 11), the blanket (1, 100)
THOMAS_SHAPES = ((1, 50), (3, 50), (11, 50), (50, 11), (1, 100))
F64_FLOP_PER_S = 34e12      # H100 SXM float64 outside the tensor cores (NVIDIA's data sheet)


def thomas_systems(rng, n_sys: int, n: int, dtype, dev, guards: bool = False):
    """Seeded (a, b, c, d) of ``n_sys`` systems of length ``n``; with
    ``guards`` the first four systems trip the solver's guards: a zero first
    pivot, a zero second pivot, an inf in d, a NaN in a."""
    import torch
    a, c = rng.standard_normal((n_sys, n - 1)), rng.standard_normal((n_sys, n - 1))
    b, d = rng.standard_normal((n_sys, n)) + 4.0, rng.standard_normal((n_sys, n))
    if guards:
        b[0, 0] = 0.0
        c[1, 0] = 0.0
        b[1, 1] = 0.0
        d[2, n // 2] = np.inf
        a[3, n // 3] = np.nan
    return [torch.tensor(x, dtype=dtype, device=dev) for x in (a, b, c, d)]


def thomas_work(n_sys: int, n: int, itemsize: int) -> tuple[float, float]:
    """a, b, c, d in and x out; per row 2 products, 2 differences, 2
    divisions forward and a product and a difference back."""
    return float(itemsize * n_sys * (2 * (n - 1) + 3 * n)), 8.0 * n_sys * (n - 1)


def thomas_checks(dev, rng, results: dict, timing: dict, library: dict,
                  extra_times: list) -> None:
    """The Thomas kernel against its plain version on the card at every
    (systems, length) of the transport paths, in float32 and float64, the
    guard cases included: bit for bit, one ``__global__`` launch a call; a
    CUDA input that requires a gradient raises."""
    import torch
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_tridiag, tridiag

    results.setdefault("thomas_solve_batched", {"max_abs_err": 0.0})
    for dtype in (torch.float32, torch.float64):
        for n_sys, n in THOMAS_SHAPES + ((4, 50), (4, 11)):
            guards = n_sys == 4
            sys_ = thomas_systems(rng, n_sys, n, dtype, dev, guards)
            before = cb.kernel_launches()
            x_k = cuda_tridiag.thomas_solve_batched(*sys_)
            launched = cb.kernel_launches() - before
            x_p = tridiag.thomas_solve_batched_plain(*sys_)
            torch.cuda.synchronize()
            err = float((x_k - x_p).abs().max())
            label = f"({n_sys}, {n}) {str(dtype)[6:]}{' with the guard cases' if guards else ''}"
            print(f"check thomas_solve_batched {label}: equal to plain {torch.equal(x_k, x_p)}, "
                  f"max abs err {err!r}, finite {bool(torch.isfinite(x_k).all())}, __global__ "
                  f"launches {launched}")
            require(torch.equal(x_k, x_p), f"thomas_solve_batched {label}: not equal to plain")
            require(bool(torch.isfinite(x_k).all()), f"thomas_solve_batched {label}: not finite")
            require(launched == 1, f"thomas_solve_batched {label}: {launched} launches, not 1")
            results["thomas_solve_batched"]["max_abs_err"] = max(
                results["thomas_solve_batched"]["max_abs_err"], err)
    sys_ = thomas_systems(rng, 1, 50, torch.float64, dev)
    sys_[1].requires_grad_(True)
    try:
        cuda_tridiag.thomas_solve_batched(*sys_)
    except RuntimeError as exc:
        print(f"check thomas_solve_batched with a gradient: raises ({exc})")
    else:
        raise AssertionError("thomas_solve_batched took an input that requires a gradient")
    # timed at the thermal channels' (1, 50) float64 of the TORAX tier; the
    # library time is torch.linalg.solve of the same system as a dense matrix
    a, b, c, d = thomas_systems(rng, 1, 50, torch.float64, dev)
    dense = torch.diag_embed(b) + torch.diag_embed(a, -1) + torch.diag_embed(c, 1)
    timing["thomas_solve_batched"] = (
        lambda: cuda_tridiag.thomas_solve_batched(a, b, c, d),
        lambda: tridiag.thomas_solve_batched_plain(a, b, c, d), "(1, 50) f64",
        (*thomas_work(1, 50, 8), F64_FLOP_PER_S))
    library["thomas_solve_batched"] = lambda: torch.linalg.solve(dense, d[..., None])
    for n_sys, n in THOMAS_SHAPES[1:]:
        sys_ = thomas_systems(rng, n_sys, n, torch.float64, dev)
        extra_times.append((
            f"thomas_solve_batched ({n_sys}, {n}) f64",
            ("kernel", lambda s=sys_: cuda_tridiag.thomas_solve_batched(*s)),
            ("plain", lambda s=sys_: tridiag.thomas_solve_batched_plain(*s)),
            (*thomas_work(n_sys, n, 8), F64_FLOP_PER_S)))


@contextlib.contextmanager
def plain_thomas():
    """Run the transport's Thomas solves on the card through the plain row
    loop (``ops/tridiag.py`` looks the CUDA wrapper up in its module)."""
    from scpn_fusion_tpu_torch.ops import cuda_tridiag, tridiag
    saved = cuda_tridiag.thomas_solve_batched
    cuda_tridiag.thomas_solve_batched = tridiag.thomas_solve_batched_plain
    try:
        yield
    finally:
        cuda_tridiag.thomas_solve_batched = saved


def state_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def coupled_lane(dev, card: str, counted, by_path: dict) -> dict:
    """(j) ``run_self_consistent`` on the bench machine at 257^2 in float32
    with the kernels (``bench_config.COUPLED``), against the same call with
    plain ops (GS kernels off, the plain Thomas loop): the same outer count,
    psi within 1e-5 span-relative, the transport state bit for bit, J_phi
    within 1e-4 in the relative L2 norm and within 2e-3 of its span at every
    pixel (where psi_norm is ~1e-5, rho = sqrt(psi_norm) multiplies psi's
    float32 rounding by ~1/(2 rho) ~ 140, so a few pixels near the axis
    exceed 1e-4 of the span while psi itself stays within 1e-5; the sound
    reading was 5.3e-4 on 15 pixels, and a fault of the axis search moves
    J_phi near the axis by far more).  Kernels 2 and 3 once each an
    inner Picard iteration of the GS solves, the Thomas kernel on every CN
    solve, one launch a call."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import COUPLED, bench_config
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
    from scpn_fusion_tpu_torch.models.transport.coupling import run_self_consistent
    from scpn_fusion_tpu_torch.models.transport.solver import TransportParams, initial_state

    f32 = torch.float32
    kw = {k: v for k, v in COUPLED.items() if k != "n"}
    tp = TransportParams()

    def run(use_pallas):
        cfg = bench_config(COUPLED["n"], use_pallas=use_pallas)
        grid = Grid.from_config(cfg, dtype=f32, device=dev)
        bc = vacuum_psi_from_config(grid, cfg).to(f32)
        return run_self_consistent(cfg, grid, tp, initial_state(tp, f32, dev), bc, bc, **kw)

    (res_k, ms_k), calls, launched = counted(lambda: events_ms(lambda: run(True)))
    with plain_thomas():
        res_p, ms_p = events_ms(lambda: run(False))
    dev_psi = span_rel(res_k.psi, res_p.psi)
    dev_j = float(torch.linalg.vector_norm(res_k.j_phi - res_p.j_phi)
                  / torch.linalg.vector_norm(res_p.j_phi))
    j_diff = (res_k.j_phi - res_p.j_phi).abs()
    j_span = float(res_p.j_phi.max() - res_p.j_phi.min())
    dev_j_point = float(j_diff.max()) / j_span
    same_state = state_equal(res_k.transport, res_p.transport)
    print(f"(j) coupled GS <-> transport {COUPLED['n']}^2 f32 ({kw}): kernels {res_k.outer_iterations} "
          f"outer iterations, converged {res_k.converged}, psi residual "
          f"{float(res_k.psi_residual)!r}, core Ti {float(res_k.t_core)!r} keV, tau_E "
          f"{float(res_k.tau_e)!r} s, {ms_k:.3f} ms; plain {res_p.outer_iterations} outer, "
          f"{ms_p:.3f} ms; psi span-rel {dev_psi:.3e} (limit {SPAN_TOL:.0e}), J_phi relative L2 "
          f"{dev_j:.3e} (limit 1e-4), pointwise span-rel {dev_j_point:.3e} (limit {J_POINT_TOL:.0e}; "
          f"{int((j_diff > 1e-4 * j_span).sum())} of {j_diff.numel()} pixels above 1e-4 of the "
          f"span), transport state equal {same_state}; wrapper calls {calls}, "
          f"__global__ launches {launched} [{card}]")
    require(res_k.outer_iterations == res_p.outer_iterations,
            "(j): outer iteration counts differ between kernels and plain ops")
    require(bool(torch.isfinite(res_k.psi).all()) and dev_psi <= SPAN_TOL,
            "(j): psi deviates from plain ops")
    require(same_state, "(j): the transport state is not bit-identical to plain ops")
    require(dev_j <= 1e-4 and dev_j_point <= J_POINT_TOL, "(j): J_phi deviates from plain ops")
    n_src, n_thomas = calls["fused_topology_source"], calls["thomas_solve_batched"]
    require(n_src == calls["fused_coarse_vcycle"] > 0 and n_thomas > 0,
            f"(j): calls {calls}: kernels 2 and 3 not equal and > 0, or no Thomas kernel")
    require(all(v == 0 for k, v in calls.items() if k not in (
        "fused_topology_source", "fused_coarse_vcycle", "thomas_solve_batched")),
        f"(j): other kernels called: {calls}")
    require(launched == {"scpn_fused_source": n_src, "scpn_fused_vcycle": n_src,
                         "scpn_thomas_f32": n_thomas},
            f"(j): launches {launched}, not one a call")
    by_path["coupled_257"] = calls
    return calls


def torax_run(d):
    """(k)'s run: ``TransportParams()`` in float64 through ``TORAX_COARSE``."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import TORAX_COARSE
    from scpn_fusion_tpu_torch.models.transport.solver import (
        TransportParams, initial_state, run_transport,
    )
    kw = TORAX_COARSE
    tp = TransportParams()
    return run_transport(initial_state(tp, torch.float64, d), kw["dt"], kw["p_aux_mw"], tp,
                         kw["n_steps"])


def torax_on_cpu(conn) -> None:
    """(k)'s CPU twin: the final state and the trace as numpy, and the wall ms."""
    cpu = on_cpu(2)
    t0 = time.perf_counter()
    fin, tr = torax_run(cpu)
    ms = (time.perf_counter() - t0) * 1e3
    conn.send(({k: v.numpy() for k, v in fin._asdict().items()},
               {k: v.numpy() for k, v in tr.items()}, ms))
    conn.close()


def torax_plain_on_card(conn) -> None:
    """(k)'s run through the plain Thomas loop on the card, in a process of
    its own (a host-bound loop of ~80-100 s that overlaps the earlier
    paths): the final state and the trace as numpy, and its ms."""
    import torch
    sys.path.insert(0, str(ROOT))
    with plain_thomas():
        (fin, tr), ms = events_ms(lambda: torax_run(torch.device("cuda")))
    conn.send(({k: v.cpu().numpy() for k, v in fin._asdict().items()},
               {k: v.cpu().numpy() for k, v in tr.items()}, ms))
    conn.close()


def torax_lane(dev, card: str, counted, by_path: dict, plain_card, cpu) -> None:
    """(k) the TORAX-parity coarse tier (``bench_config.TORAX_COARSE``):
    ``run_transport`` of ``TransportParams()`` in float64 for 400 steps of
    0.5 s at 50 MW, against the same run through the plain Thomas loop on
    the card (bit for bit over the whole run; ``plain_card`` waits for
    :func:`torax_plain_on_card`) and on the CPU (within 1e-9 span-relative,
    the same Picard count at every step; ``cpu`` waits for
    :func:`torax_on_cpu`), both in processes of their own started early."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import TORAX_COARSE, limit_cycle
    from scpn_fusion_tpu_torch.models.transport.solver import TransportParams

    tp = TransportParams()
    kw = dict(TORAX_COARSE)
    n_steps = kw.pop("n_steps")
    ((fin_k, tr_k), ms_k), calls, launched = counted(lambda: events_ms(lambda: torax_run(dev)))
    fin_np, tr_np, ms_p = plain_card()
    fin_p = type(fin_k)(**{k: torch.from_numpy(v) for k, v in fin_np.items()})
    tr_p = {k: torch.from_numpy(v) for k, v in tr_np.items()}
    fin_np, tr_np, ms_c = cpu()
    fin_c = type(fin_k)(**{k: torch.from_numpy(v) for k, v in fin_np.items()})
    tr_c = {k: torch.from_numpy(v) for k, v in tr_np.items()}
    ti = tr_k["ti0"].cpu().numpy()
    picard = tr_k["picard"]
    same = (state_equal([t.cpu() for t in fin_k], fin_p)
            and all(torch.equal(tr_k[k].cpu(), tr_p[k]) for k in tr_k))
    dev_cpu = max(max(span_rel(getattr(fin_k, k).cpu(), getattr(fin_c, k)) for k in
                      ("ti", "te", "ne", "n_d", "n_t", "n_he", "chi_i", "chi_e", "d_n")),
                  max(span_rel(tr_k[k].cpu(), tr_c[k]) for k in ("ti0", "te0", "ne0", "n_he0")))
    same_picard = torch.equal(picard, tr_c["picard"])
    print(f"(k) TORAX coarse tier (TransportParams() f64, dt {kw['dt']} s, {kw['p_aux_mw']} MW, "
          f"{n_steps} steps): final core Ti {float(ti[-1])!r} keV, peak {float(ti.max())!r} keV, "
          f"limit cycle {limit_cycle(ti)}; Picard iterations {int(picard.sum())} "
          f"({int((picard == 1).sum())} steps at 1, {int((picard == tp.picard_max_iter).sum())} "
          f"at the cap of {tp.picard_max_iter}); card {ms_k:.3f} ms with the kernel, {ms_p:.3f} ms "
          f"through the plain Thomas loop (in its own process), bit-identical over the whole run "
          f"{same}; CPU "
          f"{ms_c:.1f} ms, span-rel {dev_cpu:.3e} (limit {LANE_TOL:.0e}), same Picard count at "
          f"every step {same_picard}; wrapper calls {calls}, __global__ launches {launched} "
          f"[{card}]")
    require(bool(np.isfinite(ti).all()) and bool(torch.isfinite(fin_k.te).all()),
            "(k): the run is not finite")
    require(same, "(k): the kernel run is not bit-identical to the plain Thomas loop")
    require(dev_cpu <= LANE_TOL and same_picard, "(k): the card deviates from the CPU run")
    n_thomas = calls["thomas_solve_batched"]
    require(n_thomas > 0 and sum(calls.values()) == n_thomas
            and launched == {"scpn_thomas_f64": n_thomas},
            f"(k): calls {calls}, launches {launched}: expected the Thomas kernel alone")
    by_path["torax_coarse"] = calls


def transport_lanes(dev, card: str, counted, by_path: dict) -> None:
    """(l) the small transport lanes once each in float64 against the same
    call on the CPU (within 1e-9 relative): adaptive stepping with the
    analytic closure, current diffusion, the impurity ladder, rotation and
    the L-H transition, the reduced closure, the Aurora-parity step, the 0D
    burn point and the blanket.  Adaptive stepping with the neural surrogate
    is held within ``SURROGATE_TOL``: its float32 MLP sums in cuBLAS's order
    on the card and in another on the CPU.  The Thomas kernel launches on
    every lane that solves a tridiagonal system, row E once on the burn
    point's relaxation, and no other kernel does."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import aurora_case_arrays, lane_profiles
    from scpn_fusion_tpu_torch.models.physics import scaling_burn as sb
    from scpn_fusion_tpu_torch.models.surrogates.pretrained import load_transport_surrogate_pytree
    from scpn_fusion_tpu_torch.models.transport import (
        adaptive, aurora_parity as au, current_diffusion as cd, impurity as im,
        momentum_lh as ml, reduced_closure as rc, solver,
    )

    f64, cpu = torch.float64, torch.device("cpu")
    prof = lane_profiles(50)
    arrays = aurora_case_arrays()
    case = au.AuroraParityCase(**arrays["fields"])
    lanes: list[tuple[str, object, object, float]] = []
    lane_calls = {name: 0 for name in KERNELS}

    def t(name, d):
        return torch.tensor(prof[name], dtype=f64, device=d)

    def both(name, run, solves: bool, tol: float = LANE_TOL, burns: int = 0):
        (out, ms), calls, _ = counted(lambda: events_ms(lambda: run(dev)))
        n_thomas = calls["thomas_solve_batched"]
        require(sum(calls.values()) == n_thomas + burns and calls["burn_relax"] == burns
                and (n_thomas > 0) == solves, f"{name}: wrapper calls {calls}")
        for k, v in calls.items():
            lane_calls[k] += v
        lanes.append((name, out, run(cpu), tol))
        print(f"(l) {name}: {ms:.3f} ms, Thomas kernel calls {n_thomas} [{card}]")
        return out

    tp = solver.TransportParams()

    def adaptive_run(d, with_surrogate):
        sur = load_transport_surrogate_pytree(device=d)[0] if with_surrogate else None
        fin, tr = adaptive.run_transport_adaptive(solver.initial_state(tp, f64, d), 50.0, tp,
                                                  n_steps=50, surrogate=sur)
        return fin.ti, fin.te, fin.chi_i, tr.dt, tr.error, tr.ti0

    for with_surrogate in (False, True):
        out = both(f"run_transport_adaptive with the "
                   f"{'neural surrogate' if with_surrogate else 'analytic closure'} (50 steps)",
                   lambda d: adaptive_run(d, with_surrogate), True,
                   SURROGATE_TOL if with_surrogate else LANE_TOL)
        print(f"(l)   dt from {float(out[3][0])!r} to {float(out[3][-1])!r} s, core Ti "
              f"{float(out[5][-1])!r} keV")
    s0 = solver.initial_state(tp, f64, cpu)
    x = solver._local_surrogate_inputs(tp, s0, tp.rho(f64, cpu))
    y_card, y_cpu = (load_transport_surrogate_pytree(device=d)[0].fluxes_gb(x.to(d))
                     for d in (dev, cpu))
    print(f"(l)   surrogate fluxes on the initial state's {x.shape[0]} points, card vs CPU: max "
          f"relative deviation {max_rel(y_card, y_cpu):.3e}")

    def current(d):
        p = cd.CurrentDiffusionParams(nr=50, r0=6.2, a=2.0, b0=5.3)
        psi, tr = cd.run_current_diffusion(p, cd.initial_psi(p, device=d), 0.01, t("te_kev", d),
                                           t("ne_19", d), 1.7, t("j_source", d), n_steps=100)
        return psi, tr["q0"], tr["q_edge"]

    both("run_current_diffusion (nr 50, 100 steps)", current, True)

    def impurity(d):
        n0 = torch.zeros((11, 50), dtype=f64, device=d)
        n0[0] = 0.1
        st, tr = im.run_impurity(im.ImpuritySpecies(z_max=10), im.ImpurityState(n0),
                                 t("te_kev", d) * 300.0 + 5.0, t("ne_19", d), t("d_imp", d),
                                 t("rho", d), 1e-4, n_steps=50, edge_source_1e19=0.05)
        return st.n_z, tr["p_rad_total"], tr["n_total"]

    both("run_impurity (z_max 10, nr 50, 50 steps)", impurity, True)

    def rotation(d):
        par = ml.MomentumParams(*(torch.tensor(v, dtype=f64, device=d) for v in (6.2, 2.0, 0.7, 0.0)))
        rho = t("rho", d)
        tq = ml.nbi_torque_density(rho, 33.0, 5.3, 6.2)
        tr = ml.evolve_rotation(torch.zeros(50, dtype=f64, device=d), t("chi_i", d), tq,
                                10.0 * (1.0 - 0.8 * rho**2), rho, 1e-3, 200, par)
        mode, rows = torch.tensor(False, device=d), []
        for p_net in (10.0, 120.0, 90.0, 60.0):
            st = ml.lh_transition_step(p_net, 1.0, 5.3, 6.2, 2.0, 1.7, mode)
            mode = st.h_mode
            rows.append(torch.stack([st.h_mode.to(f64), st.p_threshold_mw, st.margin]))
        return tr.omega, tr.v_tor_core_m_s, torch.stack(rows)

    both("evolve_rotation (200 steps) + lh_transition_step", rotation, True)

    def closure(d):
        out = rc.evaluate_closure_profile(t("rho", d), t("te_kev", d), t("ti_kev", d),
                                          t("ne_19", d), t("q", d), t("s_hat", d))
        return out.chi_i, out.chi_e, out.d_e, out.channel.to(f64)

    both("evaluate_closure_profile (nr 50)", closure, False)

    def aurora(d):
        dens = torch.tensor(arrays["density"], dtype=f64, device=d)
        step = au.advance_transport_and_cr(case, dens, 2, 1e-4)
        clo = au.derive_effective_source_closure(case, arrays["reference"], device=d)
        audit = au.radial_transport_budget_diagnostic(case, arrays["density"], 1e-4, device=d)
        require(audit["passed"], "(l) Aurora: the inventory audit failed")
        return step, clo

    both("Aurora-parity step, closure and audit (neon, nr 24)", aurora, False)

    def burn(d):
        pt = sb.burn_equilibrium_0d(ne19=10.0, p_aux_mw=50.0, ip_ma=15.0, bt_t=5.3, r_m=6.2,
                                    a_m=2.0, kappa=1.7, device=d)
        return tuple(x.to(f64) for x in pt)

    out = both("burn_equilibrium_0d (200 iterations; one launch of row E)", burn, False,
               burns=1)
    print(f"(l)   Q {float(out[0])!r}, P_fus {float(out[1])!r} MW, converged {bool(out[5])}")

    def blanket(d):
        res = sb.blanket_tbr(thickness_cm=80.0, li6_enrichment=0.9, device=d)
        return res.flux, res.tbr

    out = both("blanket_tbr (80 cm, 90% Li-6)", blanket, True)
    print(f"(l)   TBR {float(out[1])!r}")

    for name, on_card, on_cpu, tol in lanes:
        dev_l = max_rel(on_card, on_cpu)
        print(f"(l) {name}: card vs CPU max relative deviation {dev_l:.3e} (limit {tol:.0e})")
        require(dev_l <= tol, f"{name}: the card deviates from the CPU run")
    by_path["transport_lanes"] = lane_calls


# ── the tenth slice: the control layer (the flight simulator's full lane, the
# SCPN closed loop as one kernel launch, the plain-op control lanes) ──

AXIS_TOL_M = 1e-3        # (m) r_axis / z_axis traces, kernels vs plain float32 [m]
REFERENCE_CLOSED_LOOP_MS = (0.012, 0.047)   # BASELINE.md:45: PID, surrogate / full plant, P95


@contextlib.contextmanager
def recorded_solves(log: list):
    """Append (Picard iterations, converged, update-norm history) of every
    GS solve the flight simulator makes to ``log`` (it looks its solver up
    in its own module)."""
    from scpn_fusion_tpu_torch.control import flight_sim
    solve = flight_sim.solve_fixed_boundary_impl

    def recorded(*args, **kw):
        eq = solve(*args, **kw)
        log.append((eq.iterations, eq.converged,
                    eq.residual_history[:eq.iterations].tolist()))
        return eq

    flight_sim.solve_fixed_boundary_impl = recorded
    try:
        yield log
    finally:
        flight_sim.solve_fixed_boundary_impl = solve


def flight_full_lane(dev, card: str, counted, by_path: dict) -> None:
    """(m) ``run_shot_full`` on the bench machine at 513^2 in float32
    (``bench_config.FLIGHT_FULL``: 30 ticks, 31 GS solves) with kernels 2-5,
    against the same shot on plain float32 ops: every solve converged, the
    Picard counts of the 30 tick solves equal or within one (float32 sum
    order), the initial cold-start solve's within two (its update histories
    are printed: Anderson mixing carries the float32 rounding differences of
    the first iterations to a few percent of the update, and the update
    crosses the 1e-4 tolerance within ten percent of it, 1.08e-4 with the
    kernels against 0.92e-4 plain at the tenth iteration; plain float32 and
    float64 differ by one there on the CPU), psi within 1e-3 of its span,
    the axis traces within 1e-3 m, and each of kernels 2-5 called once a
    Picard iteration over the 31 solves, one launch a call.  Then the same
    lane at 65^2 for 5 ticks in float64, on the card (plain ops) against
    the CPU within 1e-9."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import FLIGHT_FULL, bench_config
    from scpn_fusion_tpu_torch.control.flight_sim import run_shot_full

    f32, f64 = torch.float32, torch.float64
    kw = {k: v for k, v in FLIGHT_FULL.items() if k != "n"}

    def shot(use_pallas, log, n=FLIGHT_FULL["n"], dtype=f32, device=dev, **extra):
        with recorded_solves(log):
            return run_shot_full(bench_config(n, use_pallas=use_pallas), dtype=dtype,
                                 device=device, **kw, **extra)

    log_k, log_p, log_k2 = [], [], []
    ((psi_k, _, tr_k), ms_k), calls, launched = counted(
        lambda: events_ms(lambda: shot(True, log_k)))
    (psi_p, _, tr_p), ms_p = events_ms(lambda: shot(False, log_p))
    _, ms_k2 = events_ms(lambda: shot(True, log_k2))
    it_k, it_p = [i for i, *_ in log_k], [i for i, *_ in log_p]
    n_ticks = tr_k.t_s.shape[0]
    differ = [(k, a, b) for k, (a, b) in enumerate(zip(it_k, it_p)) if a != b]
    dev_psi = span_rel(psi_k, psi_p)
    dev_r = float((tr_k.r_axis - tr_p.r_axis).abs().max())
    dev_z = float((tr_k.z_axis - tr_p.z_axis).abs().max())
    picard = sum(it_k)
    print(f"(m) flight simulator full lane {FLIGHT_FULL['n']}^2 f32 ({n_ticks} ticks, "
          f"{len(log_k)} solves, {kw}): Picard iterations with kernels {it_k} (sum {picard}), "
          f"plain {it_p} (sum {sum(it_p)}); solves that differ (solve, kernels, plain) {differ}; "
          f"psi span-rel {dev_psi:.3e} (limit {SLICE_TOL:.0e}), r_axis {dev_r:.3e} m, z_axis "
          f"{dev_z:.3e} m (limit {AXIS_TOL_M:.0e}); final r_axis {float(tr_k.r_axis[-1])!r} m; "
          f"wrapper calls {calls}, __global__ launches {launched} [{card}]")
    print(f"time (m) flight simulator full lane {FLIGHT_FULL['n']}^2 f32: kernels {ms_k:.3f} ms "
          f"a shot ({1e3 * ms_k / n_ticks:.1f} us a tick), plain {ms_p:.3f} ms "
          f"({1e3 * ms_p / n_ticks:.1f} us a tick), kernels again {ms_k2:.3f} ms (in turns: "
          f"kernels, plain, kernels; CUDA events) [{card}]")
    print(f"(m) the initial solve's update histories: kernels "
          f"{['%.4g' % v for v in log_k[0][2]]}, plain {['%.4g' % v for v in log_p[0][2]]}")
    require(len(log_k) == len(log_p) == n_ticks + 1, "(m): not one solve a tick and one before")
    require(all(c for _, c, _ in log_k + log_p), "(m): a solve did not converge")
    require(abs(it_k[0] - it_p[0]) <= 2 and all(abs(a - b) <= 1 for a, b in zip(it_k[1:], it_p[1:])),
            "(m): Picard counts differ by more than one on a tick (two on the initial solve)")
    require(bool(torch.isfinite(psi_k).all()) and dev_psi <= SLICE_TOL,
            "(m): psi deviates from plain float32")
    require(dev_r <= AXIS_TOL_M and dev_z <= AXIS_TOL_M, "(m): the axis traces deviate")
    expected = {name: 0 for name in KERNELS}
    expected.update(fused_topology_source=picard, fused_coarse_vcycle=picard,
                    fine_presmooth_restrict=picard, fine_prolong_smooth=picard)
    require(calls == expected, f"(m): wrapper calls {calls} != {expected}")
    require(launched == {"scpn_fused_source": picard, "scpn_fused_vcycle": picard,
                         "scpn_fine_pre": picard, "scpn_fine_post": picard},
            f"(m): launches {launched}, not one a call")
    by_path["flight_full_513"] = calls

    log_d, log_c = [], []
    ((psi_d, cur_d, tr_d), ms_d), calls_d, _ = counted(
        lambda: events_ms(lambda: shot(True, log_d, n=65, dtype=f64, shot_steps=5)))
    t0 = time.perf_counter()
    psi_c, cur_c, tr_c = shot(True, log_c, n=65, dtype=f64, device="cpu", shot_steps=5)
    ms_c = (time.perf_counter() - t0) * 1e3
    dev_64 = max(span_rel(psi_d.cpu(), psi_c), max_rel(cur_d, cur_c),
                 max_rel(tuple(tr_d), tuple(tr_c)))
    print(f"(m) flight simulator full lane 65^2 f64 (5 ticks): card {ms_d:.3f} ms, CPU "
          f"{ms_c:.1f} ms, deviation {dev_64:.3e} (limit {LANE_TOL:.0e}), Picard iterations "
          f"card {[i for i, *_ in log_d]}, CPU {[i for i, *_ in log_c]}; wrapper calls "
          f"{sum(calls_d.values())} [{card}]")
    require(dev_64 <= LANE_TOL and [x[:2] for x in log_d] == [x[:2] for x in log_c],
            "(m): the f64 lane deviates from the CPU")
    require(sum(calls_d.values()) == 0, "(m): a kernel ran on the float64 lane")


def closed_loop_work(ctrl, n_ticks: int) -> tuple[float, float]:
    """Bytes: the net, the specs and the start state in once, the traces and
    the final state out once; operations a tick: the two products with the
    input matrix and the one with the output matrix, and a few for each
    injection, firing, place and action."""
    n_t, n_p = ctrl.w_in.shape
    n_i, n_act = ctrl.inj_place_ids.shape[0], ctrl.act_gain.shape[0]
    item = ctrl.w_in.element_size()
    n_in = 2 * n_t * n_p + 3 * n_t + n_p + 4 + 5 * n_i + 5 * n_act + 2
    n_out = n_ticks * (2 + n_act + n_t) + 2 * n_p + n_t + n_act + 3
    flops = n_ticks * (6 * n_t * n_p + 8 * n_i + 6 * n_t + 3 * n_p + 8 * n_act + 8)
    return float(item * (n_in + n_out)), float(flops)


def closed_loop_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                       measured_plain: dict) -> dict:
    """(n) the R/Z controller of ``validation/run_control_latency.py:23-42``
    against the reduced plant (``bench_config.CLOSED_LOOP``: fractional,
    margin 0.5, dt 1e-3, from (6.5, 0.3) m, 10,000 ticks, float32):
    ``run_neuro_closed_loop`` in ONE launch of ``csrc/closed_loop.cu``,
    against its plain version (the per-tick loop) on the card within 1e-5 of
    each trace's span; the same controller in binary mode with equal firing
    vectors on every tick; float64 on the card against the port's CPU run
    within 1e-9; a configuration that samples its firing (8 antithetic
    passes) on the per-tick loop, no kernel, deterministic by tick, its mean
    firing at a fixed state within 3 sigma of the float path's."""
    import math

    import torch
    from scpn_fusion_tpu_torch.bench_config import CLOSED_LOOP, RZ_SPECS, rz_net
    from scpn_fusion_tpu_torch.control.neuro_closed_loop import (
        ReducedPlantState, run_neuro_closed_loop,
    )
    from scpn_fusion_tpu_torch.ops.cuda_closed_loop import closed_loop, closed_loop_plain
    from scpn_fusion_tpu_torch.scpn import controller as sc
    from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet

    f32, f64 = torch.float32, torch.float64
    n_ticks, dt = CLOSED_LOOP["n_ticks"], CLOSED_LOOP["dt"]
    frac = dict(firing_mode="fractional", firing_margin=CLOSED_LOOP["firing_margin"])

    def setup(dtype, device, **cfg_kw):
        ctrl = sc.build_controller(rz_net(StochasticPetriNet), dtype=dtype, device=device,
                                   **RZ_SPECS)
        plant0 = ReducedPlantState(*(torch.tensor(v, dtype=dtype, device=device)
                                     for v in CLOSED_LOOP["plant0"]))
        return ctrl, sc.ControllerConfig(dt=dt, **cfg_kw), plant0

    ctrl, cfg, plant0 = setup(f32, dev, **frac)
    ((cs_k, ps_k, tr_k), ms_k), calls, launched = counted(lambda: events_ms(
        lambda: run_neuro_closed_loop(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt)))
    (cs_p, ps_p, tr_p), ms_p = events_ms(
        lambda: closed_loop_plain(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt))
    dev_tr = max(span_rel(tr_k[k], tr_p[k]) for k in tr_k)
    err = max(float((tr_k[k] - tr_p[k]).abs().max()) for k in tr_k)
    print(f"(n) SCPN closed loop, R/Z controller f32 ({n_ticks} ticks, {cfg}): kernel vs plain "
          f"loop traces span-rel {dev_tr:.3e} (limit {SPAN_TOL:.0e}), max abs {err!r}; final "
          f"r {float(ps_k.r)!r} m (plain {float(ps_p.r)!r}), z {float(ps_k.z)!r} m; wrapper "
          f"calls {calls}, __global__ launches {launched} [{card}]")
    require(all(bool(torch.isfinite(v).all()) for v in tr_k.values()), "(n): traces not finite")
    require(dev_tr <= SPAN_TOL, "(n): the kernel deviates from its plain loop")
    expected = {name: 0 for name in KERNELS}
    expected["closed_loop"] = 1
    require(calls == expected and launched == {"scpn_closed_loop_f32": 1},
            f"(n): calls {calls}, launches {launched}: not one launch for the shot")
    results["closed_loop"] = {"max_abs_err": err}
    by_path["closed_loop_rz"] = calls

    ctrl_b, cfg_b, _ = setup(f32, dev, firing_mode="binary")
    _, _, trb_k = closed_loop(ctrl_b, cfg_b, plant0, n_ticks=n_ticks, dt=dt)
    _, _, trb_p = closed_loop_plain(ctrl_b, cfg_b, plant0, n_ticks=n_ticks, dt=dt)
    differ = int((trb_k["firing"] != trb_p["firing"]).any(dim=1).sum())
    dev_b = max(span_rel(trb_k[k], trb_p[k]) for k in trb_k)
    print(f"(n) binary mode: ticks whose firing vectors differ from the plain loop {differ} of "
          f"{n_ticks}; traces span-rel {dev_b:.3e}; {int(trb_k['firing'].sum())} firings")
    require(differ == 0 and dev_b <= SPAN_TOL, "(n): binary firing differs from the plain loop")

    ctrl_d, cfg_d, p_d = setup(f64, dev, **frac)
    ctrl_c, _, p_c = setup(f64, "cpu", **frac)
    (_, ps_d, tr_d), calls_d, _ = counted(
        lambda: run_neuro_closed_loop(ctrl_d, cfg_d, p_d, n_ticks=n_ticks, dt=dt))
    t0 = time.perf_counter()
    _, ps_c, tr_c = run_neuro_closed_loop(ctrl_c, cfg_d, p_c, n_ticks=n_ticks, dt=dt)
    ms_c = (time.perf_counter() - t0) * 1e3
    dev_64 = max(max_rel(tr_d[k], tr_c[k]) for k in tr_c)
    print(f"(n) f64: the kernel ({calls_d['closed_loop']} call) vs the port's CPU run "
          f"({ms_c:.1f} ms) max relative deviation {dev_64:.3e} (limit {LANE_TOL:.0e})")
    require(calls_d["closed_loop"] == 1 and dev_64 <= LANE_TOL,
            "(n): the f64 kernel deviates from the CPU run")

    sampled = dict(frac, sc_n_passes=8)
    ctrl_s, cfg_s, p_s = setup(f32, dev, **sampled)
    n_s = 2000
    run_s, calls_s, _ = counted(
        lambda: run_neuro_closed_loop(ctrl_s, cfg_s, p_s, n_ticks=n_s, dt=dt))
    run_s2 = run_neuro_closed_loop(ctrl_s, cfg_s, p_s, n_ticks=n_s, dt=dt)
    same = (state_equal(run_s[0], run_s2[0])
            and all(torch.equal(run_s[2][k], run_s2[2][k]) for k in run_s[2]))
    obs = torch.tensor([6.4, 0.1], dtype=f32, device=dev)
    s0 = sc.initial_controller_state(ctrl_s, cfg_s)
    f_mean = torch.stack([sc.controller_step(ctrl_s, cfg_s, s0, obs, k)[2]["firing"]
                          for k in range(n_s)]).double().mean(0).cpu()
    p_ref = sc._controller_step(ctrl_s, sc.ControllerConfig(dt=dt, **frac), s0, obs,
                                sc.StepDraws())[2]["firing"].double().cpu()
    sigma = torch.sqrt(p_ref * (1.0 - p_ref) / (cfg_s.sc_n_passes * n_s))
    z = ((f_mean - p_ref).abs() / torch.clamp(sigma, min=1e-300)).tolist()
    print(f"(n) sampled firing ({cfg_s.sc_n_passes} antithetic passes, {n_s} ticks): wrapper "
          f"calls {sum(calls_s.values())}, two runs equal {same}; at obs (6.4, 0.1) the mean "
          f"firing over {n_s} ticks {f_mean.tolist()} against the float path's {p_ref.tolist()} "
          f"({[round(v, 3) if math.isfinite(v) else v for v in z]} sigma)")
    require(sum(calls_s.values()) == 0, "(n): a kernel ran on the sampled configuration")
    require(same, "(n): the sampled loop is not deterministic by tick")
    require(bool(((f_mean - p_ref).abs() <= 3.0 * sigma + 1e-12).all()),
            "(n): the mean sampled firing is more than 3 sigma from p_fire")

    ms_kernel = cuda_ms(lambda: closed_loop(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt))
    print(f"time (n) SCPN closed loop f32: kernel {ms_kernel:.4f} ms a shot "
          f"({1e3 * ms_kernel / n_ticks:.3f} us a tick; median of 5), plain loop {ms_p:.3f} ms "
          f"({1e3 * ms_p / n_ticks:.3f} us a tick; once), first kernel call {ms_k:.4f} ms; "
          f"yardstick, not a target: the original reference's closed-loop step on a local CPU, "
          f"{REFERENCE_CLOSED_LOOP_MS[0]} / {REFERENCE_CLOSED_LOOP_MS[1]} ms P95 (PID with a "
          f"surrogate / full-physics plant; BASELINE.md:45); dependent stages "
          f"{4 * n_ticks} (4 barrier-separated stages a tick) [{card}]")
    timing["closed_loop"] = (
        lambda: closed_loop(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt),
        lambda: closed_loop_plain(ctrl, cfg, plant0, n_ticks=n_ticks, dt=dt),
        f"R/Z net, {n_ticks} ticks f32", closed_loop_work(ctrl, n_ticks))
    measured_plain["closed_loop"] = ms_p
    return calls


# (o)'s lanes, by label
REDUCED_LANE = "run_shot_reduced (10000 ticks at 10000 Hz)"
MPC_LANE = "mpc.plan (horizon 12, 12 iterations) + mpc_closed_loop (20 steps)"
SHOT_LANE = "integrated_scenario.run_shot (standard schedule, 840 ticks)"
OPTIMIZE_LANE = "optimize_shot (25 iterations, lr 0.6)"
TRACKING_LANE = "run_tracking_shot (33^2, 2 ticks)"


def control_lane_runs() -> list:
    """(label, run(device) -> tuple of tensors) of (o)'s lanes, float64: the
    reduced flight-sim shot (10,000 ticks), ``mpc.plan`` and
    ``mpc_closed_loop`` on the MPC lane's plant of
    ``validation/run_controller_comparison.py:77-86, 165-183``, the
    integrated shot on ``standard_shot_schedule()``, ``optimize_shot`` with
    the settings of ``tests/test_optimal_scenario.py`` (25 iterations, lr
    0.6) and two ticks of ``run_tracking_shot`` on the 33^2 machine of
    ``validation/run_tracking_acceptance.py:44-70`` (nine free-boundary
    solves: the initial one, six for the response, one a tick)."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import TRACKING_MACHINE, TRACKING_STEP
    from scpn_fusion_tpu_torch.control import free_boundary_tracking as fbt
    from scpn_fusion_tpu_torch.control import mpc
    from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams, run_shot_reduced
    from scpn_fusion_tpu_torch.control.optimal_scenario import (
        OptimizerConfig, ShotKnobs, optimize_shot,
    )
    from scpn_fusion_tpu_torch.control.scenario import FluxBudget, standard_shot_schedule
    from scpn_fusion_tpu_torch.core.config import config_from_dict
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import coilset_from_config
    from scpn_fusion_tpu_torch.models.physics.integrated_scenario import run_shot

    f64 = torch.float64

    def reduced(d):
        trace, metrics = run_shot_reduced(FlightSimParams(), dtype=f64, device=d)
        return (*trace, *metrics.values())

    # validation/run_controller_comparison.py's plant and MPC lane
    drift_r, gamma_z, u_max, dt = 0.03, 5.0, 2.0, 1e-3
    mcfg = mpc.MPCConfig(horizon=12, dt=dt, iterations=12, learning_rate=0.3, l2_reg=1e-3,
                         u_min=-u_max, u_max=u_max)

    def nominal(x, u):
        return torch.stack([drift_r + u[0], gamma_z * x[1] + u[1]])

    def plant(x, u):
        u = torch.clamp(u, -u_max, u_max)
        return torch.stack([drift_r + u[0], gamma_z * x[1] + u[1]])

    def mpc_lane(d):
        x0 = torch.tensor([6.5, 0.1], dtype=f64, device=d)
        target = torch.tensor([6.2, 0.0], dtype=f64, device=d)
        p = mpc.plan(nominal, mcfg, x0, target, torch.zeros((12, 2), dtype=f64, device=d))
        return (*p, *mpc.mpc_closed_loop(nominal, plant, mcfg, x0, target, 20))

    budget = FluxBudget(phi_cs_vs=280.0, l_plasma_uh=7.0, r0_m=6.2)

    def shot(d):
        trace, report = run_shot(standard_shot_schedule(), budget, device=d)
        return (*trace, *report)

    def optimize(d):
        k0 = ShotKnobs(*(torch.tensor(v, dtype=f64, device=d) for v in (20.0, 6.0, 10.0)))
        res = optimize_shot(k0, budget, cfg=OptimizerConfig(n_iters=25, learning_rate=0.6))
        return (*res.knobs, res.q_flattop, res.loss_history, res.feasible)

    cfg_t = config_from_dict(TRACKING_MACHINE)

    def tracking(d):
        grid = Grid.from_config(cfg_t, dtype=f64, device=d)
        coils = coilset_from_config(cfg_t, f64, d)
        obj0 = fbt.soft_objectives(fbt._plant_solve(coils, cfg_t, grid, False), grid)
        targets = obj0 + torch.tensor(TRACKING_STEP, dtype=f64, device=d)
        return tuple(fbt.run_tracking_shot(cfg_t, coils, targets, grid=grid, dtype=f64, n_steps=2,
                                           fallback_currents=coils.currents))

    return [(REDUCED_LANE, reduced), (MPC_LANE, mpc_lane), (SHOT_LANE, shot),
            (OPTIMIZE_LANE, optimize), (TRACKING_LANE, tracking)]


# (o)'s lanes that run for minutes on the card (host-bound loops of 0-d
# float64 ops); they run in a process of their own started after the build
CARD_LANES = (OPTIMIZE_LANE, TRACKING_LANE)


def control_lanes_on_card(conn) -> None:
    """(o)'s :data:`CARD_LANES` on the card: sends {label: (outputs as numpy
    arrays, ms between CUDA events, wrapper calls by kernel)}."""
    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    out = {}
    for label, run in control_lane_runs():
        if label in CARD_LANES:
            cb.reset_launch_counts()
            res, ms = events_ms(lambda: run(torch.device("cuda")))
            out[label] = ([t.detach().cpu().numpy() for t in res], ms,
                          {name: cb.CALLS[name] for name in KERNELS})
    conn.send(out)
    conn.close()


# (o)'s tracking_acceptance shots (indices into its module's SHOTS, 132
# ticks in all) in four spawned processes of 26-38 ticks each
TRACKING_BINS = ((6, 1, 10), (7, 2), (8, 3, 0), (9, 4, 5))


def tracking_shots_on_card(conn, card: str, indices: tuple) -> None:
    """Some of (o)'s ``tracking_acceptance`` shots on the card (each tick
    seven free-boundary plant solves in f64 plain ops, host-bound): sends
    {index: the trace as numpy arrays}, the machine's currents, the seconds
    and the kernel calls (none may launch)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.validation import run_tracking_acceptance as ta
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    m = ta.setup(torch.device("cuda"))
    traces = {i: tuple(t.detach().cpu().numpy() for t in ta.run_shot(ta.SHOTS[i], m))
              for i in indices}
    torch.cuda.synchronize()
    conn.send({"traces": traces, "currents": m["coils"].currents.cpu().numpy(),
               "s": time.perf_counter() - t0,
               "calls": {name: cb.CALLS[name] for name in KERNELS}})
    conn.close()


def tracking_campaign(card: str, twins: list) -> dict:
    """(o)'s ``tracking_acceptance`` campaign from the shots of
    :func:`tracking_shots_on_card`'s processes (``twins``), its lanes built
    by its module's ``finish``, its status the committed report's; returns
    the kernel calls on its shots."""
    from scpn_fusion_tpu_torch.control.free_boundary_tracking import TrackingTrace
    from scpn_fusion_tpu_torch.validation import run_tracking_acceptance as ta
    traces, calls, secs = {}, dict.fromkeys(KERNELS, 0), []
    for twin in twins:
        r = twin()
        traces.update({i: TrackingTrace(*arrays) for i, arrays in r["traces"].items()})
        currents = r["currents"]
        secs.append(r["s"])
        for name, v in r["calls"].items():
            calls[name] += v
    require(sorted(traces) == list(range(len(ta.SHOTS))), f"(o) tracking shots {sorted(traces)}")
    rc = ta.finish([traces[i] for i in range(len(ta.SHOTS))], currents)
    campaign_check("tracking_acceptance", rc, card, "(o)")
    print(f"(o) tracking_acceptance: {len(ta.SHOTS)} shots, {sum(n for _, n in ta.SHOTS)} ticks "
          f"in {len(twins)} spawned processes on the card ({', '.join(f'{v:.1f}' for v in secs)} "
          f"s) [{card}]")
    require(sum(calls.values()) == 0, f"(o) tracking_acceptance (f64 plain ops) launched {calls}")
    return calls


def control_lanes_on_cpu(conn) -> None:
    """(o)'s CPU twins: sends {label: (outputs as numpy arrays, wall ms)}."""
    cpu = on_cpu(2)
    out = {}
    for label, run in control_lane_runs():
        t0 = time.perf_counter()
        res = run(cpu)
        out[label] = ([t.detach().numpy() for t in res], (time.perf_counter() - t0) * 1e3)
    conn.send(out)
    conn.close()


def control_lanes(dev, card: str, counted, by_path: dict, card_lanes, cpu) -> None:
    """(o) the control lanes (``control_lane_runs``) in float64, each on the
    card against the same call on the CPU within 1e-9 relative: the reduced
    shot in one launch of ``csrc/reduced_shot.cu`` (its plain loop on the
    CPU), the other lanes with no kernel.  The lanes are host-bound loops of
    small ops on either device: :data:`CARD_LANES` run on the card in a
    process of their own (``card_lanes`` waits for
    :func:`control_lanes_on_card`), the CPU twins in another (``cpu`` waits
    for :func:`control_lanes_on_cpu`), both started early."""
    import torch

    on_card = {}
    for label, run in control_lane_runs():
        if label not in CARD_LANES:
            (out, ms), calls, _ = counted(lambda: events_ms(lambda: run(dev)))
            on_card[label] = (out, ms, calls)
    for label, (out, ms, calls) in card_lanes().items():
        on_card[label] = (tuple(torch.from_numpy(a) for a in out), ms, calls)
    cpu_runs = cpu()
    lane_calls = {name: 0 for name in KERNELS}
    for label, (out, ms, calls) in on_card.items():
        cpu_out, ms_c = cpu_runs[label]
        for k, v in calls.items():
            lane_calls[k] += v
        dev_l = max_rel(out, tuple(torch.from_numpy(a) for a in cpu_out))
        where = " (in its own process)" if label in CARD_LANES else ""
        print(f"(o) {label}: card {ms:.3f} ms{where}, CPU {ms_c:.1f} ms (in its own process), max "
              f"relative deviation {dev_l:.3e} (limit {LANE_TOL:.0e}), wrapper calls "
              f"{sum(calls.values())} [{card}]")
        want = {name: int(label == REDUCED_LANE and name == "reduced_shot") for name in KERNELS}
        require(calls == want, f"(o) {label}: wrapper calls {calls} != {want}")
        require(dev_l <= LANE_TOL, f"(o) {label}: the card deviates from the CPU run")
    out, ms, _ = on_card[REDUCED_LANE]
    print(f"time (o) run_shot_reduced f64: {ms / 10.0:.2f} us a tick (CUDA events over the "
          f"10,000-tick shot, one launch of csrc/reduced_shot.cu); disruption fraction "
          f"{float(out[-5])!r}, final |r err| "
          f"{float(out[-4])!r} m [{card}]")
    out = on_card[SHOT_LANE][0]
    print(f"(o)   Q flattop {float(out[12])!r}, flux exhausted {bool(out[15])}")
    out = on_card[OPTIMIZE_LANE][0]
    print(f"(o)   knobs {[float(v) for v in out[:3]]}, Q flattop {float(out[3])!r}, feasible "
          f"{bool(out[5])}")
    out = on_card[TRACKING_LANE][0]
    print(f"(o)   axis error by tick {out[5].tolist()}, alert levels {out[4].tolist()}")
    by_path["control_lanes"] = lane_calls


# ── the eleventh slice: (p) row R, the batched reduced shot (csrc/reduced_shot.cu),
# with the stress campaign and the PID tuner through it; (q) the classical and
# robust controllers and the vertical-stability chain on the 513^2 FMG psi ──

CAMPAIGN_SHOTS = 1000         # validation/run_stress_campaign.py: 1000 shots, FlightSimParams()
TUNE_SMALL = dict(control_hz=1000.0, shot_duration_s=0.25)    # tests/test_tuning.py's lane
LANE64_SHOTS = 64             # (p)'s float64 runs, kernel against the CPU
COST_SLACK = 1.0001           # tests/test_tuning.py:50: tuned cost <= default cost * 1.0001


def reduced_shot_work(n: int, p: int, itemsize: int, stress: bool) -> tuple[float, float]:
    """Bytes: the schedule (one or two values a tick), the gains and the
    draws (stress: four a shot-tick) in once, the traces (stress: r, z;
    reduced: r, z, beta, heating) out once.  Operations a shot-tick, rounded
    products, sums and differences: heating 2, beta 6, the two PIDs 16, the
    two envelopes 4, the two applied commands 4; the reduced variant's drift
    of r and z 3, the stress variant's ELM kick, drift and noise 14."""
    items = (n * (2 if stress else 1) + 6 * (1 if stress else p)
             + n * p * (4 + 2 if stress else 4))
    return float(itemsize * items), float(n * p * (32 + (14 if stress else 3)))


def lane64_inputs(device):
    """(p)'s float64 inputs, the same in every process: 64 gain sets (the
    reduced variant) and 64 shots' draws (the stress variant), drawn on the
    CPU from a seeded generator, then moved to ``device``."""
    import torch
    from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams, reduced_inputs
    from scpn_fusion_tpu_torch.control.stress import StressConfig, stress_draws, stress_inputs

    f64, params, cfg = torch.float64, FlightSimParams(), StressConfig()
    g = torch.Generator().manual_seed(SEED)
    gains = torch.exp(torch.randn((LANE64_SHOTS, 6), generator=g, dtype=f64))
    draws = stress_draws(params.n_steps, LANE64_SHOTS, generator=g, dtype=f64).to(device)
    scaled, heat, _ = reduced_inputs(params, gains.to(device), f64)
    return params, cfg, (scaled, heat), (*stress_inputs(params, cfg, f64, device), draws)


def reduced_lanes_on_cpu(conn) -> None:
    """(p)'s CPU twins: the plain loop on ``lane64_inputs`` in both variants;
    sends [(reduced traces), (stress traces)] as numpy arrays."""
    cpu = on_cpu(2)
    from scpn_fusion_tpu_torch.ops.cuda_reduced_shot import reduced_shot_plain

    params, cfg, (scaled, heat), (gains, heat_s, drift, draws) = lane64_inputs(cpu)
    red = reduced_shot_plain(params, scaled, heat)
    st = reduced_shot_plain(params, gains, heat_s, drift=drift, draws=draws, stress=cfg)
    conn.send([[t.numpy() for t in red], [st.r.numpy(), st.z.numpy()]])
    conn.close()


@contextlib.contextmanager
def plain_reduced_shot():
    """The flight simulator's and the campaign's tick loop on its plain
    version (the name each module looks up), so a public entry point runs
    plain ops on the card."""
    from scpn_fusion_tpu_torch.control import flight_sim, stress
    from scpn_fusion_tpu_torch.ops.cuda_reduced_shot import reduced_shot, reduced_shot_plain

    flight_sim.reduced_shot = stress.reduced_shot = reduced_shot_plain
    try:
        yield
    finally:
        flight_sim.reduced_shot = stress.reduced_shot = reduced_shot


def reduced_shot_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                        measured_plain: dict) -> int:
    """(p) row R against its batched plain loop on the card, ``torch.equal``
    field for field: the stress variant at 1000 shots x 10,000 ticks in
    float32 on the campaign's draws (seed 1), the reduced variant at 128 x
    10,000 in float32 on the CEM's first generation of gains, and both at 64
    shots in float64, which must also lie within 1e-9 of the plain loop on
    the CPU (a spawned process, the same inputs).  Then the campaign
    ``run_stress_campaign(n_shots=1000)`` in float32 as
    ``validation/run_stress_campaign.py`` runs it (one launch; gate:
    disruption rate 0; CUDA events, median of 5), ``tune_pid`` at its
    defaults (128 x 15: 15 launches; the tuned cost no worse than the default
    gains', ``tests/test_tuning.py:50``) and ``tune_pid`` at 128 x 2 on the
    JAX test's 1 kHz lane with the kernel and with the plain loop on one
    generator (``best_params`` equal).  Returns the launches of the
    campaign and the tuner."""
    import torch
    from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams, reduced_inputs
    from scpn_fusion_tpu_torch.control.stress import (
        StressConfig, run_stress_campaign, stress_draws, stress_inputs,
    )
    from scpn_fusion_tpu_torch.control.tuning import (
        PID_BOUNDS_HI, PID_BOUNDS_LO, _cem_minimize, pid_shot_cost, tune_pid,
    )
    from scpn_fusion_tpu_torch.ops.cuda_reduced_shot import reduced_shot, reduced_shot_plain

    f32, f64 = torch.float32, torch.float64
    params, cfg = FlightSimParams(), StressConfig()
    n = params.n_steps
    errs = []

    def equal(a, b) -> bool:
        pairs = [(x, y) for x, y in zip(a, b) if x is not None]
        errs.extend(float((x - y).abs().max()) for x, y in pairs)
        return all(torch.equal(x, y) for x, y in pairs)

    with cpu_twin(reduced_lanes_on_cpu) as twin:
        draws = stress_draws(n, CAMPAIGN_SHOTS, dtype=f32,
                             generator=torch.Generator(device=dev).manual_seed(1))
        s_in = stress_inputs(params, cfg, f32, dev)
        kw_s = dict(drift=s_in[2], draws=draws, stress=cfg)
        out_k = reduced_shot(params, s_in[0], s_in[1], **kw_s)
        out_p, ms_plain = events_ms(lambda: reduced_shot_plain(params, s_in[0], s_in[1], **kw_s))
        eq_s = equal(out_k, out_p)
        # the CEM's first generation of tune_pid's candidates: the gains its objective sees
        first = []
        _cem_minimize(lambda g: first.append(g) or torch.zeros(g.shape[0], device=dev),
                      PID_BOUNDS_LO, PID_BOUNDS_HI,
                      torch.randn((1, 128, 6), generator=torch.Generator(device=dev).manual_seed(
                          SEED), device=dev))
        scaled, heat, _ = reduced_inputs(params, first[0], f32)
        eq_r = equal(reduced_shot(params, scaled, heat), reduced_shot_plain(params, scaled, heat))
        _, _, (scaled64, heat64), (g64, heat_s64, drift64, draws64) = lane64_inputs(dev)
        red_k = reduced_shot(params, scaled64, heat64)
        st_k = reduced_shot(params, g64, heat_s64, drift=drift64, draws=draws64, stress=cfg)
        eq_64 = (equal(red_k, reduced_shot_plain(params, scaled64, heat64))
                 and equal(st_k, reduced_shot_plain(params, g64, heat_s64, drift=drift64,
                                                    draws=draws64, stress=cfg)))
        cpu_red, cpu_st = twin()
    dev_cpu = max(max(span_rel(a.cpu(), torch.from_numpy(b)) for a, b in zip(red_k, cpu_red)),
                  max(span_rel(a.cpu(), torch.from_numpy(b)) for a, b in zip(st_k[:2], cpu_st)))
    print(f"(p) row R against its batched plain loop on the card, torch.equal: stress variant "
          f"{CAMPAIGN_SHOTS} x {n} f32 {eq_s}, reduced variant 128 x {n} f32 (the CEM's first "
          f"generation) {eq_r}, both at {LANE64_SHOTS} shots f64 {eq_64}; f64 against the plain "
          f"loop on the CPU span-rel {dev_cpu:.3e} (limit {LANE_TOL:.0e}); max abs difference "
          f"{max(errs)!r} [{card}]")
    require(eq_s and eq_r and eq_64, "(p): row R differs from its plain loop on the card")
    require(dev_cpu <= LANE_TOL, "(p): the f64 kernel deviates from the plain loop on the CPU")
    results["reduced_shot"] = {"max_abs_err": max(errs)}

    (res, ms_c1), calls_c, launched_c = counted(lambda: events_ms(lambda: run_stress_campaign(
        params, cfg, n_shots=CAMPAIGN_SHOTS, seed=1, device=dev)))
    ms_campaign = cuda_ms(lambda: run_stress_campaign(params, cfg, n_shots=CAMPAIGN_SHOTS, seed=2,
                                                      device=dev))
    want = {name: int(name == "reduced_shot") for name in KERNELS}
    print(f"(p) stress campaign {CAMPAIGN_SHOTS} shots x {n} ticks f32 ({cfg}): disruption rate "
          f"{float(res.disruption_rate)!r} (gate 0, BASELINE.md:49), |r err| p50 "
          f"{float(res.r_err_p50)!r} m, p95 {float(res.r_err_p95)!r} m, p99 "
          f"{float(res.r_err_p99)!r} m, |z err| p95 {float(res.z_err_p95)!r} m, mean final "
          f"error {float(res.mean_final_err)!r} m; wrapper calls {calls_c}, launches "
          f"{launched_c} [{card}]")
    print(f"time (p) stress campaign: {ms_campaign:.4f} ms (median of 5, CUDA events; first call "
          f"{ms_c1:.4f} ms), {1e3 * ms_campaign / (CAMPAIGN_SHOTS * n):.6f} us a shot-tick; its "
          f"tick loop on the batched plain loop {ms_plain:.1f} ms (once), "
          f"{1e3 * ms_plain / (CAMPAIGN_SHOTS * n):.6f} us a shot-tick [{card}]")
    require(calls_c == want and launched_c == {"scpn_reduced_shot_f32": 1},
            f"(p): the campaign made {calls_c} / {launched_c}, not one launch")
    require(float(res.disruption_rate) == 0.0, "(p): the campaign disrupted a shot")
    by_path["stress_campaign"] = calls_c

    default = torch.tensor([params.pid_r_kp, params.pid_r_ki, params.pid_r_kd, params.pid_z_kp,
                            params.pid_z_ki, params.pid_z_kd], dtype=f32, device=dev)
    base = float(pid_shot_cost(params, default))
    (tuned, ms_t), calls_t, launched_t = counted(lambda: events_ms(lambda: tune_pid(
        params, torch.Generator(device=dev).manual_seed(SEED))))
    n_gen = int(tuned.cost_history.shape[0])
    print(f"(p) tune_pid 128 x {n_gen} on FlightSimParams() f32: best cost "
          f"{float(tuned.best_cost)!r} against the default gains' {base!r} (limit x{COST_SLACK}), "
          f"best gains {tuned.best_params.tolist()}, best cost by generation "
          f"{tuned.cost_history.tolist()}; wrapper calls {calls_t}, launches {launched_t}; "
          f"{ms_t:.3f} ms ({ms_t / n_gen:.3f} ms a generation, CUDA events) [{card}]")
    require(calls_t == {name: n_gen * v for name, v in want.items()} and n_gen == 15
            and launched_t == {"scpn_reduced_shot_f32": 15},
            f"(p): tune_pid made {calls_t} / {launched_t}, not one launch a generation")
    require(float(tuned.best_cost) <= base * COST_SLACK, "(p): tune_pid did not beat the defaults")
    by_path["tune_pid"] = calls_t

    small = FlightSimParams(**TUNE_SMALL)
    res_k = tune_pid(small, torch.Generator(device=dev).manual_seed(SEED), n_generations=2)
    with plain_reduced_shot():
        (res_p, ms_tp), calls_p, _ = counted(lambda: events_ms(lambda: tune_pid(
            small, torch.Generator(device=dev).manual_seed(SEED), n_generations=2)))
    same = all(torch.equal(a, b) for a, b in zip(res_k, res_p))
    print(f"(p) tune_pid 128 x 2 on the 1 kHz lane of tests/test_tuning.py: kernel and plain "
          f"loop equal in every field {same} (best gains {res_k.best_params.tolist()}, cost "
          f"{float(res_k.best_cost)!r}); plain {ms_tp:.1f} ms, wrapper calls "
          f"{sum(calls_p.values())}")
    require(same and sum(calls_p.values()) == 0, "(p): tune_pid differs on the plain loop")

    def kernel_run():
        return reduced_shot(params, s_in[0], s_in[1], **kw_s)

    timing["reduced_shot"] = (
        kernel_run, lambda: reduced_shot_plain(params, s_in[0], s_in[1], **kw_s),
        f"stress variant {CAMPAIGN_SHOTS} x {n} f32", reduced_shot_work(n, CAMPAIGN_SHOTS, 4, True))
    measured_plain["reduced_shot"] = ms_plain
    return calls_c["reduced_shot"] + calls_t["reduced_shot"]


# (q): the plants and sizes of the JAX tests
HINF_PLANT = ([[0.0, 1.0], [4.0, 0.0]], [[0.1], [0.0]], [[0.0], [1.0]],
              [[1.0, 0.0], [0.0, 0.1]], [[1.0, 0.0]])         # tests/test_estimator_hinf.py
MU_PLANT = ([[0.5, 1.0], [0.0, -2.0]], [[0.0], [1.0]], [[1.0, 0.0], [0.0, 1.0]])  # test_robust
TUNE_HINF_PLANT = ([[0.0, 1.0], [-4.0, -0.2]], [[0.0], [1.0]], [[0.0], [1.0]], [[1.0, 0.0]],
                   [[1.0, 0.0]])                              # tests/test_tuning.py
RZIP_LQR = dict(kp=100.0, kd=100.0, dt=2e-5, n_steps=20_000)  # tests/test_vessel_rzip.py's Q, dt
CONTROLLER_LANES = ("synthesize_hinf + hinf_step (4000 steps)", "mu_synthesis (3 D-K iterations)",
                    "dk_iteration_structured", "rwm_feedback_design", "run_smc_vertical (8000)",
                    "schedule_step over iter_baseline_waveforms (300 steps)", "EKF (200 ticks)",
                    "run_fault_tolerant_shot", "tune_hinf (16 x 3)",
                    "vertical stability on the 513^2 FMG psi")


def controller_lane_runs(psi, r, z, r_axis: float, ip_ma: float) -> list:
    """(label, run(device) -> tuple of tensors) of (q)'s lanes in float64, at
    the plants and sizes of the JAX tests, and the vertical-stability chain
    (``VerticalStabilityAnalysis.compute_n_index`` on ``psi`` at ``r_axis``,
    the RZIP state space of ``bench_config.RZIP_VESSEL`` at ``ip_ma``, its
    growth rate, the LQR gain, the closed-loop eigenvalues)."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import rzip_vessel_arrays
    from scpn_fusion_tpu_torch.control import estimator as ekf
    from scpn_fusion_tpu_torch.control import fault_tolerant as ft
    from scpn_fusion_tpu_torch.control import gain_schedule as gs
    from scpn_fusion_tpu_torch.control import hinf, robust, sliding_mode, tuning
    from scpn_fusion_tpu_torch.control import vessel_rzip as vr

    f64 = torch.float64

    def mats(d, ms):
        return [torch.tensor(m, dtype=f64, device=d) for m in ms]

    def hinf_lane(d):
        a, b1, b2, c1, c2 = mats(d, HINF_PLANT)
        g = hinf.synthesize_hinf(a, b1, b2, c1, c2, 20.0)
        x, s = torch.tensor([0.3, 0.0], dtype=f64, device=d), hinf.HInfState(
            torch.zeros(2, dtype=f64, device=d))
        for _ in range(4000):
            s, u = hinf.hinf_step(g, a, b2, c2, s, c2 @ x, 1e-3)
            x = x + 1e-3 * (a @ x + b2 @ u)
        return (*g, x, s.x_hat)

    def mu_lane(d):
        return tuple(robust.mu_synthesis(*mats(d, MU_PLANT), n_dk_iters=3))

    def dk_lane(d):
        struct = robust.StructuredUncertainty((robust.UncertaintyBlock("mode", 1, 0.2),
                                               robust.UncertaintyBlock("wall", 1, 0.2)))
        return tuple(robust.dk_iteration_structured(*mats(d, MU_PLANT), struct))

    def rwm_lane(d):
        return tuple(robust.rwm_feedback_design(robust.build_rwm_plant(device=d)))

    def smc_lane(d):
        p = sliding_mode.SMCParams(alpha=50.0, beta=30.0, c=0.05, u_max=200.0)
        return tuple(sliding_mode.run_smc_vertical(p, z0=0.02, dz0=0.0, gamma=20.0,
                                                   control_gain=500.0, dt=1e-4, n_steps=8000,
                                                   dtype=f64, device=d))

    def schedule_lane(d):
        kp = torch.ones((gs.N_REGIMES, 2), dtype=f64, device=d)
        kp[gs.H_MODE_FLAT] = 3.0
        x_ref = torch.zeros_like(kp)
        x_ref[gs.H_MODE_FLAT] = 2.0
        bank = gs.GainBank(kp, torch.full_like(kp, 0.1), torch.full_like(kp, 0.01), x_ref)
        wf = gs.iter_baseline_waveforms(f64, d)
        st, dt, us = gs.init_schedule_state(2, 5, f64, d), 2.0, []
        for k in range(300):
            t = dt * k
            x = torch.stack([wf["ip_ma"](t) * 0.98, wf["n_e_19"](t)]) / 10.0
            u, st = gs.schedule_step(
                gs.DetectorThresholds(), bank, st, x, t, dt,
                dip_dt=(wf["ip_ma"](t + dt) - wf["ip_ma"](t)) / dt,
                tau_e=0.5 + wf["p_aux_mw"](t) / 25.0, p_disrupt=0.9 if 560 <= t < 580 else 0.0)
            us.append(u)
        return (torch.stack(us), *st)

    def ekf_lane(d):
        state = ekf.ekf_init(torch.tensor([6.0, 0.1, 0.0, 0.0, 15.0, 10.0], dtype=f64, device=d),
                             torch.eye(6, dtype=f64, device=d) * 0.1)
        q = torch.eye(6, dtype=f64, device=d) * 1e-4
        r_cov = torch.eye(4, dtype=f64, device=d) * 1e-3
        noise, true_r = np.random.default_rng(0).standard_normal(200), 6.0
        for k in range(200):
            true_r += 0.2 * 0.01
            z_meas = torch.tensor([true_r + 0.01 * noise[k], 0.1, 15.0, 10.0], dtype=f64, device=d)
            state = ekf.ekf_step(state, z_meas, q, r_cov, 0.01)
        return tuple(state)

    def fault_lane(d):
        jac = torch.tensor(np.random.default_rng(0).standard_normal((4, 6)), dtype=f64, device=d)
        return tuple(ft.run_fault_tolerant_shot(
            jac, torch.tensor([1.0, -0.5, 0.3, 0.8], dtype=f64, device=d),
            fault_times=torch.tensor([50, 80, -1], device=d),
            fault_kinds=torch.tensor([ft.ACTUATOR_LOSS, ft.ACTUATOR_LOSS, 0], device=d),
            fault_indices=torch.tensor([0, 3, -1], device=d)))

    def tune_hinf_lane(d):
        normals = torch.randn((3, 16, 2), generator=torch.Generator().manual_seed(SEED))
        return tuple(tuning._tune_hinf(*mats(d, TUNE_HINF_PLANT), normals.to(d)))

    def vertical_lane(d):
        arr = rzip_vessel_arrays()
        vessel = vr.Vessel(*(torch.tensor(arr[k], device=d) for k in
                             ("r", "z", "resistance", "inductance")))
        n_index = vr.compute_n_index(torch.from_numpy(psi).to(d), torch.from_numpy(r).to(d),
                                     torch.from_numpy(z).to(d), r_axis)
        ss = vr.build_rzip_state_space(vessel, n_wall=8, r0=r_axis, ip_ma=ip_ma,
                                       n_index=n_index)
        k = vr.rzip_lqr_gain(ss, **RZIP_LQR)
        eig = np.sort_complex(vr.closed_loop_eigenvalues(ss, k))
        return (n_index, torch.tensor(vr.vertical_growth_rate(ss), dtype=f64), ss.a, ss.b, k,
                torch.from_numpy(eig))

    return list(zip(CONTROLLER_LANES, (hinf_lane, mu_lane, dk_lane, rwm_lane, smc_lane,
                                       schedule_lane, ekf_lane, fault_lane, tune_hinf_lane,
                                       vertical_lane)))


def controller_lanes_on_cpu(conn, *chain) -> None:
    """(q)'s CPU twins: sends {label: (outputs as numpy arrays, wall ms)}."""
    cpu = on_cpu(2)
    out = {}
    for label, run in controller_lane_runs(*chain):
        t0 = time.perf_counter()
        res = run(cpu)
        out[label] = ([t.detach().numpy() for t in res], (time.perf_counter() - t0) * 1e3)
    conn.send(out)
    conn.close()


def controller_lanes(dev, card: str, counted, by_path: dict, fmg_result, fmg_cfg) -> None:
    """(q) the controllers of ``controller_lane_runs`` in float64, each on
    the card (plain ops, no kernel) against the same call in a spawned CPU
    process within 1e-9 relative; the vertical-stability chain reads the
    513^2 FMG psi that the smoke solved through kernels 2-5 (a float64 copy,
    the same in both processes) at its magnetic axis, and adds no solve."""
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.topology import find_magnetic_axis

    f64 = torch.float64
    g = Grid.from_config(fmg_cfg, dtype=f64, device="cpu")
    psi = fmg_result.psi.detach().to(f64).cpu()
    iz, ir, _ = find_magnetic_axis(psi)
    chain = (psi.numpy(), g.R.numpy(), g.Z.numpy(), float(g.R[ir]),
             float(fmg_cfg.physics.plasma_current_target))
    with cpu_twin(controller_lanes_on_cpu, *chain) as twin:
        on_card = {}
        for label, run in controller_lane_runs(*chain):
            (out, ms), calls, _ = counted(lambda: events_ms(lambda: run(dev)))
            on_card[label] = (out, ms, calls)
        cpu_runs = twin()
    lane_calls = {name: 0 for name in KERNELS}
    for label, (out, ms, calls) in on_card.items():
        cpu_out, ms_c = cpu_runs[label]
        for k, v in calls.items():
            lane_calls[k] += v
        dev_l = max_rel(out, tuple(torch.from_numpy(a) for a in cpu_out))
        print(f"(q) {label}: card {ms:.1f} ms, CPU {ms_c:.1f} ms (in its own process), max "
              f"relative deviation {dev_l:.3e} (limit {LANE_TOL:.0e}), wrapper calls "
              f"{sum(calls.values())} [{card}]")
        require(sum(calls.values()) == 0, f"(q) {label}: a kernel ran on a plain-ops lane")
        require(dev_l <= LANE_TOL, f"(q) {label}: the card deviates from the CPU run")
    out = on_card[CONTROLLER_LANES[0]][0]
    print(f"(q)   H-inf at gamma 20: rho(XY) {float(out[5])!r}, feasible {bool(out[6])}, state "
          f"after 4 s {out[7].tolist()}")
    out = on_card[CONTROLLER_LANES[1]][0]
    print(f"(q)   mu-synthesis: mu upper bound {float(out[2])!r}, gamma {float(out[3])!r}")
    out = on_card[CONTROLLER_LANES[3]][0]
    print(f"(q)   RWM: closed-loop rate {float(out[1])!r} /s, stabilised {bool(out[2])}")
    out = on_card[CONTROLLER_LANES[-2]][0]
    print(f"(q)   tune_hinf: best [gamma, w] {out[0].tolist()}, cost {float(out[1])!r}")
    n_index, growth, *_, eig = on_card[CONTROLLER_LANES[-1]][0]
    print(f"(q) vertical stability on the 513^2 FMG psi at the axis R = {chain[3]!r} m, Ip "
          f"{chain[4]} MA: n-index {float(n_index)!r}, open-loop growth rate {float(growth)!r} "
          f"/s, closed-loop max Re(lambda) {float(eig.real.max())!r} /s (LQR {RZIP_LQR}) "
          f"[{card}]")
    require(bool(torch.isfinite(eig).all()), "(q): the vertical-stability chain is not finite")
    by_path["controllers"] = lane_calls



# ── the twelfth slice: (r) the disturbance-rejection ladder through row L
# (csrc/ladder.cu) and row N's linear-plant variant, (s) the disruption
# predictors' training at the validations' sizes, (t) the learned controllers
# against the CPU ──

LADDER_LINEAR = ("PID", "H-infinity", "MPC")
# operations a lane-tick of row L, rounded products, sums, quotients and
# clamps: the plant's step 20; the PID 13, the H-inf observer 28, the MPC law 6
LADDER_OPS = {"plant": 20, "PID": 13, "H-infinity": 28, "MPC": 6}
SM_CLOCK_HZ = 1.98e9         # H100 SXM boost clock, for the dependent-chain estimate
ROC_THRESHOLDS = 33          # validation/run_disruption_roc.py: np.linspace(0.02, 0.98, 33)
SEQ_STEPS, MLP_STEPS = 600, 2500   # run_disruption_roc.py:161-176, run_control_ladder.py:87-92
AGREE_MLP_STEPS, AGREE_SEQ_STEPS = 100, 20   # (s)'s float64 training agreement
# validation gates that the port's own draws miss on the CPU already (none)
GATES_MISSED_ON_CPU: frozenset = frozenset()


def ladder_work(lanes, n_ticks, itemsize: int) -> tuple[float, float]:
    """Row L at ``lanes`` ((controller, scenario) pairs): bytes of the
    packed disturbance traces, the gains and the initial states in once and
    z and u of every tick out once; operations per :data:`LADDER_OPS`."""
    scen = {s: n for (_, s), n in zip(lanes, n_ticks)}
    items = sum(scen.values()) + 18 * len(lanes) + 8 + 2 * sum(n_ticks)
    ops = sum(n * (LADDER_OPS["plant"] + LADDER_OPS[c]) for (c, _), n in zip(lanes, n_ticks))
    return float(itemsize * items), float(ops)


def ladder_chain_ms(n_ticks: int, depth: int, cycles: int = 4) -> float:
    """The dependent chain of a lane: ``depth`` dependent operations a tick
    of ``cycles`` cycles each, over ``n_ticks`` ticks at the boost clock."""
    return 1e3 * n_ticks * depth * cycles / SM_CLOCK_HZ


def ladder_lanes_f64(device, part: str = "all"):
    """(r)'s float64 run: every linear lane's (z, u) through
    ``cuda_ladder.ladder`` (the plain loop on the CPU) and every scenario's
    SNN (z, u) through ``closed_loop_linear``, as a flat list; ``part``
    "linear" or "snn" takes one of the two."""
    import torch
    from scpn_fusion_tpu_torch.control import disturbance_ladder as dl
    from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
    from scpn_fusion_tpu_torch.ops import cuda_ladder as cl

    f64 = torch.float64
    out = []
    if part != "snn":
        spec = dl.linear_lanes([(c, s) for s in dl.SCENARIOS for c in LADDER_LINEAR], f64,
                               device)
        out += list(cl.ladder(spec, dt=dl.DT, u_max=dl.U_MAX))
    if part != "linear":
        for s in dl.SCENARIOS:
            _, _, tr = ccl.closed_loop_linear(dl._build_z_net(2e3, f64, device), dl.snn_config(),
                                              dl.initial_state(s, f64, device),
                                              dl.snn_plant(s, f64, device))
            out += [tr["z"], tr["u"]]
    return out


def ladder_on_cpu(conn, part: str) -> None:
    """(r)'s CPU twin of one part ("linear" or "snn") of ``ladder_lanes_f64``
    on the plain loops; sends the traces as numpy arrays."""
    cpu = on_cpu(1)
    conn.send([t.numpy() for t in ladder_lanes_f64(cpu, part)])
    conn.close()


def ladder_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                  measured_plain: dict) -> int:
    """(r) the disturbance-rejection ladder of ``validation/run_control_ladder.py:59-83``:
    rows L and N ``torch.equal`` to their plain loops on the card in float32
    on the VDE scenario at full length (20,000 ticks; the three linear lanes
    in one launch of row L, the SNN lane in one launch of row N); the whole
    ladder (4 controllers x 3 scenarios, 360,000 ticks) through the kernels
    in float32 in one launch of L and three of N, with the validation's gates
    (every lane stable; VDE ISE MPC < PID < H-inf, SNN > MPC); the whole ladder in
    float64 within 1e-9 of the plain loops on the CPU (two spawned
    processes); L's and N's times.  Returns row L's launches on the float32
    ladder."""
    import torch
    from scpn_fusion_tpu_torch.control import disturbance_ladder as dl
    from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
    from scpn_fusion_tpu_torch.ops import cuda_ladder as cl

    f32 = torch.float32
    with cpu_twin(ladder_on_cpu, "linear") as linear_cpu, cpu_twin(ladder_on_cpu, "snn") as snn_cpu:
        vde = [(c, "VDE") for c in LADDER_LINEAR]
        spec = dl.linear_lanes(vde, f32, dev)
        ((zk, uk), ms_k1), calls, launched = counted(
            lambda: events_ms(lambda: cl.ladder(spec, dt=dl.DT, u_max=dl.U_MAX)))
        (zp, up), ms_p = events_ms(lambda: cl.ladder_plain(spec, dt=dl.DT, u_max=dl.U_MAX))
        equal_l = torch.equal(zk, zp) and torch.equal(uk, up)
        err_l = max(float((zk - zp).abs().max()), float((uk - up).abs().max()))
        print(f"(r) row L, {', '.join(LADDER_LINEAR)} on VDE f32 (3 lanes x 20,000 ticks): kernel "
              f"torch.equal to the plain loop {equal_l} (max abs {err_l!r}); wrapper calls "
              f"{calls['ladder']}, launches {launched}; plain loop {ms_p:.1f} ms [{card}]")
        require(equal_l, "(r): row L differs from its plain loop")
        require(calls["ladder"] == 1 and launched == {"scpn_ladder_f32": 1},
                f"(r): row L made {calls} / {launched}, not one launch")

        ctrl, cfg = dl._build_z_net(2e3, f32, dev), dl.snn_config()
        plant, x0 = dl.snn_plant("VDE", f32, dev), dl.initial_state("VDE", f32, dev)
        (cs_k, xk, trk), calls_n, launched_n = counted(
            lambda: ccl.closed_loop_linear(ctrl, cfg, x0, plant))
        (cs_p, xp, trp), ms_pn = events_ms(lambda: ccl.closed_loop_linear_plain(ctrl, cfg, x0,
                                                                                 plant))
        equal_n = (all(torch.equal(trk[k], trp[k]) for k in trp) and torch.equal(xk, xp)
                   and all(torch.equal(a, b) for a, b in zip(cs_k, cs_p)))
        err_n = max(float((trk[k] - trp[k]).abs().max()) for k in trp)
        print(f"(r) row N linear plant, SNN on VDE f32 (20,000 ticks): kernel torch.equal to the "
              f"per-tick loop {equal_n} (traces, final plant and controller state; max abs "
              f"{err_n!r}); wrapper calls {calls_n['closed_loop']}, launches {launched_n}; plain "
              f"loop {ms_pn:.1f} ms [{card}]")
        require(equal_n, "(r): row N's linear variant differs from its plain loop")
        require(calls_n["closed_loop"] == 1 and launched_n == {"scpn_closed_loop_f32": 1},
                f"(r): row N made {calls_n} / {launched_n}, not one launch")
        results["ladder"] = {"max_abs_err": err_l}

        (table, ms_w), calls_w, launched_w = counted(
            lambda: events_ms(lambda: dl.run_ladder(dtype=f32, device=dev)))
        want = {name: 0 for name in KERNELS}
        want.update(ladder=1, closed_loop=3)
        print(f"(r) the ladder, 4 controllers x 3 scenarios f32 (360,000 ticks), through the "
              f"kernels: {ms_w:.1f} ms (controller designs included); wrapper calls "
              f"{ {k: v for k, v in calls_w.items() if v} }, launches {launched_w} [{card}]")
        for (name, scen), m in table.items():
            print(f"(r)   {name:10s} {scen:12s} ISE {m['ise']:.6e}  settle "
                  f"{m['settling_time_s']:.4f} s  overshoot {m['overshoot']:.6e}  effort "
                  f"{m['control_effort']:.6e}  stable {m['stable']}")
        require(calls_w == want, f"(r): the ladder made {calls_w}, not one L and three N launches")
        all_stable = all(m["stable"] for m in table.values())
        ise = {c: table[(c, "VDE")]["ise"] for c in (*LADDER_LINEAR, "SNN")}
        ordering = ise["MPC"] < ise["PID"] < ise["H-infinity"] and ise["SNN"] > ise["MPC"]
        print(f"(r) validation gates (run_control_ladder.py:72-73): every lane stable "
              f"{all_stable}; VDE ISE MPC < PID < H-inf and SNN > MPC {ordering}")
        require(all_stable and ordering, "(r): the ladder misses the validation's gates")
        by_path["ladder_f32"] = calls_w

        card64, calls_64, _ = counted(lambda: ladder_lanes_f64(dev))
        cpu64 = linear_cpu() + snn_cpu()
        dev64 = max(max_rel(a, torch.from_numpy(b)) for a, b in zip(card64, cpu64))
        print(f"(r) the ladder f64 through the kernels (wrapper calls "
              f"{ {k: v for k, v in calls_64.items() if v} }) against the plain loops on the "
              f"CPU: max relative deviation over every z and u trace {dev64:.3e} (limit "
              f"{LANE_TOL:.0e}) [{card}]")
        require(dev64 <= LANE_TOL, "(r): the f64 ladder deviates from the CPU's plain loops")

    full = dl.linear_lanes([(c, s) for s in dl.SCENARIOS for c in LADDER_LINEAR], f32, dev)
    ms_l = cuda_ms(lambda: cl.ladder(spec, dt=dl.DT, u_max=dl.U_MAX))
    ms_full = cuda_ms(lambda: cl.ladder(full, dt=dl.DT, u_max=dl.U_MAX))
    ms_n = cuda_ms(lambda: ccl.closed_loop_linear(ctrl, cfg, x0, plant))
    work_l = ladder_work(vde, [20_000] * 3, 4)
    work_full = ladder_work([(c, s) for s in dl.SCENARIOS for c in LADDER_LINEAR],
                            full.n_ticks.tolist(), 4)
    b_l, by_l = bound(work_l)
    b_full, by_full = bound(work_full)
    chain = ladder_chain_ms(40_000, 12 + 20)     # PID: ~12 dependent ops + a quotient (~20)
    print(f"time (r) row L: VDE 3 lanes {ms_l:.4f} ms ({1e3 * ms_l / 20_000:.4f} us a tick), the "
          f"whole ladder's 9 lanes {ms_full:.4f} ms ({1e3 * ms_full / 40_000:.4f} us a tick of "
          f"its longest lane; median of 5); bound {b_l:.4g} / {b_full:.4g} ms ({by_l} / "
          f"{by_full}); the dependent chain of the longest lane ~{chain:.3f} ms (40,000 ticks x "
          f"~32 dependent operations x 4 cycles at {SM_CLOCK_HZ / 1e9:.2f} GHz); plain loop "
          f"{ms_p:.1f} ms once [{card}]")
    n_bytes, n_flops = closed_loop_work(ctrl, 20_000)
    b_n, by_n = bound((n_bytes + 4 * 20_000, n_flops + 20.0 * 20_000))
    print(f"time (r) row N linear plant: SNN on VDE {ms_n:.4f} ms ({1e3 * ms_n / 20_000:.4f} us "
          f"a tick; median of 5), bound {b_n:.4g} ms ({by_n}), 4 barrier-separated stages a "
          f"tick; per-tick loop {ms_pn:.1f} ms once [{card}]")
    timing["ladder"] = (lambda: cl.ladder(spec, dt=dl.DT, u_max=dl.U_MAX),
                        lambda: cl.ladder_plain(spec, dt=dl.DT, u_max=dl.U_MAX),
                        "PID, H-inf, MPC on VDE, 3 lanes x 20,000 ticks f32", work_l)
    measured_plain["ladder"] = ms_p
    return calls_w["ladder"]


def to_device(a, device, dtype=None):
    import torch
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t.to(dtype) if dtype is not None else t


def roc_metrics(fired, first, pos, t_len: int, window: int, thresholds) -> dict:
    """validation/run_disruption_roc.py's lanes 1-2 on a threshold sweep:
    the trapezoid AUC anchored at (0,0) and (1,1), dominance of chance, and
    the loosest zero-false-positive operating point with its median warning."""
    tprs = [float(np.sum(f & pos) / max(np.sum(pos), 1)) for f in fired]
    fprs = [float(np.sum(f & ~pos) / max(np.sum(~pos), 1)) for f in fired]
    f = np.array([0.0] + fprs[::-1] + [1.0])
    t = np.array([0.0] + tprs[::-1] + [1.0])
    order = np.argsort(f, kind="stable")
    auc = float(np.trapezoid(t[order], f[order]))
    dominates = bool(np.all(np.array(tprs) >= np.array(fprs) - 1e-12))
    op = None
    for k in range(len(thresholds)):
        if fprs[k] == 0.0 and tprs[k] > 0.0:
            lead = [int(t_len - (first[k][i] + window - 1)) for i in range(len(pos))
                    if pos[i] and fired[k][i]]
            op = (float(thresholds[k]), tprs[k], float(np.median(lead)) if lead else 0.0)
            break
    return {"auc": auc, "dominates": dominates, "zero_fp": op}


def hard_operating_point(fired, first, pos, t_len: int, thresholds):
    """run_disruption_roc.py's lane 4: the loosest threshold at FPR <= 0.13,
    (threshold, fpr, recall, median warning ticks) or None."""
    for k in range(len(thresholds)):
        fpr = float(np.sum(fired[k] & ~pos) / max(np.sum(~pos), 1))
        rec = float(np.sum(fired[k] & pos) / max(np.sum(pos), 1))
        if fpr <= 0.13:
            leads = [int(t_len - first[k][i]) for i in range(len(pos)) if pos[i] and fired[k][i]]
            return float(thresholds[k]), fpr, rec, float(np.median(leads)) if leads else 0.0
    return None


def predictor_lanes_run(device, seed: int = 0) -> dict:
    """(s)'s three validation lanes at full size in float32 on ``device``,
    every draw from a CPU generator seeded with ``seed`` (JAX's PRNGKey(0)):
    the windowed MLP of run_control_ladder.py:87-101 (24 x 200 training
    shots, 2500 steps, recall / FPR on 16 held-out shots), the windowed MLP
    of run_disruption_roc.py:74-90 (32 x 240, 2500 steps, the 33-threshold
    sweep over 48 held-out shots) and the causal transformer of
    run_disruption_roc.py:161-230 (256 x 240 training family, batch 16, 600
    AdamW steps, scored and swept with 15-tick confirmation over the 64-shot
    held-out cohort).  Returns the gates' metrics and the training times."""
    import torch
    from scpn_fusion_tpu_torch import bench_config as bc
    from scpn_fusion_tpu_torch.control import disruption as dp
    from scpn_fusion_tpu_torch.control import disruption_seq as ds

    def timed(fn):
        if device.type == "cuda":
            return events_ms(fn)
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    out = {}
    tr_s, tr_l = bc.ladder_cohort(*bc.LADDER_COHORTS["train"])
    te_s, te_l = bc.ladder_cohort(*bc.LADDER_COHORTS["test"])
    pred, ms = timed(lambda: dp.train_disruption_predictor(
        to_device(tr_s, device), to_device(tr_l, device), torch.Generator().manual_seed(seed),
        n_steps=MLP_STEPS))
    ev = dp.evaluate_predictor(pred, to_device(te_s, device), to_device(te_l, device))
    out["ladder_mlp"] = {"recall": float(ev["recall"]), "fpr": float(ev["fpr"]),
                         "ms_step": ms / MLP_STEPS}

    tr_s, tr_l, _, _ = bc.roc_cohort(*bc.ROC_COHORTS["train"])
    te_s, te_l, _, _ = bc.roc_cohort(*bc.ROC_COHORTS["test"])
    pred, ms = timed(lambda: dp.train_disruption_predictor(
        to_device(tr_s, device), to_device(tr_l, device), torch.Generator().manual_seed(seed),
        n_steps=MLP_STEPS))
    thresholds = np.linspace(0.02, 0.98, ROC_THRESHOLDS)
    with torch.no_grad():
        risks = pred.risk(to_device(te_s, device))
    fired, first = dp.alarm_threshold_sweep(risks, to_device(thresholds, device, risks.dtype))
    roc = roc_metrics(fired.cpu().numpy(), first.cpu().numpy(), te_l > 0.5, te_s.shape[1],
                      pred.window, thresholds)
    out["roc_mlp"] = {**roc, "ms_step": ms / MLP_STEPS}

    fam, _, fam_noisy, fam_on = ds.generate_training_family(7)
    h_shots, h_clean, _, _ = ds.generate_hard_cohort(ds.TEST_CONFIG, seed=991)
    res, ms = timed(lambda: ds.train_seq_predictor(
        to_device(fam, device), to_device(fam_noisy, device), to_device(fam_on, device),
        torch.Generator().manual_seed(seed), n_steps=SEQ_STEPS))
    with torch.no_grad():
        h_risks = ds.seq_risk(res.params, to_device(h_shots, device))
    scores = h_risks[:, 24:].amax(dim=1).cpu().numpy()
    fired_h, first_h = dp.alarm_threshold_sweep(
        h_risks, to_device(thresholds, device, h_risks.dtype), confirm_ticks=15)
    out["hard_seq"] = {"auc": ds.roc_auc(scores, h_clean),
                       "op": hard_operating_point(fired_h.cpu().numpy(), first_h.cpu().numpy(),
                                                  h_clean > 0.5, h_shots.shape[1], thresholds),
                       "final_loss": float(res.loss_history[-1]), "ms_step": ms / SEQ_STEPS}
    return out


def predictor_gates(m: dict) -> dict:
    """Each validation gate of (s): name -> passed."""
    zfp, op = m["roc_mlp"]["zero_fp"], m["hard_seq"]["op"]
    return {
        "ladder recall 1.0 / FPR 0.0": m["ladder_mlp"]["recall"] >= 1.0
        and m["ladder_mlp"]["fpr"] <= 0.0,
        "ROC AUC >= 0.95, dominating chance": m["roc_mlp"]["auc"] >= 0.95
        and m["roc_mlp"]["dominates"],
        "zero-FP recall >= 0.9, warning > 0": zfp is not None and zfp[1] >= 0.9 and zfp[2] > 0.0,
        "hard-cohort AUC in [0.72, 0.98]": 0.72 <= m["hard_seq"]["auc"] <= 0.98,
        "hard FPR <= 0.13 with recall >= 0.45": op is not None and op[2] >= 0.45 and op[3] > 0.0,
    }


def training_agreement_runs(device) -> list:
    """(s)'s float64 training agreement at full width, the same draws on
    every device: 100 Adam steps of ``train_mlp`` on the windows of
    run_control_ladder.py's cohort (9 -> 64 -> 64 -> 1, batch 512) and 20
    AdamW steps of ``train_seq_predictor`` on the 256-shot training family;
    the loss histories and every parameter, as a flat list."""
    import torch
    from scpn_fusion_tpu_torch import bench_config as bc
    from scpn_fusion_tpu_torch.control import disruption as dp
    from scpn_fusion_tpu_torch.control import disruption_seq as ds
    from scpn_fusion_tpu_torch.models.surrogates import mlp

    f64 = torch.float64
    tr_s, tr_l = bc.ladder_cohort(*bc.LADDER_COHORTS["train"])
    xn, yt, _, _ = dp.window_dataset(to_device(tr_s, device, f64), to_device(tr_l, device, f64),
                                     16, 32)
    gen = torch.Generator().manual_seed(SEED)
    p0 = mlp.init_mlp(gen, (9, 64, 64, 1), dtype=f64, device=device)
    res = mlp.train_mlp(p0, xn, yt, gen, n_steps=AGREE_MLP_STEPS, batch_size=512)
    fam, _, noisy, onsets = ds.generate_training_family(7)
    seq = ds.train_seq_predictor(to_device(fam, device, f64), to_device(noisy, device, f64),
                                 to_device(onsets, device), torch.Generator().manual_seed(SEED),
                                 n_steps=AGREE_SEQ_STEPS)
    return [res.loss_history, *mlp.leaves(res.params), seq.loss_history,
            *ds.flatten(seq.params)[0]]


def predictors_on_cpu(conn) -> None:
    """(s)'s CPU twin: ``training_agreement_runs`` on the CPU, as numpy."""
    cpu = on_cpu(4)
    conn.send([t.detach().numpy() for t in training_agreement_runs(cpu)])
    conn.close()


def predictor_lanes(dev, card: str, counted, by_path: dict) -> None:
    """(s) the disruption predictors trained on the card at the validations'
    full sizes in float32 with the validations' gates, and the float64
    training agreement with the CPU (a spawned process) within 1e-9; no
    kernel may launch (the JAX package computes these outside its Pallas
    kernels)."""
    import torch

    with cpu_twin(predictors_on_cpu) as twin:
        m, calls, _ = counted(lambda: predictor_lanes_run(dev))
        lm, rm, hm = m["ladder_mlp"], m["roc_mlp"], m["hard_seq"]
        print(f"(s) windowed MLP, run_control_ladder.py lane 2 (24 x 200 shots, {MLP_STEPS} "
              f"steps) f32: recall {lm['recall']!r}, FPR {lm['fpr']!r} on 16 held-out shots; "
              f"{lm['ms_step']:.3f} ms a training step [{card}]")
        print(f"(s) windowed MLP, run_disruption_roc.py lanes 1-2 (32 x 240, {MLP_STEPS} steps) "
              f"f32: AUC {rm['auc']!r}, dominates chance {rm['dominates']}, zero-FP point "
              f"(threshold, recall, median warning ticks) {rm['zero_fp']}; {rm['ms_step']:.3f} ms "
              f"a training step [{card}]")
        print(f"(s) causal transformer d32/h4/ff64/L2, run_disruption_roc.py lanes 3-4 (256 x "
              f"240, batch 16, {SEQ_STEPS} AdamW steps) f32: hard-cohort AUC {hm['auc']!r}, "
              f"operating point at FPR <= 0.13 (threshold, FPR, recall, median warning ticks) "
              f"{hm['op']}, final loss {hm['final_loss']!r}; {hm['ms_step']:.3f} ms a training "
              f"step [{card}]")
        for gate, ok in predictor_gates(m).items():
            if gate in GATES_MISSED_ON_CPU:
                print(f"(s) gate {gate}: {'met' if ok else 'MISSED'} (the port's own draws miss "
                      f"it on the CPU already; not enforced)")
            else:
                print(f"(s) gate {gate}: {'met' if ok else 'MISSED'}")
                require(ok, f"(s): {gate} missed on the card")
        require(sum(calls.values()) == 0, f"(s): a kernel launched on the predictors: {calls}")
        by_path["predictors"] = calls

        on_card, ms = events_ms(lambda: training_agreement_runs(dev))
        cpu_out = twin()
    dev_t = max(max_rel(a, torch.from_numpy(b)) for a, b in zip(on_card, cpu_out))
    print(f"(s) float64 training agreement ({AGREE_MLP_STEPS} train_mlp steps, "
          f"{AGREE_SEQ_STEPS} train_seq_predictor steps at full width, the same draws): max "
          f"relative deviation of the loss histories and every parameter from the CPU "
          f"{dev_t:.3e} (limit {LANE_TOL:.0e}); {ms:.1f} ms on the card [{card}]")
    require(dev_t <= LANE_TOL, "(s): the f64 training deviates from the CPU")


# (t)'s lanes, by label
LEARNED_LANES = ("surrogate_mpc (learn 2000 steps, plan, 25-step loop)",
                 "replay_shot (800-step predictor)", "train_federated (6 rounds)",
                 "safe_rl.train (8 x 60, 15 iterations)", "run_soc_learning (300 steps)",
                 "run_neuro_cybernetic_shot (200 ticks)", "run_channel (1000 ticks)",
                 "run_neural_shape_loop (committed surrogate, 120 ticks)")
SHAPE_LOOP_TOL = SURROGATE_TOL   # the float32 equilibrium surrogate's MLP sums in cuBLAS's order


def learned_lane_runs() -> list:
    """(label, run(device) -> tuple of tensors) of (t)'s lanes in float64
    at the JAX tests' sizes (tests/test_surrogate_mpc.py, test_replay.py,
    test_federated.py FAST, test_safe_rl.py's training, test_soc_learning.py,
    test_neuro_cybernetic.py, test_nef_director.py, test_neural_kernel.py),
    every draw from a CPU generator so that both devices see the same."""
    import torch
    from scpn_fusion_tpu_torch.control import disruption as dp
    from scpn_fusion_tpu_torch.control import federated as fed
    from scpn_fusion_tpu_torch.control import mpc
    from scpn_fusion_tpu_torch.control import nef_snn as nef
    from scpn_fusion_tpu_torch.control import neural_kernel as nk
    from scpn_fusion_tpu_torch.control import neuro_cybernetic as ncy
    from scpn_fusion_tpu_torch.control import replay as rp
    from scpn_fusion_tpu_torch.control import safe_rl
    from scpn_fusion_tpu_torch.control import soc_learning as soc
    from scpn_fusion_tpu_torch.control import surrogate_mpc as smpc
    from scpn_fusion_tpu_torch.models.surrogates.pretrained import load_equilibrium_artifact

    f64 = torch.float64
    a_np = np.asarray([[-0.5, 0.1], [0.0, 0.4]])
    b_np = np.asarray([[1.0, 0.0], [0.0, 1.5]])

    def gen(seed=0):
        return torch.Generator().manual_seed(seed)

    def surrogate(d):
        rng = np.random.default_rng(0)
        xs = np.empty((64, 31, 2))
        us = rng.uniform(-1.0, 1.0, (64, 30, 2))
        for i in range(64):
            x = rng.uniform(-1.0, 1.0, 2)
            xs[i, 0] = x
            for k in range(30):
                x = x + 0.05 * (a_np @ x + b_np @ us[i, k])
                xs[i, k + 1] = x
        a_t, b_t = to_device(a_np, d), to_device(b_np, d)

        def plant(x, u):
            return a_t @ x + b_t @ torch.atleast_1d(u)

        model = smpc.learn_dynamics(to_device(xs, d), to_device(us, d), gen(), n_steps=2000,
                                    dtype=f64)
        cfg = mpc.MPCConfig(horizon=12, dt=0.05, iterations=60, learning_rate=0.1, u_min=-2.0,
                            u_max=2.0)
        x0 = torch.tensor([0.8, 0.6], dtype=f64, device=d)
        p = smpc.surrogate_mpc_plan(model, cfg, x0, torch.zeros(2, dtype=f64, device=d))
        loop = smpc.surrogate_mpc_closed_loop(model, plant, cfg, x0,
                                              torch.zeros(2, dtype=f64, device=d), n_steps=25)
        err = smpc.one_step_error(model, to_device(xs[:8], d), to_device(us[:8], d))
        return (*model.mlp.weights, err, *p, *loop)

    def replay(d):
        rng = np.random.default_rng(0)
        shots = rng.standard_normal((24, 128, 2)) * 0.1
        labels = (np.arange(24) % 2).astype(float)
        shots[labels > 0.5, -40:, 0] += np.linspace(0, 3.0, 40)
        pred = dp.train_disruption_predictor(to_device(shots, d), to_device(labels, d), gen(),
                                             window=16, n_steps=800)
        t = torch.linspace(0.0, 0.128, 128, dtype=f64, device=d)
        res = rp.replay_shot(pred, rp.ReplayConfig(), t, to_device(shots[1].T, d))
        return tuple(res)

    def federated(d):
        cfg = fed.FederatedConfig(n_samples=128, local_epochs=2, n_rounds=6, batch_size=32)
        params, trace = fed.train_federated(cfg, 0, dtype=f64, device=d)
        return (*params.weights, *params.biases, *trace)

    def rl(d):
        cfg = safe_rl.PPOConfig(batch_episodes=8, max_episode_steps=60, policy_lr=0.02)
        params, lambdas, hist = safe_rl.train(safe_rl.TokamakEnvParams(), cfg, n_iterations=15,
                                              seed=0, dtype=f64, device=d)
        returns = torch.tensor([h["mean_return"] for h in hist], dtype=f64)
        return (*params, lambdas, returns)

    def sandpile(d):
        trace, summary, q = soc.run_soc_learning(gen(7), n_steps=300, dtype=f64, device=d)
        return (*trace, q)

    def neuro(d):
        trace, _ = ncy.run_neuro_cybernetic_shot(gen(3), n_ticks=200, dtype=f64, device=d)
        return tuple(trace)

    def channel(d):
        cfg = nef.NefConfig(n_neurons=120, gain=0.8, seed=5)
        x = 0.6 * torch.sin(torch.arange(1000, dtype=f64) * 0.02).to(d)
        return (nef.run_channel(cfg, nef.make_channel(cfg, f64, d), x),)

    def shape_loop(d):
        sur, _ = load_equilibrium_artifact(device=d)
        n = sur.shape[0]
        r1 = torch.linspace(2.0, 10.0, n, dtype=f64, device=d)
        z1 = torch.linspace(-4.0, 4.0, n, dtype=f64, device=d)
        base = torch.tensor([-1.0, 4.0, 6.0, 4.0, -1.0, 3.0], device=d)
        steer = torch.tensor([0, 0, 1.0, 0, 1.0, 0.0], device=d)
        ax_r, _ = nk.soft_axis_position(sur.predict(base).to(f64), r1, z1)
        tr = nk.run_neural_shape_loop(sur, base, r1, z1, target_r=float(ax_r) + 0.15,
                                      steer=steer / torch.linalg.norm(steer), n_ticks=120,
                                      kp=2.0, ki=0.2)
        # the positions in metres (axis R, axis Z, the radial error) as one
        # trace, held to the scale of the axis radius: Z sits near 0 m and the
        # error shrinks to ~0, so either alone would be held to its own
        # vanishing size (the target itself moves by the surrogate's rounding)
        return (torch.stack([tr.axis_r, tr.axis_z, tr.err_r], dim=-1), tr.currents,
                tr.final_psi)

    return list(zip(LEARNED_LANES, (surrogate, replay, federated, rl, sandpile, neuro, channel,
                                    shape_loop)))


def learned_lanes_on_cpu(conn) -> None:
    """(t)'s CPU twins: sends {label: (outputs as numpy arrays, wall ms)}."""
    cpu = on_cpu(2)
    out = {}
    for label, run in learned_lane_runs():
        t0 = time.perf_counter()
        res = run(cpu)
        out[label] = ([t.detach().cpu().numpy() for t in res], (time.perf_counter() - t0) * 1e3)
    conn.send(out)
    conn.close()


def learned_lanes(dev, card: str, counted, by_path: dict) -> None:
    """(t) the learned controllers in float64 at the JAX tests' sizes, each
    on the card against the same call on the CPU (a spawned process) within
    1e-9 relative; the neural shape loop, whose float32 equilibrium
    surrogate sums its MLP in cuBLAS's order on the card, within 1e-5.  No
    kernel may launch."""
    import torch

    with cpu_twin(learned_lanes_on_cpu) as twin:
        on_card = {}
        for label, run in learned_lane_runs():
            (out, ms), calls, _ = counted(lambda: events_ms(lambda: run(dev)))
            on_card[label] = (out, ms, calls)
        cpu_runs = twin()
    lane_calls = {name: 0 for name in KERNELS}
    for label, (out, ms, calls) in on_card.items():
        cpu_out, ms_c = cpu_runs[label]
        for k, v in calls.items():
            lane_calls[k] += v
        devs = [max_rel(a, torch.from_numpy(b)) for a, b in zip(out, cpu_out)]
        dev_l = max(devs)
        tol = SHAPE_LOOP_TOL if label == LEARNED_LANES[-1] else LANE_TOL
        print(f"(t) {label}: card {ms:.1f} ms, CPU {ms_c:.1f} ms (in its own process), max "
              f"relative deviation {dev_l:.3e} (output {devs.index(dev_l)} of {len(devs)}; "
              f"limit {tol:.0e}), wrapper calls {sum(calls.values())} [{card}]")
        require(sum(calls.values()) == 0, f"(t) {label}: a kernel launched ({calls})")
        require(dev_l <= tol, f"(t) {label}: the card deviates from the CPU run")
    by_path["learned_lanes"] = lane_calls


# ── the fourteenth slice: (u) the nonlinear gyrokinetic run through row G
# (csrc/gk_rhs.cu: one RK4 stage of every species a launch), (v) the reduced
# GK lanes on plain ops ──

GK_STAGE_TOL = {"complex64": 1e-6, "complex128": 1e-12}   # row G vs plain, of max |k|
GK_RUN_TOL = {"complex64": 1e-4, "complex128": 1e-10}     # whole runs' traces vs plain
GK_TIMED_STEPS = 20          # steps between a pair of CUDA events, (u)'s ms a step
GK_IV_GAMMA_TOL = 1e-3       # tests/test_gyrokinetics.py:83-92: IV gamma vs eig gamma
GK_JUMP_MAX = 0.08           # run_gk_growth_rates.py lane 1: max neighbour jump of gamma
GK_RATE_BAND = 2.5           # run_gk_growth_rates.py lane 2: ratio to the fixture's gamma


def gk_cases():
    """(label, config, seed) of (u)'s two runs: the default NonlinearGKConfig()
    and the 32^3 complex128 spec of run_sharded_convergence.py:350-354."""
    from scpn_fusion_tpu_torch.bench_config import GK_SPEC_32, GK_SPEC_32_SEED
    from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import NonlinearGKConfig
    return (("default 2x16x16x32x16x8 c64, 200 steps", NonlinearGKConfig(), 42),
            ("32^3 spec 2x32x32x16x16x8 c128, 50 steps", NonlinearGKConfig(**GK_SPEC_32),
             GK_SPEC_32_SEED))


def gk_stage_inputs(cfg, dev, seed: int):
    """A stage's inputs at ``cfg``: (grids, spec, gram_inv, f, dt, stage terms)
    from the seeded initial state after one step."""
    from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
    g = nl.build_grids(cfg, device=dev)
    spec = nl.stage_spec(cfg, g)
    gram_inv = nl._gram_inv(cfg, g, nl._dtypes(cfg)[0])
    f = nl._rk4_step(cfg, g, spec, nl.init_state(cfg, g, seed=seed), gram_inv).f
    phi = nl.field_solve(cfg, g, f)
    return g, spec, gram_inv, f, nl.cfl_dt(cfg, g, phi), nl.stage_terms(cfg, g, f, phi, gram_inv)


def gk_stage_work(f, terms, spec, stage: int) -> tuple[float, float]:
    """Row G's bytes and real flops (~70 a point of an active species) at RK4
    stage ``stage``, counting what the stage needs: f0 read and next written
    for every species; the terms read once; fin read for the active species
    (for adiabatic electrons with zonal damping, at ky = 0 alone); the
    accumulator of ``spec.n_acc`` species read (stages 1-3) and written
    (stages 0-2).  Adiabatic, undamped electrons have k = 0: their next is
    their f0, and neither their fin nor an accumulator is touched."""
    per = f[0].numel() * f.element_size()          # one species of f
    n_act = 2 if spec.electrons_active else 1
    fin = n_act * per
    if spec.n_acc > n_act:
        ky0 = int((spec.grids.ky.abs() < 1e-10).sum())
        fin += (spec.n_acc - n_act) * per * ky0 // f.shape[2]
    acc = spec.n_acc * per * (int(stage > 0) + int(stage < 3))
    terms_b = sum(t.numel() * t.element_size() for t in terms if t is not None)
    return 2 * f.shape[0] * per + fin + acc + terms_b, 70.0 * n_act * f[0].numel()


def gk_stage_checks(dev, card: str) -> dict:
    """Row G against ``gk_stage_plain`` on the card, four chained stages (the
    plain chain's inputs) at both (u) configurations in both dtypes: k (the
    accumulator of stage 0, then its increments) within 1e-6 (complex64) /
    1e-12 (complex128) of max |k|, the next stage's input within the same of
    its max; one launch a stage.  Returns {label: max_abs_err of k}."""
    import dataclasses

    import torch
    from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_gk

    errs = {}
    for label, cfg0, seed in gk_cases():
        for dtype in ("complex64", "complex128"):
            cfg = dataclasses.replace(cfg0, dtype=dtype)
            g, spec, gram_inv, f, dt, _ = gk_stage_inputs(cfg, dev, seed)
            fin, acc, worst, worst_abs = f, None, 0.0, 0.0
            cb.reset_launch_counts()
            for stage in range(4):
                terms = nl.stage_terms(cfg, g, fin, nl.field_solve(cfg, g, fin), gram_inv)
                k = cuda_gk.stage_rhs_plain(fin, terms, spec)
                nk, ak = cuda_gk.gk_stage(stage, f, fin, None if acc is None else acc.clone(),
                                          terms, dt, spec)
                np_, ap = cuda_gk.gk_stage_plain(stage, f, fin, acc, terms, dt, spec)
                kmax = float(k.abs().max())
                if ap is not None:
                    e = float((ak - ap).abs().max())
                    worst, worst_abs = max(worst, e / kmax), max(worst_abs, e)
                worst = max(worst, float((nk - np_).abs().max()) / float(np_.abs().max()))
                fin, acc = np_, ap
            torch.cuda.synchronize()
            entry = f"scpn_gk_stage_{'c64' if dtype == 'complex64' else 'c128'}"
            print(f"(u) row G vs gk_stage_plain, {label.split(',')[0]} {dtype}, four stages: "
                  f"max deviation {worst:.3e} of max |k| (limit {GK_STAGE_TOL[dtype]:.0e}); "
                  f"wrapper calls {cb.CALLS['gk_rhs']}, launches {dict(cb.LAUNCHES)} [{card}]")
            require(worst <= GK_STAGE_TOL[dtype], f"(u): row G deviates from its plain version "
                                                 f"at {label} {dtype}")
            require(cb.CALLS["gk_rhs"] == 4 and dict(cb.LAUNCHES) == {entry: 4},
                    f"(u): row G made {dict(cb.CALLS)} / {dict(cb.LAUNCHES)}, not 4 launches")
            errs[f"{label} {dtype}"] = worst_abs
    return errs


def gk_variant_run(device):
    """(u)'s variant: kinetic electrons, electromagnetic, conservative
    collisions, zonal damping, shaped Miller geometry, 8^4 x 4, 20 steps f64,
    from the seeded initial state: (final f, *trace)."""
    from scpn_fusion_tpu_torch.bench_config import GK_VARIANT, GK_VARIANT_MILLER
    from scpn_fusion_tpu_torch.models.gyrokinetics import geometry, nonlinear as nl
    cfg = nl.NonlinearGKConfig(**GK_VARIANT)
    geo = geometry.miller_geometry(**GK_VARIANT_MILLER, device=device)
    final, trace = nl.run_nonlinear_gk(cfg, geometry=geo, seed=9, device=device)
    return (final.f, *trace)


def gk_variant_on_cpu(conn) -> None:
    """(u)'s variant on the CPU (the plain stages), as numpy."""
    cpu = on_cpu(4)
    conn.send([t.detach().numpy() for t in gk_variant_run(cpu)])
    conn.close()


def gk_nonlinear_lane(dev, card: str, counted, by_path: dict, results: dict,
                      timing: dict) -> int:
    """(u) ``run_nonlinear_gk`` at the default config (200 steps) and the 32^3
    spec (50 steps) through row G, 4 launches a step, against the same runs
    with the plain stage on the card (traces and final f within 1e-4 in
    complex64, 1e-10 in complex128); the linear ITG lane of
    ``validation/run_gk_scenario.py:78-90`` with its gate; the variant in
    float64 against the CPU; ms a step with row G and plain (CUDA events
    around 20 steps, median of 3, in turns), device launches and peak
    memory.  Returns row G's launches on the default run."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import (
        GK_LINEAR_ITG, GK_LINEAR_ITG_JAX_F0, GK_LINEAR_ITG_RUN,
    )
    from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
    from scpn_fusion_tpu_torch.ops import cuda_gk

    errs = gk_stage_checks(dev, card)
    results["gk_rhs"] = {"max_abs_err": errs[f"{gk_cases()[0][0]} complex64"]}
    launches_default = 0
    with cpu_twin(gk_variant_on_cpu) as variant_cpu:
        for i, (label, cfg, seed) in enumerate(gk_cases()):
            g = nl.build_grids(cfg, device=dev)
            state = nl.init_state(cfg, g, seed=seed)
            # one plain step first: cuFFT's plans of this shape, outside the timed runs
            nl._rk4_step(cfg, g, nl.stage_spec(cfg, g), state,
                         nl._gram_inv(cfg, g, state.f.dtype), cuda_gk.gk_stage_plain)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ((final, trace), ms_k), calls, launched = counted(
                lambda: events_ms(lambda: nl._run(cfg, g, state)))
            peak = torch.cuda.max_memory_allocated() / 2**20
            (final_p, trace_p), ms_p = events_ms(
                lambda: nl._run(cfg, g, state, stage_fn=cuda_gk.gk_stage_plain))
            n_steps = max(cfg.n_steps // cfg.save_interval, 1) * cfg.save_interval
            entry = f"scpn_gk_stage_{'c64' if cfg.dtype == 'complex64' else 'c128'}"
            want = {name: 4 * n_steps * (name == "gk_rhs") for name in KERNELS}
            dev_f = max_rel(final.f, final_p.f)
            dev_t = max(max_rel(a, b) for a, b in zip(trace, trace_p))
            finite = bool(torch.isfinite(torch.view_as_real(final.f)).all())
            print(f"(u) run_nonlinear_gk {label}: row G {ms_k:.1f} ms ({ms_k / n_steps:.4f} ms a "
                  f"step), plain stage {ms_p:.1f} ms (once each, CUDA events); final f vs plain "
                  f"{dev_f:.3e}, traces {dev_t:.3e} (limit {GK_RUN_TOL[cfg.dtype]:.0e}); finite "
                  f"{finite}; q_ion[-1] {float(trace.q_ion[-1])!r}, phi_rms[-1] "
                  f"{float(trace.phi_rms[-1])!r}, free energy[-1] "
                  f"{float(trace.free_energy[-1])!r}, time {float(final.time)!r}; wrapper calls "
                  f"{ {k: v for k, v in calls.items() if v} }, launches {launched}; peak memory "
                  f"{peak:.1f} MiB [{card}]")
            require(finite and dev_f <= GK_RUN_TOL[cfg.dtype] and dev_t <= GK_RUN_TOL[cfg.dtype],
                    f"(u) {label}: row G's run deviates from the plain run")
            require(calls == want and launched == {entry: 4 * n_steps},
                    f"(u) {label}: {calls} / {launched}, not 4 row-G launches a step")
            by_path["gk_default" if i == 0 else "gk_spec32"] = calls
            if i == 0:
                launches_default = calls["gk_rhs"]

            def steps(stage_fn, state=final):
                spec = nl.stage_spec(cfg, g)
                gram_inv = nl._gram_inv(cfg, g, state.f.dtype)
                for _ in range(GK_TIMED_STEPS):
                    state = nl._rk4_step(cfg, g, spec, state, gram_inv, stage_fn)
                return state

            t_k, t_p = cuda_ms_pair(lambda: steps(cuda_gk.gk_stage),
                                    lambda: steps(cuda_gk.gk_stage_plain), reps=3)
            print(f"time (u) {label}: row G {t_k / GK_TIMED_STEPS:.4f} ms a step, plain stage "
                  f"{t_p / GK_TIMED_STEPS:.4f} ms a step (CUDA events around {GK_TIMED_STEPS} "
                  f"steps, median of 3, in turns) [{card}]")

        # the linear ITG lane of run_gk_scenario.py:78-90 (complex64, 60 steps)
        cfg = nl.NonlinearGKConfig(**GK_LINEAR_ITG)
        f0 = torch.from_numpy(np.load(GK_LINEAR_ITG_JAX_F0)).to(dev)
        st0 = nl.GKState(f0, torch.zeros((), dtype=torch.float32, device=dev))
        (_, tr), calls, _ = counted(lambda: nl.run_nonlinear_gk(cfg, state=st0, device=dev))
        g = nl.build_grids(cfg, device=dev)
        _, tr_p = nl._run(cfg, g, st0, stage_fn=cuda_gk.gk_stage_plain)
        ratio = float(tr.phi_rms[-1]) / max(float(tr.phi_rms[0]), 1e-30)
        dev_l = max(max_rel(a, b) for a, b in zip(tr, tr_p))
        _, tr_own = nl.run_nonlinear_gk(cfg, device=dev, **GK_LINEAR_ITG_RUN)
        ratio_own = float(tr_own.phi_rms[-1]) / max(float(tr_own.phi_rms[0]), 1e-30)
        print(f"(u) linear ITG lane (run_gk_scenario.py:78-90, from the validation's own draw, "
              f"bench_config.GK_LINEAR_ITG_JAX_F0): amplitude ratio {ratio!r} (gate > 1), traces "
              f"vs plain {dev_l:.3e}; wrapper calls {calls['gk_rhs']}; from the port's draw at "
              f"the same seed the ratio is {ratio_own!r} (the gate depends on the draw: JAX's "
              f"own draws miss it at seeds 4-7) [{card}]")
        require(ratio > 1.0 and np.isfinite(ratio), "(u): the linear ITG lane did not grow")
        require(dev_l <= GK_RUN_TOL["complex64"], "(u): the ITG lane deviates from plain")
        require(calls["gk_rhs"] == 4 * 60, f"(u): the ITG lane made {calls}")

        (card_v, ms_v), calls_v, _ = counted(lambda: events_ms(lambda: gk_variant_run(dev)))
        cpu_v = variant_cpu()
    dev_v = max(max_rel(a, torch.from_numpy(b)) for a, b in zip(card_v, cpu_v))
    print(f"(u) variant (kinetic, electromagnetic, conservative, zonal 0.05, Miller kappa 1.6 "
          f"delta 0.3; 8^4 x 4, 20 steps f64): card {ms_v:.1f} ms through row G ("
          f"{calls_v['gk_rhs']} launches) against the plain stages on the CPU: max relative "
          f"deviation of f and every trace field {dev_v:.3e} (limit "
          f"{GK_RUN_TOL['complex128']:.0e}) [{card}]")
    require(dev_v <= GK_RUN_TOL["complex128"], "(u): the variant deviates from the CPU")
    require(calls_v["gk_rhs"] == 80, f"(u): the variant made {calls_v}")

    # the timed call: stage 2 of 4 on the default run's inputs (its own stage input)
    label, cfg, seed = gk_cases()[0]
    g, spec, gram_inv, f, dt, terms = gk_stage_inputs(cfg, dev, seed)
    fin, acc = cuda_gk.gk_stage_plain(0, f, f, None, terms, dt, spec)
    terms = nl.stage_terms(cfg, g, fin, nl.field_solve(cfg, g, fin), gram_inv)
    acc_k = acc.clone()      # the kernel adds 2k into its accumulator in place at each call
    timing["gk_rhs"] = (lambda: cuda_gk.gk_stage(1, f, fin, acc_k, terms, dt, spec),
                        lambda: cuda_gk.gk_stage_plain(1, f, fin, acc, terms, dt, spec),
                        "one RK4 stage (stage 2 of 4), default 2x16x16x32x16x8 c64",
                        gk_stage_work(f, terms, spec, 1))
    return launches_default


# (v)'s lanes, by label
GK_LANES = ("solve_linear_gk (defaults: 10 k_y, 64 theta, 8 x 12 grid)",
            "the ITG fixture's 11-k_y spectrum + its rate (run_gk_growth_rates.py)",
            "tglf_native_fluxes_profile (3 surfaces, 12 k_y, SAT1)",
            "QLTransportModel.evaluate_profile (12 radii, ETG)",
            "run_local_maxwell_evolution (run_mif_frc.py lane 4: 64 steps, dt 2e-13)",
            "hybrid round: OOD, adaptive schedule, TGLF at the spots, corrector")


def gk_lane_runs(device):
    """(v)'s lanes: [(label, outputs as a tuple of tensors, extras)]; f64."""
    import json

    import torch
    from scpn_fusion_tpu_torch.models.gyrokinetics import hybrid, linear, local_dispersion
    from scpn_fusion_tpu_torch.models.gyrokinetics import maxwell_evolution as mx
    from scpn_fusion_tpu_torch.models.gyrokinetics import ql_closure, tglf_native

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)

    out = []
    lin = linear.solve_linear_gk(device=device, method="initial_value")
    out.append((t(lin.gamma), t(lin.omega_r)))
    fixtures = ROOT / "validation" / "configs" / "tglf_reference"
    itg = json.loads((fixtures / "itg_dominated.json").read_text())
    p = itg["input_parameters"]
    kw = dict(r_l_t=p["R_LT_i"], r_l_n=p["R_Ln_e"], tau=1.0, q=p["q"], device=device)
    spec = local_dispersion.solve_local_kinetic_dispersion(t(np.linspace(0.15, 0.9, 11)), **kw)
    fix = local_dispersion.solve_local_kinetic_dispersion(itg["tglf_output"]["ky_max_rho_s"],
                                                          **kw)
    out.append((spec.gamma, spec.omega_r, spec.converged.to(torch.float64), fix.gamma,
                fix.omega_r, fix.converged.to(torch.float64)))
    rho3 = np.linspace(0.3, 0.75, 3)
    prof = dict(r_l_ti=t(9.0 - 4.0 * rho3), r_l_te=t(np.full(3, 6.9)), r_l_ne=t(2.2 + rho3),
                q=t(1.0 + 2.5 * rho3**2), s_hat=t(0.4 + 1.2 * rho3), epsilon=t(rho3 / 2.78),
                te_ti=1.0, nu_star=0.1, a=1.0, b0=2.0, r0=2.78, t_i_kev=8.0)
    tg = tglf_native.tglf_native_fluxes_profile(**prof)
    out.append((tg.chi_i, tg.chi_e, tg.d_e, tg.v_e, tg.gamma, tg.gamma_net, tg.phi_sq))
    nr = 12
    rho = np.linspace(0.0, 1.0, nr)
    te = 10.0 * (1.0 - 0.9 * rho**2)
    ne = 8.0 * (1.0 - 0.6 * rho**2)
    dr = float(rho[1] - rho[0]) * 2.0
    cols = [t(c) for c in (rho, te, te, ne, 1.0 + 2.5 * rho**2, np.ones(nr), np.gradient(te, dr),
                           np.gradient(te, dr), np.gradient(ne, dr))]
    ql = ql_closure.QLTransportModel(n_modes=16, include_etg=True).evaluate_profile(
        *cols, 6.2, 2.0, 5.3)
    out.append(tuple(ql))
    mcfg = mx.MaxwellEvolutionConfig(n_steps=64, dt=2e-13)
    ev = mx.run_local_maxwell_evolution(mcfg, device=device)
    out.append((ev.total_field_energy_t, ev.a_parallel_energy_t, ev.b_parallel_energy_t))
    status = mx.to_evidence(ev, mcfg)["status"]
    # one hybrid round: OOD on the QL profile's features, an adaptive plan, the
    # native TGLF model at the planned surfaces, the corrector against QL
    feats = np.random.default_rng(SEED).standard_normal((400, 10)) * 0.5 + 1.0
    ood_p = hybrid.fit_ood(t(feats))
    x = t(feats[:nr] * 1.4)
    flags = hybrid.ood_check(x, ood_p).is_ood
    plan = hybrid.schedule_spot_checks(hybrid.SchedulerConfig(budget=4), 1, cols[0], ql[0],
                                       ql[0] * 0.4, ood_mask=flags)
    idx = plan.indices.to(torch.int64)
    gk = tglf_native.tglf_native_fluxes_profile(
        r_l_ti=t(np.full(4, 9.0)), r_l_te=6.9, r_l_ne=2.2, q=cols[4][idx], s_hat=0.8,
        epsilon=torch.clamp(cols[0][idx] * 2.0 / 6.2, min=1e-3), te_ti=1.0, nu_star=0.1,
        a=2.0, b0=5.3, r0=6.2, t_i_kev=cols[1][idx],
        cfg=tglf_native.TGLFNativeConfig(n_ky_ion=4))
    gk_fl = torch.stack([gk.chi_i, gk.chi_e, gk.d_e], dim=1)
    surr = torch.stack([ql[0][idx], ql[1][idx], ql[2][idx]], dim=1)
    corr = hybrid.corrector_update(hybrid.init_corrector(nr, device=device), cols[0],
                                   cols[0][idx], plan.valid, gk_fl, surr)
    out.append((plan.indices.to(torch.float64), plan.reasons.to(torch.float64),
                plan.valid.to(torch.float64), gk_fl, *corr))
    return [(label, o) for label, o in zip(GK_LANES, out)], {
        "lin": lin, "spec": spec, "fix": fix, "itg": itg, "maxwell": status}


def gk_lanes_on_cpu(conn) -> None:
    """(v)'s CPU twin: every lane on the CPU, and the CPU's ``eig`` growth
    rates of ``solve_linear_gk`` at its defaults, as numpy."""
    from scpn_fusion_tpu_torch.models.gyrokinetics import linear
    cpu = on_cpu(3)
    t0 = time.perf_counter()
    runs, _ = gk_lane_runs(cpu)
    ms = (time.perf_counter() - t0) * 1e3
    eig = linear.solve_linear_gk(device=cpu)
    conn.send(({label: [x.detach().numpy() for x in out] for label, out in runs}, ms,
               np.asarray(eig.gamma)))
    conn.close()


def gk_reduced_lanes(dev, card: str, counted, by_path: dict, twin) -> None:
    """(v) the reduced GK lanes in float64 on plain ops, each against the
    same call on the CPU within 1e-9 (a spawned process): the linear scan at
    its defaults on the initial-value lane (the card's gamma within 1e-3 of
    the CPU's ``eig``), the ITG spectrum and fixture rate with the gates of
    ``validation/run_gk_growth_rates.py:60-100``, the native TGLF profile,
    the QL closure's profile, the Maxwell evolution with the gate of
    ``validation/run_mif_frc.py:179-182`` and one hybrid scheduler-corrector
    round.  No kernel may launch.  ``twin`` waits for ``gk_lanes_on_cpu``'s
    results (started after the build, so that it runs while the card does)."""
    import torch

    (runs, extra), calls, _ = counted(lambda: gk_lane_runs(dev))
    _, ms = events_ms(lambda: gk_lane_runs(dev))
    cpu_runs, ms_c, eig_gamma = twin()
    require(sum(calls.values()) == 0, f"(v): a kernel launched on the reduced GK lanes: {calls}")
    by_path["gk_lanes"] = calls
    for label, out in runs:
        dev_l = max_rel(out, tuple(torch.from_numpy(a) for a in cpu_runs[label]))
        print(f"(v) {label}: max relative deviation from the CPU {dev_l:.3e} (limit "
              f"{LANE_TOL:.0e}) [{card}]")
        require(dev_l <= LANE_TOL, f"(v) {label}: the card deviates from the CPU")
    lin = extra["lin"]
    iv_eig = float(np.max(np.abs(lin.gamma - eig_gamma)))
    print(f"(v) solve_linear_gk on the card (initial-value lane): gamma max {lin.gamma_max!r}, "
          f"modes {lin.mode_type}; |gamma_IV - gamma_eig(CPU)| max {iv_eig:.3e} (limit "
          f"{GK_IV_GAMMA_TOL:.0e}: the parity matrix is Hermitian, both are round-off)")
    require(iv_eig < GK_IV_GAMMA_TOL, "(v): the IV lane misses the CPU's eig")
    spec, fix, itg = extra["spec"], extra["fix"], extra["itg"]
    gam, omr = spec.gamma.cpu().numpy(), spec.omega_r.cpu().numpy()
    growing = gam > 1e-3
    jump = float(np.max(np.abs(np.diff(gam))))
    lane1 = bool(spec.converged.all()) and bool(np.all(omr[growing] < 0.0)) and jump < GK_JUMP_MAX
    r_over_a = itg["input_parameters"]["R_major_m"] / itg["input_parameters"]["a_minor_m"]
    ratio = float(fix.gamma) * r_over_a / itg["tglf_output"]["gamma_max_cs_a"]
    lane2 = 1.0 / GK_RATE_BAND <= ratio <= GK_RATE_BAND and bool(fix.converged)
    print(f"(v) run_gk_growth_rates.py lane 1: all converged {bool(spec.converged.all())}, ion "
          f"direction where growing {bool(np.all(omr[growing] < 0.0))}, max neighbour jump "
          f"{jump:.4f} (< {GK_JUMP_MAX}), gamma max {float(gam.max())!r} c_s/R; lane 2: gamma "
          f"at k_y {itg['tglf_output']['ky_max_rho_s']} = {float(fix.gamma) * r_over_a!r} c_s/a "
          f"against the fixture's {itg['tglf_output']['gamma_max_cs_a']}, ratio {ratio:.3f} "
          f"(band {GK_RATE_BAND})")
    require(lane1 and lane2, "(v): the growth-rate campaign's gates are missed")
    print(f"(v) Maxwell evolution status {extra['maxwell']}")
    require(extra["maxwell"] == "accepted_local_source_free_maxwell_evolution",
            "(v): the Maxwell evolution's residual gate is missed")
    print(f"time (v) the reduced GK lanes: card {ms:.1f} ms (CUDA events, second run), CPU "
          f"{ms_c:.1f} ms (in its own process) [{card}]")


# ── the fifteenth slice: (w) row N's plant kinds 2 and 3 (the fueling shot,
# the TORAX-style campaign), (x) row D (the digital twin), the realtime twin
# sessions, the FPGA export's report and the directed mission, (y) the bus's
# parity oracle through row R and the three-process bus session ──

FUELING_GATES = (0.02, 0.2, 2.0)   # test_cad_fueling_torax.py:113-116: |error|, rmse, |command|
TORAX_GATES = (0.4, 0.3)           # :127-130: max beta_N rmse, max |beta_N final - 1.85|
# dependent operations a tick on the kernel's chain (every stage's longest
# path: injection, the firing sum over the places, the marking sums over the
# transitions, the action clamps and the plant), and a twin step's (the MRE
# width with its quotient, q, the danger test and the stencil of a point)
CLOSED_LOOP_DEPTH = {"fueling": 60, "torax": 70}
TWIN_DEPTH = 40
TWIN_GATE_CFG = dict(grid_size=32)   # tests/test_digital_twin.py:68-100 (32^2, 300 steps)
BUS_TICKS = 400                      # tests/test_realtime_bus.py:85-97
BUS_ORACLE_TOL = 1e-12               # tests/test_realtime_bus.py:46-49: atol, float64
SESSIONS = ("SPARC", "NSTX-U")       # twin_ingest's default sessions


def fueling_lanes(device) -> dict:
    """(w)'s float64 lanes: the fueling shot at its defaults and the TORAX-style
    campaign at its defaults (its draws from a CPU generator, so that the card
    and the CPU see the same), as numpy."""
    import torch
    from scpn_fusion_tpu_torch.control import fueling_torax as ft

    fuel = ft.run_fueling_mode(dtype=torch.float64, device=device)
    camp = ft.run_torax_hybrid_campaign(dtype=torch.float64, device=device)
    out = {f"fueling {k}": v for k, v in fuel._asdict().items()}
    out.update({f"campaign {k}": v for k, v in camp._asdict().items() if k != "within_limits"})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def fueling_lanes_on_cpu(conn) -> None:
    conn.send(fueling_lanes(on_cpu(2)))
    conn.close()


def mission_supervised(ctrl, cfg, plant0, period: int = 20):
    """The Director's supervised callable over the R/Z controller (as
    ``tests/test_torch_control_copies_4a.py`` builds it): ``period`` ticks of
    controller and reduced plant an oversight period under the current axis
    targets, the firing entropy of its last tick, a radial target 2 cm
    further in proposed."""
    import torch
    from scpn_fusion_tpu_torch.control import director as dr
    from scpn_fusion_tpu_torch.control import neuro_closed_loop as ncl
    from scpn_fusion_tpu_torch.scpn import controller as sc

    carried = {"cs": sc.initial_controller_state(ctrl, cfg), "ps": plant0}
    like = ctrl.w_in

    def step(targets, k):
        c = ctrl._replace(axis_targets=torch.tensor(targets, dtype=like.dtype, device=like.device))
        cs, ps = carried["cs"], carried["ps"]
        for t in range(period):
            cs, actions, diag = sc.controller_step(c, cfg, cs, torch.stack([ps.r, ps.z]),
                                                   k * period + t)
            ps, _ = ncl.reduced_plant_step(ps, actions, 1e-3)
        carried.update(cs=cs, ps=ps)
        err = abs(float(ps.r) - targets[0])
        snap = dr.DirectorSnapshot(stable=err < 0.25, axis_error_m=err, tick=k,
                                   brain_entropy=dr.firing_entropy(diag["firing"].cpu().numpy()))
        return snap, (targets[0] - 0.02, targets[1])

    return step


def twin_lanes(device) -> dict:
    """(x)'s float64 lanes, as numpy: the twin's default shot uncontrolled and
    under a seeded action trace (row D on the card), ``twin_ingest``'s default
    SPARC and NSTX-U sessions, ``quantization_report`` on the R/Z controller
    at Q2.14 and Q3.4, and the directed mission's log over it."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import RZ_SPECS, rz_net
    from scpn_fusion_tpu_torch.control import digital_twin as dtw
    from scpn_fusion_tpu_torch.control import director as dr
    from scpn_fusion_tpu_torch.control import fpga_export as fe
    from scpn_fusion_tpu_torch.control import twin_ingest as ti
    from scpn_fusion_tpu_torch.control.neuro_closed_loop import ReducedPlantState
    from scpn_fusion_tpu_torch.scpn import controller as sc
    from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet

    f64 = torch.float64
    out = {}
    acts = torch.tensor(np.random.default_rng(SEED).uniform(-1.0, 1.0, 200), dtype=f64,
                        device=device)
    for tag, a in (("uncontrolled", None), ("driven", acts)):
        final, trace = dtw.run_digital_twin(dtype=f64, device=device, actions=a)
        out.update({f"twin {tag} t_field": final.t_field, f"twin {tag} widths": final.island_widths,
                    **{f"twin {tag} {k}": v for k, v in trace._asdict().items()}})
    for machine in SESSIONS:
        plans, info = ti.run_realtime_twin_session(machine, dtype=f64, device=device)
        out.update({f"session {machine} {k}": v for k, v in plans._asdict().items()})
        out[f"session {machine} worst_mean_risk"] = info["worst_mean_risk"]
    ctrl = sc.build_controller(rz_net(StochasticPetriNet), dtype=f64, device=device, **RZ_SPECS)
    cfg = sc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    for bits in ((16, 14), (8, 4)):
        rep = fe.quantization_report(ctrl, cfg, fmt=fe.FixedPointFormat(*bits))
        out[f"fpga Q{bits} report"] = torch.tensor(
            [rep.max_action_dev, rep.rms_action_dev, rep.action_scale, float(rep.acceptable)],
            dtype=f64)
    plant0 = ReducedPlantState(*(torch.tensor(v, dtype=f64, device=device) for v in (6.5, 0.3)))
    director = dr.DirectorInterface(mission_supervised(ctrl, cfg, plant0),
                                    entropy_threshold=0.6, history_window=2)
    final, log = director.run_directed_mission((6.2, 0.0), n_periods=12)
    out["mission log"] = torch.tensor([[e[k] for k in sorted(e)] for e in log], dtype=f64)
    out["mission final"] = torch.tensor(final, dtype=f64)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def twin_lanes_on_cpu(conn) -> None:
    conn.send(twin_lanes(on_cpu(2)))
    conn.close()


def agree(card: dict, cpu: dict, label: str, card_name: str) -> None:
    """Every entry of two dicts of numpy results within 1e-9 relative."""
    import torch
    worst = {}
    for key, ref in cpu.items():
        worst[key] = max_rel(torch.from_numpy(np.asarray(card[key], np.float64)),
                             torch.from_numpy(np.asarray(ref, np.float64)))
    key = max(worst, key=worst.get)
    print(f"{label} f64 against the CPU ({len(worst)} results): max relative deviation "
          f"{worst[key]:.3e} ({key}; limit {LANE_TOL:.0e}) [{card_name}]")
    require(worst[key] <= LANE_TOL, f"{label}: {key} deviates from the CPU")


def closed_loop_kind_work(ctrl, n_ticks: int, episodes: int, extra_in: int,
                          extra_ops: int) -> tuple[float, float]:
    """Row N's kinds 2 and 3: :func:`closed_loop_work` of each episode, plus
    ``extra_in`` values read a tick (disturbance, noise), a third trace
    written a tick and ``extra_ops`` plant operations a tick."""
    n_bytes, n_flops = closed_loop_work(ctrl, n_ticks)
    item = ctrl.w_in.element_size()
    return (episodes * (n_bytes + item * n_ticks * (1 + extra_in)),
            episodes * (n_flops + float(extra_ops) * n_ticks))


def twin_work(n: int, steps: int, item: int) -> tuple[float, float]:
    """Row D: the geometry (r and a byte of mask a point), the actions, the
    field in and out, the widths and the traces (3 + 4 values a step) once;
    operations a step: 24 a point (q, the danger test, the stencil, the
    update) and 8 a width."""
    n_bytes = n * n * (item + 1) + steps * item + 2 * n * n * item + 8 * item + 6 * steps * item
    return float(n_bytes), float(steps * (24 * n * n + 32))


def fueling_checks(dev, card: str, counted, by_path: dict, cpu) -> None:
    """(w) row N's plant kinds 2 and 3: ``run_fueling_mode`` (3000 ticks) in
    ONE launch of kind 2 and ``run_torax_hybrid_campaign`` (16 episodes x 220
    ticks, one CTA an episode) in ONE launch of kind 3, each ``torch.equal``
    to its plain loop on the card (traces, final plant and controller state)
    in float32 and float64; the JAX tests' gates
    (``tests/test_cad_fueling_torax.py:111-139``); the float64 lanes within
    1e-9 of the CPU (``cpu`` waits for :func:`fueling_lanes_on_cpu`); times
    and both bounds of each launch."""
    import torch
    from scpn_fusion_tpu_torch.control import fueling_torax as ft
    from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
    from scpn_fusion_tpu_torch.scpn import controller as sc

    cfg = sc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    plant = ccl.FuelingPlant(target=1.0, density0=0.82, dt=1e-3)
    one = {name: int(name == "closed_loop") for name in KERNELS}
    times = {}
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        entry = f"scpn_closed_loop_{tag}"
        ctrl = ft._build_axis_controller(5000.0, dtype, dev)
        res, calls, launched = counted(lambda: ft.run_fueling_mode(dtype=dtype, device=dev))
        require(calls == one and launched == {entry: 1},
                f"(w) fueling {tag}: {calls} / {launched}, not one launch of kind 2")
        (cs_k, fin_k, tr_k), ms_k = events_ms(
            lambda: ccl.closed_loop_fueling(ctrl, cfg, plant, n_ticks=3000))
        (cs_p, fin_p, tr_p), ms_p = events_ms(
            lambda: ccl.closed_loop_fueling_plain(ctrl, cfg, plant, n_ticks=3000))
        equal = (all(torch.equal(tr_k[k], tr_p[k]) for k in tr_p) and torch.equal(fin_k, fin_p)
                 and all(torch.equal(a, b) for a, b in zip(cs_k, cs_p)))
        d = tr_k["density"]
        gates = (float(res.final_abs_error) < FUELING_GATES[0] and float(res.rmse) < FUELING_GATES[1]
                 and float(res.command_trace.abs().max()) <= FUELING_GATES[2]
                 and bool((d >= 0.0).all()) and bool(torch.isfinite(d).all()))
        print(f"(w) run_fueling_mode {tag} (3000 ticks, one launch of row N kind 2): kernel "
              f"torch.equal to the plain loop {equal} (traces, final plant and controller "
              f"state); final density {float(res.final_density)!r}, |error| "
              f"{float(res.final_abs_error)!r} (< {FUELING_GATES[0]}), rmse {float(res.rmse)!r} "
              f"(< {FUELING_GATES[1]}); gates {gates}; launches {launched}; kernel {ms_k:.4f} ms "
              f"(one call), plain loop {ms_p:.1f} ms [{card}]")
        require(equal, f"(w) fueling {tag}: the kernel differs from its plain loop")
        require(gates, f"(w) fueling {tag}: the JAX test's gates are missed")
        by_path[f"fueling_{tag}"] = calls
        if tag == "f32":
            hi, lo = (ft.run_fueling_mode(target_density=t, dtype=dtype, device=dev)
                      for t in (1.2, 0.8))
            ok = (float(hi.final_density) > float(lo.final_density)
                  and float(hi.final_abs_error) < 0.05)
            print(f"(w) fueling targets 1.2 / 0.8: final {float(hi.final_density)!r} / "
                  f"{float(lo.final_density)!r}, |error| at 1.2 {float(hi.final_abs_error)!r} "
                  f"(< 0.05): {ok}")
            require(ok, "(w) fueling: the other targets miss the JAX test's gates")
            times["fueling"] = (ctrl, ms_p, functools.partial(
                ccl.closed_loop_fueling, ctrl, cfg, plant, n_ticks=3000))

        camp, calls, launched = counted(
            lambda: ft.run_torax_hybrid_campaign(dtype=dtype, device=dev))
        require(calls == one and launched == {entry: 1},
                f"(w) campaign {tag}: {calls} / {launched}, not one launch of kind 3")
        gen = torch.Generator().manual_seed(SEED)
        amps = (0.25 + 0.5 * torch.rand(16, generator=gen, dtype=torch.float64)).to(dev, dtype)
        noise = torch.randn((16, 220, 2), generator=gen, dtype=torch.float64).to(dev, dtype)
        dist = ft.torax_disturbance(amps, 220)
        plant0 = tuple(torch.full((16,), v, dtype=dtype, device=dev)
                       for v in (1.7, 5.1, 0.95, 140.0))
        (cs_k, fin_k, tr_k), ms_k = events_ms(
            lambda: ccl.closed_loop_torax(ctrl, cfg, plant0, dist, noise))
        (cs_p, fin_p, tr_p), ms_p = events_ms(
            lambda: ccl.closed_loop_torax_plain(ctrl, cfg, plant0, dist, noise))
        equal = (all(torch.equal(tr_k[k], tr_p[k]) for k in tr_p) and torch.equal(fin_k, fin_p)
                 and all(torch.equal(a, b) for a, b in zip(cs_k, cs_p)))
        gates = (bool(camp.within_limits.all()) and float(camp.beta_rmse.max()) < TORAX_GATES[0]
                 and float((camp.beta_n_final - 1.85).abs().max()) < TORAX_GATES[1]
                 and bool(torch.isfinite(camp.risk_peak).all()))
        print(f"(w) run_torax_hybrid_campaign {tag} (16 episodes x 220 ticks, one launch of row N "
              f"kind 3, a CTA an episode): kernel torch.equal to the batched plain loop {equal}; "
              f"within limits {int(camp.within_limits.sum())} of 16, max beta_N rmse "
              f"{float(camp.beta_rmse.max())!r} (< {TORAX_GATES[0]}), max |beta_N - 1.85| "
              f"{float((camp.beta_n_final - 1.85).abs().max())!r} (< {TORAX_GATES[1]}), risk peak "
              f"max {float(camp.risk_peak.max())!r}; gates {gates}; launches {launched}; kernel "
              f"{ms_k:.4f} ms (one call), plain loop {ms_p:.1f} ms [{card}]")
        require(equal, f"(w) campaign {tag}: the kernel differs from its batched plain loop")
        require(gates, f"(w) campaign {tag}: the JAX test's gates are missed")
        by_path[f"torax_{tag}"] = calls
        if tag == "f32":
            times["torax"] = (ctrl, ms_p, functools.partial(ccl.closed_loop_torax, ctrl, cfg,
                                                             plant0, dist, noise))
    agree(fueling_lanes(dev), cpu(), "(w) the fueling shot and the campaign", card)
    for label, episodes, extra_in, extra_ops in (("fueling", 1, 0, 20), ("torax", 16, 3, 45)):
        ctrl, ms_p, run = times[label]
        n_ticks = 3000 if label == "fueling" else 220
        ms_k = cuda_ms(run)
        work = closed_loop_kind_work(ctrl, n_ticks, episodes, extra_in, extra_ops)
        b, by = bound(work)
        chain = ladder_chain_ms(n_ticks, CLOSED_LOOP_DEPTH[label])
        print(f"time (w) row N kind {2 if label == 'fueling' else 3} ({label}, f32): kernel "
              f"{ms_k:.4f} ms ({1e3 * ms_k / n_ticks:.4f} us a tick; CUDA events, median of 5), "
              f"plain loop {ms_p:.1f} ms (once), bound {b:.4g} ms ({by}: {work[0] / 1e6:.4g} MB, "
              f"{work[1] / 1e6:.4g} Mflop), dependent chain ~{chain:.4f} ms ({n_ticks} ticks x "
              f"~{CLOSED_LOOP_DEPTH[label]} dependent operations x 4 cycles at "
              f"{SM_CLOCK_HZ / 1e9:.2f} GHz, 4 barriers a tick besides); library_ms null (no "
              f"PyTorch call computes a closed loop) [{card}]")


def twin_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                measured_plain: dict, cpu) -> int:
    """(x) row D: ``run_digital_twin`` at its defaults (48^2, 200 steps) in ONE
    launch, ``torch.equal`` to its plain loop on the card in float32 and
    float64, uncontrolled and under a seeded action trace; the JAX test's
    gates at 32^2 x 300 steps through the kernel; the float64 lanes of
    :func:`twin_lanes` (the twin, ``twin_ingest``'s default SPARC and NSTX-U
    sessions, ``quantization_report``, the directed mission) within 1e-9 of
    the CPU (``cpu`` waits for :func:`twin_lanes_on_cpu`), the SPARC
    session's all-pass gate, device launches a session; no kernel on the
    sessions, the report or the mission.  Returns row D's launches on the
    default float32 shot."""
    import torch
    from scpn_fusion_tpu_torch.control import digital_twin as dtw
    from scpn_fusion_tpu_torch.control import twin_ingest as ti
    from scpn_fusion_tpu_torch.ops import cuda_twin

    cfg = dtw.TwinConfig()
    launches = 0
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        _, calls, launched = counted(lambda: dtw.run_digital_twin(dtype=dtype, device=dev))
        want = {name: int(name == "twin_shot") for name in KERNELS}
        require(calls == want and launched == {f"scpn_twin_shot_{tag}": 1},
                f"(x) twin {tag}: {calls} / {launched}, not one launch of row D")
        if tag == "f32":
            launches = calls["twin_shot"]
            by_path["twin_f32"] = calls
        r_map, mask = dtw._geometry(cfg, dtype, dev)
        acts = torch.tensor(np.random.default_rng(SEED).uniform(-1.0, 1.0, 200), dtype=dtype,
                            device=dev)
        err = 0.0
        for a in (torch.zeros(200, dtype=dtype, device=dev), acts):
            s0 = dtw.twin_init(cfg, dtype, dev)
            (sk, trk), ms_k = events_ms(lambda: cuda_twin.twin_shot(cfg, r_map, mask, s0, a))
            (sp, trp), ms_p = events_ms(lambda: cuda_twin.twin_shot_plain(cfg, r_map, mask, s0, a))
            equal = (torch.equal(sk.t_field, sp.t_field) and torch.equal(sk.island_widths,
                                                                         sp.island_widths)
                     and all(torch.equal(x, y) for x, y in zip(trk, trp)))
            err = max(err, float((sk.t_field - sp.t_field).abs().max()))
            print(f"(x) row D {tag}, 48^2 x 200 steps {'driven' if a is acts else 'uncontrolled'}: "
                  f"kernel torch.equal to the step loop {equal} (field, widths, traces); t_core "
                  f"{float(trk[0][-1])!r}, danger fraction {float(trk[2][-1])!r}; kernel "
                  f"{ms_k:.4f} ms (one call), plain loop {ms_p:.1f} ms [{card}]")
            require(equal, f"(x) row D {tag}: the kernel differs from its step loop")
            require(bool(torch.isfinite(sk.t_field).all()), "(x) row D: the field is not finite")
        if tag == "f32":
            results["twin_shot"] = {"max_abs_err": err}
            zero = torch.zeros(200, dtype=dtype, device=dev)
            s0 = dtw.twin_init(cfg, dtype, dev)
            measured_plain["twin_shot"] = events_ms(
                lambda: cuda_twin.twin_shot_plain(cfg, r_map, mask, s0, zero))[1]
            shot = (cfg, r_map, mask, s0, zero)
            timing["twin_shot"] = (functools.partial(cuda_twin.twin_shot, *shot),
                                   functools.partial(cuda_twin.twin_shot_plain, *shot),
                                   "digital twin 48^2 x 200 steps f32", twin_work(48, 200, 4))

    gate_cfg = dtw.TwinConfig(**TWIN_GATE_CFG)
    final, base = dtw.run_digital_twin(gate_cfg, n_steps=300, device=dev)
    _, mask32 = dtw._geometry(gate_cfg, torch.float32, dev)
    driven = dtw.run_digital_twin(gate_cfg, n_steps=300, actions=dtw.avoidance_action_trace(
        gate_cfg, 300, gain=1.0, device=dev))[1]
    gates = (bool(torch.isfinite(final.t_field).all()) and float(base.t_core[-1]) > 0.0
             and 0.0 <= float(base.danger_fraction[-1]) <= 1.0
             and float(final.t_field[~mask32].abs().max()) == 0.0
             and float(driven.danger_fraction[-1]) < float(base.danger_fraction[-1]))
    print(f"(x) the JAX test's gates (32^2 x 300 steps, row D): t_core {float(base.t_core[-1])!r} "
          f"> 0, zero outside the plasma, danger fraction driven "
          f"{float(driven.danger_fraction[-1])!r} < uncontrolled "
          f"{float(base.danger_fraction[-1])!r}: {gates}")
    require(gates, "(x): the digital twin misses the JAX test's gates")

    (card64, ms64), calls, _ = counted(lambda: events_ms(lambda: twin_lanes(dev)))
    want = {name: 2 * (name == "twin_shot") for name in KERNELS}
    require(calls == want, f"(x): the f64 lanes made {calls}, not row D's two shots alone")
    by_path["twin_lanes_f64"] = calls
    agree(card64, cpu(), "(x) the twin, the SPARC and NSTX-U sessions, the FPGA report and the "
          "directed mission", card)
    print(f"time (x) the float64 lanes on the card: {ms64:.1f} ms (CUDA events) [{card}]")
    acts = card64["mission log"][:, 0]     # sorted keys: approved first
    print(f"(x) directed mission over the R/Z controller: approvals {int(acts.sum())} of "
          f"{len(acts)}, final targets {card64['mission final'].tolist()}")
    require(0 < acts.sum() < len(acts), "(x): the directed mission approved all or nothing")

    for machine in SESSIONS:
        (_, info), calls, _ = counted(lambda: ti.run_realtime_twin_session(machine, device=dev))
        require(sum(calls.values()) == 0, f"(x) session {machine}: a kernel launched: {calls}")
        by_path[f"session_{machine}"] = calls
        n_launch, (_, ms_s) = device_launches(
            lambda: events_ms(lambda: ti.run_realtime_twin_session(machine, device=dev)))
        print(f"(x) run_realtime_twin_session {machine} f32 (320 samples, {info['n_plans']} plan "
              f"points x 24 horizon ticks, the plan points one batch): all-pass rate "
              f"{float(info['all_pass_rate'])!r}, worst mean risk "
              f"{float(info['worst_mean_risk'])!r}, min safe-horizon rate "
              f"{float(info['min_safe_horizon_rate'])!r}; {n_launch} device launches a session "
              f"(plain ops; profiled run {ms_s:.1f} ms) [{card}]")
        if machine == "SPARC":
            require(float(info["all_pass_rate"]) == 1.0 and info["chaos_dropouts"] == 0,
                    "(x): the chaos-free SPARC session does not pass every plan")

    s0 = dtw.twin_init(cfg, torch.float32, dev)
    r_map, mask = dtw._geometry(cfg, torch.float32, dev)
    zero = torch.zeros(200, dtype=torch.float32, device=dev)
    ms_k = cuda_ms(lambda: cuda_twin.twin_shot(cfg, r_map, mask, s0, zero))
    work = twin_work(48, 200, 4)
    b, by = bound(work)
    print(f"time (x) row D (48^2 x 200 steps, f32): kernel {ms_k:.4f} ms ({1e3 * ms_k / 200:.3f} "
          f"us a step; median of 5), plain loop {measured_plain['twin_shot']:.1f} ms (once), bound "
          f"{b:.4g} ms ({by}: {work[0] / 1e6:.4g} MB, {work[1] / 1e6:.4g} Mflop), dependent "
          f"chain ~{ladder_chain_ms(200, TWIN_DEPTH):.4f} ms (200 steps x ~{TWIN_DEPTH} "
          f"dependent operations x 4 cycles, 2 barriers a step besides); library_ms null (no "
          f"PyTorch call computes a twin step) [{card}]")
    return launches


# ── the sixteenth slice: (z) row B, the Newcomb field-line kernel, with the
# ballooning and EPED tiers, (za) the plasma controllers, RMF, the converters
# and the HIL latency lanes, (zb) rt-EFIT at 129^2 and the control room ──

BALLOONING_GEOMETRY = dict(r0=1.67, a=0.67, rho=0.95, kappa=1.74, delta=0.3, q=5.7)  # test_ballooning.py:145
EPED_DIIID = dict(n_ped_1e19=6.0, r0=1.67, a=0.67, b0=2.1, kappa=1.74)   # test_ballooning.py:188-192
EPED_IP_MA = (0.5, 1.0, 1.5)
EPED_P_KPA = 13.0            # the EPED1 point of tests/test_ballooning.py:196-198
# operations a step of row B that the function needs.  On every line: w, f
# and g depend on (s, alpha, theta) alone, so they are made at the step's
# three theta values only (k2 and k3 share t + h/2): 8 each circular, 13
# Miller (with the floor's max); the four u2 / f and g u1 (a negation is an
# operand modifier, not counted); the stage inputs of k2, k3 and k4 (12);
# the RK4 combination (14); the minimum.  Once a step for all lines: the
# three theta values' coefficients (a sin, cos, rint or division counted as
# one).  And the dependent operations a step on a line's chain (four
# right-hand sides of ~8 with their division, the final combination): a
# count, not a bound, for an IEEE division takes tens of cycles.
NEWCOMB_OPS = {"circular": (59, 8), "miller": (74, 83)}
NEWCOMB_DEPTH = {"circular": 33, "miller": 37}
HIL_GATES = (2000.0, 5000.0, 100.0)   # run_control_latency.py:74, :99, :120: p50, p50, mean us
EFIT_GRID = dict(NR=129, NZ=129, R_min=4.5, R_max=8.5, Z_min=-2.5, Z_max=2.5)  # test_realtime_efit.py:33-34 at 129^2
EFIT_BUILD = dict(r_axis=6.5, a_minor=1.6, kappa=1.5)
EFIT_COEFFS = (1.2e6, -0.3e6, 0.1e6, 0.5e6, 0.0, 0.0)      # test_realtime_efit.py:55-56
EFIT_COILS = (1e5, -2e5, -2e5, 1e5)
ROOM_TOL = 1e-5              # the control room, float32: of max |z|; absolute on the frames


def newcomb_cases(dtype, device) -> dict:
    """Row B's two timed shapes, as the entry points give them: the scan of
    ``tests/test_ballooning.py:75-80`` (10 shears x 48 alphas, 4000 steps,
    circular) and the DIII-D bootstrap path (65 points, 2000 steps, Miller):
    op -> (s, alpha, tables, n_steps, label)."""
    import torch
    from scpn_fusion_tpu_torch.core.grid import linspace
    from scpn_fusion_tpu_torch.models.physics import ballooning as bal

    s_vals = torch.tensor(np.linspace(0.2, 2.0, 10), dtype=dtype, device=device)
    s, a, _ = bal._lines(s_vals[:, None], linspace(0.0, 5.0, 48, dtype, device)[None, :],
                         dtype, device)
    alphas = linspace(0.0, 16.0, 65, dtype, device)
    s_eff = torch.tensor(2.04, dtype=dtype, device=device) - torch.tensor(
        3.0, dtype=dtype, device=device) * alphas
    tables = bal._miller_coefficients(**BALLOONING_GEOMETRY, n_theta=256, dtype=dtype,
                                      device=device)
    return {"circular": (s, a, None, 4000, "scan 10 x 48 lines x 4000 steps"),
            "miller": (s_eff.contiguous(), alphas, tables, 2000,
                       "DIII-D bootstrap path 65 lines x 2000 steps")}


def newcomb_work(op: str, n_lines: int, n_steps: int, item: int, n_tab: int = 513):
    """Row B: (bytes, operations, peak rate): s and alpha read and min xi
    written once a line, the Miller tables once; the operations of
    :data:`NEWCOMB_OPS`."""
    per_line, shared = NEWCOMB_OPS[op]
    n_bytes = 3 * n_lines * item + (7 * n_tab * item if op == "miller" else 0)
    return (float(n_bytes), float(n_steps * (per_line * n_lines + shared)),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def ballooning_lanes(device, min_xi: dict | None = None, tiers: dict | None = None) -> dict:
    """(z)'s float64 results as numpy: min xi of both timed shapes, and the
    s-alpha and shaped EPED tiers at the DIII-D inputs and 0.5, 1.0, 1.5 MA.
    ``min_xi`` (op -> min xi of both shapes) and ``tiers`` (Ip -> (shaped,
    s-alpha)) hold results already made on ``device``, which are not made
    again."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import ballooning as bal
    from scpn_fusion_tpu_torch.models.physics import edge
    from scpn_fusion_tpu_torch.ops import cuda_ballooning as cbal

    f64, tiers = torch.float64, tiers or {}
    if min_xi is None:
        min_xi = {op: cbal.newcomb_min_xi(op, s, a, tables, bal.THETA_MAX, n_steps)
                  for op, (s, a, tables, n_steps, _) in newcomb_cases(f64, device).items()}
    out = {f"min xi {op}": v for op, v in min_xi.items()}
    for ip in EPED_IP_MA:
        sh, sa = tiers[ip] if ip in tiers else (
            edge.eped_pedestal_shaped(**EPED_DIIID, ip_ma=ip, dtype=f64, device=device),
            edge.eped_pedestal(**EPED_DIIID, ip_ma=ip, dtype=f64, device=device))
        out.update({f"shaped {ip} {k}": v for k, v in sh.pedestal._asdict().items()})
        out.update({f"s-alpha {ip} {k}": v for k, v in sa._asdict().items()})
        out[f"shaped {ip} alphas"] = torch.stack([sh.alpha_crit, sh.alpha_ballooning,
                                                  sh.alpha_peeling, sh.second_access.to(f64)])
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def control_4b_lanes(device) -> dict:
    """(za)'s float64 lanes as numpy: the detachment loop (200 ticks), the RMF
    spin-up (20,000 ticks) at the default and a synchronising amplitude, the
    PLL (5000 ticks) and its drifting target (8000), a seeded command
    sequence through the DAC and ``sensor_vote`` on an even count."""
    import torch
    from scpn_fusion_tpu_torch.control import hil_sensors as hs
    from scpn_fusion_tpu_torch.control import plasma_controllers as pc
    from scpn_fusion_tpu_torch.control import rmf

    f64, out = torch.float64, {}
    final, f_rad, q_t = pc.run_detachment_loop(pc.DetachmentControllerParams(), p_sol_mw=100.0,
                                               n_u_19=3.0, dtype=f64, device=device)
    out.update({"detachment f_rad": f_rad, "detachment q_target": q_t,
                "detachment integral": final.integral})
    for tag, kw in (("default", {}), ("8 mT", dict(b_rmf_mt=8.0))):
        tr = rmf.run_rmf_spinup(rmf.RMFParams(**kw), dtype=f64, device=device)
        out.update({f"rmf {tag} omega": tr.omega_e_hz, f"rmf {tag} sync": tr.sync_fraction,
                    f"rmf {tag} duty": tr.drive_efficiency})
    for tag, pll, kw in (("default", {}, {}), ("drift", dict(n_steps=8000),
                                               dict(freq_drift_hz_s=2e5))):
        tr = rmf.run_phase_lock(rmf.PLLParams(**pll), dtype=f64, device=device, **kw)
        out.update({f"pll {tag} error": tr.phase_error, f"pll {tag} freq": tr.antenna_freq_hz,
                    f"pll {tag} lock": torch.stack([tr.lock_time_s, tr.locked.to(f64)])})
    cmds = torch.tensor(np.random.default_rng(SEED).uniform(-15.0, 15.0, (400, 4)), dtype=f64)
    cmds[50:60, 1] = float("nan")
    state, applied = hs.converter_loop(cmds.to(device), dt_us=0.05)
    out.update({"dac applied": applied, "dac faults": state.faults.to(f64)})
    readings = torch.tensor([1.0, 1.05, 0.97, 50.0, float("nan"), 1.2, 0.99], dtype=f64,
                            device=device)
    rep = pc.sensor_vote(readings, torch.full((7,), 0.1, dtype=f64, device=device))
    out["vote"] = torch.cat([rep.healthy.to(f64), rep.fused_estimate[None],
                             rep.degraded.to(f64)[None]])
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def efit_layout():
    from scpn_fusion_tpu_torch.control.realtime_efit import MagneticsLayout
    loops = tuple((r, z) for r in (4.0, 9.0) for z in (-3.5, 0.0, 3.5))
    probes = tuple((r, z, d) for (r, z) in ((3.8, -2.0), (3.8, 2.0), (9.2, 0.0), (6.5, 4.0),
                                            (6.5, -4.0)) for d in ("R", "Z"))
    return MagneticsLayout(flux_loops=loops, b_probes=probes, coil_r=(3.5, 9.5, 9.5, 3.5),
                           coil_z=(4.5, 2.5, -2.5, -4.5))


def efit_model(device):
    """(zb)'s rt-EFIT model in float64: the JAX test's layout at 129^2."""
    import torch
    from scpn_fusion_tpu_torch.control import realtime_efit as ef
    from scpn_fusion_tpu_torch.core.grid import Grid

    return ef.build_efit_model(Grid(**EFIT_GRID, dtype=torch.float64,
                                    device=torch.device(device)), efit_layout(), **EFIT_BUILD)


def efit_lanes(model) -> dict:
    """(zb)'s rt-EFIT lane as numpy: ``model`` (:func:`efit_model`) and the
    round trip of its coefficients on its device."""
    import torch
    from scpn_fusion_tpu_torch.control import realtime_efit as ef

    f64, device = torch.float64, model.basis_ip.device
    coeffs = torch.tensor(EFIT_COEFFS, dtype=f64, device=device)
    coils = torch.tensor(EFIT_COILS, dtype=f64, device=device)
    meas = ef.synthetic_measurements(model, coeffs, coils)
    res = ef.reconstruct(model, meas, coils, model.basis_ip @ coeffs)
    out = {f"model {k}": v for k, v in model._asdict().items()}
    out.update({f"reconstruct {k}": v for k, v in res._asdict().items()})
    out["measurements"] = meas
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def room_lane(device) -> dict:
    """(zb)'s default control-room session (200 steps, 60^2, seed 42), float32,
    as numpy."""
    from scpn_fusion_tpu_torch.control.control_room import run_control_room_session

    trace, summary = run_control_room_session(device=device)
    out = {k: v.detach().cpu().numpy() for k, v in trace._asdict().items()}
    out.update({k: v.detach().cpu().numpy() for k, v in summary.items()})
    return out


def slice16_on_cpu(conn) -> None:
    """The CPU twins of (z), (za) and (zb)."""
    dev = on_cpu(4)
    conn.send({"z": ballooning_lanes(dev), "za": control_4b_lanes(dev),
               "zb": efit_lanes(efit_model(dev)),
               "room": room_lane(dev)})
    conn.close()


def ballooning_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                      measured_plain: dict, twin: dict) -> int:
    """(z) row B: ``second_stability_scan`` of the JAX test and the DIII-D
    bootstrap path each in ONE launch, and row B ``torch.equal`` to its plain
    twin on both shapes in float32 and float64; the gates of
    ``tests/test_ballooning.py`` (but the ``stability_mhd`` eigen lane) on the
    card in float64, counted; the EPED tiers at 1.0 MA with that test's gates;
    the float64 lanes within 1e-9 of the CPU (``twin``: the results of
    :func:`slice16_on_cpu`).  Returns row B's launches over the gates."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import ballooning as bal
    from scpn_fusion_tpu_torch.models.physics import edge
    from scpn_fusion_tpu_torch.ops import cuda_ballooning as cbal

    one = {name: int(name == "newcomb_min_xi") for name in KERNELS}
    min_xi = {}              # the f64 kernel's results, for the comparison with the CPU
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        entry = f"scpn_newcomb_{tag}"
        s_vals = torch.tensor(np.linspace(0.2, 2.0, 10), dtype=dtype, device=dev)
        _, calls, launched = counted(lambda: bal.second_stability_scan(s_vals, alpha_max=5.0,
                                                                       n_alpha=48))
        require(calls == one and launched == {entry: 1},
                f"(z) scan {tag}: {calls} / {launched}, not one launch of row B")
        by_path[f"ballooning_scan_{tag}"] = calls
        _, calls, launched = counted(lambda: bal.bootstrap_path_alpha_crit(
            2.04, 3.0, alpha_hi=16.0, n_steps=2000, dtype=dtype, device=dev,
            **BALLOONING_GEOMETRY))
        require(calls == one and launched == {entry: 1},
                f"(z) bootstrap path {tag}: {calls} / {launched}, not one launch of row B")
        by_path[f"bootstrap_path_{tag}"] = calls
        for op, (s, a, tables, n_steps, label) in newcomb_cases(dtype, dev).items():
            args = (op, s, a, tables, bal.THETA_MAX, n_steps)
            k, ms_k = events_ms(functools.partial(cbal.newcomb_min_xi, *args))
            p, ms_p = events_ms(functools.partial(cbal.newcomb_min_xi_plain, *args))
            equal = torch.equal(k, p)
            print(f"(z) row B {tag} {op}, {label}: kernel torch.equal to the plain RK4 loop "
                  f"{equal}; stable lines {int((k > 0).sum())} of {k.numel()}, min xi in "
                  f"[{float(k.min())!r}, {float(k.max())!r}]; kernel {ms_k:.4f} ms (one call), "
                  f"plain loop {ms_p:.1f} ms [{card}]")
            require(equal, f"(z) row B {tag} {op}: the kernel differs from its plain loop")
            require(bool(torch.isfinite(k).all()), f"(z) row B {tag} {op}: a min xi not finite")
            if tag == "f64":
                min_xi[op] = k
            if tag == "f64" and op == "circular":
                results["newcomb_min_xi"] = {"max_abs_err": float((k - p).abs().max())}
                measured_plain["newcomb_min_xi"] = ms_p
                timing["newcomb_min_xi"] = (
                    functools.partial(cbal.newcomb_min_xi, *args),
                    functools.partial(cbal.newcomb_min_xi_plain, *args), f"{label} f64",
                    newcomb_work(op, s.numel(), n_steps, 8))

    def gates():
        f64 = torch.float64
        lin = functools.partial(torch.linspace, dtype=f64, device=dev)
        out = {"traversal": bal.ballooning_stable(0.5, torch.tensor(
            [0.1, 0.8, 3.5], dtype=f64, device=dev)).tolist() == [True, False, True]}
        band = bal.second_stability_scan(torch.tensor(np.linspace(0.1, 2.0, 8), dtype=f64,
                                                      device=dev), alpha_max=5.0, n_alpha=48)
        a1, a2 = band.alpha_crit_first, band.alpha_crit_second
        out["band"] = bool(band.second_access.all() and (a1 > 0).all() and (a2 > a1).all()
                           and (a2 <= 5.0).all())
        mono = bal.second_stability_scan(torch.tensor(np.linspace(0.25, 2.0, 8), dtype=f64,
                                                      device=dev), alpha_max=5.0, n_alpha=48)
        out["non-decreasing"] = bool((torch.diff(mono.alpha_crit_first) >= -1e-12).all())
        helper = bal.second_stability_scan(torch.tensor(np.linspace(0.2, 2.0, 10), dtype=f64,
                                                        device=dev), alpha_max=5.0, n_alpha=48)
        lo, mid, hi = (float(helper.alpha_crit_at(x)) for x in (0.2, 1.1, 2.0))
        out["helpers"] = lo <= mid <= hi and bool(helper.has_second_stability_at(0.5))
        a_ch = float(bal.marginal_alpha(1.0, alpha_hi=2.0, dtype=f64, device=dev))
        out[f"Connor-Hastie {a_ch:.6f}"] = 0.45 < a_ch < 0.75
        scan = bal.second_stability_scan(torch.tensor([0.8], dtype=f64, device=dev),
                                         alpha_max=5.0, n_alpha=96)
        a_bis = float(bal.marginal_alpha(0.8, alpha_hi=2.0, dtype=f64, device=dev))
        out["bisection vs scan"] = abs(float(scan.alpha_crit_first[0]) - a_bis) <= 2 * 5.0 / 95
        s3, al = torch.tensor([0.5, 1.0, 2.0], dtype=f64, device=dev)[:, None], lin(0.0, 3.0, 25)
        out["thin tube"] = bool(torch.equal(bal.ballooning_stable(s3, al[None]),
                                            bal.miller_ballooning_stable(s3, al[None], rho=1e-4)))
        acs = [float(bal.miller_marginal_alpha(1.0, r0=3.0, a=1.0, rho=0.9, kappa=k, delta=0.0,
                                               q=3.0, dtype=f64, device=dev))
               for k in (1.0, 1.4, 1.8)]
        out["elongation"] = acs[0] < acs[1] < acs[2]
        a81 = torch.tensor(np.linspace(0.0, 8.0, 81), dtype=f64, device=dev)

        def band_of(delta, s):
            un = ~bal.miller_ballooning_stable(torch.tensor(s, dtype=f64, device=dev), a81,
                                               rho=0.9, kappa=1.8, delta=delta, q=3.0).cpu()
            idx = torch.nonzero(un).flatten()
            return None if idx.numel() == 0 else (float(a81[idx[0]]), float(a81[idx[-1]]))

        pt, nt, circ = band_of(0.4, 0.5), band_of(-0.4, 1.0), band_of(0.0, 1.0)
        out["triangularity"] = pt is None and nt is not None and circ is not None and \
            nt[1] > circ[1]
        geo = dict(BALLOONING_GEOMETRY, n_steps=2000, dtype=f64, device=dev)
        strong = bal.bootstrap_path_alpha_crit(2.04, 3.0, alpha_hi=16.0, **geo)
        weak = bal.bootstrap_path_alpha_crit(2.04, 1.5, alpha_hi=16.0, **geo)
        zero = bal.bootstrap_path_alpha_crit(2.04, 0.0, alpha_hi=8.0, n_grid=65, **geo)
        fixed = float(bal.miller_marginal_alpha(2.04, alpha_hi=8.0, n_grid=65, **geo))
        out["bootstrap strong / weak / zero"] = (
            bool(strong.second_access) and float(strong.alpha_crit) == 16.0
            and not bool(weak.second_access) and 0.0 < float(weak.alpha_crit) < 2.0
            and abs(float(zero.alpha_crit) - (fixed - 8.0 / 64.0)) < 1e-9)
        return out

    # 4 scans, 24 + 1 + 24 for the two marginal gates, 2 thin tube, 3
    # elongation, 3 triangularity, 3 paths + 1 fixed-shear scan
    (out, ms_gates), calls, launched = counted(lambda: events_ms(gates))
    want = {name: 65 * (name == "newcomb_min_xi") for name in KERNELS}
    print(f"(z) the gates of tests/test_ballooning.py on the card (f64): {out}; row B launches "
          f"{launched}; {ms_gates:.1f} ms (CUDA events) [{card}]")
    require(all(out.values()), "(z): the port misses a gate of tests/test_ballooning.py")
    require(calls == want and launched == {"scpn_newcomb_f64": 65},
            f"(z) gates: {calls} / {launched}, not 65 launches of row B")
    by_path["ballooning_gates_f64"] = calls
    launches = calls["newcomb_min_xi"]

    salpha = edge.eped_pedestal(**EPED_DIIID, ip_ma=1.0, dtype=torch.float64, device=dev)
    shaped, calls, _ = counted(lambda: edge.eped_pedestal_shaped(**EPED_DIIID, ip_ma=1.0,
                                                                 dtype=torch.float64, device=dev))
    t_s, t_sh, p_sh = (float(salpha.t_ped_kev), float(shaped.pedestal.t_ped_kev),
                       float(shaped.pedestal.p_ped_kpa))
    gates = (t_s <= 0.1 + 1e-9 and bool(shaped.second_access) and t_sh > 0.3
             and EPED_P_KPA / 3.0 < p_sh < EPED_P_KPA * 3.0)
    print(f"(z) EPED at the DIII-D inputs, 1.0 MA, f64: s-alpha T_ped {t_s!r} keV (the 0.1 keV "
          f"floor), shaped T_ped {t_sh!r} keV, p_ped {p_sh!r} kPa (in ({EPED_P_KPA / 3:.3f}, "
          f"{EPED_P_KPA * 3:.1f})), alpha_crit {float(shaped.alpha_crit)!r} (ballooning "
          f"{float(shaped.alpha_ballooning)!r}, peeling {float(shaped.alpha_peeling)!r}), second "
          f"access {bool(shaped.second_access)}; gates {gates}; row B launches "
          f"{calls['newcomb_min_xi']} [{card}]")
    require(gates, "(z): the EPED tiers miss the gates of tests/test_ballooning.py:184-198")
    require(calls == one, f"(z) shaped EPED: {calls}, not one launch of row B")
    by_path["eped_shaped_f64"] = calls
    agree(ballooning_lanes(dev, min_xi, {1.0: (shaped, salpha)}), twin["z"],
          "(z) row B's min xi and the EPED tiers at 0.5, 1.0 and 1.5 MA", card)

    for op, (s, a, tables, n_steps, label) in newcomb_cases(torch.float64, dev).items():
        run = functools.partial(cbal.newcomb_min_xi, op, s, a, tables, bal.THETA_MAX, n_steps)
        ms_k = cuda_ms(run)
        work = newcomb_work(op, s.numel(), n_steps, 8)
        b, by = bound(work)
        chain = ladder_chain_ms(n_steps, NEWCOMB_DEPTH[op])
        print(f"time (z) row B {op} ({label}, f64): kernel {ms_k:.4f} ms ({1e3 * ms_k / n_steps:.4f}"
              f" us a step; CUDA events, median of 5), bound {b:.4g} ms ({by}: "
              f"{work[0] / 1e6:.4g} MB, {work[1] / 1e6:.4g} Mflop); a line's dependent "
              f"operations {n_steps * NEWCOMB_DEPTH[op]} ({n_steps} steps x ~{NEWCOMB_DEPTH[op]}), "
              f"~{chain:.4f} ms at a nominal 4 cycles each and {SM_CLOCK_HZ / 1e9:.2f} GHz (a "
              f"count, not a bound: the step's four IEEE f64 divisions on the chain take tens "
              f"of cycles each); library_ms null (no PyTorch call integrates an ODE) [{card}]")
    return launches


def hil_lanes(dev, card: str, counted, by_path: dict) -> None:
    """(za)'s latency lanes, as ``validation/run_control_latency.py:60-130``
    runs them, through the port's ``control.hil``: the PID step's
    synchronous dispatch, the SCPN controller tick pipelined (batches of 20),
    and the fused closed loop (``run_neuro_closed_loop``, 10,000 ticks: one
    launch of row N a call), each with the validation's gate."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import RZ_SPECS, rz_net
    from scpn_fusion_tpu_torch.control import hil
    from scpn_fusion_tpu_torch.control.neuro_closed_loop import (
        ReducedPlantState, run_neuro_closed_loop,
    )
    from scpn_fusion_tpu_torch.control.pid import PIDGains, pid_init, pid_step
    from scpn_fusion_tpu_torch.scpn import controller as sc
    from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet

    f32 = torch.float32
    gains = PIDGains(kp=1.0, ki=0.2, kd=0.05)
    ctrl = sc.build_controller(rz_net(StochasticPetriNet), dtype=f32, device=dev, **RZ_SPECS)
    cfg = sc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)

    def dispatch_lanes():
        pid = hil.measure_dispatch_latency(
            lambda s, e: pid_step(gains, s, e),
            (pid_init(device=dev), torch.tensor(0.1, device=dev)), n_samples=100)
        tick = hil.measure_dispatch_latency(
            lambda s, o: sc.controller_step(ctrl, cfg, s, o, 0),
            (sc.initial_controller_state(ctrl, cfg),
             torch.tensor([6.4, 0.1], dtype=f32, device=dev)), n_samples=100, pipelined=True)
        return pid, tick

    (rep1, rep2), calls, _ = counted(dispatch_lanes)
    require(sum(calls.values()) == 0, f"(za) dispatch lanes: a kernel launched: {calls}")
    by_path["hil_dispatch"] = calls
    plant0 = ReducedPlantState(torch.tensor(6.5, dtype=f32, device=dev),
                               torch.tensor(0.3, dtype=f32, device=dev))
    rep3, calls, launched = counted(lambda: hil.measure_fused_throughput(
        lambda: run_neuro_closed_loop(ctrl, cfg, plant0, n_ticks=10_000, dt=1e-3), (),
        n_ticks=10_000, n_repeats=3))
    want = {name: 4 * (name == "closed_loop") for name in KERNELS}
    for label, rep, gate, key in (("pid_step dispatch", rep1, HIL_GATES[0], "p50_us"),
                                  ("SCPN tick, pipelined", rep2, HIL_GATES[1], "p50_us"),
                                  ("fused closed loop, 10,000 ticks (row N)", rep3, HIL_GATES[2],
                                   "mean_us")):
        print(f"(za) HIL {label}: p50 {rep.p50_us:.3f} us, p95 {rep.p95_us:.3f} us, p99 "
              f"{rep.p99_us:.3f} us, mean {rep.mean_us:.3f} us ({rep.n_samples} samples; "
              f"{key} < {gate:.0f}), rate at p95 {hil.control_rate_hz(rep):.4g} Hz [{card}]")
        require(getattr(rep, key) < gate, f"(za) HIL {label}: {key} over the validation's gate")
    require(calls == want and launched == {"scpn_closed_loop_f32": 4},
            f"(za) fused lane: {calls} / {launched}, not one launch of row N a call")
    by_path["hil_fused"] = calls


def control_4b_checks(dev, card: str, counted, by_path: dict, twin: dict) -> None:
    """(za) the detachment, RMF, PLL and converter loops and ``sensor_vote``
    in float64 on plain ops (no kernel) within 1e-9 of the CPU; the JAX
    tests' gates of the loops' defaults; then the HIL lanes (``twin``: the
    results of :func:`slice16_on_cpu`)."""
    (card64, ms), calls, _ = counted(lambda: events_ms(lambda: control_4b_lanes(dev)))
    require(sum(calls.values()) == 0, f"(za): a kernel launched on the plain loops: {calls}")
    by_path["controllers_f64"] = calls
    agree(card64, twin["za"], "(za) detachment, RMF, PLL, DAC and sensor vote", card)
    gates = (float(card64["rmf 8 mT sync"]) > 0.85 and not float(card64["rmf default sync"]) > 0.85
             and float(card64["pll default lock"][1]) == 1.0
             and float(card64["pll default lock"][0]) < 0.05
             and abs(float(card64["pll default freq"][-1]) - 95e3) < 2e3
             and float(card64["pll drift lock"][1]) == 1.0
             and card64["vote"][:7].tolist() == [1, 1, 1, 0, 0, 1, 1])
    print(f"(za) gates: RMF 8 mT sync {float(card64['rmf 8 mT sync'])!r} (> 0.85), default "
          f"{float(card64['rmf default sync'])!r}; PLL lock time "
          f"{float(card64['pll default lock'][0])!r} s (< 0.05), final "
          f"{float(card64['pll default freq'][-1])!r} Hz; detachment f_rad final "
          f"{float(card64['detachment f_rad'][-1])!r}; vote healthy "
          f"{card64['vote'][:7].tolist()}, fused {float(card64['vote'][7])!r}: {gates}; the "
          f"float64 lanes {ms:.1f} ms (CUDA events; plain loops: RMF 20,000 ticks x 2, PLL "
          f"5000 + 8000 ticks) [{card}]")
    require(gates, "(za): the loops miss the JAX tests' gates")
    hil_lanes(dev, card, counted, by_path)


def room_and_efit_checks(dev, card: str, counted, by_path: dict, psi_513, twin: dict) -> None:
    """(zb) rt-EFIT on the JAX test's layout at 129^2 in float64 (the build
    once, then the round trip, on plain ops) within 1e-9 of the CPU, with the
    gates of ``tests/test_realtime_efit.py``; the default control-room
    session in float32 against the CPU at 1e-5 (of max |z|; absolute on the
    frames) with its summary's gates; the kernel-backed psi lane on the
    513^2 FMG result's psi (kernels 2-5, solved once earlier) at size 513."""
    import torch
    from scpn_fusion_tpu_torch.control import control_room as cr
    from scpn_fusion_tpu_torch.control import realtime_efit as ef

    f64 = torch.float64

    def efit_run():
        model, ms = events_ms(lambda: efit_model(dev))
        return model, ms, efit_lanes(model)

    (model, ms_build, card_efit), calls, _ = counted(efit_run)
    require(sum(calls.values()) == 0, f"(zb) rt-EFIT: a kernel launched: {calls}")
    by_path["efit_129"] = calls
    agree(card_efit, twin["zb"], "(zb) rt-EFIT 129^2: the model and a round trip", card)
    ip_true = float(card_efit["model basis_ip"] @ np.asarray(EFIT_COEFFS))
    ip_rel = abs(float(card_efit["reconstruct ip_reconstructed"]) - ip_true) / abs(ip_true)
    resid = float(card_efit["reconstruct residual_norm"])
    meas_norm = float(np.linalg.norm(card_efit["measurements"]))
    gates = (ip_rel < 0.05 and resid < 0.03 * meas_norm
             and np.isfinite(card_efit["model basis_maps"]).all())
    print(f"(zb) rt-EFIT 129^2 f64 round trip: Ip relative error {ip_rel!r} (< 0.05), residual "
          f"{resid!r} (< 0.03 x {meas_norm!r}), axis ({float(card_efit['reconstruct axis_r'])!r}, "
          f"{float(card_efit['reconstruct axis_z'])!r}) m; gates {gates} [{card}]")
    require(gates, "(zb): rt-EFIT misses the gates of tests/test_realtime_efit.py")
    coils = torch.tensor(EFIT_COILS, dtype=f64, device=dev)
    meas = torch.from_numpy(card_efit["measurements"]).to(dev)
    ip = torch.tensor(ip_true, dtype=f64, device=dev)
    run = functools.partial(ef.reconstruct, model, meas, coils, ip)
    ms_rec = cuda_ms(run)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        run()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    n_launch, _ = device_launches(run)
    print(f"time (zb) rt-EFIT 129^2 f64: build {ms_build:.1f} ms (once, CUDA events, in the "
          f"counted run above); "
          f"reconstruct {ms_rec:.4f} ms (CUDA events, median of 5), {host_us:.1f} us a call on "
          f"the host clock over 50 calls, {n_launch} device launches a call [{card}]")

    # one session gives the comparison, the wrapper counts, its time between
    # CUDA events and its device launches under the profiler
    (n_room, ((trace, summary), ms_room)), calls, _ = counted(lambda: device_launches(
        lambda: events_ms(lambda: cr.run_control_room_session(device=dev))))
    require(sum(calls.values()) == 0, f"(zb) control room: a kernel launched: {calls}")
    by_path["control_room"] = calls
    ref = twin["room"]
    scale = max(float(np.abs(ref["z_true"]).max()), 1.0)
    dev_z = max(float(np.abs(getattr(trace, k).cpu().numpy() - ref[k]).max())
                for k in ("z_true", "z_measured", "z_filtered", "top_action", "bottom_action"))
    dev_d = float(np.abs(trace.density.cpu().numpy() - ref["density"]).max())
    gates = float(summary["max_abs_z"]) < 1.5 and float(summary["mean_abs_z"]) < 0.5
    print(f"(zb) control room, default session (200 steps, 60^2, f32): max |z| "
          f"{float(summary['max_abs_z'])!r} (< 1.5), mean |z| {float(summary['mean_abs_z'])!r} "
          f"(< 0.5), estimator rmse {float(summary['estimator_rmse'])!r}, measurement rmse "
          f"{float(summary['measurement_rmse'])!r}; against the CPU: traces {dev_z!r} (limit "
          f"{ROOM_TOL:.0e} x {scale!r}), frames {dev_d!r} (limit {ROOM_TOL:.0e}); gates {gates} "
          f"[{card}]")
    require(dev_z <= ROOM_TOL * scale and dev_d <= ROOM_TOL, "(zb): the control room deviates "
            "from the CPU")
    require(gates, "(zb): the control room misses its summary's gates")

    (trace_k, _), calls, _ = counted(lambda: cr.run_control_room_session(
        size=513, psi_kernel=psi_513))
    require(sum(calls.values()) == 0, f"(zb) the psi lane: a kernel launched: {calls}")
    by_path["control_room_psi_513"] = calls
    pk = (psi_513 - psi_513.min()) / (psi_513.max() - psi_513.min())
    core = torch.argmin(pk)
    frames = trace_k.density
    lane = (tuple(frames.shape) == (200, 513, 513) and bool(torch.isfinite(frames).all())
            and float(frames.min()) >= 0.0 and float(frames.max()) <= 1.3
            and bool((frames[:, pk >= 1.0] == 0.0).all())
            and float(frames.reshape(200, -1)[:, core].min()) > 0.75
            and torch.equal(trace_k.z_true, trace.z_true))
    print(f"(zb) psi lane on the 513^2 FMG psi (size 513, 200 frames): frames finite in "
          f"[{float(frames.min())!r}, {float(frames.max())!r}], zero where the normalised psi "
          f">= 1, min density at its core {float(frames.reshape(200, -1)[:, core].min())!r} "
          f"(> 0.75: the core's 1 less 5 sigma of the 5% noise), z trace torch.equal to the default session's: {lane}; the default session "
          f"{ms_room:.1f} ms (CUDA events, under the profiler), {n_room} device launches "
          f"[{card}]")
    require(lane, "(zb): the kernel-backed psi lane does not follow the FMG psi")


def device_launches(run):
    """(device kernel launches, result) of one ``run()`` under ``torch.profiler``."""
    import torch
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    return n, out


def bus_checks(dev, card: str, counted, by_path: dict) -> None:
    """(y) the bus's parity oracle ``run_monolithic_twin`` (numpy, carried
    over) against the port's ``run_shot_reduced`` in float64 on the card (one
    launch of row R) at atol 1e-12, as ``tests/test_realtime_bus.py:31-52``
    holds it against JAX; then one three-process ``run_realtime_session``
    of 400 ticks (physics, controller and diagnostics in spawned
    interpreters over a manager dict) with the gates of
    ``tests/test_realtime_bus.py:85-97``."""
    import torch
    from scpn_fusion_tpu_torch.control import realtime_bus as bus
    from scpn_fusion_tpu_torch.control.flight_sim import FlightSimParams, run_shot_reduced

    params = FlightSimParams(control_hz=100.0, shot_duration_s=2.0)
    (trace, metrics), calls, launched = counted(
        lambda: run_shot_reduced(params, dtype=torch.float64, device=dev))
    twin = bus.run_monolithic_twin(params)
    worst = 0.0
    for key, ours in (("r", trace.r), ("z", trace.z), ("beta", trace.beta),
                      ("heating", trace.heating_mw), ("ip_ma", trace.ip_ma),
                      ("r_err", trace.r_err), ("z_err", trace.z_err)):
        worst = max(worst, float(np.max(np.abs(twin[key] - ours.cpu().numpy()))))
    same_flags = bool(np.array_equal(twin["disrupted"], trace.disrupted.cpu().numpy()))
    want = {name: int(name == "reduced_shot") for name in KERNELS}
    print(f"(y) the bus oracle (run_monolithic_twin, {params.n_steps} ticks f64) against "
          f"run_shot_reduced through row R: max abs deviation {worst!r} (limit "
          f"{BUS_ORACLE_TOL:.0e}), disrupted flags equal {same_flags}, r_err final "
          f"{float(metrics['r_err_final'])!r}; wrapper calls "
          f"{ {k: v for k, v in calls.items() if v} }, launches {launched} [{card}]")
    require(worst <= BUS_ORACLE_TOL and same_flags, "(y): the bus oracle deviates from row R")
    require(calls == want and launched == {"scpn_reduced_shot_f64": 1},
            f"(y): {calls} / {launched}, not one launch of row R")
    by_path["bus_oracle"] = calls

    res = bus.run_realtime_session(n_ticks=BUS_TICKS, tick_interval_s=0.002)
    gates = (res.n_ticks == BUS_TICKS and res.final_r_err < 0.5 * res.open_loop_r_err
             and res.final_r_err < 0.05 and res.final_z_err < 0.05
             and res.controller_actions >= BUS_TICKS // 4
             and res.diagnostics["n_seen"] == BUS_TICKS
             and res.diagnostics["disrupted_any"] is False
             and res.diagnostics["r_err_rms_window"] < 0.05)
    print(f"(y) run_realtime_session({BUS_TICKS}), three spawned processes: final r error "
          f"{res.final_r_err!r} (open loop {res.open_loop_r_err!r}), z error {res.final_z_err!r}, "
          f"controller actions {res.controller_actions}, stale reads {res.stale_action_reads}, "
          f"diagnostics seen {res.diagnostics['n_seen']}, window rms "
          f"{res.diagnostics['r_err_rms_window']!r}; wall {res.wall_s:.2f} s; gates {gates}")
    require(gates, "(y): the three-process bus session misses its gates")


# ── the seventeenth slice: (zc) row Q, the staged disruption, with the runaway
# models and SPI ablation, (zd) row S, the SOC sandpile, (ze) the MHD modes,
# sawteeth, the stability suite (its eigen lane through row B), ELMs and edge
# events ──

# (label, injected density [1e20 m^-3], delivery [ms]): the CLI's disruption
# mode at its default (cli.py:256-266, --spi 0) and the whole-plant fault
# lane's SPI (validation/run_whole_plant_fault.py:154-156)
SEQ_CASES = (("unmitigated", 0.0, 0.0), ("SPI 200 at 0.2 ms", 200.0, 0.2))
# the mitigation scan of test_disruption_edge_events.py:51-55
SCAN_Q, SCAN_STEPS, SCAN_TIME_MS = (0.0, 5.0, 50.0), 2000, 0.5
# operations a tick of row Q that the function needs: on each sequence the
# density step, the loop field, the avalanche, the current balance, the halo
# and the three scaled traces (35); once a tick for every sequence the tick
# time, Te (its exp), eta (its pow), R and the seed's switch (15).  And the
# dependent operations a tick on a sequence's chain (the ohmic current, E_par,
# E/E_c, the avalanche rate, dI_RE, I_RE and its clamp: three divisions).
DISRUPTION_OPS = (35, 15)
DISRUPTION_DEPTH = 12
# the SPI cloud of test_spi_ablation.py:21-23
SPI_CFG = dict(n_fragments=64, injector_pos=(8.4, 0.0, 0.0), velocity_mps=500.0)
SPI_MASSES = (0.002, 0.01, 0.03)                                  # test_spi_ablation.py:76
# the fluid runs of test_runaway_fluid.py:72-92: a pure avalanche, the density cap
FLUID_CASES = (((0.5, 0.01, 0.5, 1.0), dict(n_re_seed=1e10, t_max_s=0.01, n_steps=50)),
               ((0.5, 0.1, 50.0, 1.0), dict(n_re_seed=1e16, t_max_s=1.0, n_steps=100,
                                            max_runaway_fraction=0.05)))
DEPOSITION_TOL = 1e-12       # the SPI deposition (index_add_'s atomics on the card) against the CPU
SANDPILE_SHORT = (64, 100)   # (cells, drives) of row S against its plain loop, from a critical pile
# (label, cells, drives): the default config (sandpile.py:24-30), the CLI's
# sandpile mode (cli.py:890-894) and the JAX test's (test_sandpile_property.py:29)
SANDPILE_RUNS = (("default 128 x 2000", 128, 2000), ("CLI 64 x 2000", 64, 2000),
                 ("JAX test 24 x 6000", 24, 6000))
SANDPILE_TIMED = (128, 200)  # the timed shape: the default pile, a tenth of its drives
SANDPILE_OPS = 6             # operations a cell and a sweep: slope, test, move, two updates, count


def disruption_work(n_seq: int, n_steps: int, item: int):
    """Row Q: (bytes, operations, peak rate): each sequence's density read
    and its six traces written; the operations of :data:`DISRUPTION_OPS`."""
    per_seq, shared = DISRUPTION_OPS
    return (float(n_seq * item * (1 + 6 * n_steps)), float(n_steps * (per_seq * n_seq + shared)),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def sandpile_work(n: int, n_steps: int, sweeps: int, item: int):
    """Row S: (bytes, operations, peak rate): the drive cells (int64) read,
    the starting and final heights and three values a drive written; the
    operations of :data:`SANDPILE_OPS` a cell and a sweep, and a drive's
    grain, slope differences and sums."""
    n_bytes = 8 * n_steps + item * (2 * n + 3 * n_steps)
    n_ops = n_steps * (sweeps * SANDPILE_OPS * n + 2 * n + 2)
    return (float(n_bytes), float(n_ops), F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def as_numpy(results: dict) -> dict:
    """Tensors as float64 numpy arrays (bools as 0 / 1)."""
    import torch
    return {k: v.detach().cpu().to(torch.float64).numpy() for k, v in results.items()}


def fp_seed(device):
    """The JAX test's seed population on the 64-point grid (made on the CPU)."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import fokker_planck_re as fp
    p = fp.FokkerPlanckGrid(64).p(torch.float64, "cpu")
    return (1e12 * torch.exp(-((torch.log10(p) + 1.0) ** 2) / 0.1)).to(device)


def disruption_lanes(device, seqs: dict | None = None, scan=None) -> dict:
    """(zc)'s float64 results as numpy: the default sequence unmitigated and
    with SPI, the mitigation scan, ``run_fokker_planck`` (the JAX test's seed
    on 64 points: 300 steps at 10 V/m, 50 field-free), ``run_fluid_runaway``
    on :data:`FLUID_CASES`, ``run_spi_injection`` (600 steps) and
    ``spi_quantity_sweep`` (500 steps) of the JAX test's cloud, drawn from
    seeded generators.  ``seqs`` (label -> (trace, summary)) and ``scan``
    hold results already made on ``device``."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import disruption_sequence as ds
    from scpn_fusion_tpu_torch.models.physics import fokker_planck_re as fp
    from scpn_fusion_tpu_torch.models.physics import runaway_fluid as rf
    from scpn_fusion_tpu_torch.models.physics import spi_ablation as spi

    f64, out = torch.float64, {}
    for label, q, ts in SEQ_CASES:
        trace, summ = (seqs or {}).get(label) or ds.run_disruption_sequence(
            ds.DisruptionParams(), spi_ne20_injected=q, spi_time_ms=ts, dtype=f64, device=device)
        out.update({f"{label} {k}": v for k, v in (*trace._asdict().items(),
                                                    *summ._asdict().items())})
    scan = scan if scan is not None else ds.spi_mitigation_scan(
        ds.DisruptionParams(n_steps=SCAN_STEPS), torch.tensor(SCAN_Q, dtype=f64, device=device),
        spi_time_ms=SCAN_TIME_MS)
    out.update({f"scan {k}": v for k, v in scan._asdict().items()})
    grid, f0 = fp.FokkerPlanckGrid(64), fp_seed(device)
    for e_field, n_steps in ((10.0, 300), (0.0, 50)):
        f, tr = fp.run_fokker_planck(grid, f0, 1e-6, e_field, 5e19, 5000.0, 1.5, n_steps=n_steps)
        out.update({f"fp {e_field} f": f, f"fp {e_field} n_re": tr.n_re,
                    f"fp {e_field} j_re": tr.j_re})
    for i, (args, kw) in enumerate(FLUID_CASES):
        tr = rf.run_fluid_runaway(*args, **kw, dtype=f64, device=device)
        out.update({f"fluid {i} {k}": v for k, v in tr._asdict().items()})
    out["fluid gamma"] = rf.avalanche_rate(0.5, 0.01, 0.5, 1.0, dtype=f64, device=device)
    cfg = spi.SpiConfig(**SPI_CFG)
    ne19, te = (torch.tensor(np.linspace(a, b, 33), dtype=f64, device=device)
                for a, b in ((8.0, 2.0), (8.0, 0.05)))     # test_spi_ablation.py:19-20
    trace, summ = spi.run_spi_injection(cfg, torch.Generator().manual_seed(1), ne19, te,
                                        dt_s=5e-5, n_steps=600)
    out.update({f"spi {k}": v for k, v in (*trace._asdict().items(), *summ._asdict().items())})
    sweep = spi.spi_quantity_sweep(cfg, torch.Generator().manual_seed(4),
                                   torch.tensor(SPI_MASSES, dtype=f64, device=device), ne19, te,
                                   dt_s=5e-5, n_steps=500)
    out.update({f"sweep {k}": v for k, v in sweep._asdict().items()})
    return as_numpy(out)


def sandpile_lanes(device) -> dict:
    """(zd)'s float32 runs of :data:`SANDPILE_RUNS` (seed 0), as numpy."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import sandpile as sp
    return {label: as_numpy(sp.run_sandpile(sp.SandpileConfig(n_cells=n, n_steps=steps), seed=0,
                                            dtype=torch.float32, device=device)._asdict())
            for label, n, steps in SANDPILE_RUNS}


def mhd_lanes(device) -> dict:
    """(ze)'s float64 results as numpy, on the JAX tests' inputs: the TAE and
    MRTI screens, Delta', the Rutherford island (5000 steps, growing; 3000,
    decaying) and the locked mode (3000, both cases); the q=1 radius, the
    Kadomtsev crash and the sawtooth step at q0 0.8 and 1.1 (NaN radii as
    -1, with their masks); the q-profile, the full stability check and the
    eigenvalue ballooning lane (two launches of row B on the card); the ELM
    limit cycle (3000 steps); the pellet at three core temperatures, blobs
    and MARFE onset."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import edge_events as ev
    from scpn_fusion_tpu_torch.models.physics import elm
    from scpn_fusion_tpu_torch.models.physics import mhd_modes as mm
    from scpn_fusion_tpu_torch.models.physics import sawtooth as sw
    from scpn_fusion_tpu_torch.models.physics import stability_mhd as st

    f64, out = torch.float64, {}
    kw = dict(dtype=f64, device=device)

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=f64, device=device)

    def put(prefix, result):
        for k, v in result._asdict().items():
            if hasattr(v, "_asdict"):
                put(f"{prefix} {k}", v)
            else:
                v = torch.as_tensor(v, device=device)
                if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                    # NaN 1, +inf 2, -inf 3 in a code; the values as -1, -2, -3
                    out[f"{prefix} {k} nonfinite"] = (torch.isnan(v) + 2 * torch.isposinf(v)
                                                      + 3 * torch.isneginf(v))
                    v = torch.nan_to_num(v, nan=-1.0, posinf=-2.0, neginf=-3.0)
                out[f"{prefix} {k}"] = v

    out["tae f"] = mm.tae_frequency(5.3, 10.0, 1.5, 6.2, **kw)
    for i, extra in enumerate((dict(beta_fast_pct=0.1, v_fast_over_va=0.8),
                               dict(beta_fast_pct=8.0, v_fast_over_va=1.8))):
        put(f"tae {i}", mm.tae_stability(b_t=5.3, n_i_19=10.0, q=1.5, r0_m=6.2, a_m=2.0, **extra,
                                         **kw))
    for i, extra in enumerate((dict(k_m=100.0, b_t=0.0, n_i_19=1.0),
                               dict(k_m=1e6, b_t=2.0, n_i_19=0.01),
                               dict(k_m=1e6, b_t=2.0, n_i_19=0.01, theta_kb_rad=np.pi / 2),
                               dict(k_m=1.0, b_t=2.0, n_i_19=0.01))):
        put(f"mrti {i}", mm.mrti_growth_rate(g_eff_m_s2=1e9, **extra, **kw))
    rho = np.linspace(0.01, 1.0, 64)
    for width in (0.632, 0.15):
        put(f"delta' {width}", mm.delta_prime_cylindrical(
            t(rho), t(1.0 + 2.5 * rho ** 2), t(np.exp(-(rho / width) ** 2)), 2.0))
    put("island grow", mm.rutherford_island_evolution(delta_prime=5.0, r_s_m=1.2, eta_ohm_m=1e-7,
                                                      n_steps=5000, dt=1e-2, **kw))
    put("island decay", mm.rutherford_island_evolution(delta_prime=-4.0, r_s_m=1.2,
                                                       eta_ohm_m=1e-7, w0_m=0.02, n_steps=3000,
                                                       dt=1e-2, **kw))
    put("locked ok", mm.locked_mode_evolution(w_island_m=0.03, b_error_mt=0.05, omega0_hz=5000.0,
                                              **kw))
    put("locked bad", mm.locked_mode_evolution(w_island_m=0.12, b_error_mt=5.0, omega0_hz=100.0,
                                               **kw))
    rho = np.linspace(0.0, 1.0, 100)
    for q0 in (0.8, 1.1):
        q = t(q0 + 2.5 * rho ** 2)
        prof = (t(rho), t(10.0 * (1 - rho ** 2) + 0.1), t(8.0 * (1 - rho ** 2) ** 0.5 + 0.5))
        shear = t(np.gradient(q0 + 2.5 * rho ** 2) / (rho[1] - rho[0]) * rho
                  / np.maximum(q0 + 2.5 * rho ** 2, 1e-6))
        radius = sw.find_q1_radius(prof[0], q)
        out[f"saw {q0} rho_1 nan"] = torch.isnan(radius)
        out[f"saw {q0} rho_1"] = torch.nan_to_num(radius, nan=-1.0)
        put(f"saw {q0} crash", sw.kadomtsev_crash(*prof, q))
        put(f"saw {q0} step", sw.sawtooth_step(*prof, q, shear))
    rho = np.linspace(0.0, 1.0, 50)
    ne, te = 10.0 * (1 - rho ** 2) ** 0.5 + 0.5, 20.0 * (1 - rho ** 2) + 0.1
    geom = dict(r0=6.2, a=2.0, b0=5.3, ip_ma=15.0)
    qp = st.compute_q_profile(t(rho), t(ne), t(te), t(te), **geom, kappa=1.7, delta=0.33)
    put("q", qp)
    put("ballooning", st.ballooning_stability(qp))
    put("s 0.5", st.ballooning_stability(qp._replace(shear=torch.full_like(qp.q, 0.5),
                                                     alpha_mhd=torch.zeros_like(qp.q))))
    put("cold mercier", st.mercier_stability(st.compute_q_profile(
        t(rho), t(np.ones(50)), t(np.full(50, 0.5)), t(np.full(50, 0.5)), **geom)))
    put("troyon", st.troyon_beta_limit(0.025, 15.0, 2.0, 5.3, **kw))
    for beta_n in (3.0, 2.0):
        put(f"rwm {beta_n}", st.rwm_stability(beta_n, **kw))
    put("ntm", st.ntm_stability(qp, torch.full_like(qp.rho, 0.2e6), torch.full_like(qp.rho, 1e6),
                                2.0))
    for tag, j_edge, p_ped in (("low", 1e4, 1e4), ("high", 1e7, 2e5)):
        put(f"pb {tag}", st.peeling_ballooning_stability(qp, j_edge, p_ped, 6.2, 2.0, 5.3))
    put("full", st.run_full_stability_check(t(rho), t(ne), t(te), t(te), t(np.full(50, 1e5)),
                                            t(np.full(50, 1e6)), **geom, beta_t=0.02, j_edge=1e5,
                                            p_ped_pa=5e4))
    n = 7
    qp = st.QProfile(t(np.linspace(0.1, 1.0, n)), t(np.linspace(1.0, 4.0, n)), t(np.full(n, 0.4)),
                     t(np.full(n, 3.5)), t(1.0), t(0.1), t(4.0))
    put("eigen", st.ballooning_stability_eigen(qp))
    put("closed form", st.ballooning_stability(qp))
    put("elm cycle", elm.run_elm_cycle(t_ped0_kev=1.0, n_ped_1e19=8.0, w_ped_mj=10.0,
                                       heat_rate_kev_s=50.0, alpha_per_kev=1.0, s_edge=1.5,
                                       j_edge_norm=0.1, dt=1e-3, n_steps=3000, **kw))
    rho = np.linspace(0.0, 1.0, 33)
    for t_core in (10.0, 25.0, 2.0):
        put(f"pellet {t_core}", ev.pellet_ablation(te_profile_kev=t(t_core * (1 - 0.9 * rho ** 2)),
                                                   ne_profile_19=t(8.0 * (1 - 0.7 * rho ** 2))))
    for size in (2.0, 30.0):
        put(f"blob {size}", ev.blob_transport(blob_size_mm=size, **kw))
    for i, extra in enumerate((dict(n_edge_19=1.0, te_edge_ev=50.0),
                               dict(n_edge_19=20.0, te_edge_ev=15.0, impurity_fraction=0.06),
                               dict(n_edge_19=1.0, te_edge_ev=50.0, impurity_fraction=0.1))):
        put(f"marfe {i}", ev.marfe_onset(ip_ma=2.0, a_m=0.6, **extra, **kw))
    return as_numpy(out)


def slice17_on_cpu(conn) -> None:
    """The CPU twins of (zc), (zd) and (ze)."""
    dev = on_cpu(4)
    conn.send({"zc": disruption_lanes(dev), "zd": sandpile_lanes(dev), "ze": mhd_lanes(dev)})
    conn.close()


def disruption_gates(r: dict) -> dict:
    """The gates of ``tests/test_disruption_edge_events.py`` (``TestDisruption``),
    the whole-plant lane's (``run_whole_plant_fault.py:157-159``), the
    runaway tests' (``TestFokkerPlanck`` at 10 V/m, ``test_runaway_fluid.py``)
    and ``tests/test_spi_ablation.py``'s, on :func:`disruption_lanes`'
    results."""
    from scpn_fusion_tpu_torch.models.physics import fokker_planck_re as fp
    from scpn_fusion_tpu_torch.models.physics import spi_ablation as spi

    u, m = "unmitigated", "SPI 200 at 0.2 ms"
    ip, i_re = r[f"{u} ip_ma"], r[f"{u} i_re_ma"]
    j, n = r["fp 10.0 j_re"][49], r["fp 10.0 n_re"][49]
    fluid = r["fluid 0 n_re"], 1e10 * np.exp(r["fluid gamma"] * r["fluid 0 time_s"])
    dep = r["spi deposition_m3s"]
    gates = {
        "ohmic current quenched": abs(ip[0] - 15.0) <= 0.15 and ip[-1] - i_re[-1] < 1.0
        and ip[-1] < ip[0] and float(r[f"{u} tau_cq_ms"]) > 0.0
        and abs(r[f"{u} te_ev"][-1] - 10.0) <= 2.0,
        "unmitigated RE beam": float(r[f"{u} i_re_final_ma"]) > 0.5
        and not bool(r[f"{u} mitigated"]),
        "SPI suppresses": float(r[f"{m} i_re_final_ma"]) < 0.2 * float(r[f"{u} i_re_final_ma"]),
        "whole-plant lane": bool(r[f"{m} mitigated"]) and float(r[f"{m} i_re_final_ma"]) < 0.15,
        "halo": float(r[f"{u} halo_peak_ma"]) > 0.5,
        "scan monotone": r["scan i_re_final_ma"][2] < r["scan i_re_final_ma"][0],
        "FP grows": bool(np.all(np.isfinite(r["fp 10.0 n_re"])))
        and r["fp 10.0 n_re"][-1] > r["fp 10.0 n_re"][0] and bool(np.all(r["fp 10.0 f"] >= 0.0))
        and 0 <= j <= fp.E_CHARGE * fp.C * n * (1 + 1e-6),
        "fluid exact avalanche": bool(np.allclose(*fluid, rtol=1e-9, atol=0.0)),
        "fluid cap": float(np.max(r["fluid 1 n_re"])) <= 0.05 * 0.5e20 * (1 + 1e-12),
        "SPI ledger": abs(r["spi mass_total_kg"][-1] + float(r["spi assimilated_particles"])
                          * spi.M_NEON_KG - 0.01) <= 1e-5 * 0.01
        and 0.0 < float(r["spi assimilated_fraction"]) <= 1.0,
        "SPI deposition": bool(np.all(np.isfinite(dep)) and np.all(dep >= 0.0))
        and dep.shape == (600, 33),
        "sweep monotone": bool(np.all(np.diff(r["sweep assimilated_particles"]) > 0.0)
                               and np.all(r["sweep delta_ne20_volavg"] > 0.0)),
    }
    return {k: bool(v) for k, v in gates.items()}


def disruption_ptx(source: str = "disruption.cu") -> dict:
    """Instructions of a kernel source's PTX (``nvcc -ptx``, sm_90a) that a
    rewrite of ``pow`` for a constant exponent (1.5 in ``csrc/disruption.cu``:
    x * sqrt(x)) would bring in: the exponent reaches the kernel as an
    argument, as in torch's elementwise ``pow``, so none is expected."""
    import tempfile
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        out = Path(tmp) / "kernel.ptx"
        subprocess.run([cb._nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "-ptx",
                        str(cb.CSRC / source), "-o", str(out)], check=True,
                       capture_output=True)
        ptx = out.read_text()
    return {op: len(re.findall(rf"\b{op}\.", ptx)) for op in ("sqrt", "rsqrt", "call")}


def disruption_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                      measured_plain: dict, twin: dict) -> int:
    """(zc) row Q: the default sequence unmitigated and with SPI each ONE
    launch, and the mitigation scan one launch for its three inventories,
    ``torch.equal`` to the plain tick loop on the card in float32 and
    float64; the gates of :func:`disruption_gates` (the field-free
    Fokker-Planck run at the JAX test's 300 steps besides); every float64
    result within 1e-9 of the CPU (``twin``: :func:`slice17_on_cpu`'s), the
    SPI deposition within 1e-12.  Returns row Q's counted launches."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import disruption_sequence as ds
    from scpn_fusion_tpu_torch.models.physics import fokker_planck_re as fp
    from scpn_fusion_tpu_torch.ops import cuda_disruption as cdis

    one = {name: int(name == "disruption_sequence") for name in KERNELS}
    launches, seqs = 0, {}
    print(f"(zc) csrc/disruption.cu's PTX (nvcc -ptx): {disruption_ptx()} sqrt / rsqrt / call "
          f"instructions (pow's exponent is an argument; a rewrite for 1.5 would bring a sqrt)")
    p, p_scan = ds.DisruptionParams(), ds.DisruptionParams(n_steps=SCAN_STEPS)
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        entry = f"scpn_disruption_{tag}"
        for label, q, ts in SEQ_CASES:
            (trace, summ), calls, launched = counted(functools.partial(
                ds.run_disruption_sequence, p, spi_ne20_injected=q, spi_time_ms=ts, dtype=dtype,
                device=dev))
            require(calls == one and launched == {entry: 1},
                    f"(zc) {label} {tag}: {calls} / {launched}, not one launch of row Q")
            by_path[f"disruption {label} {tag}"] = calls
            launches += calls["disruption_sequence"]
            q_t = torch.tensor([q], dtype=dtype, device=dev)
            plain, ms_p = events_ms(functools.partial(cdis.disruption_sequence_plain, p, q_t, ts))
            equal = all(torch.equal(a, b[0]) for a, b in zip(trace, plain))
            print(f"(zc) row Q {tag} {label} ({p.n_steps} ticks): one launch, torch.equal to the "
                  f"plain tick loop {equal}; I_RE final {float(summ.i_re_final_ma)!r} MA, tau_CQ "
                  f"{float(summ.tau_cq_ms)!r} ms, halo peak {float(summ.halo_peak_ma)!r} MA; "
                  f"plain loop {ms_p:.1f} ms [{card}]")
            require(equal, f"(zc) row Q {tag} {label}: the kernel differs from its plain loop")
            if tag == "f64":
                seqs[label] = (trace, summ)
            if tag == "f64" and label == "unmitigated":
                kernel = functools.partial(cdis.disruption_sequence, p, q_t, ts)
                results["disruption_sequence"] = {"max_abs_err": max(
                    float((a - b).abs().max()) for a, b in zip(kernel(), plain))}
                measured_plain["disruption_sequence"] = ms_p
                timing["disruption_sequence"] = (
                    kernel, functools.partial(cdis.disruption_sequence_plain, p, q_t, ts),
                    f"one default sequence, {p.n_steps} ticks f64",
                    disruption_work(1, p.n_steps, 8))
        q_scan = torch.tensor(SCAN_Q, dtype=dtype, device=dev)
        scan, calls, launched = counted(functools.partial(
            ds.spi_mitigation_scan, p_scan, q_scan, spi_time_ms=SCAN_TIME_MS))
        require(calls == one and launched == {entry: 1},
                f"(zc) scan {tag}: {calls} / {launched}, not one launch of row Q")
        by_path[f"disruption scan {tag}"] = calls
        launches += calls["disruption_sequence"]
        equal = all(torch.equal(a, b) for a, b in zip(
            cdis.disruption_sequence(p_scan, q_scan, SCAN_TIME_MS),
            cdis.disruption_sequence_plain(p_scan, q_scan, SCAN_TIME_MS)))
        print(f"(zc) row Q {tag} mitigation scan ({len(SCAN_Q)} inventories x {SCAN_STEPS} ticks): "
              f"one launch, torch.equal to the plain loop {equal}; I_RE final "
              f"{scan.i_re_final_ma.tolist()} MA [{card}]")
        require(equal, f"(zc) row Q {tag} scan: the kernel differs from its plain loop")
        if tag == "f64":
            scan64 = scan

    (r, ms), calls, _ = counted(lambda: events_ms(lambda: disruption_lanes(dev, seqs, scan64)))
    require(calls == {name: 0 for name in KERNELS},
            f"(zc) lanes: {calls}: the runaway and SPI lanes launch no kernel")
    by_path["runaway_spi_lanes_f64"] = calls
    _, decay = fp.run_fokker_planck(fp.FokkerPlanckGrid(64), fp_seed(dev), 1e-6, 0.0, 5e19, 5000.0,
                                    1.5, n_steps=300)
    gates = disruption_gates(r)
    n_re0 = decay.n_re.cpu().numpy()
    gates["FP decays field-free"] = bool(np.all(np.isfinite(n_re0)) and n_re0[-1] < n_re0[0])
    print(f"(zc) gates of the JAX tests on the card (f64): {gates}; the runaway, fluid, SPI "
          f"injection (600 steps, 64 fragments) and sweep lanes {ms:.1f} ms (CUDA events) "
          f"[{card}]")
    require(all(gates.values()), "(zc): the port misses a gate of the JAX tests")
    agree(r, twin["zc"], "(zc) row Q's sequences, the scan, Fokker-Planck, fluid and SPI lanes",
          card)
    dep = max_rel(torch.from_numpy(r["spi deposition_m3s"]),
                  torch.from_numpy(twin["zc"]["spi deposition_m3s"]))
    print(f"(zc) SPI deposition (index_add_, atomics on the card) against the CPU: {dep:.3e} of "
          f"its largest value (limit {DEPOSITION_TOL:.0e}) [{card}]")
    require(dep <= DEPOSITION_TOL, "(zc): the SPI deposition deviates from the CPU's")

    kernel, _, label, work = timing["disruption_sequence"]
    ms_k = cuda_ms(kernel)
    b, by = bound(work)
    chain = ladder_chain_ms(p.n_steps, DISRUPTION_DEPTH)
    print(f"time (zc) row Q ({label}): kernel {ms_k:.4f} ms ({1e3 * ms_k / p.n_steps:.4f} us a "
          f"tick; CUDA events, median of 5), bound {b:.4g} ms ({by}: {work[0] / 1e6:.4g} MB, "
          f"{work[1] / 1e6:.4g} Mflop); a sequence's dependent operations "
          f"{p.n_steps * DISRUPTION_DEPTH} ({p.n_steps} ticks x ~{DISRUPTION_DEPTH}), "
          f"~{chain:.4f} ms at a nominal 4 cycles each and {SM_CLOCK_HZ / 1e9:.2f} GHz (a count, "
          f"not a bound: three IEEE f64 divisions a tick on the chain); plain loop "
          f"{measured_plain['disruption_sequence']:.1f} ms; library_ms null (no PyTorch call "
          f"runs a disruption sequence) [{card}]")
    return launches


def sandpile_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                    measured_plain: dict, twin: dict) -> int:
    """(zd) row S: ``torch.equal`` to its plain loop on the card at
    :data:`SANDPILE_SHORT` from a pile at its critical slope, in float32 and
    float64; the default, CLI and JAX
    test sizes (:data:`SANDPILE_RUNS`, float32, seed 0) each ONE launch,
    their heights, avalanche sizes and flux equal to the CPU twin's and the
    mean slope within one ulp; mass conservation on every run and on the
    JAX test's 32 x 500 (seed 1), the marginal-slope gates at 24 x 6000.
    Returns row S's counted launches."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import sandpile as sp
    from scpn_fusion_tpu_torch.ops import cuda_sandpile as csp

    one = {name: int(name == "sandpile_run") for name in KERNELS}
    n, steps = SANDPILE_SHORT
    cfg = sp.SandpileConfig(n_cells=n, n_steps=steps)
    idx = sp.drive_indices(cfg, 0).to(dev)
    # a pile at its critical slope (4.2 a cell less 0-2 grains at random), so
    # that the short run avalanches and spills from its first drive
    pile = np.round(np.linspace(4.2 * (n - 1), 0.0, n)) - np.random.default_rng(SEED).integers(
        0, 3, n)
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        h0 = torch.tensor(np.maximum(pile, 0.0), dtype=dtype, device=dev)
        k, ms_k = events_ms(functools.partial(csp.sandpile_run, cfg, h0, idx))
        plain, ms_p = events_ms(functools.partial(csp.sandpile_run_plain, cfg, h0, idx))
        equal = all(torch.equal(a, b) for a, b in zip(k, plain))
        print(f"(zd) row S {tag} {n} cells x {steps} drives x {cfg.relax_sweeps} sweeps: kernel "
              f"torch.equal to the plain loop {equal}; {int(k[1].sum())} topples, "
              f"{float(k[2].sum())!r} grains out; kernel {ms_k:.4f} ms (one call), plain loop "
              f"{ms_p:.1f} ms [{card}]")
        require(equal, f"(zd) row S {tag}: the kernel differs from its plain loop")
        if tag == "f32":
            results["sandpile_run"] = {"max_abs_err": max(float((a - b).abs().max())
                                                          for a, b in zip(k, plain))}

    launches = 0
    for label, n, steps in SANDPILE_RUNS:
        cfg = sp.SandpileConfig(n_cells=n, n_steps=steps)
        trace, calls, launched = counted(functools.partial(sp.run_sandpile, cfg, 0,
                                                           dtype=torch.float32, device=dev))
        require(calls == one and launched == {"scpn_sandpile_f32": 1},
                f"(zd) {label}: {calls} / {launched}, not one launch of row S")
        by_path[f"sandpile {label}"] = calls
        launches += calls["sandpile_run"]
        ours, ref = as_numpy(trace._asdict()), twin["zd"][label]
        same = all(np.array_equal(ours[k], ref[k]) for k in ("heights_final", "avalanche_sizes",
                                                              "flux_out"))
        ulp = np.spacing(np.abs(ref["mean_slope"]).astype(np.float32)).astype(np.float64)
        slope_equal = bool(np.array_equal(ours["mean_slope"], ref["mean_slope"]))
        slope_ok = bool(np.all(np.abs(ours["mean_slope"] - ref["mean_slope"]) <= ulp))
        stats = sp.avalanche_statistics(trace)
        mass = float(trace.heights_final.sum()) + float(trace.flux_out.sum())
        print(f"(zd) row S {label} f32: one launch; heights, sizes and flux equal to the CPU twin "
              f"{same}, mean slope equal {slope_equal} (within one ulp {slope_ok}); grains held + "
              f"out {mass!r} of {cfg.drive_amount * steps!r}; {stats} [{card}]")
        require(same and slope_ok, f"(zd) row S {label}: the card differs from the CPU twin")
        require(mass == cfg.drive_amount * steps, f"(zd) {label}: grains not conserved")
        if label.startswith("JAX test"):
            gates = (stats["total_flux_out"] > 0.0
                     and 0.3 * cfg.critical_slope < stats["final_mean_slope"] <= cfg.critical_slope
                     and stats["max_avalanche"] > 5.0 * max(stats["mean_avalanche"], 1.0))
            require(gates, "(zd): the 24 x 6000 run misses test_reaches_marginal_slope's gates")
    cfg = sp.SandpileConfig(n_cells=32, n_steps=500)
    trace, calls, _ = counted(functools.partial(sp.run_sandpile, cfg, 1, dtype=torch.float32,
                                                device=dev))
    held, out = float(trace.heights_final.sum()), float(trace.flux_out.sum())
    require(calls == one and abs(held + out - 500.0) <= 1e-6 * 500.0,
            "(zd): the 32 x 500 run misses test_mass_conservation's gate")
    by_path["sandpile mass 32 x 500"] = calls
    launches += calls["sandpile_run"]

    n, steps = SANDPILE_TIMED
    cfg = sp.SandpileConfig(n_cells=n, n_steps=steps)
    idx, h0 = sp.drive_indices(cfg, 0).to(dev), torch.zeros(n, device=dev)
    _, ms_p = events_ms(functools.partial(csp.sandpile_run_plain, cfg, h0, idx))
    measured_plain["sandpile_run"] = ms_p
    label = f"{n} cells x {steps} drives x {cfg.relax_sweeps} sweeps f32"
    work = sandpile_work(n, steps, cfg.relax_sweeps, 4)
    timing["sandpile_run"] = (functools.partial(csp.sandpile_run, cfg, h0, idx),
                              functools.partial(csp.sandpile_run_plain, cfg, h0, idx), label, work)
    full = sp.SandpileConfig()
    idx_full, h0_full = sp.drive_indices(full, 0).to(dev), torch.zeros(full.n_cells, device=dev)
    ms_full = cuda_ms(functools.partial(csp.sandpile_run, full, h0_full, idx_full))
    b, by = bound(work)
    stages = full.n_steps * full.relax_sweeps
    print(f"time (zd) row S ({label}): kernel {cuda_ms(timing['sandpile_run'][0]):.4f} ms, plain "
          f"loop {ms_p:.1f} ms (once), bound {b:.4g} ms ({by}: {work[0] / 1e6:.4g} MB, "
          f"{work[1] / 1e6:.4g} Mflop); the default run (128 x 2000 x 64, one CTA of "
          f"{csp.threads_for(full.n_cells)} threads) {ms_full:.4f} ms (CUDA events, median of 5), "
          f"{1e3 * ms_full / stages:.4f} us a sweep over its {stages} barrier stages; library_ms "
          f"null (no PyTorch call runs a sandpile) [{card}]")
    return launches


def mhd_gates(r: dict) -> dict:
    """The gates of ``tests/test_mhd_modes.py``, the sawtooth cases of
    ``test_edge_orbits_frc.py``, the stability parts of
    ``test_stability_scaling.py``, the eigen lane of ``test_ballooning.py:87-103``,
    the ELM limit cycle of ``test_elm_impurity.py`` and the pellet, blob and
    MARFE cases of ``test_disruption_edge_events.py``, on :func:`mhd_lanes`'
    results."""
    w = r["island grow w_m"]
    q = r["q q"]
    rho = np.linspace(0.0, 1.0, 100)
    mix = rho < float(r["saw 0.8 crash rho_mix"])
    n0, t0 = 8.0 * (1 - rho ** 2) ** 0.5 + 0.5, 10.0 * (1 - rho ** 2) + 0.1
    n1, t1 = r["saw 0.8 crash n_new"], r["saw 0.8 crash t_new"]
    trap = np.trapezoid
    gates = {
        "TAE": 3e4 < float(r["tae f"]) < 3e5 and not bool(r["tae 0 unstable"])
        and bool(r["tae 1 unstable"]),
        "MRTI": abs(float(r["mrti 0 gamma_s"]) - np.sqrt(1e11)) <= 1e-6 * np.sqrt(1e11)
        and bool(r["mrti 1 stabilised"]) and not bool(r["mrti 2 stabilised"]),
        "Delta'": bool(r["delta' 0.632 classically_unstable"])
        and not bool(r["delta' 0.15 classically_unstable"])
        and abs(float(r["delta' 0.632 r_s_m"]) - 1.264) <= 0.05 * 1.264,
        "Rutherford": w[-1] > w[0] and abs(w[-1] - float(r["island grow saturated_w_m"]))
        <= 0.05 * abs(float(r["island grow saturated_w_m"]))
        and r["island decay w_m"][-1] < 0.02 and not bool(r["island decay locked_risk"]),
        "locked mode": not bool(r["locked ok locked"]) and bool(r["locked bad locked"])
        and float(r["locked bad omega_final"]) < float(r["locked ok omega_final"]),
        "sawtooth": abs(float(r["saw 0.8 rho_1"]) - np.sqrt(0.08)) <= 0.02
        and bool(r["saw 1.1 rho_1 nan"]) and not bool(r["saw 1.1 crash triggered"])
        and bool(r["saw 0.8 crash triggered"]) and t1[0] < t0[0]
        and abs(r["saw 0.8 crash q_new"][0] - 1.01) <= 1e-12
        and abs(trap(n1[mix] * rho[mix], rho[mix]) / trap(n0[mix] * rho[mix], rho[mix]) - 1) <= 0.02
        and abs(trap((n1 * t1)[mix] * rho[mix], rho[mix])
                / trap((n0 * t0)[mix] * rho[mix], rho[mix]) - 1) <= 0.02
        and bool(r["saw 0.8 step triggered"]),
        "q-profile": bool(np.all(np.isfinite(q)) and np.all(q > 0))
        and 0.5 < float(r["q q_min"]) < 2.0 and 2.0 < float(r["q q_edge"]) < 6.0,
        "criteria": bool(r["cold mercier all_stable"])
        and bool(np.all(r["ballooning alpha_crit"] >= 0.0))
        and bool(np.allclose(r["s 0.5 alpha_crit"], 0.375, rtol=1e-6))
        and abs(float(r["troyon beta_n"]) - 100 * 0.025 * 2.0 * 5.3 / 15.0) <= 1e-6
        and bool(r["troyon stable_nowall"])
        and not bool(r["rwm 3.0 stable"]) and float(r["rwm 3.0 mode_growth_rate"]) > 0.0
        and bool(r["rwm 2.0 stable"]) and float(r["rwm 2.0 mode_growth_rate"]) == 0.0
        and bool(np.allclose(r["ntm w_marginal"], 0.2, rtol=1e-6))
        and float(r["pb low stability_distance"]) > float(r["pb high stability_distance"])
        and r["full overall_stable"] in (0.0, 1.0),
        "eigen lane": bool(np.all(r["eigen stable"] == 1.0))
        and not bool(np.any(r["closed form stable"] == 1.0)),
        "ELM cycle": float(r["elm cycle n_crashes"]) >= 3
        and bool(np.all(np.isfinite(r["elm cycle t_ped"]))) and r["elm cycle t_ped"].max() < 10.0,
        "pellet": float(r["pellet 10.0 radius_mm"][-1]) < 2.0
        and r["pellet 10.0 deposition"].sum() > 0.0 and float(r["pellet 10.0 penetration_rho"]) > 0
        and float(r["pellet 25.0 penetration_rho"]) > float(r["pellet 2.0 penetration_rho"]),
        "blob": float(r["blob 2.0 v_blob_m_s"]) > 0.0
        and float(r["blob 30.0 v_blob_m_s"]) != float(r["blob 2.0 v_blob_m_s"])
        and float(r["blob 2.0 gamma_flux_m2_s"]) > 0.0,
        "MARFE": not bool(r["marfe 0 at_risk"]) and bool(r["marfe 1 at_risk"])
        and float(r["marfe 2 n_marfe_19"]) < float(r["marfe 0 n_marfe_19"]),
    }
    return {k: bool(v) for k, v in gates.items()}


def mhd_checks(dev, card: str, counted, by_path: dict, twin: dict) -> None:
    """(ze) the MHD modes, sawteeth, the stability suite, ELMs and edge events
    in float64 on the card: the eigen lane in two launches of row B, nothing
    else launching a kernel; the gates of :func:`mhd_gates`; every result
    within 1e-9 of the CPU (``twin``: :func:`slice17_on_cpu`'s)."""
    (r, ms), calls, launched = counted(lambda: events_ms(lambda: mhd_lanes(dev)))
    want = {name: 2 * (name == "newcomb_min_xi") for name in KERNELS}
    gates = mhd_gates(r)
    print(f"(ze) the MHD, sawtooth, stability, ELM and edge-event lanes on the card (f64): gates "
          f"{gates}; row B launches {launched} (the eigen lane: ballooning_stable and "
          f"second_stability_scan); {ms:.1f} ms (CUDA events) [{card}]")
    require(all(gates.values()), "(ze): the port misses a gate of the JAX tests")
    require(calls == want and launched == {"scpn_newcomb_f64": 2},
            f"(ze): {calls} / {launched}, not the eigen lane's two launches of row B")
    by_path["mhd_stability_f64"] = calls
    agree(r, twin["ze"], "(ze) the MHD modes, sawteeth, stability suite, ELMs and edge events",
          card)


# ── the eighteenth slice: (zf) row P, the voltage-driven compression, and its
# adjoint, with the rigid rotor, the tilt diagnostics and Faraday recovery; (zg)
# the pulsed Hall-MHD carrier and the Hall-MHD discovery sandbox ──

FARADAY_COIL = dict(n_turns=20, l_coil_m=1.0, resistance_ohm=5e-3, inductance_h=2e-6)
FARADAY_CFG = dict(min_radius_m=0.02, gamma=5.0 / 3.0, plasma_mass_kg=2e-5)
FARADAY_STATE = dict(radius_m=0.3, t_i_ev=100.0, t_e_ev=100.0, density_m3=5e19)
# (label, config kwargs, coil kwargs, initial state kwargs, drive a + b t, dt_s, n_steps, t0):
# the JAX tests' drives (test_pulsed_compression.py:52-100, the 4000-step one also lanes 1-2
# of validation/run_pulsed_suppression.py; test_faraday_recovery.py:115-126, lane 3 of
# validation/run_mif_frc.py) and a ramp from a nonzero start, so that the table's times matter
COMPRESSION_CASES = (
    ("4000 V, 3000 steps", {}, {}, dict(radius_m=0.25), (4000.0, 0.0), 2e-8, 3000, 0.0),
    ("4000 V, 4000 steps", {}, {}, dict(radius_m=0.25), (4000.0, 0.0), 2e-8, 4000, 0.0),
    ("3000 V, 1500 steps", {}, {}, dict(radius_m=0.25), (3000.0, 0.0), 2e-8, 1500, 0.0),
    ("3000 V, 1500 steps, loss", dict(radial_loss_time_s=5e-6), {}, dict(radius_m=0.25),
     (3000.0, 0.0), 2e-8, 1500, 0.0),
    ("Faraday 400 V, 800 steps", FARADAY_CFG, FARADAY_COIL, FARADAY_STATE, (400.0, 0.0), 1e-7,
     800, 0.0),
    ("ramp from 30 ns, 2000 steps", {}, {}, dict(radius_m=0.25), (1000.0, 5e10), 2e-8, 2000,
     3e-8),
)
COMPRESSION_TIMED = "4000 V, 4000 steps"
GRAD_STEPS, COTANGENT_STEPS, GRADCHECK_STEPS = 500, 200, 30
ADJOINT_F64_TOL, ADJOINT_F32_TOL = 1e-10, 1e-4
# row P's float32 gradient on random cotangents carries ~1e-3 of rounding (each step
# differentiates the ratio of two nearly equal volumes): the kernel's and autograd's differ by
# that much, so the kernel is held to no more than this many times autograd's distance from the
# float64 gradient (plus ADJOINT_F32_TOL); the JAX test's d min(radius)/dV to ADJOINT_F32_TOL
F32_GRADIENT_SPREAD = 4.0
# operations a step of row P that the function needs (the circuit with its clip 20, the
# piston 19, compression, loss and ledgers 39), and the dependent operations a step on the
# chain (T_i -> p_int -> acceleration -> velocity -> radius -> volume -> ratio -> pow -> T_i:
# two divisions and a pow among them); the adjoint recomputes the step and applies its
# vector-Jacobian product (~181 more)
COMPRESSION_OPS, COMPRESSION_DEPTH, ADJOINT_OPS = 78, 18, 259
# results of (zf), (zg) and (zl) that are rounding noise of a cancellation, held absolutely: the
# dimensionless residuals at 1e-12; the carrier's source residual, (psi' - psi) / dt - source +
# psi' / tau over max(|source|, |psi' / tau|, 1), whose noise is eps |psi| / (dt scale), ~2e-11
# at the JAX test's dt = 1e-8, at 1e-10; the quasi-3D n2 amplitude, an FFT bin the surface
# leaves empty (~1e-17 of a 0.95 m ring), at 1e-14
NOISE_KEYS = {"balance_residual": 1e-12, "force_balance_residual": 1e-12,
              "pressure_balance_residual": 1e-12, "flux_derivative_residual": 1e-12,
              "source_residual": 1e-10, "n2_amp": 1e-14}


def compression_work(n: int, item: int):
    """Row P: (bytes, operations, peak rate): the drive table, state0 and the
    constants read, the fifteen trace rows written."""
    return (float(item * (n + 15 * n + 12 + 18)), float(COMPRESSION_OPS * n),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def compression_adjoint_work(n: int, item: int):
    """Row P's adjoint: the drive, the twelve state rows and the fifteen
    cotangent rows read, dL/dV and dL/dstate0 written."""
    return (float(item * (n + 12 * n + 15 * n + 12 + 18 + n + 12)), float(ADJOINT_OPS * n),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def compression_case(label: str):
    return next(case for case in COMPRESSION_CASES if case[0] == label)


def compression_inputs(cfg, s_kw: dict, drive, dt: float, n: int, t0: float, dtype, device):
    """(step constants, state0 (12,), drive table (n,)) of a run, as
    ``run_voltage_driven_compression`` forms them."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    st = pc.initial_state(cfg, **s_kw, dtype=dtype, device=device)
    st = st._replace(t_s=torch.tensor(t0, dtype=dtype, device=device))
    _, table = pc.drive_table(drive, st.t_s, dt, n, dtype, device)
    return pc.step_constants(cfg, dt, dtype, device), torch.stack(list(st)), table


def compression_case_config(label: str):
    """(config, initial state kwargs, drive, dt_s, n_steps, t0) of a
    :data:`COMPRESSION_CASES` run."""
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    _, cfg_kw, coil_kw, s_kw, (a, b), dt, n, t0 = compression_case(label)
    return (pc.CompressionConfig(coil=pc.CoilGeometry(**coil_kw), **cfg_kw), s_kw,
            lambda t: a + b * t, dt, n, t0)


def compression_run_case(label: str, dtype, device):
    """(config, trace) of a :data:`COMPRESSION_CASES` run through the entry point."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    cfg, s_kw, drive, dt, n, t0 = compression_case_config(label)
    st = pc.initial_state(cfg, **s_kw, dtype=dtype, device=device)
    st = st._replace(t_s=torch.tensor(t0, dtype=dtype, device=device))
    return cfg, pc.run_voltage_driven_compression(cfg, st, drive, dt_s=dt, n_steps=n)


def compression_plain_case(label: str, dtype, device):
    """The same run through the plain twin: the trace (15, n)."""
    from scpn_fusion_tpu_torch.ops import cuda_compression as ccp
    return ccp.compression_run_plain(*compression_inputs(*compression_case_config(label), dtype,
                                                         device))


def trace_rows(tr):
    import torch
    return torch.stack([*tr.state, tr.b_ext_t, tr.beta, tr.balance_residual])


def cotangent_weights(trace64):
    """Random cotangents on the fifteen rows: standard normals (seed 18) over
    each row's largest magnitude in the float64 trace (1 for an all-zero row
    and for the balance residual, rounding noise of a cancellation)."""
    import torch
    scale = trace64.detach().abs().amax(dim=1, keepdim=True).cpu()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    scale[14] = 1.0
    return torch.randn(tuple(trace64.shape), generator=torch.Generator().manual_seed(18),
                       dtype=torch.float64) / scale


def adjoint_lanes(dtype, device, run, weights=None) -> dict:
    """The two gradient lanes with ``run`` (``compression_run`` or its plain
    twin): d min(radius) / d V at :data:`GRAD_STEPS` (the JAX test's and lane
    4 of ``run_pulsed_suppression.py``), and the gradients of a random
    cotangent on all fifteen rows at :data:`COTANGENT_STEPS` (4000 V) by the
    drive table and by state0 (its start time excluded), the latter in
    relative units (times |state0|), and the cotangents used.  ``weights``:
    the cotangents, float64 (else :func:`cotangent_weights` of this run's
    trace)."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    cfg = pc.CompressionConfig()
    v = torch.tensor(3000.0, dtype=dtype, device=device, requires_grad=True)
    c, s0, table = compression_inputs(cfg, dict(radius_m=0.25), lambda t: v, 2e-8, GRAD_STEPS,
                                      0.0, dtype, device)
    (g,) = torch.autograd.grad(run(c, s0, table)[1].min(), v)
    c, s0, table = compression_inputs(cfg, dict(radius_m=0.25), lambda t: 4000.0, 2e-8,
                                      COTANGENT_STEPS, 0.0, dtype, device)
    s0, table = s0.detach().clone().requires_grad_(), table.detach().clone().requires_grad_()
    trace = run(c, s0, table)
    w = (cotangent_weights(trace) if weights is None else weights).to(dtype).to(device)
    g_drive, g_s0 = torch.autograd.grad((trace * w).sum(), (table, s0))
    return {"dmin_dv": g.detach().cpu().double(), "drive": g_drive.cpu().double(),
            "state0": (g_s0 * s0.detach().abs())[1:].cpu().double(),
            "weights": w.detach().cpu().double()}


def adjoint_gaps(dtype, device) -> dict:
    """max |kernel - autograd| over max |autograd| of each lane of
    :func:`adjoint_lanes`, autograd through the plain loop on ``device``
    (the profile tool's short check)."""
    from scpn_fusion_tpu_torch.ops import cuda_compression as ccp
    ref = adjoint_lanes(dtype, device, ccp.compression_run_plain)
    ours = adjoint_lanes(dtype, device, ccp.compression_run)
    return {k: max_rel(ours[k], ref[k]) for k in ref if k != "weights"}


def compression_gradcheck(device) -> bool:
    """``torch.autograd.gradcheck`` of row P and its adjoint in float64 over
    :data:`GRADCHECK_STEPS` steps at 4000 V, the drive and state0 (its start
    time fixed) scaled to O(1) inputs and each trace row to O(1) outputs."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    from scpn_fusion_tpu_torch.ops import cuda_compression as ccp
    c, s0, table = compression_inputs(pc.CompressionConfig(), dict(radius_m=0.25),
                                      lambda t: 4000.0, 2e-8, GRADCHECK_STEPS, 0.0,
                                      torch.float64, device)
    ref = ccp.compression_run(c, s0, table)
    row = ref.abs().amax(dim=1, keepdim=True)
    row = torch.where(row > 0, row, torch.ones_like(row))
    row[14] = 1.0
    s_scale = torch.where(s0 != 0, s0.abs(), torch.ones_like(s0))

    def fn(x_v, x_s):
        return ccp.compression_run(c, torch.cat([s0[:1], x_s * s_scale[1:]]), x_v * 4000.0) / row

    return bool(torch.autograd.gradcheck(
        fn, ((table / 4000.0).requires_grad_(), (s0[1:] / s_scale[1:]).requires_grad_())))


def frc_lanes(device, cases: dict | None = None, grads: dict | None = None) -> dict:
    """(zf)'s float64 results as numpy: every :data:`COMPRESSION_CASES`
    trace and its diagnostics, the gradient lanes of :func:`adjoint_lanes`,
    the tilt diagnostic over the Faraday trace, ``run_pulsed_suppression.py``'s
    lanes 1, 2 and 4 and ``run_mif_frc.py``'s lanes 1-3 at 512 points.
    ``cases`` (label -> (cfg, trace)) and ``grads`` hold results made
    already on ``device``."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import frc
    from scpn_fusion_tpu_torch.models.physics import frc_stability as fs
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    from scpn_fusion_tpu_torch.ops import cuda_compression as ccp
    fr = importlib.import_module("scpn_fusion_tpu_torch.models.physics.faraday_recovery")

    f64, out = torch.float64, {}
    cases = cases or {label: compression_run_case(label, f64, device)
                      for label, *_ in COMPRESSION_CASES}
    for label, (cfg, tr) in cases.items():
        r0 = compression_case(label)[3]["radius_m"]
        out.update({f"{label} {k}": v for k, v in (
            *tr.state._asdict().items(), ("b_ext_t", tr.b_ext_t), ("beta", tr.beta),
            ("balance_residual", tr.balance_residual),
            *pc.trajectory_diagnostics(tr, cfg, r0)._asdict().items())})
    grads = grads or adjoint_lanes(f64, device, ccp.compression_run)
    out.update({f"gradient {k}": v for k, v in grads.items() if k != "weights"})

    eq = frc.solve_rigid_rotor(b_external_t=1.5, separatrix_radius_m=0.3, peak_density_m3=2e20,
                               n_points=512, dtype=f64, device=device)
    out.update({f"audit {k}": v for k, v in fs.validate_rigid_rotor(eq)._asdict().items()})
    t_i, rho, b_z, r_s = 500.0, eq.rho.cpu().numpy(), eq.b_z.cpu().numpy(), float(eq.r_s)
    p_th = np.sqrt(2.0 * fs.DEUTERIUM_MASS_AMU * fs.ATOMIC_MASS_KG * t_i * fs.ELEMENTARY_CHARGE_C)
    integrand = rho * fs.ELEMENTARY_CHARGE_C * np.abs(b_z) / p_th
    stop = int(np.searchsorted(rho, r_s, side="right"))
    out["tilt s twin"] = np.trapezoid(np.append(integrand[:stop], np.interp(r_s, rho, integrand)),
                                      np.append(rho[:stop], r_s)) / r_s
    out["tilt s"] = fs.s_parameter(eq, t_i)
    out.update({f"tilt report {k}": v for k, v in fs.tilt_mode_report(eq, t_i, 4.0)._asdict().items()})
    out["tilt stable"] = float(fs.tilt_mode_stable(eq, t_i, 4.0)[0])
    pair = {k: torch.tensor(v, dtype=f64, device=device) for k, v in (
        ("t_s", [0.0, 1e-6]), ("radius_m", [0.3, 0.15]), ("t_i_ev", [500.0, 2000.0]),
        ("density_m3", [2e20, 8e20]), ("b_ext_t", [1.5, 6.0]))}
    out.update({f"tilt pair {k}": v for k, v in fs.tilt_trajectory_from_compression(
        eq, t_i, 4.0, **pair)._asdict().items()})
    st = cases["Faraday 400 V, 800 steps"][1]
    out.update({f"tilt faraday {k}": v for k, v in fs.tilt_trajectory_from_compression(
        eq, t_i, 4.0, t_s=st.state.t_s, radius_m=st.state.radius_m, t_i_ev=st.state.t_i_ev,
        density_m3=st.state.density_m3, b_ext_t=st.b_ext_t)._asdict().items()})
    rep = fr.recovery_from_compression(st, n_turns=8, coil_resistance_ohm=0.1)
    out.update({f"faraday {k}": v for k, v in rep.result._asdict().items()})
    out.update({f"faraday {k}": float(getattr(rep, k)) for k in (
        "flux_derivative_closure_passed", "compression_work_j", "energy_budget_relative_error",
        "coil_source_work_j", "source_energy_budget_relative_error")})
    out["faraday statuses evaluated"] = float(rep.budget_claim_status in ("passed", "failed")
                                              and rep.source_budget_claim_status
                                              in ("passed", "failed"))
    return as_numpy({k: torch.as_tensor(v) for k, v in out.items()})


def frc_gates(r: dict) -> dict:
    """The gates of ``tests/test_pulsed_compression.py``, lanes 1, 2 and 4 of
    ``run_pulsed_suppression.py``, lanes 1-3 of ``run_mif_frc.py`` and
    ``tests/test_faraday_recovery.py``'s adapter case, on :func:`frc_lanes`'
    results."""
    u3, u4 = "4000 V, 3000 steps", "4000 V, 4000 steps"
    i_min = int(np.argmin(r[f"{u3} radius_m"]))
    inv = r[f"{u4} t_i_ev"] * (np.pi * r[f"{u4} radius_m"] ** 2) ** (2.0 / 3.0)
    inv15 = (r["3000 V, 1500 steps t_i_ev"]
             * (np.pi * r["3000 V, 1500 steps radius_m"] ** 2) ** (2.0 / 3.0))
    gates = {
        "compresses, heats, densifies (3000 steps)": float(r[f"{u3} radius_m"].min()) < 0.2
        and r[f"{u3} t_i_ev"][i_min] > 150.0 and r[f"{u3} density_m3"][i_min] > 7.5e20
        and float(np.max(np.abs(r[f"{u3} balance_residual"]))) < 1e-8
        and bool(np.all(np.isfinite(r[f"{u3} radius_m"]))),
        "adiabatic invariant (1500 steps)": bool(np.allclose(inv15, inv15[0], rtol=1e-6)),
        "loss channel radiates": float(r["3000 V, 1500 steps, loss radiated_loss_j"][-1]) > 0.0
        and float(r["3000 V, 1500 steps, loss max_balance_residual"]) < 1e-8,
        "bounce (4000 steps)": float(r[f"{u4} radial_turning_points"]) >= 1
        and abs(float(r[f"{u4} compression_ratio"]) - 0.25 / float(r[f"{u4} radius_m"].min()))
        <= 1e-6 * float(r[f"{u4} compression_ratio"])
        and float(r[f"{u4} max_balance_residual"]) < 1e-8,
        "pulsed lane 1": float(r[f"{u4} compression_ratio"]) > 1.3
        and float(r[f"{u4} radial_turning_points"]) >= 1
        and float(r[f"{u4} max_balance_residual"]) < 1e-8,
        "pulsed lane 2": float(np.max(np.abs(inv / inv[0] - 1.0))) < 1e-6,
        "pulsed lane 4": np.isfinite(float(r["gradient dmin_dv"]))
        and float(r["gradient dmin_dv"]) < 0.0,
        "mif lane 1": bool(r["audit all_passed"]),
        "mif lane 2": abs(float(r["tilt s"]) - float(r["tilt s twin"])) <= 1e-6 * float(
            r["tilt s twin"])
        and float(r["tilt stable"]) == 0.0
        and abs(float(r["tilt pair s_parameter"][1] / r["tilt pair s_parameter"][0])
                - 0.5 * 4.0 * np.sqrt(0.25)) <= 1e-6,
        "mif lane 3": bool(r["faraday flux_derivative_closure_passed"])
        and float(r["faraday recovered_energy_j"]) >= 0.0
        and bool(r["faraday statuses evaluated"]),
    }
    return {k: bool(v) for k, v in gates.items()}


def agree_noise(card: dict, cpu: dict, label: str, card_name: str) -> None:
    """:func:`agree` on every result but those of :data:`NOISE_KEYS`, which
    are held absolutely, each to its limit there."""
    limits = {k: min(tol for n, tol in NOISE_KEYS.items() if n in k) for k in cpu
              if any(n in k for n in NOISE_KEYS)}
    agree({k: card[k] for k in cpu if k not in limits},
          {k: v for k, v in cpu.items() if k not in limits}, label, card_name)
    gap = {k: float(np.max(np.abs(np.asarray(card[k], np.float64) - np.asarray(cpu[k], np.float64))))
           for k in limits}
    key = max(gap, key=lambda k: gap[k] / limits[k])
    print(f"{label}: {len(gap)} residuals of a cancellation against the CPU: max absolute "
          f"deviation {gap[key]:.3e} ({key}; limit {limits[key]:.0e}) [{card_name}]")
    require(all(gap[k] <= limits[k] for k in gap), f"{label}: a residual deviates from the CPU")


# (zg): the carrier cases of test_physics_kernels.py TestHallMHD, (params, psi0 zero, ramp
# (a, b) of a + b t or a flat a, dt, steps), and the discovery runs of
# test_hall_mhd_discovery.py at 64^2, drawn from torch.Generator seeds 0-4 and 7
CARRIER_CASES = (
    ("decay", dict(tau_psi_s=1e-3), False, (0.1, None), 1e-5, 200),
    ("ramp drive", dict(tau_psi_s=1.0), True, (0.1, 50.0), 1e-5, 100),
    ("BE residual", dict(tau_psi_s=1e-3), False, (0.1, 5.0), 1e-6, 10),
    ("implicit_be", dict(tau_psi_s=1e-3), False, (0.1, 5.0), 1e-8, 50),
    ("imex_rk2", dict(tau_psi_s=1e-3, time_integrator="imex_rk2"), False, (0.1, 5.0), 1e-8, 50),
)
SWEEP = dict(eta_range=(1e-5, 3e-3), nu_range=(1e-5, 1e-4), n_points=3, sim_steps=250)
BISECTION = dict(eta_range=(1e-6, 1e-2), n_bisect=6, sim_steps=300)


def hall_lanes(device) -> dict:
    """(zg)'s float64 results as numpy: the carrier cases, the rigid rotor
    feeding the carrier, the Spitzer anchor and its cross-module agreement,
    and the discovery runs, sweep and bisection at 64^2 (complex128)."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import disruption_sequence as ds
    from scpn_fusion_tpu_torch.models.physics import frc
    from scpn_fusion_tpu_torch.models.physics import hall_mhd_discovery as hd
    from scpn_fusion_tpu_torch.models.physics import hall_mhd_pulsed as hp

    f64, out = torch.float64, {}
    rho = torch.tensor(np.linspace(0.01, 0.5, 65), dtype=f64, device=device)
    psi0 = 0.02 * torch.sin(torch.pi * rho / 0.5)
    for label, kw, zero, (a, b), dt, steps in CARRIER_CASES:
        ramp = (lambda t, a=a: a) if b is None else (lambda t, a=a, b=b: a + b * t)
        params = hp.HallMHDPulsedParams(electron_temperature_ev=50.0, r_null_m=0.3, **kw)
        final, b_z, diags = hp.run_hall_mhd_pulsed(
            params, torch.zeros_like(psi0) if zero else psi0, rho, torch.zeros_like(rho), ramp,
            dt, n_steps=steps)
        out.update({f"carrier {label} psi": final.psi, f"carrier {label} b_z": b_z,
                    **{f"carrier {label} {k}": v for k, v in diags._asdict().items()}})
    eq = frc.solve_rigid_rotor(b_external_t=0.5, separatrix_radius_m=0.3, dtype=f64,
                               device=device)
    params = hp.HallMHDPulsedParams(tau_psi_s=1e-3, electron_temperature_ev=50.0,
                                    r_null_m=float(eq.r_null))
    final, b_z, _ = hp.run_hall_mhd_pulsed(params, eq.psi[1:], eq.rho[1:], eq.j_theta[1:],
                                           lambda t: 0.5 + 10.0 * t, 1e-6, n_steps=100)
    out.update({"feeds psi": final.psi, "feeds b_z": b_z})
    t_ev = torch.tensor([10.0, 100.0, 1000.0], dtype=f64, device=device)
    out["spitzer 100 eV"] = hp.spitzer_resistivity_ohm_m(100.0, dtype=f64, device=device)
    out["spitzer pulsed"] = hp.spitzer_resistivity_ohm_m(t_ev, z_eff=1.5,
                                                         ln_lambda=float(ds.LN_LAMBDA))
    out["spitzer disruption"] = ds.spitzer_resistivity(t_ev, z_eff=1.5)

    def state(seed):
        return hd.init_hall_mhd(torch.Generator().manual_seed(seed), dtype=f64, device=device)

    for label, seed, kw in (("unforced 300", 0, dict(n_steps=300)),
                            ("free 400", 1, dict(eta=1e-4, n_steps=400)),
                            ("driven 400", 1, dict(eta=1e-4, background_amplitude=1.0, n_steps=400)),
                            ("zonal 150", 2, dict(background_amplitude=1.0, n_steps=150)),
                            ("replay 100", 7, dict(n_steps=100))):
        tr = hd.run_hall_mhd(state(seed), **kw)
        out.update({f"{label} total": tr.total_energy, f"{label} zonal": tr.zonal_energy})
    out["replay 100 again"] = hd.run_hall_mhd(state(7), n_steps=100).total_energy
    out["sheet"] = torch.fft.ifft2(hd.background_flux_k(64, 2.0, dtype=f64, device=device)).real
    etas, nus, growth = hd.parameter_sweep(torch.Generator().manual_seed(3), **SWEEP, dtype=f64,
                                           device=device)
    out.update({"sweep etas": etas, "sweep nus": nus, "sweep growth": growth})
    res = hd.find_tearing_threshold(torch.Generator().manual_seed(4), **BISECTION, dtype=f64,
                                    device=device)
    out.update({f"bisection {k}": v for k, v in res.items()})
    return as_numpy(out)


def hall_gates(r: dict) -> dict:
    """The gates of ``tests/test_physics_kernels.py`` (``TestHallMHD``),
    ``test_edge_orbits_frc.py``'s carrier case, ``run_physics_closures.py``'s
    Spitzer lane and ``tests/test_hall_mhd_discovery.py``, on
    :func:`hall_lanes`' results."""
    psi0 = 0.02 * np.sin(np.pi * np.linspace(0.01, 0.5, 65) / 0.5)
    e = r["unforced 300 total"]
    etas, growth = r["sweep etas"], r["sweep growth"]
    x = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    gates = {
        "carrier decays e^-2": abs(np.max(np.abs(r["carrier decay psi"])) / np.max(np.abs(psi0))
                                   - np.exp(-2.0)) <= 0.05 * np.exp(-2.0),
        "ramp drives flux": np.max(np.abs(r["carrier ramp drive psi"])) > 0.0
        and r["carrier ramp drive hall_drive_l2"][-1] > 0.0
        and bool(np.all(np.isfinite(r["carrier ramp drive b_z"]))),
        "BE residual": float(np.max(r["carrier BE residual source_residual_linf"])) < 1e-6,
        "integrators agree": bool(np.allclose(r["carrier implicit_be psi"],
                                              r["carrier imex_rk2 psi"], rtol=1e-4, atol=1e-12)),
        "rigid rotor feeds the carrier": bool(np.all(np.isfinite(r["feeds psi"]))),
        "Spitzer anchor": abs(float(r["spitzer 100 eV"]) / (0.51 * 1.03e-4 * 17.0 / 100.0**1.5)
                              - 1.0) < 0.05
        and float(np.max(np.abs(r["spitzer pulsed"] / r["spitzer disruption"] - 1.0))) < 0.01,
        "unforced decays": bool(np.all(np.isfinite(e))) and e[-1] < 5.0 * e.max()
        and e[-1] <= np.max(e[:50]) * 2.0,
        "replay": bool(np.array_equal(r["replay 100 total"], r["replay 100 again"])),
        "sheet injects energy": np.isfinite(r["driven 400 total"][-1])
        and r["driven 400 total"][-1] > 1.05 * r["free 400 total"][-1],
        "zonal within total": bool(np.all(r["zonal 150 zonal"] <= r["zonal 150 total"] + 1e-12)),
        "cos x sheet": bool(np.allclose(r["sheet"][0, :], 2.0 * np.cos(x), atol=1e-10, rtol=0.0)
                            and np.allclose(r["sheet"][10, :], r["sheet"][0, :], atol=1e-10,
                                            rtol=0.0)),
        "sweep": bool(np.all(np.isfinite(growth)))
        and growth[etas == etas.min()].mean() > growth[etas == etas.max()].mean(),
        "bisection bracketed": 1e-6 <= float(r["bisection threshold_eta"]) <= 1e-2
        and float(r["bisection lo"]) <= float(r["bisection threshold_eta"])
        <= float(r["bisection hi"]),
    }
    return {k: bool(v) for k, v in gates.items()}


def slice18_on_cpu(conn) -> None:
    """The CPU twins of (zf) and (zg)."""
    dev = on_cpu(4)
    conn.send({"zf": frc_lanes(dev), "zg": hall_lanes(dev)})
    conn.close()


def slice18_plain_on_card(conn) -> None:
    """(zf)'s plain references on the card, in a process of its own: row P's
    plain twin on every :data:`COMPRESSION_CASES` run in float32 and float64
    (but the timed float64 one, which (zf) runs in line), and autograd
    through it on the gradient lanes in float32 and float64, and in float64
    on the float32 lane's cotangents, as numpy arrays of the run's dtype (a
    tensor through a pipe would share memory with a process that ends)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.ops import cuda_compression as ccp
    dev, out = torch.device("cuda"), {}
    for dtype in (torch.float32, torch.float64):
        for label, *_ in COMPRESSION_CASES:
            if not (dtype == torch.float64 and label == COMPRESSION_TIMED):
                out[(str(dtype), label)] = compression_plain_case(label, dtype, dev).cpu().numpy()
    g64 = adjoint_lanes(torch.float64, dev, ccp.compression_run_plain)
    g32 = adjoint_lanes(torch.float32, dev, ccp.compression_run_plain)
    g64_32 = adjoint_lanes(torch.float64, dev, ccp.compression_run_plain, weights=g32["weights"])
    for key, g in (("grad f64", g64), ("grad f32", g32), ("grad f64 at f32's cotangents", g64_32)):
        out[key] = {k: v.numpy() for k, v in g.items()}
    conn.send(out)
    conn.close()


def compression_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                       measured_plain: dict, plain_card, twin: dict) -> tuple[int, int]:
    """(zf) row P: every :data:`COMPRESSION_CASES` run ONE launch, in float32
    and float64, ``torch.equal`` to its plain twin on the card
    (``plain_card``: :func:`slice18_plain_on_card`'s, the timed run's in
    line); row P's adjoint against autograd through the plain twin on the
    card (float64 within :data:`ADJOINT_F64_TOL`; float32 d min(radius) / d V
    within :data:`ADJOINT_F32_TOL`, and on random cotangents no further from
    the float64 gradient than :data:`F32_GRADIENT_SPREAD` times autograd's
    float32 gradient is, plus that tolerance; the float32 lane's minimum can
    sit at another step than the float64 one's, so only the float64 gradient
    is held to the JAX test's sign), ``gradcheck`` in float64; the gates of :func:`frc_gates`
    and every float64 result within 1e-9 of the CPU (``twin``:
    :func:`slice18_on_cpu`'s), the diagnostics' counts equal.  Returns the
    counted launches of row P and of its adjoint."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import pulsed_compression as pc
    from scpn_fusion_tpu_torch.ops import cuda_compression as ccp

    f32, f64 = torch.float32, torch.float64
    print(f"(zf) csrc/compression.cu's PTX (nvcc -ptx): {disruption_ptx('compression.cu')} sqrt / "
          f"rsqrt / call instructions (pow's exponent is read from the constants)")
    one = {name: int(name == "compression_run") for name in KERNELS}
    two = {name: 2 * int(name in ("compression_run", "compression_adjoint")) for name in KERNELS}
    timed, ms_p = events_ms(functools.partial(compression_plain_case, COMPRESSION_TIMED, f64, dev))
    plain = plain_card()
    runs, adjoints, cases64, grads = 0, 0, {}, {}
    for dtype in (f32, f64):
        tag = "f32" if dtype == f32 else "f64"
        for label, *_ in COMPRESSION_CASES:
            (cfg, tr), calls, launched = counted(functools.partial(compression_run_case, label,
                                                                   dtype, dev))
            require(calls == one and launched == {f"scpn_compression_{tag}": 1},
                    f"(zf) {label} {tag}: {calls} / {launched}, not one launch of row P")
            by_path[f"compression {label} {tag}"] = calls
            runs += calls["compression_run"]
            ref = (timed.cpu() if (tag == "f64" and label == COMPRESSION_TIMED)
                   else torch.from_numpy(plain[(str(dtype), label)]))
            rows = trace_rows(tr)
            equal = torch.equal(rows.cpu(), ref)
            d = pc.trajectory_diagnostics(tr, cfg, compression_case(label)[3]["radius_m"])
            print(f"(zf) row P {tag} {label}: one launch, torch.equal to the plain loop {equal}; "
                  f"min radius {float(d.min_radius_m)!r} m, ratio {float(d.compression_ratio)!r}, "
                  f"{int(d.radial_turning_points)} turning points, {int(d.floor_contact_count)} "
                  f"floor contacts, max |balance residual| {float(d.max_balance_residual)!r} "
                  f"[{card}]")
            require(equal, f"(zf) row P {tag} {label}: the kernel differs from its plain loop")
            if tag == "f64":
                cases64[label] = (cfg, tr)
            if tag == "f64" and label == COMPRESSION_TIMED:
                results["compression_run"] = {"max_abs_err": float((rows - timed).abs().max())}

        g, calls, launched = counted(functools.partial(adjoint_lanes, dtype, dev,
                                                       ccp.compression_run))
        require(calls == two and launched == {f"scpn_compression_{tag}": 2,
                                              f"scpn_compression_adjoint_{tag}": 2},
                f"(zf) gradient lanes {tag}: {calls} / {launched}, not two launches of row P and "
                f"two of its adjoint")
        by_path[f"compression gradients {tag}"] = calls
        runs += calls["compression_run"]
        adjoints += calls["compression_adjoint"]
        grads[tag] = g
    keys = ("dmin_dv", "drive", "state0")
    ref64, ref32, ref64_32 = ({k: torch.from_numpy(v) for k, v in plain[key].items()} for key in (
        "grad f64", "grad f32", "grad f64 at f32's cotangents"))
    gap64 = {k: max_rel(grads["f64"][k], ref64[k]) for k in keys}
    gap32 = {k: max_rel(grads["f32"][k], ref32[k]) for k in keys}
    to64 = {k: max_rel(grads["f32"][k], ref64_32[k]) for k in keys}
    auto64 = {k: max_rel(ref32[k], ref64_32[k]) for k in keys}
    print(f"(zf) row P's adjoint against autograd through the plain loop on the card: f64 {gap64} "
          f"(limit {ADJOINT_F64_TOL:.0e}); f32 {gap32}; f32 against the f64 gradient: the kernel "
          f"{to64}, autograd {auto64}; d min(radius)/dV at {GRAD_STEPS} steps "
          f"{float(grads['f64']['dmin_dv'])!r} m/V f64, {float(grads['f32']['dmin_dv'])!r} f32 "
          f"[{card}]")
    require(all(v <= ADJOINT_F64_TOL for v in gap64.values()),
            "(zf) row P's float64 adjoint deviates from autograd through the plain loop")
    require(gap32["dmin_dv"] <= ADJOINT_F32_TOL,
            "(zf) row P's float32 d min(radius)/dV deviates from autograd's")
    require(all(to64[k] <= F32_GRADIENT_SPREAD * auto64[k] + ADJOINT_F32_TOL
                for k in ("drive", "state0")),
            "(zf) row P's float32 adjoint is further from the float64 gradient than autograd's")
    require(float(grads["f64"]["dmin_dv"]) < 0.0, "(zf) d min(radius)/dV is not negative")
    ok = compression_gradcheck(dev)
    print(f"(zf) gradcheck of row P and its adjoint, f64, {GRADCHECK_STEPS} steps: {ok} [{card}]")
    require(ok, "(zf) gradcheck of row P failed")

    (r, ms), calls, launched = counted(lambda: events_ms(
        lambda: frc_lanes(dev, cases64, grads["f64"])))
    require(calls == {name: 0 for name in KERNELS} and not launched,
            f"(zf) lanes: {calls} / {launched}: the FRC and Faraday lanes launch no kernel")
    by_path["frc_faraday_lanes_f64"] = calls
    gates = frc_gates(r)
    print(f"(zf) gates of the JAX tests and validations on the card (f64): {gates}; the FRC, tilt "
          f"and Faraday lanes {ms:.1f} ms (CUDA events) [{card}]")
    require(all(gates.values()), "(zf): the port misses a gate of the JAX tests")
    counts = [k for k in twin["zf"] if k.endswith(("radial_turning_points", "floor_contact_count"))]
    require(all(np.array_equal(r[k], twin["zf"][k]) for k in counts),
            "(zf): a diagnostic's count differs from the CPU's")
    agree_noise(r, twin["zf"], "(zf) row P's runs and gradients, the FRC, tilt and Faraday lanes",
                card)

    label, *_ = compression_case(COMPRESSION_TIMED)
    c, s0, table = compression_inputs(pc.CompressionConfig(), dict(radius_m=0.25),
                                      lambda t: 4000.0, 2e-8, 4000, 0.0, f64, dev)
    measured_plain["compression_run"] = ms_p
    timing["compression_run"] = (functools.partial(ccp.compression_run, c, s0, table),
                                 functools.partial(ccp.compression_run_plain, c, s0, table),
                                 f"{label} f64", compression_work(4000, 8))
    c, s0, table = compression_inputs(pc.CompressionConfig(), dict(radius_m=0.25),
                                      lambda t: 3000.0, 2e-8, GRAD_STEPS, 0.0, f64, dev)
    v_k, v_p = table.clone().requires_grad_(), table.clone().requires_grad_()
    trace_k, trace_p = ccp.compression_run(c, s0, v_k), ccp.compression_run_plain(c, s0, v_p)
    seed = torch.zeros_like(trace_p)
    seed[1, int(trace_p[1].argmin())] = 1.0

    def adjoint(trace, v):
        return torch.autograd.grad(trace, v, seed, retain_graph=True)[0]

    g_p, ms_pa = events_ms(functools.partial(adjoint, trace_p, v_p))
    measured_plain["compression_adjoint"] = ms_pa
    results["compression_adjoint"] = {"max_abs_err": float((adjoint(trace_k, v_k)
                                                             - g_p).abs().max())}
    timing["compression_adjoint"] = (functools.partial(adjoint, trace_k, v_k),
                                     functools.partial(adjoint, trace_p, v_p),
                                     f"d min(radius)/dV backward, {GRAD_STEPS} steps f64",
                                     compression_adjoint_work(GRAD_STEPS, 8))
    for name, n in (("compression_run", 4000), ("compression_adjoint", GRAD_STEPS)):
        kernel, _, shape, work = timing[name]
        ms_k = cuda_ms(kernel)
        b, by = bound(work)
        chain = ladder_chain_ms(n, COMPRESSION_DEPTH)
        print(f"time (zf) {name} ({shape}): kernel {ms_k:.4f} ms ({1e3 * ms_k / n:.4f} us a "
              f"step; CUDA events, median of 5), bound {b:.4g} ms ({by}: {work[0] / 1e6:.4g} MB, "
              f"{work[1] / 1e6:.4g} Mflop); the forward's dependent chain "
              f"{n * COMPRESSION_DEPTH} operations ({n} steps x ~{COMPRESSION_DEPTH}), "
              f"~{chain:.4f} ms at a nominal 4 cycles each and {SM_CLOCK_HZ / 1e9:.2f} GHz (a "
              f"count, not a bound: a pow and two IEEE f64 divisions a step on the chain); plain "
              f"{measured_plain[name]:.1f} ms (once); library_ms null (no PyTorch call runs a "
              f"compression trajectory or its gradient) [{card}]")
    return runs, adjoints


def hall_checks(dev, card: str, counted, by_path: dict, twin: dict) -> None:
    """(zg) the pulsed carrier, the rigid rotor feeding it, the Spitzer lane
    and the discovery sandbox at 64^2 (the JAX tests' runs, sweep and
    bisection) in float64 on the card: no kernel launches; the gates of
    :func:`hall_gates`; every result within 1e-9 of the CPU (``twin``:
    :func:`slice18_on_cpu`'s), the residuals absolutely."""
    (r, ms), calls, launched = counted(lambda: events_ms(lambda: hall_lanes(dev)))
    gates = hall_gates(r)
    print(f"(zg) the carrier, Spitzer and discovery lanes on the card (f64, 64^2 c128): gates "
          f"{gates}; sweep growth {r['sweep growth'].tolist()}, threshold eta "
          f"{float(r['bisection threshold_eta'])!r} in [{float(r['bisection lo'])!r}, "
          f"{float(r['bisection hi'])!r}]; {ms:.1f} ms (CUDA events) [{card}]")
    require(all(gates.values()), "(zg): the port misses a gate of the JAX tests")
    require(calls == {name: 0 for name in KERNELS} and not launched,
            f"(zg): {calls} / {launched}: the Hall-MHD lanes launch no kernel")
    by_path["hall_mhd_f64"] = calls
    agree_noise(r, twin["zg"], "(zg) the pulsed carrier and the Hall-MHD sandbox", card)


# ── the nineteenth slice: (zh) row F, the guiding-centre orbit -- a fast-ion
# population and one orbit -- with the fast-ion validation lanes and the plain
# Boris and lambda-field lanes; (zi) ICRH, ECRH, current drive, the drift-wave
# turbulence, the divertor lab and the stellarator lane ──

FAST_R0, FAST_A, FAST_B0 = 6.2, 2.0, 5.3     # tests/test_fast_ions.py:29
FAST_DT, FAST_STEPS = 1e-8, 4000
# (label, torch.Generator seed, particles, birth minor radius): the JAX tests' populations
# (test_fast_ions.py:36-48, 94-102) and the 2048 of its birth test, each followed 4000 steps
FAST_POPULATIONS = (("central 256", 0, 256, 2.0), ("narrow 512", 7, 512, 0.4),
                    ("wide 512", 7, 512, 1.6), ("birth 2048", 1, 2048, 2.0))
FAST_TIMED = "birth 2048"
# test_edge_orbits_frc.py:90-102: the guiding centre, its 20,000 steps; the plain twin on the
# card is held to the kernel's first GC_PLAIN_STEPS (the trace is a prefix) and to a
# GC_PLAIN_STEPS-step launch
GC = dict(m_amu=2.0, charge_z=1, e_kev=80.0, pitch_angle=0.4, r0=6.8, z0=0.0)
GC_STEPS, GC_PLAIN_STEPS = 20000, 4000
# validation/run_fast_ions.py:40-46: lanes 3-5, 384 alphas x 8000 steps of 5 ns
LANE_IPS, LANE_N, LANE_STEPS, LANE_DT = (15.0, 2.0, 5.0, 10.0), 384, 8000, 5e-9
LANE_SEED = 20260819     # the validation's PRNG key, seeding a torch.Generator
# operations a particle-step of row F (csrc/orbits.cu: four right-hand sides of 109 -- the
# field and its gradient 75, the guiding-centre equations 34 -- the stage and final updates
# 52, the wall and bounce tests 6), and the dependent operations a step on a particle's chain
# (~25 a right-hand side, two square roots and ~6 divisions among them)
ORBIT_OPS, ORBIT_DEPTH = 494, 100
# (zi): the drift-wave lanes of test_drift_wave_esn.py (64^2, 800 + 200 steps at kappa 0
# and 2; 32^2, 200 + 500), the float32 lane held to the CPU (32^2, 20 + 30 steps) and its
# limit (cuFFT against pocketfft, float32), and the float64 step lane (64^2, 100 steps)
DRIFT_F32_TOL, DRIFT_F64_STEPS = 1e-4, 100
# ECRH's float32 inputs (JAX's :241,243,258) round in float32 on each device (a quotient by a
# constant is a product on the card, float32 sin and cos are libdevice's there and SLEEF's on
# the CPU): its deposition and efficiency against the CPU, relative
ECRH_F32_TOL = 1e-5


def fast_field(ip_ma: float = 15.0):
    """The analytic ITER-like field; validation/run_fast_ions.py:111-114 scales
    q0 and qa with 15 MA / Ip."""
    from scpn_fusion_tpu_torch.models.physics import fast_ions as fi
    return fi.tokamak_field(FAST_B0, FAST_R0, FAST_A, q0=15.0 / ip_ma, qa=3.0 * (15.0 / ip_ma))


def fast_population(label: str, dtype, device):
    """A population of :data:`FAST_POPULATIONS`, drawn on the CPU (so card and
    CPU see the same draws)."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import fast_ions as fi
    _, seed, n, a = next(p for p in FAST_POPULATIONS if p[0] == label)
    return fi.sample_fast_ion_birth(torch.Generator().manual_seed(seed), n, fast_field(),
                                    r0=FAST_R0, a=a, dtype=dtype, device=device)


def fast_constants(dtype, device):
    """Row F's constants for the JAX tests' alphas: 1e-8 s steps, walls 0.5 m
    outside the plasma (test_fast_ions.py:44-46)."""
    from scpn_fusion_tpu_torch.models.physics import fast_ions as fi
    return fi.ensemble_constants(fi.ALPHA_AMU, fi.ALPHA_Z, FAST_DT, FAST_R0 - FAST_A - 0.5,
                                 FAST_R0 + FAST_A + 0.5, FAST_A + 0.5, dtype, device)


def packed(state):
    import torch
    return torch.stack(list(state))


def orbit_state(dtype, device):
    """(step constants, state (5,)) of the JAX test's guiding centre in
    :func:`fast_field`."""
    from scpn_fusion_tpu_torch.models.physics import orbits
    s0 = orbits.init_guiding_center(fast_field(), **GC, dtype=dtype, device=device)
    return orbits.step_constants(2.0, 1, 1e-8, dtype, device), packed(s0)


def orbit_work(n: int, n_steps: int, item: int, ensemble: bool = True):
    """Row F: (bytes, operations, peak rate): the state (5 n) and constants
    read; the final state, flags and drift (ensemble) or the final state and
    the two traces (orbit) written."""
    out = item * (4 * n + n) + 2 * n if ensemble else item * (4 + 2 * n_steps)
    return (float(item * (5 * n + 16) + out), float(ORBIT_OPS * n * n_steps),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def orbit_ptx(source: str = "orbits.cu") -> dict:
    """Square roots and divisions of a kernel source's PTX (``csrc/orbits.cu``
    by default) by rounding: only ``.rn`` (IEEE) forms are expected, no
    ``approx`` or ``full``."""
    import tempfile
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        out = Path(tmp) / "kernel.ptx"
        subprocess.run([cb._nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "-ptx",
                        str(cb.CSRC / source), "-o", str(out)], check=True,
                       capture_output=True)
        ptx = out.read_text()
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", ptx)) for op in (
        "sqrt.rn.f32", "sqrt.rn.f64", "div.rn.f32", "div.rn.f64", "sqrt.approx.f32",
        "sqrt.approx.ftz.f32", "div.approx.f32", "div.full.f32", "rcp.approx.ftz.f64",
        "fma.rn.f32", "fma.rn.f64")}


def fast_ion_lanes(device) -> dict:
    """``validation/run_fast_ions.py``'s lanes in float64: 1 (Stix critical
    energy, slowing-down time), 2 (the slow-down-averaged heating partition)
    and 3-5 (384 alphas x 8000 steps at 5, 10, 15 and 2 MA through
    ``follow_ensemble``: row F on the card), drawn from a ``torch.Generator``
    seeded with the validation's key."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import fast_ions as fi
    f64, out = torch.float64, {}
    kw = dict(dtype=f64, device=device)
    m_alpha = fi.ALPHA_AMU * fi.ATOMIC_MASS_KG
    v_c = fi.critical_velocity(20.0, **kw)
    out["e_c_over_te"] = 0.5 * m_alpha * v_c**2 / fi.E_CHARGE / 1e3 / 20.0
    out["tau_se"] = fi.tau_spitzer_electron(20.0, 1.0, **kw)
    out["coulomb_log"] = fi.coulomb_log_ei(20.0, 1.0, **kw)
    v_birth = float(np.sqrt(2.0 * fi.ALPHA_BIRTH_KEV * 1e3 * fi.E_CHARGE / m_alpha))
    out["thermalisation"] = fi.slowing_down_time(v_birth, 0.1 * v_birth, v_c, out["tau_se"])
    v_grid = torch.tensor(np.linspace(0.05 * v_birth, v_birth, 2001), **kw)
    for te in (10.0, 20.0, 30.0):
        f_ion, _ = fi.heating_partition(v_grid, fi.critical_velocity(te, **kw))
        out[f"f_ion_avg {te:g}"] = torch.trapezoid(f_ion * v_grid, v_grid) / torch.trapezoid(
            v_grid, v_grid)
    for ip in LANE_IPS:
        field = fast_field(ip)
        birth = fi.sample_fast_ion_birth(torch.Generator().manual_seed(LANE_SEED), LANE_N, field,
                                         r0=FAST_R0, a=FAST_A, **kw)
        s = fi.follow_ensemble(birth, field, m_amu=fi.ALPHA_AMU, charge_z=fi.ALPHA_Z, dt=LANE_DT,
                               n_steps=LANE_STEPS, r_wall_in=FAST_R0 - 1.15 * FAST_A,
                               r_wall_out=FAST_R0 + 1.15 * FAST_A, z_wall=1.15 * FAST_A)
        out.update({f"{ip:g} MA {k}": getattr(s, k) for k in (
            "n_passing", "n_trapped", "n_lost", "loss_fraction", "trapped_fraction",
            "energy_drift_rel_max")})
        out[f"{ip:g} MA final"] = torch.stack(list(s.final))
    out["bound 15 MA"] = fi.first_orbit_loss(FAST_R0, FAST_A, 15.0, **kw)
    return as_numpy({k: torch.as_tensor(v) for k, v in out.items()})


def fast_ion_gates(r: dict) -> dict:
    """The gates of ``validation/run_fast_ions.py``'s five lanes."""
    loss = {ip: float(r[f"{ip:g} MA loss_fraction"]) for ip in LANE_IPS}
    gates = {
        "lane 1 Stix": 28.0 <= float(r["e_c_over_te"]) <= 36.0 and 0.6 <= float(r["tau_se"]) <= 1.6
        and 15.0 <= float(r["coulomb_log"]) <= 20.0 and 0.3 <= float(r["thermalisation"]) <= 2.0,
        "lane 2 partition": 0.15 <= float(r["f_ion_avg 20"]) <= 0.45
        and float(r["f_ion_avg 10"]) < float(r["f_ion_avg 20"]) < float(r["f_ion_avg 30"]) < 0.5,
        "lane 3 energy drift < 1e-5": np.isfinite(float(r["15 MA energy_drift_rel_max"]))
        and float(r["15 MA energy_drift_rel_max"]) < 1e-5,
        "lane 4 prompt loss": loss[15.0] <= float(r["bound 15 MA"]) + 0.05,
        "lane 5 Ip scaling": loss[2.0] > 0.01
        and loss[2.0] >= loss[5.0] >= loss[10.0] >= loss[15.0],
    }
    return {k: bool(v) for k, v in gates.items()}


def fast_ion_test_gates(stats: dict) -> dict:
    """The gates of ``tests/test_fast_ions.py`` on the statistics of
    :data:`FAST_POPULATIONS` (label -> ``EnsembleStats``), and its birth test
    on the 2048 births."""
    import torch
    central, narrow, wide = (stats[k] for k in ("central 256", "narrow 512", "wide 512"))
    birth = fast_population("birth 2048", torch.float64, "cpu")
    rm = np.hypot(birth.r.numpy() - FAST_R0, birth.z.numpy())
    v_par = birth.v_par.numpy()
    gates = {
        "partition": int(central.n_passing + central.n_trapped + central.n_lost) == 256,
        "loss fraction < 0.35": float(central.loss_fraction) < 0.35,
        "trapped fraction in (0.05, 0.75)": 0.05 < float(central.trapped_fraction) < 0.75,
        "energy drift < 1e-2": float(central.energy_drift_rel_max) < 1e-2,
        "wider birth traps more": float(wide.trapped_fraction)
        > float(narrow.trapped_fraction) + 0.02,
        "birth prior": rm.max() < FAST_A and np.median(rm) < 0.45 * FAST_A
        and (v_par > 0).mean() > 0.35 and (v_par < 0).mean() > 0.35,
    }
    return {k: bool(v) for k, v in gates.items()}


def lambda_field(r, z, b0=5.3, r0=6.2):
    """``TestOrbits._tokamak_field`` (test_edge_orbits_frc.py:80-86)."""
    return -0.1 * z, 0.1 * (r - r0), b0 * r0 / r


def orbit_plain_lanes(device) -> dict:
    """``TestOrbits`` on plain ops at its lengths, float64: the lambda-field
    guiding centre (20,000 steps; grad |B| by ``torch.func.grad``), the Boris
    gyration (5000 steps) and the E x B drift (40,000 steps), with their
    gates; the port's kernel calls while they ran."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import orbits
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    f64, out = torch.float64, {}
    cb.reset_launch_counts()
    s0 = orbits.init_guiding_center(lambda_field, **GC, dtype=f64, device=device)
    (final, tr), ms = events_ms(lambda: orbits.run_guiding_center(
        s0, lambda_field, m_amu=2.0, charge_z=1, dt=1e-8, n_steps=GC_STEPS))
    r = tr["r"].cpu().numpy()
    br, bz, bphi = lambda_field(float(final.r), float(final.z))
    e_final = (0.5 * 2.0 * 1.66053906660e-27 * float(final.v_par) ** 2
               + float(final.mu) * np.sqrt(br**2 + bz**2 + bphi**2))
    out["gc ms"] = ms
    out["gc gate"] = bool(np.all(np.isfinite(r)) and np.all((r > 4.0) & (r < 9.0))
                          and abs(e_final / (80.0e3 * 1.602176634e-19) - 1.0) <= 0.02)
    qm = 1.602176634e-19 / (2.0 * 1.66053906660e-27)
    e0, b5 = torch.zeros(3, dtype=f64, device=device), torch.tensor([0.0, 0.0, 5.0], dtype=f64,
                                                                     device=device)
    st = orbits.BorisState(torch.zeros(3, dtype=f64, device=device),
                           torch.tensor([1e6, 0.0, 0.0], dtype=f64, device=device))
    (_, tr), ms = events_ms(lambda: orbits.run_boris(st, lambda x: (e0, b5), q_over_m=qm,
                                                     dt=1e-9, n_steps=5000))
    en, x = tr["energy"].cpu().numpy(), tr["x"].cpu().numpy()
    out["gyration ms"] = ms
    out["gyration gate"] = bool(np.allclose(en, en[0], rtol=1e-6, atol=0.0) and abs(
        0.5 * (x[:, 0].max() - x[:, 0].min()) / (1e6 / (qm * 5.0)) - 1.0) <= 0.01)
    e1 = torch.tensor([0.0, 1e4, 0.0], dtype=f64, device=device)
    b2 = torch.tensor([0.0, 0.0, 2.0], dtype=f64, device=device)
    st = orbits.BorisState(torch.zeros(3, dtype=f64, device=device),
                           torch.zeros(3, dtype=f64, device=device))
    (final, _), ms = events_ms(lambda: orbits.run_boris(st, lambda x: (e1, b2), q_over_m=qm,
                                                        dt=5e-9, n_steps=40000))
    out["exb ms"] = ms
    out["exb drift"] = float(final.x[0]) / (5e-9 * 40000)
    out["exb gate"] = bool(abs(out["exb drift"] / (1e4 / 2.0) - 1.0) <= 0.05)
    out["kernel calls"] = sum(cb.CALLS.values())
    return out


def heating_lanes(device) -> dict:
    """(zi)'s float64 results as numpy: the default ICRH bundle (10 x 160), its
    deposition, ECRH at two launches, the current-drive mix of
    ``test_rf_current_drive.py``, the drift-wave step at 64^2 with float64
    operators (:data:`DRIFT_F64_STEPS`), ``run_divertor_ballooning.py``'s lanes
    1-3 (lane 3 through row B) and ``run_stellarator_lane.py``'s lanes 1-3."""
    import dataclasses

    import torch
    from scpn_fusion_tpu_torch.models.physics import ballooning as bl
    from scpn_fusion_tpu_torch.models.physics import current_drive as cd
    from scpn_fusion_tpu_torch.models.physics import divertor_lab as dl
    from scpn_fusion_tpu_torch.models.physics import drift_wave as dw
    from scpn_fusion_tpu_torch.models.physics import rf_heating as rf
    from scpn_fusion_tpu_torch.models.physics import stellarator as st
    f64, out = torch.float64, {}
    kw = dict(dtype=f64, device=device)
    p = rf.ICRHParams()
    rays = rf.trace_icrh_rays(p, **kw)
    out.update({f"icrh {k}": getattr(rays, k) for k in ("r", "z", "k_r", "k_z", "frozen")})
    out.update({f"icrh deposition {i}": v for i, v in enumerate(
        rf.icrh_power_deposition(p, rays, 20.0))})
    for label, ekw in (("default", {}), ("angled", dict(launch_angle_deg=25.0, t_e_kev=4.0))):
        out.update({f"ecrh {label} {i}": v for i, v in enumerate(
            rf.ecrh_deposition(rf.ECRHParams(), **ekw, **kw))})
    rho = torch.linspace(0.0, 1.0, 50, **kw)
    ne, te = 8.0 * (1 - rho**2) ** 0.5 + 1.0, 20.0 * (1 - rho**2) + 0.5
    mix = cd.CurrentDriveMix(a_minor=2.0).with_source(cd.ECCDSource(10.0, 0.3, 0.08)) \
        .with_source(cd.NBISource(33.0, 1000.0, 0.2)).with_source(cd.LHCDSource(5.0, 0.6, 0.1))
    out["cd j"] = mix.total_j_cd(rho, ne, te, te)
    out["cd p"] = mix.total_heating_power(rho)
    out["cd i 1.7"] = mix.total_driven_current(rho, ne, te, te, elongation=1.7)
    out["cd i 1"] = mix.total_driven_current(rho, ne, te, te)
    out["cd i kappa"] = mix.total_driven_current(rho, ne, te, te, elongation=1.4 + 0.3 * rho**2)
    cfg = dw.DriftWaveConfig(n=64)
    noise = torch.randn((2, 64, 64), generator=torch.Generator().manual_seed(2), dtype=f64)
    s = dw._initial_state(noise[0].to(device), noise[1].to(device), cfg)
    ops = dw._operators(cfg, f64, device)
    for _ in range(DRIFT_F64_STEPS):
        s = dw.step(s, cfg, ops)
    out["drift f64 phi"], out["drift f64 n"] = dw.real_fields(s)
    load = dl.divertor_heat_load(80.0, 2.1, 2.5, expansion_factor=15.0, **kw)
    out.update({f"divertor load {k}": v for k, v in load._asdict().items()})
    out.update({f"divertor tungsten {k}": v for k, v in dl.tungsten_monoblock(
        load.q_target)._asdict().items()})
    out.update({f"divertor lithium {k}": v for k, v in dl.lithium_vapor_shield(
        load.q_target)._asdict().items()})
    v = torch.tensor([0.5, 2.0, 8.0, 20.0], **kw)
    for p_sol in (80.0, 20.0):
        out.update({f"divertor scan {p_sol:g} {k}": x for k, x in dl.flow_velocity_scan(
            v, p_sol, 2.1, 2.5)._asdict().items()})
    scan = bl.second_stability_scan(torch.linspace(0.25, 2.0, 8, **kw), alpha_max=5.0,
                                    n_alpha=48)
    out.update({f"ballooning {k}": x for k, x in scan._asdict().items()})
    out["ballooning marginal"] = bl.marginal_alpha(1.0, alpha_hi=2.0, **kw)
    w7x = st.w7x_config()
    out["iss04"] = st.iss04_tau_e(w7x, 8.0, 5.0, **kw)
    out["iss04 p"] = st.iss04_tau_e(w7x, 8.0, 5.5, **kw)
    out["iss04 n"] = st.iss04_tau_e(w7x, 8.8, 5.0, **kw)
    out["iota 2/3"] = st.iota_profile(w7x, 2.0 / 3.0, **kw)
    out["ripple axi"] = st.effective_ripple(dataclasses.replace(
        w7x, mirror_ratio=0.0, helical_excursion=0.0), 0.5, **kw)
    for s_ in (0.5, 1.0):
        out[f"ripple {s_:g}"] = st.effective_ripple(w7x, s_, **kw)
        out.update({f"surface {s_:g} {i}": x for i, x in enumerate(
            st.stellarator_flux_surface(w7x, s_, n_theta=32, n_phi=40, **kw))})
    for t in (1.0, 10.0):
        out[f"chi {t:g}"] = st.stellarator_neoclassical_chi(w7x, 0.5, t, 5.0, **kw)
    out["chi mirror x2"] = st.stellarator_neoclassical_chi(
        dataclasses.replace(w7x, mirror_ratio=2.0 * w7x.mirror_ratio), 0.5, 1.0, 5.0, **kw)
    return as_numpy({k: torch.as_tensor(x) for k, x in out.items()})


def heating_gates(r: dict) -> dict:
    """The gates of ``tests/test_rf_current_drive.py`` (on the default
    bundle), ``run_divertor_ballooning.py``'s and ``run_stellarator_lane.py``'s
    lanes 1-3, on :func:`heating_lanes`' results."""
    from scpn_fusion_tpu_torch.models.physics import rf_heating as rf
    cfg_tau = r["iss04"]
    a, r0, b0 = 0.53, 5.5, 2.5
    tau_lit = (0.134 * a**2.28 * r0**0.64 * 5.0**-0.61 * 8.0**0.54 * b0**0.84
               * float(r["iota 2/3"]) ** 0.41)
    rho, p_dep = r["ecrh default 0"], r["ecrh default 1"]
    ecrh = rf.ECRHParams()
    rho_res = abs(ecrh.resonance_radius - ecrh.r0_major) / ecrh.a_minor
    a1, a2 = r["ballooning alpha_crit_first"], r["ballooning alpha_crit_second"]
    idx_full, idx_red = r["divertor scan 80 stability_index"], r["divertor scan 20 stability_index"]
    gates = {
        "rays inward and finite": bool(np.all(np.isfinite(r["icrh r"])))
        and bool(np.all(r["icrh r"][:, 10] < 9.0)),
        "deposition absorbs": r["icrh deposition 1"].shape == (50,)
        and bool(np.all(r["icrh deposition 1"] >= 0)) and 0.01 < float(r["icrh deposition 2"])
        <= 1.0,
        "ECRH at the resonance": abs(float(rho[int(np.argmax(p_dep))]) - rho_res) < 0.1
        and 0.01 <= float(r["ecrh default 2"]) <= 0.9901,
        "driven current grows with elongation": float(r["cd i 1.7"]) > float(r["cd i 1"]) > 0.0,
        "divertor lane 1": bool(r["divertor tungsten melted"])
        and float(r["divertor lithium f_rad"]) >= 0.95
        and float(r["divertor lithium t_surface_c"]) < 2000.0
        and abs(float(r["divertor load lambda_q_m"]) - 0.63e-3 * 2.5 ** (-1.19))
        < 1e-12 * 0.63e-3 * 2.5 ** (-1.19) + 1e-15
        and float(r["divertor load q_target"]) == float(r["divertor load q_parallel"]) / 15.0,
        "divertor lane 2": bool(np.all(np.diff(idx_full) > 0.0)) and idx_red[0] <= 1.0
        and idx_full[-1] > 1.0,
        "ballooning lane 3": bool(np.all(r["ballooning second_access"]))
        and bool(np.all(a2 > a1)) and bool(np.all(np.diff(a1) >= -1e-12))
        and 0.45 < float(r["ballooning marginal"]) < 0.75,
        "stellarator lane 1": abs(float(cfg_tau) - tau_lit) / tau_lit < 1e-10
        and abs(np.log(float(r["iss04 p"]) / float(cfg_tau)) / np.log(1.1) + 0.61) < 1e-6
        and abs(np.log(float(r["iss04 n"]) / float(cfg_tau)) / np.log(1.1) - 0.54) < 1e-6,
        "stellarator lane 2": float(r["ripple axi"]) == 0.0 and 0.0 < float(r["ripple 0.5"]) < 0.1
        and 0.05 < float(cfg_tau) < 0.5 and float(r["ripple 1"]) > float(r["ripple 0.5"]),
        "stellarator lane 3": abs(np.log(float(r["chi 10"]) / float(r["chi 1"])) / np.log(10.0)
                                  - 2.5) < 0.125
        and float(r["chi mirror x2"]) > float(r["chi 1"]),
    }
    return {k: bool(v) for k, v in gates.items()}


def drift_probe_runs(device) -> dict:
    """The float32 drift-wave lanes: ``test_drift_wave_esn.py``'s drive test
    (64^2 from the test's own draw, ``bench_config.DRIFT_WAVE_JAX_NOISE``: its
    gate depends on the draw; 800 + 200 steps at kappa 0 and 2, 8 probes) and
    its oracle run (32^2 from a ``torch.Generator`` seeded 1, 200 + 500 steps,
    16 probes), and the short run held to the CPU (32^2, seed 3, 20 + 30)."""
    import dataclasses

    import torch
    from scpn_fusion_tpu_torch.bench_config import DRIFT_WAVE_JAX_NOISE
    from scpn_fusion_tpu_torch.models.physics import drift_wave as dw
    out = {}
    cfg64 = dw.DriftWaveConfig(n=64)
    noise = torch.from_numpy(np.load(DRIFT_WAVE_JAX_NOISE)).to(device)
    s0 = dw._initial_state(noise[0], noise[1], cfg64)
    idx = dw.default_probe_indices(64, 8, device=device)
    for kappa in (0.0, 2.0):
        _, out[f"drive {kappa:g}"] = dw.simulate_probes(
            s0, dataclasses.replace(cfg64, kappa=kappa), idx, warmup=800, steps=200)
    cfg32 = dw.DriftWaveConfig(n=32)
    s1 = dw.initial_state(torch.Generator().manual_seed(1), cfg32, device=device)
    idx32 = dw.default_probe_indices(32, 16, device=device)
    _, out["oracle"] = dw.simulate_probes(s1, cfg32, idx32, warmup=200, steps=500)
    s3 = dw.initial_state(torch.Generator().manual_seed(3), cfg32, device=device)
    final, out["short"] = dw.simulate_probes(s3, cfg32, idx32, warmup=20, steps=30)
    out["short phi_k"] = torch.view_as_real(final.phi_k)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def slice19_on_cpu(conn) -> None:
    """The CPU twins of (zh) and (zi): row F's plain twin on every
    :data:`FAST_POPULATIONS` population and the 20,000-step orbit in float64,
    the fast-ion lanes, (zi)'s float64 lanes and the short float32 drift-wave
    run."""
    import torch
    from scpn_fusion_tpu_torch.ops import cuda_orbits as co
    dev, f64 = on_cpu(1), torch.float64
    out, start = {}, 0
    res = co.gc_ensemble_plain(fast_constants(f64, dev), fast_field(), torch.cat(
        [packed(fast_population(label, f64, dev)) for label, *_ in FAST_POPULATIONS], dim=1),
        FAST_STEPS)
    for label, _, n, _ in FAST_POPULATIONS:
        out[label] = as_numpy(dict(zip(("final", "lost", "bounced", "drift"),
                                       (t[start:start + n] for t in res))))
        start += n
    c, s0 = orbit_state(f64, dev)
    fin, r_tr, z_tr = co.gc_orbit_plain(c, fast_field(), s0, GC_STEPS)
    out["orbit"] = as_numpy({"final": fin, "r": r_tr, "z": z_tr})
    out["lanes"] = fast_ion_lanes(dev)
    out["zi"] = heating_lanes(dev)
    out["drift"] = drift_probe_runs(dev)
    conn.send(out)
    conn.close()


def slice19_plain_on_card(conn) -> None:
    """(zh)'s plain runs on the card, in a process of its own: row F's plain
    twin on every :data:`FAST_POPULATIONS` population -- in float32 all four as
    one batch, in float64 the first three as one and the timed one alone,
    between CUDA events -- and on :data:`GC_PLAIN_STEPS` steps of the orbit
    (the float64 one timed), and :func:`orbit_plain_lanes`, as numpy arrays by
    (dtype, population) (a tensor through a pipe would share memory with a
    process that ends)."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from scpn_fusion_tpu_torch.ops import cuda_orbits as co
    dev, out = torch.device("cuda"), {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)
        c = fast_constants(dtype, dev)
        batched = [p for p in FAST_POPULATIONS if dtype == torch.float32 or p[0] != FAST_TIMED]
        res = co.gc_ensemble_plain(c, fast_field(), torch.cat(
            [packed(fast_population(label, dtype, dev)) for label, *_ in batched], dim=1),
            FAST_STEPS)
        start = 0
        for label, _, n, _ in batched:
            out[(tag, label)] = [t[start:start + n].cpu().numpy() for t in res]
            start += n
        if dtype == torch.float64:
            res, ms = events_ms(functools.partial(co.gc_ensemble_plain, c, fast_field(),
                                                  packed(fast_population(FAST_TIMED, dtype, dev)),
                                                  FAST_STEPS))
            out[(tag, FAST_TIMED)] = [t.cpu().numpy() for t in res]
            out[(tag, "ensemble ms")] = ms
        c, s0 = orbit_state(dtype, dev)
        res, ms = events_ms(functools.partial(co.gc_orbit_plain, c, fast_field(), s0,
                                              GC_PLAIN_STEPS))
        out[(tag, "orbit")] = [t.cpu().numpy() for t in res]
        out[(tag, "orbit ms")] = ms
    out["lanes"] = orbit_plain_lanes(dev)
    conn.send(out)
    conn.close()


def orbit_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                 measured_plain: dict, plain_card, twin: dict) -> tuple[int, int]:
    """(zh) row F: ``gc_ensemble`` on every :data:`FAST_POPULATIONS` population
    (4000 steps) and ``gc_orbit`` (the 20,000-step orbit through
    ``run_guiding_center``, and a :data:`GC_PLAIN_STEPS`-step launch) ONE
    launch each, in float32 and float64, ``torch.equal`` to the plain twin on
    the card (``plain_card``: :func:`slice19_plain_on_card`'s; the orbit's
    trace a prefix of the kernel's); ``follow_ensemble`` equal to the wrapper
    and ``ensemble_stats``; the gates of ``tests/test_fast_ions.py`` and of
    ``validation/run_fast_ions.py`` (lanes 3-5 through ``follow_ensemble``,
    four launches); every float64 result within 1e-9 of the CPU and the
    counts equal (``twin``: :func:`slice19_on_cpu`'s); the plain lanes'
    ``TestOrbits`` gates, no kernel among them.  Returns the counted
    launches of ``gc_ensemble`` and ``gc_orbit``."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import fast_ions as fi
    from scpn_fusion_tpu_torch.models.physics import orbits
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_orbits as co

    f32, f64 = torch.float32, torch.float64
    print(f"(zh) csrc/orbits.cu's PTX (nvcc -ptx, sm_90a): {orbit_ptx()} (no approx or full "
          f"division or square root expected)")
    print(f"(zh) row F: 64 threads a CTA: {-(-2048 // 64)} CTAs for 2048 particles, "
          f"{-(-384 // 64)} for the validation's 384; ptxas: "
          f"{ptxas_registers(cb.BUILD_LOG.get('orbits.cu', ''))}")
    one = {name: int(name == "gc_ensemble") for name in KERNELS}
    one_orbit = {name: int(name == "gc_orbit") for name in KERNELS}
    plain = plain_card()
    ensembles, orbit_calls, stats = 0, 0, {}
    for dtype in (f32, f64):
        tag = "f32" if dtype == f32 else "f64"
        c = fast_constants(dtype, dev)
        got = {}
        for label, *_ in FAST_POPULATIONS:
            s = fast_population(label, dtype, dev)
            res, calls, launched = counted(functools.partial(
                co.gc_ensemble, c, fast_field(), packed(s), FAST_STEPS))
            require(calls == one and launched == {f"scpn_gc_ensemble_{tag}": 1},
                    f"(zh) {label} {tag}: {calls} / {launched}, not one launch of row F")
            by_path[f"gc_ensemble {label} {tag}"] = calls
            ensembles += 1
            ref = [torch.from_numpy(a) for a in plain[(str(dtype), label)]]
            equal = all(torch.equal(a.cpu(), b) for a, b in zip(res, ref))
            st = fi.ensemble_stats(s, *res)
            print(f"(zh) row F {tag} {label} x {FAST_STEPS} steps: one launch, torch.equal to the "
                  f"plain twin {equal}; passing / trapped / lost {int(st.n_passing)} / "
                  f"{int(st.n_trapped)} / {int(st.n_lost)}, energy drift "
                  f"{float(st.energy_drift_rel_max)!r} [{card}]")
            require(equal, f"(zh) row F {tag} {label}: the kernel differs from its plain twin")
            got[label] = res
            stats[(tag, label)] = st
            if tag == "f64" and label == FAST_TIMED:
                results["gc_ensemble"] = {"max_abs_err": max(
                    float((a.cpu().to(f64) - b.to(f64)).abs().max()) for a, b in zip(res, ref))}
        if tag == "f64":
            for label, res in got.items():
                cpu = twin[label]
                card_np = as_numpy(dict(zip(("final", "lost", "bounced", "drift"), res)))
                require(np.array_equal(card_np["lost"], cpu["lost"])
                        and np.array_equal(card_np["bounced"], cpu["bounced"]),
                        f"(zh) {label}: the lost or bounced flags differ from the CPU's")
                agree({"final": card_np["final"]}, {"final": cpu["final"]},
                      f"(zh) row F {label}", card)
                # the relative energy drift is rounding noise of E_f - E_0 (~1e-12)
                require(float(np.max(np.abs(card_np["drift"] - cpu["drift"]))) <= 1e-12,
                        f"(zh) {label}: an energy drift deviates from the CPU's")
        c_o, s0 = orbit_state(dtype, dev)
        (final, tr), calls, launched = counted(lambda: orbits.run_guiding_center(
            orbits.GuidingCenterState(*s0.unbind()), fast_field(), m_amu=2.0, charge_z=1,
            dt=1e-8, n_steps=GC_STEPS))
        require(calls == one_orbit and launched == {f"scpn_gc_orbit_{tag}": 1},
                f"(zh) orbit {tag}: {calls} / {launched}, not one launch of row F")
        by_path[f"gc_orbit run_guiding_center {tag}"] = calls
        res, calls, launched = counted(functools.partial(co.gc_orbit, c_o, fast_field(), s0,
                                                         GC_PLAIN_STEPS))
        require(calls == one_orbit, f"(zh) orbit {tag} {GC_PLAIN_STEPS}: {calls}")
        by_path[f"gc_orbit {GC_PLAIN_STEPS} {tag}"] = calls
        orbit_calls += 2
        ref = [torch.from_numpy(a) for a in plain[(str(dtype), "orbit")]]
        equal = (all(torch.equal(a.cpu(), b) for a, b in zip(res, ref))
                 and torch.equal(tr["r"][:GC_PLAIN_STEPS].cpu(), ref[1])
                 and torch.equal(tr["z"][:GC_PLAIN_STEPS].cpu(), ref[2]))
        r = tr["r"].cpu().numpy()
        print(f"(zh) row F {tag} orbit, {GC_STEPS} steps in one launch: its first "
              f"{GC_PLAIN_STEPS} and a {GC_PLAIN_STEPS}-step launch torch.equal to the plain twin "
              f"{equal}; R in [{r.min():.6f}, {r.max():.6f}] m [{card}]")
        require(equal, f"(zh) row F {tag} orbit: the kernel differs from its plain twin")
        if tag == "f64":
            results["gc_orbit"] = {"max_abs_err": max(float((a.cpu() - b).abs().max())
                                                      for a, b in zip(res, ref))}
            agree({"r": tr["r"].cpu().numpy(), "z": tr["z"].cpu().numpy(),
                   "final": torch.stack([final.r, final.z, final.phi, final.v_par]).cpu().numpy()},
                  {k: twin["orbit"][k] for k in ("r", "z", "final")}, "(zh) row F's orbit", card)
    gates = fast_ion_test_gates({label: stats[("f64", label)] for label, *_ in FAST_POPULATIONS})
    print(f"(zh) gates of tests/test_fast_ions.py on row F's float64 results: {gates} [{card}]")
    require(all(gates.values()), "(zh): the port misses a gate of tests/test_fast_ions.py")
    s = fast_population("central 256", f64, dev)
    entry, calls, _ = counted(lambda: fi.follow_ensemble(
        s, fast_field(), m_amu=fi.ALPHA_AMU, charge_z=fi.ALPHA_Z, dt=FAST_DT, n_steps=FAST_STEPS,
        r_wall_in=FAST_R0 - FAST_A - 0.5, r_wall_out=FAST_R0 + FAST_A + 0.5,
        z_wall=FAST_A + 0.5))
    require(calls == one, f"(zh) follow_ensemble: {calls}, not one launch of row F")
    by_path["follow_ensemble central 256 f64"] = calls
    ensembles += 1
    ref = stats[("f64", "central 256")]
    require(all(torch.equal(getattr(entry, k), getattr(ref, k)) for k in (
        "n_passing", "n_trapped", "n_lost", "loss_fraction", "trapped_fraction",
        "energy_drift_rel_max")) and torch.equal(entry.final.r, ref.final.r),
        "(zh) follow_ensemble differs from the wrapper and ensemble_stats")

    (r, ms), calls, launched = counted(lambda: events_ms(lambda: fast_ion_lanes(dev)))
    require(calls == {name: len(LANE_IPS) * int(name == "gc_ensemble") for name in KERNELS},
            f"(zh) fast-ion lanes: {calls} / {launched}, not one launch of row F a current")
    by_path["fast_ion_lanes_f64"] = calls
    ensembles += len(LANE_IPS)
    gates = fast_ion_gates(r)
    print(f"(zh) validation/run_fast_ions.py's lanes on the card (384 x 8000 steps f64, row F): "
          f"{gates}; loss fractions "
          f"{ {ip: float(r[f'{ip:g} MA loss_fraction']) for ip in LANE_IPS} }, bound at 15 MA "
          f"{float(r['bound 15 MA'])!r}, energy drift at 15 MA "
          f"{float(r['15 MA energy_drift_rel_max'])!r}; {ms:.1f} ms (CUDA events) [{card}]")
    require(all(gates.values()), "(zh): the port misses a gate of validation/run_fast_ions.py")
    counts = [k for k in twin["lanes"] if k.endswith(("n_passing", "n_trapped", "n_lost"))]
    require(all(np.array_equal(r[k], twin["lanes"][k]) for k in counts),
            "(zh): a fast-ion lane's count differs from the CPU's")
    agree({k: r[k] for k in twin["lanes"] if "drift" not in k},
          {k: v for k, v in twin["lanes"].items() if "drift" not in k},
          "(zh) the fast-ion lanes", card)
    drift = {k: abs(float(r[k]) - float(v)) for k, v in twin["lanes"].items() if "drift" in k}
    print(f"(zh) the lanes' energy drifts (rounding noise of E_f - E_0, ~1e-13) against the CPU: "
          f"max absolute deviation {max(drift.values()):.3e} (limit 1e-12) [{card}]")
    require(max(drift.values()) <= 1e-12, "(zh): an energy drift deviates from the CPU")

    lanes = plain["lanes"]
    print(f"(zh) TestOrbits on plain ops on the card (f64): lambda-field guiding centre "
          f"{GC_STEPS} steps {lanes['gc ms']:.0f} ms gate {lanes['gc gate']}; Boris gyration 5000 "
          f"steps {lanes['gyration ms']:.0f} ms gate {lanes['gyration gate']}; E x B 40,000 steps "
          f"{lanes['exb ms']:.0f} ms, drift {lanes['exb drift']!r} m/s, gate {lanes['exb gate']}; "
          f"{lanes['kernel calls']} port kernel calls [{card}]")
    require(lanes["gc gate"] and lanes["gyration gate"] and lanes["exb gate"],
            "(zh): the port misses a gate of TestOrbits")
    require(lanes["kernel calls"] == 0, "(zh): the plain orbit lanes launched a port kernel")

    measured_plain["gc_ensemble"] = plain[(str(f64), "ensemble ms")]
    measured_plain["gc_orbit"] = plain[(str(f64), "orbit ms")]
    c = fast_constants(f64, dev)
    s = packed(fast_population(FAST_TIMED, f64, dev))
    timing["gc_ensemble"] = (functools.partial(co.gc_ensemble, c, fast_field(), s, FAST_STEPS),
                             functools.partial(co.gc_ensemble_plain, c, fast_field(), s,
                                               FAST_STEPS),
                             f"{FAST_TIMED} x {FAST_STEPS} steps f64",
                             orbit_work(2048, FAST_STEPS, 8))
    c_o, s0 = orbit_state(f64, dev)
    timing["gc_orbit"] = (functools.partial(co.gc_orbit, c_o, fast_field(), s0, GC_PLAIN_STEPS),
                          functools.partial(co.gc_orbit_plain, c_o, fast_field(), s0,
                                            GC_PLAIN_STEPS),
                          f"one orbit, {GC_PLAIN_STEPS} steps f64",
                          orbit_work(1, GC_PLAIN_STEPS, 8, ensemble=False))
    for name, n_steps, n in (("gc_ensemble", FAST_STEPS, 2048), ("gc_orbit", GC_PLAIN_STEPS, 1)):
        kernel, _, shape, work = timing[name]
        ms_k = cuda_ms(kernel)
        b, by = bound(work)
        print(f"time (zh) {name} ({shape}): kernel {ms_k:.4f} ms ({1e6 * ms_k / (n * n_steps):.3f} "
              f"ns a particle-step; CUDA events, median of 5), bound {b:.4g} ms ({by}: "
              f"{work[0] / 1e6:.4g} MB, {work[1] / 1e6:.4g} Mflop); a particle's dependent chain "
              f"{n_steps * ORBIT_DEPTH} operations ({n_steps} steps x ~{ORBIT_DEPTH}), "
              f"~{ladder_chain_ms(n_steps, ORBIT_DEPTH):.4f} ms at a nominal 4 cycles each and "
              f"{SM_CLOCK_HZ / 1e9:.2f} GHz (a count, not a bound: square roots and IEEE f64 "
              f"divisions on the chain); plain {measured_plain[name]:.1f} ms (once, in the "
              f"spawned process); library_ms null (no PyTorch call integrates an orbit) [{card}]")
    return ensembles, orbit_calls


def heating_checks(dev, card: str, counted, by_path: dict, twin: dict) -> None:
    """(zi) ICRH, ECRH and current drive, the drift-wave runs, the divertor lab
    and the stellarator lane on the card: float64 within 1e-9 of the CPU
    (``twin``: :func:`slice19_on_cpu`'s), row B's 25 launches of
    ``run_divertor_ballooning.py``'s lane 3 (one scan, 24 bisection steps)
    and no other kernel; the gates of :func:`heating_gates`; the drift-wave
    drive and oracle runs with ``test_drift_wave_esn.py``'s gates, and the
    short float32 run within :data:`DRIFT_F32_TOL` of the CPU's."""
    (r, ms), calls, launched = counted(lambda: events_ms(lambda: heating_lanes(dev)))
    require(calls == {name: 25 * int(name == "newcomb_min_xi") for name in KERNELS},
            f"(zi): {calls} / {launched}: only row B's 25 launches of the ballooning lane")
    by_path["heating_divertor_stellarator_f64"] = calls
    gates = heating_gates(r)
    print(f"(zi) ICRH, ECRH, current drive, the divertor and stellarator lanes on the card (f64): "
          f"gates {gates}; ICRH efficiency {float(r['icrh deposition 2'])!r}, ECRH efficiency "
          f"{float(r['ecrh default 2'])!r} (float32), marginal alpha "
          f"{float(r['ballooning marginal'])!r}, eps_eff(0.5) {float(r['ripple 0.5'])!r}; "
          f"{ms:.1f} ms (CUDA events) [{card}]")
    require(all(gates.values()), "(zi): the port misses a gate of the JAX tests or validations")
    require(np.array_equal(r["icrh frozen"], twin["zi"]["icrh frozen"]),
            "(zi): the rays' frozen masks differ from the CPU's")
    require(int(r["divertor lithium iterations"]) == int(twin["zi"]["divertor lithium iterations"]),
            "(zi): the vapor shield's Picard count differs from the CPU's")
    ecrh = [k for k in twin["zi"] if k.startswith("ecrh") and not k.endswith(" 0")]
    agree({k: r[k] for k in twin["zi"] if k not in ecrh},
          {k: v for k, v in twin["zi"].items() if k not in ecrh},
          "(zi) heating, drift-wave step, divertor and stellarator", card)
    gap = max(max_rel(torch_from(r[k]), torch_from(twin["zi"][k])) for k in ecrh)
    print(f"(zi) ECRH's deposition and efficiency (float32 temperature, angle and density, as "
          f"JAX forces them) against the CPU: {gap:.3e} (limit {ECRH_F32_TOL:.0e}) [{card}]")
    require(gap <= ECRH_F32_TOL, "(zi): ECRH deviates from the CPU")
    (p, ms), calls, launched = counted(lambda: events_ms(lambda: drift_probe_runs(dev)))
    require(calls == {name: 0 for name in KERNELS} and not launched,
            f"(zi) drift waves: {calls} / {launched}: no kernel")
    by_path["drift_wave_f32"] = calls
    var0, var2 = float(np.var(p["drive 0"])), float(np.var(p["drive 2"]))
    oracle = p["oracle"]
    short = max(max_rel(*(torch_from(a) for a in (p[k], twin["drift"][k])))
                for k in ("short", "short phi_k"))
    print(f"(zi) drift waves on the card (f32 / c64, torch.fft): probe variance at kappa 2 / 0 "
          f"{var2!r} / {var0!r}, oracle probes {oracle.shape} finite "
          f"{bool(np.all(np.isfinite(oracle)))}; the 20 + 30-step run against the CPU: "
          f"{short:.3e} (limit {DRIFT_F32_TOL:.0e}); {ms:.1f} ms (CUDA events) [{card}]")
    require(var2 > 2.0 * var0 and p["drive 2"].shape == (200, 8)
            and bool(np.all(np.isfinite(p["drive 0"]))) and bool(np.all(np.isfinite(p["drive 2"]))),
            "(zi): the port misses test_density_gradient_drive_pumps_fluctuations")
    require(oracle.shape == (500, 16) and bool(np.all(np.isfinite(oracle))),
            "(zi): the oracle run's probes are not finite")
    require(short <= DRIFT_F32_TOL, "(zi): the short drift-wave run deviates from the CPU")


# ── the twentieth slice: (zj) rows E and H with the plant lanes, (zk) the
# nuclear, heating-neutronics and CAD lanes ──

# (label, designs, seed) of row E's cases: compact_reactor_search's default 4096 draws, the
# JAX test's 512 (test_scenario_design.py:134) and the ITER-like point (:125), scalar
BURN_CASES = (("compact search 4096 (seed 0)", 4096, 0), ("JAX test 512 (seed 1)", 512, 1),
              ("ITER-like point", 1, None))
BURN_TIMED = "compact search 4096 (seed 0)"
ITER_DESIGN = (6.2, 2.0, 5.3, 15.0, 10.0, 50.0)    # R0, a, B0, Ip, ne19, P_aux; kappa 1.8
# operations of an iteration of a design point on row E (csrc/burn.cu: Bosch-Hale 27 with its
# pow, sqrt and exp, the power balance and IPB98 16 with its pow, the update and clamps 9),
# and the dependent operations an iteration on a point's chain (four IEEE divisions, two
# pows, sqrt and exp among them)
BURN_OPS, BURN_DEPTH = 52, 39
# (label, conductor, scenario) of row H's cases: the default transient and the degraded
# screen of validation/run_whole_plant_fault.py lane 2 (:68-70)
QUENCH_CASES = (("default 2000 steps", {}, {}),
                ("degraded (whole-plant lane 2)", {},
                 dict(initial_normal_zone_m=1e-3, normal_zone_velocity_m_s=1e-3)))
QUENCH_TIMED = "default 2000 steps"
QUENCH_OPS, QUENCH_DEPTH = 30, 13    # a step: operations, dependent ones (two IEEE divisions)
# the float32 design scan (compact_reactor_search casts to float32, as JAX does) on the card
# against the CPU, relative: libdevice's pow and exp against the CPU's through 200
# iterations; a design whose feasibility differs must lie this close to a limit
SCAN_F32_TOL = 1e-5
TEMHD_RUN = (10.0, 0.05, 600)           # test_temhd_wall.py:27: MW/m^2, dt, steps
TEMHD_SCAN = ((1.0, 5.0, 20.0), 200)    # :47-52
TEMHD_CONVECTION = (20.0, 400)          # :36-45, at 10 T and at 0 T
CAD_TORUS = (72, 72, 6.2, 2.0)          # poloidal x toroidal cells (10,368 faces), R0, a
CAD_SOURCE = ((6.5, 0.0, 0.3), 1.0e6)   # a point source inside the tube [m], [W]


def burn_case(label: str, dtype, device):
    """Row E's constants for a :data:`BURN_CASES` case, as the main path forms
    them: the compact search's designs (drawn on the CPU in float64, cast to
    ``dtype``, P_aux 50 MW, kappa 1.8) or the ITER-like point (0-d)."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import design_scan as ds
    from scpn_fusion_tpu_torch.models.physics import scaling_burn as sb
    _, n, seed = next(c for c in BURN_CASES if c[0] == label)
    if seed is None:
        r, a, b, ip, ne, _ = (torch.tensor(v, dtype=torch.float64) for v in ITER_DESIGN)
    else:
        r, a, b, ip, ne = ds.search_designs(*ds.search_draws(n, seed))
    r, a, b, ip, ne = (x.to(dtype=dtype, device=device) for x in (r, a, b, ip, ne))
    return sb.burn_constants(ne, torch.full_like(r, 50.0), ip, b, r, a, torch.full_like(r, 1.8),
                             0.8, 2.0)


def quench_case(label: str, dtype, device):
    """(numbers, step constants, steps) of a :data:`QUENCH_CASES` case."""
    from scpn_fusion_tpu_torch.models.engineering import hts_quench as hq
    _, c_kw, s_kw = next(c for c in QUENCH_CASES if c[0] == label)
    s = hq.QuenchScenario(**s_kw)
    values = hq.quench_values(hq.REBCOConductor(**c_kw), s)
    return values, hq.step_constants(values, dtype, device), s.n_steps


def burn_work(n: int, n_iter: int, item: int):
    """Row E: (bytes, operations, peak rate): eight values read and one
    written a point, :data:`BURN_OPS` an iteration."""
    return (float(item * 9 * n), float(BURN_OPS * n * n_iter),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def quench_work(n_steps: int, item: int):
    """Row H: (bytes, operations, peak rate): the five traces written,
    :data:`QUENCH_OPS` a step."""
    return (float(item * 5 * n_steps), float(QUENCH_OPS * n_steps),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def torus_mesh():
    """The generated first wall of (zk)'s CAD lane: a torus of
    :data:`CAD_TORUS` cells, two triangles a cell."""
    n_pol, n_tor, r0, a = CAD_TORUS
    th = np.linspace(0.0, 2.0 * np.pi, n_pol, endpoint=False)
    ph = np.linspace(0.0, 2.0 * np.pi, n_tor, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    r = r0 + a * np.cos(tt)
    vertices = np.stack([r * np.cos(pp), r * np.sin(pp), a * np.sin(tt)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_pol), np.arange(n_tor), indexing="ij")
    v00, v10 = i * n_tor + j, ((i + 1) % n_pol) * n_tor + j
    v01, v11 = i * n_tor + (j + 1) % n_tor, ((i + 1) % n_pol) * n_tor + (j + 1) % n_tor
    faces = np.concatenate([np.stack([v00, v10, v11], -1).reshape(-1, 3),
                            np.stack([v00, v11, v01], -1).reshape(-1, 3)])
    return vertices, faces


class Lanes:
    """A slice's lane results: float64 numbers (``num``), float32 numbers
    (``f32``), verdicts (``verdicts``) and the port's kernel calls of each lane
    (``counts``, by wrapper, on the card)."""

    def __init__(self):
        self.num, self.f32, self.verdicts, self.counts = {}, {}, {}, {}

    def run(self, label: str, run):
        from scpn_fusion_tpu_torch.ops import _cuda_build as cb
        before = dict(cb.CALLS)
        out = run()
        self.counts[label] = {k: cb.CALLS[k] - before.get(k, 0) for k in KERNELS
                              if cb.CALLS[k] != before.get(k, 0)}
        return out

    def put(self, prefix: str, values, f32: bool = False) -> None:
        """Record ``values`` (a NamedTuple or a dict) under ``prefix``; float32
        ones (and all of them with ``f32``) among the float32 numbers."""
        import torch
        items = values._asdict().items() if hasattr(values, "_asdict") else values.items()
        for k, v in items:
            t = (torch.tensor(float(v), dtype=torch.float64) if isinstance(v, (int, float))
                 else torch.as_tensor(v).detach())
            (self.f32 if f32 or t.dtype == torch.float32 else self.num)[f"{prefix} {k}"] = \
                t.cpu().to(torch.float64).numpy()

    def as_dict(self) -> dict:
        return {"num": self.num, "f32": self.f32, "verdicts": self.verdicts,
                "counts": self.counts}


def plant_lanes(device) -> dict:
    """(zj)'s lanes: the compact search at its defaults and at the JAX test's
    512 (float32, as JAX casts the scan), the 4096 designs and the ITER-like
    point through ``evaluate_design`` in float64, lanes 2-4 of
    ``validation/run_confinement_burn.py``, lanes 2, 3 and 5 of
    ``validation/run_whole_plant_fault.py`` (the quench screen with the
    transients, the DEC load rejection, the coolant loop) in float64."""
    import torch
    from scpn_fusion_tpu_torch.models.engineering import balance_of_plant as bop
    from scpn_fusion_tpu_torch.models.engineering import direct_energy as dec
    from scpn_fusion_tpu_torch.models.engineering import hts_quench as hq
    from scpn_fusion_tpu_torch.models.nuclear import blanket as bk
    from scpn_fusion_tpu_torch.models.physics import design_scan as ds
    from scpn_fusion_tpu_torch.models.physics import scaling_burn as sb
    lanes, kw = Lanes(), dict(dtype=torch.float64, device=device)
    for _, n, seed in BURN_CASES[:2]:
        res = lanes.run(f"compact search {n}", lambda: ds.compact_reactor_search(
            n_samples=n, seed=seed, device=device))
        lanes.put(f"search {n}", res.points, f32=True)
        lanes.verdicts[f"search {n}"] = (int(res.best_index), int(res.n_feasible))
    r, a, b, ip, ne = ds.search_designs(*(d.to(device) for d in ds.search_draws(4096, 0)))
    lanes.put("designs 4096", lanes.run("evaluate_design 4096 f64", lambda: ds.evaluate_design(
        r, a, b, ip, ne, 50.0)))
    lanes.put("ITER", lanes.run("evaluate_design ITER f64", lambda: ds.evaluate_design(
        *ITER_DESIGN, kappa=1.8, **kw)))
    lanes.put("confinement lane 2", lanes.run("confinement lane 2", lambda: sb.burn_equilibrium_0d(
        ne19=10.0, p_aux_mw=50.0, ip_ma=15.0, bt_t=5.3, r_m=6.2, a_m=2.0, kappa=1.8, **kw)))
    lanes.put("confinement lane 3", lanes.run("confinement lane 3", lambda: bk.multigroup_tbr(
        bk.MultiGroupConfig(thickness_cm=80.0, li6_enrichment=0.9), **kw)))
    for label, c_kw, s_kw in QUENCH_CASES:
        c, s = hq.REBCOConductor(**c_kw), hq.QuenchScenario(**s_kw)
        lanes.put(f"quench {label}", lanes.run(f"quench {label}", lambda: hq.simulate_quench_transient(
            c, s, **kw)))
        rep = lanes.run(f"quench screen {label}", lambda: hq.evaluate_rebco_quench(c, s, **kw))
        lanes.put(f"quench {label} report", {k: v for k, v in rep._asdict().items()
                                             if isinstance(v, float)})
        lanes.verdicts[f"quench {label}"] = (rep.passed, rep.failures)
    for label, fault in (("nominal", dec.DECFault()),
                         ("degraded", dec.DECFault(sensor_detection_latency_ms=100.0))):
        rep = dec.evaluate_direct_energy_conversion(fault=fault)
        lanes.verdicts[f"dec {label}"] = (rep.passed, rep.failures)
    lanes.put("whole-plant lane 5", {"pumps": lanes.run("whole-plant lane 5", lambda: torch.stack(
        [bop.pumping_power(p, bop.PlantParams(), **kw) for p in (500.0, 1000.0, 2000.0)]))})
    return lanes.as_dict()


def nuclear_lanes(device, cad: bool = True) -> dict:
    """(zk)'s lanes in float64: the blanket (1-group, 3-group, volumetric at
    24 x 72 x 48), TEMHD (the JAX tests' transient, flux scan and TE
    convection pair), wall loading on the 65^2 mesh with every material and
    the ash dilution, PWI with lane 6 of ``validation/run_physics_closures.py``
    and its lane 7 (the Lawson product of the Q >= 10 burn point), the
    heating proxy, MCNP-lite at 2000 histories (thin and thick) and lane 5 of
    ``validation/run_mif_frc.py`` (a candidate and its refinement), and, with
    ``cad``, the occluded CAD loading of :func:`torus_mesh`."""
    import torch
    from scpn_fusion_tpu_torch.models.engineering import cad_raytrace as cad_rt
    from scpn_fusion_tpu_torch.models.nuclear import blanket as bk
    from scpn_fusion_tpu_torch.models.nuclear import heating_neutronics as hn
    from scpn_fusion_tpu_torch.models.nuclear import pwi
    from scpn_fusion_tpu_torch.models.nuclear import temhd as te
    from scpn_fusion_tpu_torch.models.nuclear import wall_loading as wl
    from scpn_fusion_tpu_torch.models.physics import scaling_burn as sb
    lanes, kw = Lanes(), dict(dtype=torch.float64, device=device)
    lanes.put("single group", lanes.run("single group", lambda: bk.single_group_tbr(
        bk.BlanketConfig(), **kw)))
    lanes.put("multigroup", lanes.run("multigroup", lambda: bk.multigroup_tbr(
        bk.MultiGroupConfig(), **kw)))
    lanes.put("volumetric", lanes.run("volumetric", lambda: bk.volumetric_tbr(
        bk.BlanketConfig(), **kw)))
    flux, dt, steps = TEMHD_RUN
    tr = lanes.run("TEMHD run", lambda: te.run_temhd(te.TEMHDParams(), flux, dt=dt,
                                                     n_steps=steps, **kw))
    lanes.put("TEMHD run", {"surface": tr.surface_t_k, "k": tr.k_eff_max, "t": tr.state.t_k})
    fluxes, steps = TEMHD_SCAN
    lanes.put("TEMHD scan", dict(zip(("surface", "k_enh"), lanes.run(
        "TEMHD scan", lambda: te.temhd_flux_scan(te.TEMHDParams(), torch.tensor(fluxes, **kw),
                                                 n_steps=steps, **kw)))))
    flux, steps = TEMHD_CONVECTION
    for b in (10.0, 0.0):
        tr = lanes.run(f"TEMHD {b:g} T", lambda: te.run_temhd(te.TEMHDParams(b_field_t=b), flux,
                                                              n_steps=steps, **kw))
        lanes.put(f"TEMHD {b:g} T", {"surface": tr.surface_t_k[-1], "k": tr.k_eff_max[-1]})
    rr, zz = (torch.tensor(x, **kw) for x in np.meshgrid(np.linspace(3.5, 9.0, 65),
                                                         np.linspace(-4.5, 4.5, 65)))

    def wall():
        loading = wl.compute_wall_loading(wl.neutron_source_density(rr, zz, p_fusion_mw=500.0),
                                          rr, zz)
        return loading, {m: wl.analyze_material(loading, m) for m in wl.MATERIALS}

    loading, reports = lanes.run("wall loading", wall)
    lanes.put("wall", loading)
    for m, rep in reports.items():
        lanes.put(f"wall {m}", rep)
    lanes.put("ash", {f: wl.ash_poisoning_dilution(f, **kw) for f in (0.0, 0.1, 0.6)})

    def sputtering():
        w, c = pwi.SputteringMaterial.from_name("Tungsten"), pwi.SputteringMaterial.from_name("Carbon")
        out = {f"{m.e_th_ev:g} {e:g} {ang:g}": pwi.sputtering_yield(m, e, ang, **kw)
               for m in (w, c) for e in (100.0, 500.0, 1000.0, 2000.0) for ang in (0.0, 45.0, 80.0)}
        out.update(dict(zip(("temps", "erosion", "yield"), pwi.erosion_scan(
            w, 1e24, 10.0, 100.0, 50, **kw))))
        w0 = pwi.SputteringMaterial.from_name("Tungsten", redeposition_factor=0.0)
        out["net 0.95"] = pwi.erosion_rate(w, 1e24, 100.0, **kw)["Net_Flux"]
        out["net 0"] = pwi.erosion_rate(w0, 1e24, 100.0, **kw)["Net_Flux"]
        return out

    lanes.put("pwi", lanes.run("PWI and closures lane 6", sputtering))
    lanes.put("closures lane 7", lanes.run("closures lane 7", lambda: sb.burn_equilibrium_0d(
        ne19=10.0, p_aux_mw=50.0, ip_ma=15.0, bt_t=5.3, r_m=6.2, a_m=2.0, kappa=1.8, **kw)))
    lanes.put("heating", lanes.run("heating proxy", lambda: hn.genray_heating_proxy(
        torch.Generator().manual_seed(0), major_radius_m=6.2, elongation=1.8, b_t=5.5,
        rf_power_mw=30.0, nbi_power_mw=25.0, **kw)))
    for thick in (5.0, 100.0):
        lanes.put(f"mcnp {thick:g}", lanes.run(f"mcnp {thick:g} cm", lambda: hn.mcnp_lite_transport_tbr(
            torch.Generator().manual_seed(7), histories=2000, thickness_cm=thick,
            li6_enrichment=0.9, be_multiplier_fraction=0.5, reflector_albedo=0.3, **kw)))
    cand = lanes.run("mif_frc lane 5 candidate", lambda: hn.quick_candidate(
        torch.Generator().manual_seed(11), 0, **kw))
    refined = lanes.run("mif_frc lane 5 refinement", lambda: hn.refine_candidate_tbr(
        cand, torch.Generator().manual_seed(111), **kw))
    lanes.put("candidate", refined)
    blend = 0.60 * float(hn.mcnp_lite_tbr(
        raw_tbr=refined["raw_tbr"], li6_enrichment=refined["li6_enrichment"],
        be_multiplier_fraction=refined["be_multiplier_fraction"],
        reflector_albedo=refined["reflector_albedo"], **kw)[0]) + 0.40 * refined["tbr_mc"]
    lanes.put("candidate blend", {"blend": blend})
    if cad:
        (source, power) = CAD_SOURCE
        vertices, faces = torus_mesh()
        rep = lanes.run("CAD torus", lambda: cad_rt.estimate_surface_loading(
            vertices, faces, np.asarray([source]), np.asarray([power]), occlusion_cull=True,
            **kw))
        lanes.put("cad", {"loading": rep.face_loading_w_m2, "peak": rep.peak_loading_w_m2,
                          "mean": rep.mean_loading_w_m2})
    return lanes.as_dict()


def slice20_on_cpu(conn) -> None:
    """The CPU twins of (zj) and (zk): their lanes in float64 (the design scans
    in float32, as JAX casts them) on two threads."""
    dev = on_cpu(2)
    conn.send({"zj": plant_lanes(dev), "zk": nuclear_lanes(dev)})
    conn.close()


def slice20_plain_on_card(conn) -> None:
    """Rows E and H's plain twins on the card, in a process of its own: every
    :data:`BURN_CASES` and :data:`QUENCH_CASES` case in float32 and float64,
    the timed ones (row E's float32 compact search, row H's float64 default
    transient) between CUDA events after a warm-up, as numpy arrays by
    (dtype, case)."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from scpn_fusion_tpu_torch.ops import cuda_burn as cbn
    from scpn_fusion_tpu_torch.ops import cuda_quench as cq
    dev, out = torch.device("cuda"), {}
    for dtype in (torch.float32, torch.float64):
        # a warm-up of every op the timed loops run (the process's first launches load them)
        for label, *_ in BURN_CASES[1:]:
            cbn.burn_relax_plain(burn_case(label, dtype, dev), 8.0, 2)
        cq.quench_run_plain(quench_case(QUENCH_TIMED, dtype, dev)[1], 2)
    for dtype in (torch.float32, torch.float64):
        for label, *_ in BURN_CASES:
            t, ms = events_ms(functools.partial(cbn.burn_relax_plain, burn_case(label, dtype, dev),
                                                8.0, 200))
            out[(str(dtype), label)] = t.cpu().numpy()
            out[(str(dtype), label, "ms")] = ms
        for label, *_ in QUENCH_CASES:
            _, c, n_steps = quench_case(label, dtype, dev)
            traces, ms = events_ms(functools.partial(cq.quench_run_plain, c, n_steps))
            out[(str(dtype), label)] = [x.cpu().numpy() for x in traces]
            out[(str(dtype), label, "ms")] = ms
    conn.send(out)
    conn.close()


def feasibility_agrees(card: dict, cpu: dict, prefix: str, limits) -> int:
    """The float32 scan's feasibility on the card against the CPU: a design
    whose mask differs must lie within :data:`SCAN_F32_TOL` of a limit (or
    of the convergence test).  Returns the count of differing designs."""
    fields = (("greenwald_fraction", limits.greenwald_fraction_max),
              ("beta_n", limits.beta_n_max), ("q_star", limits.q_star_min),
              ("b_coil_t", limits.b_max_coil_t), ("wall_load_mw_m2", limits.p_wall_max_mw_m2),
              ("q_fusion", 10.0))
    differ = np.flatnonzero(card[f"{prefix} feasible"] != cpu[f"{prefix} feasible"])
    for i in differ:
        near = [abs(cpu[f"{prefix} {k}"][i] / lim - 1.0) <= SCAN_F32_TOL for k, lim in fields]
        require(any(near), f"{prefix}: design {i} differs in feasibility from the CPU's, away "
                           f"from every limit")
    return len(differ)


def plant_gates(r: dict) -> dict:
    """The gates of (zj) on :func:`plant_lanes`' results: those of
    ``tests/test_scenario_design.py:124-152`` and of the quench tests, lanes
    2-4 of ``run_confinement_burn.py`` and lanes 2, 3 and 5 of
    ``run_whole_plant_fault.py``."""
    from scpn_fusion_tpu_torch.models.engineering import hts_quench as hq
    num, f32r, verdicts = r["num"], r["f32"], r["verdicts"]
    best, n_ok = verdicts["search 512"]
    gates = {
        "ITER-like point Q > 5 and feasible": float(num["ITER q_fusion"]) > 5.0
        and bool(num["ITER feasible"]),
        "compact search 512 finds a Q >= 10 device, R0 < 7 m": n_ok > 0
        and bool(f32r["search 512 feasible"][best]) and float(f32r["search 512 q_fusion"][best]) >= 10.0
        and float(f32r["search 512 r_m"][best]) < 7.0,
        "confinement lane 2: Q >= 10, converged": float(num["confinement lane 2 q_fusion"]) >= 10.0
        and bool(num["confinement lane 2 converged"]),
        "confinement lane 3: |TBR - 1.1409| <= 1e-3, groups 2e-3":
        abs(float(num["confinement lane 3 tbr"]) - 1.1409) <= 1e-3
        and float(np.max(np.abs(num["confinement lane 3 tbr_per_group"]
                                - np.asarray((0.0278, 0.2257, 0.8875))))) <= 2e-3,
        "confinement lane 4: TBR > 1.05": float(num["confinement lane 3 tbr"]) > 1.05,
        "whole-plant lane 2: nominal passes, degraded fails detection":
        verdicts["quench default 2000 steps"] == (True, ())
        and not verdicts["quench degraded (whole-plant lane 2)"][0]
        and "detection_voltage_below_threshold" in verdicts["quench degraded (whole-plant lane 2)"][1],
        "whole-plant lane 3: DEC nominal passes, degraded fails": verdicts["dec nominal"][0]
        and not verdicts["dec degraded"][0],
        "whole-plant lane 5: pumping < 0.2 P, monotone": bool(np.all(
            (num["whole-plant lane 5 pumps"] > 0) & (num["whole-plant lane 5 pumps"]
                                                     < 0.2 * np.asarray([500.0, 1000.0, 2000.0]))))
        and bool(np.all(np.diff(num["whole-plant lane 5 pumps"]) > 0)),
    }
    c, s = hq.REBCOConductor(), hq.QuenchScenario()
    t_tr, i_tr = num["quench default 2000 steps t"], num["quench default 2000 steps current_a"]
    t_det = s.detection_delay_s + s.protection_switch_delay_s
    gates["quench tests: dump decay, monotone, hotspot < 200 K"] = (
        abs(i_tr[-1] / (c.operating_current_a * np.exp(-(t_tr[-1] - t_det) * c.dump_resistance_ohm
                                                        / c.inductance_h)) - 1.0) <= 0.05
        and bool(np.all(np.diff(i_tr[t_tr > t_det]) <= 1e-9)) and 0.3 * i_tr[0] < i_tr[-1] < i_tr[0]
        and float(num["quench default 2000 steps hotspot_k"].max()) < 200.0)
    return {k: bool(v) for k, v in gates.items()}


def plant_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                 measured_plain: dict, plain_card, twin: dict) -> tuple[int, int]:
    """(zj) rows E and H: ``burn_relax`` on every :data:`BURN_CASES` case and
    ``quench_run`` on every :data:`QUENCH_CASES` case ONE launch each, in
    float32 and float64, ``torch.equal`` to the plain twin on the card
    (``plain_card``: :func:`slice20_plain_on_card`'s); then :func:`plant_lanes`
    on the card with one launch of row E a design call, one of row H a
    transient and one of row T a blanket group; the gates of
    ``tests/test_scenario_design.py:124-152``, of the quench tests, of
    ``run_whole_plant_fault.py`` lanes 2, 3 and 5 and of
    ``run_confinement_burn.py`` lanes 2-4; float64 within 1e-9 of the CPU
    (``twin``: :func:`slice20_on_cpu`'s), the float32 scans within
    :data:`SCAN_F32_TOL` with their masks equal but at a limit, the verdicts
    equal.  Returns the counted launches of ``burn_relax`` and ``quench_run``."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import design_scan as ds
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_burn as cbn
    from scpn_fusion_tpu_torch.ops import cuda_quench as cq

    f32, f64 = torch.float32, torch.float64
    for source in ("burn.cu", "quench.cu"):
        print(f"(zj) csrc/{source}'s PTX (nvcc -ptx, sm_90a): {orbit_ptx(source)} (no approx or "
              f"full division or square root expected); ptxas: "
              f"{ptxas_registers(cb.BUILD_LOG.get(source, ''))}")
    print(f"(zj) row E: {cbn.THREADS} threads a CTA: {-(-4096 // cbn.THREADS)} CTAs for the "
          f"compact search's 4096 designs, one thread for a scalar point")
    one_e = {name: int(name == "burn_relax") for name in KERNELS}
    one_h = {name: int(name == "quench_run") for name in KERNELS}
    plain = plain_card()
    burns, quenches = 0, 0
    for dtype in (f32, f64):
        tag = "f32" if dtype == f32 else "f64"
        for label, *_ in BURN_CASES:
            k = burn_case(label, dtype, dev)
            t, calls, launched = counted(functools.partial(cbn.burn_relax, k, 8.0, 200))
            require(calls == one_e and launched == {f"scpn_burn_relax_{tag}": 1},
                    f"(zj) row E {label} {tag}: {calls} / {launched}, not one launch")
            by_path[f"burn_relax {label} {tag}"] = calls
            burns += 1
            ref = torch.from_numpy(plain[(str(dtype), label)])
            equal = torch.equal(t.cpu(), ref)
            print(f"(zj) row E {tag} {label} x 200 iterations: one launch, torch.equal to the "
                  f"plain twin {equal}; T in [{float(t.min())!r}, {float(t.max())!r}] keV "
                  f"[{card}]")
            require(equal, f"(zj) row E {tag} {label}: the kernel differs from its plain twin")
            if label == BURN_TIMED and dtype == f32:
                results["burn_relax"] = {"max_abs_err": float((t.cpu() - ref).abs().max())}
        for label, *_ in QUENCH_CASES:
            values, c, n_steps = quench_case(label, dtype, dev)
            traces, calls, launched = counted(functools.partial(cq.quench_run, values, c, n_steps))
            require(calls == one_h and launched == {f"scpn_quench_run_{tag}": 1},
                    f"(zj) row H {label} {tag}: {calls} / {launched}, not one launch")
            by_path[f"quench_run {label} {tag}"] = calls
            quenches += 1
            ref = [torch.from_numpy(a) for a in plain[(str(dtype), label)]]
            equal = all(torch.equal(a.cpu(), b) for a, b in zip(traces, ref))
            print(f"(zj) row H {tag} {label}: one launch, torch.equal to the plain twin {equal}; "
                  f"peak hotspot {float(traces[2].max())!r} K, final current "
                  f"{float(traces[1][-1])!r} A [{card}]")
            require(equal, f"(zj) row H {tag} {label}: the kernel differs from its plain twin")
            if label == QUENCH_TIMED and dtype == f64:
                results["quench_run"] = {"max_abs_err": max(
                    float((a.cpu() - b).abs().max()) for a, b in zip(traces, ref))}

    (r, ms), calls, launched = counted(lambda: events_ms(lambda: plant_lanes(dev)))
    expect = {"compact search 4096": {"burn_relax": 1}, "compact search 512": {"burn_relax": 1},
              "evaluate_design 4096 f64": {"burn_relax": 1},
              "evaluate_design ITER f64": {"burn_relax": 1}, "confinement lane 2": {"burn_relax": 1},
              "confinement lane 3": {"thomas_solve_batched": 3},
              "whole-plant lane 5": {}}
    for label, *_ in QUENCH_CASES:
        expect[f"quench {label}"] = expect[f"quench screen {label}"] = {"quench_run": 1}
    require(r["counts"] == expect, f"(zj) lane kernel calls {r['counts']}, expected {expect}")
    by_path["plant_lanes"] = calls
    burns += calls["burn_relax"]
    quenches += calls["quench_run"]
    num, f32r, verdicts = r["num"], r["f32"], r["verdicts"]
    cpu = twin["zj"]
    limits = ds.DesignLimits()
    gates = plant_gates(r)
    print(f"(zj) plant lanes on the card: gates {gates}; compact search (4096, f32): best R0 "
          f"{float(f32r['search 4096 r_m'][verdicts['search 4096'][0]])!r} m of "
          f"{verdicts['search 4096'][1]} feasible Q >= 10 designs; lane 2 Q "
          f"{float(num['confinement lane 2 q_fusion'])!r}, lane 3 TBR "
          f"{float(num['confinement lane 3 tbr'])!r}; {ms:.1f} ms (CUDA events) [{card}]")
    require(all(gates.values()), "(zj): the port misses a gate of the JAX tests or validations")
    require(all(verdicts[k] == cpu["verdicts"][k] for k in verdicts if not k.startswith("search")),
            "(zj): a verdict differs from the CPU's")
    agree(num, cpu["num"], "(zj) plant lanes", card)
    worst = max(max_rel(torch_from(f32r[k]), torch_from(cpu["f32"][k]))
                for k in cpu["f32"] if not k.endswith("feasible"))
    differ = sum(feasibility_agrees(f32r, cpu["f32"], f"search {n}", limits)
                 for _, n, _ in BURN_CASES[:2])
    print(f"(zj) the float32 compact searches against the CPU: max relative deviation "
          f"{worst:.3e} (limit {SCAN_F32_TOL:.0e}), {differ} designs of 4608 differ in "
          f"feasibility (each at a limit); best index and count "
          f"{[verdicts[k] for k in ('search 4096', 'search 512')]} on the card, "
          f"{[cpu['verdicts'][k] for k in ('search 4096', 'search 512')]} on the CPU [{card}]")
    require(worst <= SCAN_F32_TOL, "(zj): a float32 compact search deviates from the CPU")
    if differ == 0:
        require(all(verdicts[k] == cpu["verdicts"][k] for k in ("search 4096", "search 512")),
                "(zj): a compact search's best design differs from the CPU's")

    measured_plain["burn_relax"] = plain[(str(f32), BURN_TIMED, "ms")]
    measured_plain["quench_run"] = plain[(str(f64), QUENCH_TIMED, "ms")]
    k = burn_case(BURN_TIMED, f32, dev)
    timing["burn_relax"] = (functools.partial(cbn.burn_relax, k, 8.0, 200),
                            functools.partial(cbn.burn_relax_plain, k, 8.0, 200),
                            "compact search 4096 x 200 iterations f32", burn_work(4096, 200, 4))
    values, c_h, n_steps = quench_case(QUENCH_TIMED, f64, dev)
    timing["quench_run"] = (functools.partial(cq.quench_run, values, c_h, n_steps),
                            functools.partial(cq.quench_run_plain, c_h, n_steps),
                            "the default transient, 2000 steps f64", quench_work(2000, 8))
    k64 = burn_case(BURN_TIMED, f64, dev)
    rows = ((f"row E burn_relax ({BURN_TIMED} x 200 iterations f32)", timing["burn_relax"][0],
             burn_work(4096, 200, 4), 200 * BURN_DEPTH, plain[(str(f32), BURN_TIMED, "ms")]),
            (f"row E burn_relax ({BURN_TIMED} x 200 iterations f64)",
             functools.partial(cbn.burn_relax, k64, 8.0, 200), burn_work(4096, 200, 8),
             200 * BURN_DEPTH, plain[(str(f64), BURN_TIMED, "ms")]),
            ("row E burn_relax (the ITER-like point f64)",
             functools.partial(cbn.burn_relax, burn_case("ITER-like point", f64, dev), 8.0, 200),
             burn_work(1, 200, 8), 200 * BURN_DEPTH, plain[(str(f64), "ITER-like point", "ms")]),
            ("row H quench_run (the default transient, 2000 steps f64)", timing["quench_run"][0],
             quench_work(2000, 8), 2000 * QUENCH_DEPTH, plain[(str(f64), QUENCH_TIMED, "ms")]),
            ("row H quench_run (the default transient, 2000 steps f32)",
             functools.partial(cq.quench_run, *quench_case(QUENCH_TIMED, f32, dev)),
             quench_work(2000, 4), 2000 * QUENCH_DEPTH, plain[(str(f32), QUENCH_TIMED, "ms")]))
    for label, kernel, work, chain, plain_ms in rows:
        ms_k = cuda_ms(kernel)
        b, by = bound(work)
        print(f"time (zj) {label}: kernel {ms_k:.4f} ms (CUDA events, median of 5), bound "
              f"{b:.4g} ms ({by}: {work[0] / 1e6:.4g} MB, {work[1] / 1e6:.4g} Mflop); the dependent "
              f"chain {chain} operations, ~{ladder_chain_ms(chain, 1):.4f} ms at a nominal 4 "
              f"cycles each and {SM_CLOCK_HZ / 1e9:.2f} GHz (a count, not a bound: IEEE "
              f"divisions, pow, sqrt and exp on the chain); plain {plain_ms:.1f} ms (once, in the "
              f"spawned process); library_ms null (no PyTorch call relaxes a burn point or "
              f"integrates a quench) [{card}]")
    return burns, quenches


def nuclear_gates(n: dict) -> dict:
    """The gates of (zk) on :func:`nuclear_lanes`' float64 results: those of
    ``tests/test_nuclear.py``, ``test_temhd_wall.py`` and
    ``test_heating_neutronics.py``, of ``run_physics_closures.py`` lanes 6-7
    and of ``run_mif_frc.py`` lane 5, and the CAD shadows' presence."""
    pg = n["multigroup tbr_per_group"]
    phi = n["multigroup flux"]
    surf = n["TEMHD run surface"]
    nwl, r_w, z_w = n["wall nwl_mw_m2"], n["wall r_wall"], n["wall z_wall"]
    y = {k.split(" ", 1)[1]: float(v) for k, v in n.items() if k.startswith("pwi ") and
         k.count(" ") == 3}
    cand = {k[len("candidate "):]: float(v) for k, v in n.items() if k.startswith("candidate ")
            and k != "candidate blend blend"}
    triple = 10.0 * 1e19 * float(n["closures lane 7 t_kev"]) * float(n["closures lane 7 tau_e_s"])
    shadowed = int(np.sum(n["cad loading"] == 0.0))
    gates = {
        "blanket (test_nuclear.py)": abs(float(n["multigroup tbr"]) - 1.14) <= 0.02
        and pg[2] > pg[1] > pg[0] and abs(pg.sum() / float(n["multigroup tbr"]) - 1.0) <= 1e-6
        and phi[0, -1] < 0.05 * phi[0, 0] and phi[2, 1:20].min() > 0
        and 1.0 < float(n["single group tbr"]) < 2.5,
        "PWI and closures lane 6": y["200 100 45"] == 0.0 and y["200 1000 45"] > 0.0
        and y["30 500 45"] > y["200 500 45"] and y["200 2000 80"] > 2.0 * y["200 2000 0"]
        and y["30 100 45"] > 0.0 and n["pwi erosion"][0] == 0.0 and n["pwi erosion"][-1] > 0.0
        and bool(np.all(np.diff(n["pwi erosion"]) >= -1e-12))
        and abs(float(n["pwi net 0.95"]) / float(n["pwi net 0"]) - 0.05) <= 0.05 * 1e-5,
        "closures lane 7: Lawson window": bool(n["closures lane 7 converged"])
        and float(n["closures lane 7 q_fusion"]) >= 10.0 and 1.5e21 <= triple <= 6e21,
        "TEMHD (test_temhd_wall.py)": surf[-1] > 300.0 + 5.0 and abs(surf[-1] - surf[-10]) < 1e-3
        and float(n["TEMHD 10 T k"]) > 50.0 * 1.05 and abs(float(n["TEMHD 0 T k"]) / 50.0 - 1.0) <= 1e-6
        and float(n["TEMHD 10 T surface"]) < float(n["TEMHD 0 T surface"])
        and bool(np.all(np.diff(n["TEMHD scan surface"]) > 0)) and bool(np.all(n["TEMHD scan k_enh"] >= 1.0)),
        "wall loading": bool(np.all(nwl >= 0.0)) and 0.1 < nwl.mean() < 1.5
        and 1.0 < float(n["wall peaking_factor"]) < 4.0 and r_w[np.argmax(nwl)] > np.median(r_w)
        and abs(z_w[np.argmax(nwl)]) < 2.0
        and float(n["wall eurofer lifetime_fpy"]) < float(n["wall tungsten lifetime_fpy"])
        and float(n["ash 0.0"]) == 1.0 and abs(float(n["ash 0.1"]) - 0.64) <= 1e-12
        and float(n["ash 0.6"]) == 0.0,
        "heating proxy": 0.35 <= float(n["heating rf_absorption_eff"]) <= 0.95
        and 0.28 <= float(n["heating nbi_absorption_eff"]) <= 0.93
        and float(n["heating mean_path_length_norm"]) > 0.9,
        "MCNP-lite: thick breeds more, leaks less": float(n["mcnp 100 tbr_mc"]) > float(n["mcnp 5 tbr_mc"])
        and float(n["mcnp 100 leakage_rate"]) < float(n["mcnp 5 leakage_rate"]),
        "mif_frc lane 5": abs(cand["tbr_final"] / float(n["candidate blend blend"]) - 1.0) <= 1e-6
        and all(np.isfinite(v) for v in cand.values()),
        "CAD: some faces shadowed, some lit": 0 < shadowed < len(n["cad loading"]),
    }
    return {k: bool(v) for k, v in gates.items()}


def nuclear_checks(dev, card: str, counted, by_path: dict, twin: dict) -> tuple[int, int]:
    """(zk) :func:`nuclear_lanes` on the card: row T once a blanket group and
    once a TEMHD step, row E once on lane 7 and on the candidate, no other
    kernel; the gates of ``tests/test_nuclear.py``, ``test_temhd_wall.py``,
    ``test_heating_neutronics.py``, of ``run_physics_closures.py`` lanes 6-7
    and of ``run_mif_frc.py`` lane 5; float64 within 1e-9 of the CPU
    (``twin``: :func:`slice20_on_cpu`'s), the CAD shadows equal; the CAD
    lane's peak device memory.  Returns the counted launches of row E and
    row T."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (r, ms), calls, launched = counted(lambda: events_ms(lambda: nuclear_lanes(dev)))
    peak = torch.cuda.max_memory_allocated() - base
    steps = TEMHD_RUN[2] + TEMHD_SCAN[1] + 2 * TEMHD_CONVECTION[1]
    expect = {"single group": {"thomas_solve_batched": 1},
              "multigroup": {"thomas_solve_batched": 3},
              "volumetric": {"thomas_solve_batched": 1},
              "TEMHD run": {"thomas_solve_batched": TEMHD_RUN[2]},
              "TEMHD scan": {"thomas_solve_batched": TEMHD_SCAN[1]},
              "TEMHD 10 T": {"thomas_solve_batched": TEMHD_CONVECTION[1]},
              "TEMHD 0 T": {"thomas_solve_batched": TEMHD_CONVECTION[1]},
              "wall loading": {}, "PWI and closures lane 6": {},
              "closures lane 7": {"burn_relax": 1}, "heating proxy": {}, "mcnp 5 cm": {},
              "mcnp 100 cm": {}, "mif_frc lane 5 candidate": {"burn_relax": 1},
              "mif_frc lane 5 refinement": {"thomas_solve_batched": 1}, "CAD torus": {}}
    require(r["counts"] == expect, f"(zk) lane kernel calls {r['counts']}, expected {expect}")
    require(not r["f32"], f"(zk): float32 results {sorted(r['f32'])}: every lane is float64")
    by_path["nuclear_lanes"] = calls
    n = r["num"]
    gates = nuclear_gates(n)
    surf, nwl = n["TEMHD run surface"], n["wall nwl_mw_m2"]
    cand_tbr = float(n["candidate tbr_final"])
    triple = 10.0 * 1e19 * float(n["closures lane 7 t_kev"]) * float(n["closures lane 7 tau_e_s"])
    shadowed = int(np.sum(n["cad loading"] == 0.0))
    print(f"(zk) nuclear, heating-neutronics and CAD lanes on the card (f64): gates {gates}; "
          f"TBR {float(n['multigroup tbr'])!r}, volumetric TBR {float(n['volumetric tbr'])!r}, "
          f"TEMHD surface {float(surf[-1])!r} K, peak NWL {float(nwl.max())!r} MW/m^2, lane 5 "
          f"TBR {cand_tbr!r}, Lawson n T tau {triple:.4g}; CAD {len(n['cad loading'])} "
          f"faces, {shadowed} shadowed, peak device memory of the phase {peak / 2**20:.1f} MiB "
          f"(occlusion chunks of {2**22} pairs); row T {calls['thomas_solve_batched']} launches "
          f"({steps} of them TEMHD steps), row E {calls['burn_relax']}; {ms:.1f} ms (CUDA "
          f"events) [{card}]")
    require(all(gates.values()), "(zk): the port misses a gate of the JAX tests or validations")
    cpu = twin["zk"]
    require(np.array_equal(n["cad loading"] == 0.0, cpu["num"]["cad loading"] == 0.0),
            "(zk): the CAD shadows differ from the CPU's")
    agree(n, cpu["num"], "(zk) nuclear, heating-neutronics and CAD", card)
    return calls["burn_relax"], calls["thomas_solve_batched"]


# ── the twenty-first slice: (zl) the whole-device discharge, UQ, the synthetic
# diagnostics, tomography, the quasi-3D contracts and their validation lanes;
# (zm) row U, the monitored UPDE run, with the Kuramoto runs, the monitor's
# gates and the replay certificate's lanes ──

# row U's cases: (label, layers, oscillators a layer, seed, ticks, what): the monitor at the
# reference's from_plasma defaults (monitor.py:85-112: build_knm_plasma("baseline", 8), 50 an
# oscillator layer, seed 42) for 1000 ticks, the replay certificate's 4 x 32 x 500
# (validation/run_replay_certificate.py:77-81) and tests/test_phase.py:97-126's run_upde setup
# (4 x 32, strong coupling, zeta 0.5, psi 0.5) at 3000 steps in both psi modes
PHASE_CASES = (("monitor 8 x 50", 8, 50, 42, 1000, "monitor"),
               ("replay 4 x 32", 4, 32, 42, 500, "replay"),
               ("run_upde 4 x 32 external", 4, 32, 2, 3000, "external"),
               ("run_upde 4 x 32 mean_field", 4, 32, 2, 3000, "mean_field"))
PHASE_TIMED = "monitor 8 x 50"
# operations of row U that the function needs, a tick: an oscillator's 28 (the order
# parameter's cos, sin and masks, the Euler step with its three sines and cosines, the wrap,
# the V term, the tree adds), a (source, target) pair's 15 (gate, weight, the lag's sin and cos,
# the sums), a layer's 13 (the quotients, R, Psi, the mean field)
PHASE_OPS = (28, 15, 13)
ITER_UQ = dict(i_p_ma=15.0, b_t=5.3, p_heat_mw=50.0, n_e_19=10.1, r_major=6.2, aspect=3.1,
               kappa=1.7)                       # tests/test_uq.py:28
# tests/test_wdm.py's discharges: (label, config kwargs, steps), TransportParams(nr=32,
# picard_max_iter=5)
WDM_TEST_CASES = (("accumulates", dict(dt_s=0.01, p_aux_mw=50.0, core_penetration=1e-2), 40),
                  ("collapse", dict(dt_s=0.05, p_aux_mw=0.0, core_penetration=50.0,
                                    collapse_te_kev=0.5), 60),
                  ("clean", dict(dt_s=0.01, p_aux_mw=50.0, core_penetration=0.0), 40))
WDM_STEPS = 200                                 # the CLI's wdm mode (cli.py:846)
TOMO = (16, 4.0, 8.5, -3.0, 3.0, 500)           # tests/test_tomography.py: res, box, iterations
Q3D_BASE = dict(n_fp=1, r0=2.95, a=0.95, helical_excursion=0.0, mirror_ratio=0.0)
Q3D_STELLAR = dict(n_fp=4, r0=2.95, a=0.95, helical_excursion=0.057, mirror_ratio=0.04)
Q3D_THRESHOLDS = {"max_force_balance_rmse_pct": 8.0, "max_force_residual_p95_pct": 12.0}
JET_TEST_STATS = ({"q95": 4.0, "edge_gradient": 0.02, "bcentr": 2.8},    # test_quasi3d.py:98-100
                  {"q95": 3.4, "edge_gradient": 0.03, "bcentr": 3.4})
REPLAY_HASHSEED = "12345"                       # run_replay_certificate.py:194
# the float32 monitor of the JAX test (8 layers x 20, 200 ticks) drifts from its float64 run by
# ~1e-5 of R and ~2e-4 of lambda (ln of a ratio of V over n dt amplifies V's rounding); the
# card's float32 run is held to this many times the CPU's float32 distance from float64
MONITOR_F32_FACTOR = 4.0


def phase_case(label: str, dtype, device):
    """(run through the kernel, plain twin, ticks) of a :data:`PHASE_CASES`
    case; each run takes the tick count."""
    import torch
    from scpn_fusion_tpu_torch.models.phase import knm, monitor as mon
    from scpn_fusion_tpu_torch.ops import cuda_phase as cp
    _, n_layers, n_per, seed, n_ticks, what = next(c for c in PHASE_CASES if c[0] == label)
    if what in ("monitor", "replay"):
        spec = (knm.build_knm_plasma("baseline", n_layers) if what == "monitor"
                else knm.KnmSpec(k=0.8 * np.ones((4, 4)) + 0.4 * np.eye(4)))
        st, ar = mon.init_monitor(spec, n_per=n_per, seed=seed, dtype=dtype, device=device)
        cfg = mon.MonitorConfig()
        return (lambda n: mon.run_monitor(st, ar, cfg=cfg, n_ticks=n),
                lambda n: cp.monitor_run_plain(st, ar, cfg, n), n_ticks)
    rng = np.random.default_rng(seed)
    th = torch.as_tensor(rng.uniform(-np.pi, np.pi, (n_layers, n_per)), dtype=dtype,
                         device=device)
    om = 0.02 * (torch.as_tensor(knm.plasma_omega(8)[:n_layers], dtype=dtype, device=device)
                 [:, None].expand(n_layers, n_per) * 0.1)
    mask = torch.ones(n_layers, n_per, dtype=dtype, device=device)
    k, al, _ = knm.KnmSpec(k=np.full((n_layers, n_layers), 1.5)).arrays(dtype, device)
    ze = torch.full((n_layers,), 0.5, dtype=dtype, device=device)
    kw = dict(dt=0.01, psi_external=0.5, psi_mode=what)
    return (lambda n: cp.upde_run(th, om, mask, k, al, ze, n_steps=n, **kw),
            lambda n: cp.upde_run_plain(th, om, mask, k, al, ze, n_steps=n, **kw), n_ticks)


def phase_work(label: str, n_ticks: int, item: int):
    """Row U: (bytes, operations, peak rate) of a :data:`PHASE_CASES` case:
    the inputs read once (phases, frequencies, mask, K, alpha, zeta, the
    guard's ring) and the traces written once (the monitor's five value
    traces, verdicts and counts, its final state; ``run_upde``'s phase trace
    and four value traces)."""
    _, n_layers, n, _, _, what = next(c for c in PHASE_CASES if c[0] == label)
    inputs = item * (3 * n_layers * n + 2 * n_layers * n_layers + n_layers)
    if what in ("monitor", "replay"):
        out = n_ticks * (item * (2 * n_layers + 3) + 1 + 4) + item * (n_layers * n + 50) + 8
        inputs += item * 50 + 8
    else:
        out = n_ticks * item * (n_layers * n + 2 * n_layers + 2)
    osc, pair, layer = PHASE_OPS
    ops = n_ticks * (osc * n_layers * n + pair * n_layers * n_layers + layer * n_layers)
    return float(inputs + out), float(ops), F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S


def phase_equal(a, b) -> bool:
    """``torch.equal`` over nested tuples of tensors, on the CPU."""
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), torch.as_tensor(b).cpu())
    return all(phase_equal(x, y) for x, y in zip(a, b))


def phase_numpy(out):
    """A run's tensors (nested) as numpy arrays, to cross a pipe."""
    import torch
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return [phase_numpy(x) for x in out]


def slice21_plain_on_card(conn) -> None:
    """Row U's plain twin on the card, in a process of its own: every
    :data:`PHASE_CASES` case at full length in float32 and float64, the timed
    one (the monitor, float32) between CUDA events after a warm-up, as numpy
    arrays by (dtype, case)."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    dev, out = torch.device("cuda"), {}
    for dtype in (torch.float32, torch.float64):
        for label, *_ in PHASE_CASES:
            phase_case(label, dtype, dev)[1](3)       # a warm-up of every op
    for dtype in (torch.float32, torch.float64):
        for label, *_ in PHASE_CASES:
            _, plain, n_ticks = phase_case(label, dtype, dev)
            res, ms = events_ms(functools.partial(plain, n_ticks))
            out[(str(dtype), label)] = phase_numpy(res)
            out[(str(dtype), label, "ms")] = ms
    conn.send(out)
    conn.close()


def replay_episodes(device) -> dict:
    """The replay certificate's four episodes on the port
    (``validation/run_replay_certificate.py:56-112``): a 65^2 Solov'ev
    multigrid solve (float64, plain ops), the 4-layer monitor for 500 ticks
    (float32, as ``init_monitor`` forces; row U on the card), the
    fault-tolerant shot with two coil losses (float64), 50 Aurora-parity
    steps (float64); the sha256 of each as float64 bytes."""
    import hashlib
    import torch
    from scpn_fusion_tpu_torch.control.fault_tolerant import (
        ACTUATOR_LOSS, run_fault_tolerant_shot,
    )
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.solovev import SolovevParams
    from scpn_fusion_tpu_torch.models.phase.knm import KnmSpec
    from scpn_fusion_tpu_torch.models.phase.monitor import init_monitor, run_monitor
    from scpn_fusion_tpu_torch.models.transport.aurora_parity import radial_transport_step
    from scpn_fusion_tpu_torch.ops import multigrid as mg
    from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet

    def digest(x) -> str:
        a = np.ascontiguousarray(np.asarray(x.detach().cpu().numpy(), np.float64))
        return hashlib.sha256(a.tobytes()).hexdigest()

    f64, hashes = torch.float64, {}
    params = SolovevParams()
    grid = Grid.from_bounds(65, 65, 3.0, 9.0, -3.0, 3.0, dtype=f64, device=device)
    psi_exact = params.psi(grid.RR, grid.ZZ)
    psi0 = apply_dirichlet(torch.zeros_like(psi_exact), psi_exact)
    hashes["equilibrium_psi"] = digest(mg.mg_solve(psi0, params.source(grid.RR), grid.R, grid.dR,
                                                   grid.dZ, n_cycles=20, use_pallas=False))
    state, arrays = init_monitor(KnmSpec(k=0.8 * np.ones((4, 4)) + 0.4 * np.eye(4)), n_per=32,
                                 seed=42, device=device)
    hashes["phase_r_global"] = digest(run_monitor(state, arrays, n_ticks=500)[1].r_global)
    rng = np.random.default_rng(7)
    kw = dict(dtype=f64, device=device)
    shot = run_fault_tolerant_shot(
        torch.tensor(rng.standard_normal((4, 6)), **kw), torch.tensor([1.0, -0.5, 0.3, 0.8], **kw),
        fault_times=torch.tensor([40, 70, -1], device=device),
        fault_kinds=torch.tensor([ACTUATOR_LOSS, ACTUATOR_LOSS, 0], device=device),
        fault_indices=torch.tensor([1, 4, -1], device=device), n_steps=150)
    hashes["control_error_norm"] = digest(shot.error_norm)
    nr, nz = 24, 5
    r = np.linspace(0.05, 0.6, nr)
    prof = np.exp(-((r - 0.3) / 0.08) ** 2)
    out = torch.tensor(np.tile(prof[:, None], (1, nz)) * (1.0 + np.arange(nz)), **kw)
    d, v = torch.ones((nr, nz), **kw), -2.0 * torch.ones((nr, nz), **kw)
    for _ in range(50):
        out = radial_transport_step(out, d, v, torch.tensor(r, **kw), 1e-4)
    hashes["transport_density"] = digest(out)
    return hashes


def replay_combined(hashes: dict) -> str:
    import hashlib
    return hashlib.sha256(json.dumps(hashes, sort_keys=True).encode()).hexdigest()


def replay_on_card(conn) -> None:
    """Lane 3 of the replay certificate: the episodes in a fresh interpreter
    (started with another ``PYTHONHASHSEED``) on the card; sends the
    combined hash and the components."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    hashes = replay_episodes(torch.device("cuda"))
    conn.send((replay_combined(hashes), hashes))
    conn.close()


@contextlib.contextmanager
def environment(**values):
    """The process environment with ``values`` set, restored on the way out
    (a spawned process reads it when it starts)."""
    import os
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def multi_machine_solves(device, dtype) -> dict:
    """Lane 1's solves of ``run_multi_machine`` (the port's module) in
    ``dtype``: on the card in float32 kernels 2 and 3 run once each a Picard
    iteration.  By machine: (psi, converged, iterations, psi span)."""
    from scpn_fusion_tpu_torch.validation.run_multi_machine import machine_solves
    return {name: (res.psi.detach().cpu().numpy(), bool(res.converged), int(res.iterations),
                   span) for name, (res, span) in machine_solves(device, dtype).items()}


def discharge_lane(lanes, label: str, cfg, dtype, device, n_steps: int, f32: bool = False):
    """One discharge of ``models/wdm.py`` into ``lanes``: its traces, final
    state and collapse time."""
    from scpn_fusion_tpu_torch.models import wdm
    tr = lanes.run(label, lambda: wdm.run_discharge(cfg, wdm.default_initial_state(
        cfg, dtype, device), n_steps))
    lanes.put(label, {k: getattr(tr, k) for k in tr._fields[:-1]}, f32=f32)
    lanes.put(f"{label} final", tr.final_state, f32=f32)
    lanes.verdicts[f"{label} collapse"] = wdm.collapse_time_s(tr)


def zl_lanes(device, psi_129=None) -> dict:
    """(zl)'s lanes: the CLI's discharge (``WDMConfig()``, 200 steps) in
    float64 and ``tests/test_wdm.py``'s three; ``quantify_uncertainty`` at
    10,000 samples and ``quantify_full_chain`` at 5000, the PCE fits, Sobol
    indices and LHS at ``tests/test_uq.py``'s sizes, lane 4 of
    ``run_physics_closures.py``; the CLI's 65^2 forward channels
    (``cli.py:470-505``, float32 as the CLI's grid); tomography at
    ``tests/test_tomography.py``'s 48 chords, RES 16, the three methods at
    500 iterations; the magnetic probes on ``psi_129`` (path (b)'s 129^2
    free-boundary psi, as float64); the quasi-3D chain at its defaults (720
    samples, 56 x 48 x 14, the zonal ratio, 48 x 120 two-fluid steps, the TBR
    calibration) with ``run_quasi3d_contracts.py``'s force-balance lane.
    Float64 but where said; the
    draws from ``torch.Generator``s on the CPU, so every device sees the same."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import free_boundary_config
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models import wdm
    from scpn_fusion_tpu_torch.models.diagnostics import forward as fw
    from scpn_fusion_tpu_torch.models.diagnostics import tomography as tomo
    from scpn_fusion_tpu_torch.models.physics import quasi3d as q3
    from scpn_fusion_tpu_torch.models.physics import stellarator as st
    from scpn_fusion_tpu_torch.models.transport.solver import TransportParams
    from scpn_fusion_tpu_torch.models.uq import mc, pce
    lanes, f32, f64 = Lanes(), torch.float32, torch.float64
    kw = dict(dtype=f64, device=device)

    # the whole-device discharges
    discharge_lane(lanes, "discharge", wdm.WDMConfig(), f64, device, WDM_STEPS)
    for label, c_kw, n in WDM_TEST_CASES:
        cfg = wdm.WDMConfig(transport=TransportParams(nr=32, picard_max_iter=5), **c_kw)
        discharge_lane(lanes, f"wdm test {label}", cfg, f64, device, n)
    lanes.put("eos", {"tf": wdm.thomas_fermi_pressure([1e20, 1e30, 1e30], [1e4, 0.0, 1.0], **kw),
                      "redep": wdm.redeposition_fraction([1.0, 5.0, 20.0], 1e19, **kw)})

    # uncertainty quantification
    s = mc.PlasmaScenario(**ITER_UQ)
    lanes.put("uq", lanes.run("quantify_uncertainty 10000", lambda: mc.quantify_uncertainty(
        s, n_samples=10000, seed=0, **kw)))
    lanes.put("uq full", lanes.run("quantify_full_chain 5000", lambda: mc.quantify_full_chain(
        s, n_samples=5000, seed=0, **kw)))
    lanes.put("uq base 3000", mc.quantify_uncertainty(s, n_samples=3000, seed=1, **kw))
    lanes.put("uq full 3000", mc.quantify_full_chain(s, n_samples=3000, seed=1, **kw))

    def pce_lanes():
        g = torch.Generator().manual_seed(0)
        x2, xt, x3 = (torch.randn(shape, generator=g, dtype=f64).to(device)
                      for shape in ((400, 2), (50, 2), (500, 3)))

        def f(x):
            return 2.0 + 0.5 * x[:, 0] + 1.5 * (x[:, 1] ** 2 - 1.0) + 0.3 * x[:, 0] * x[:, 1]

        fit = pce.fit_pce(x2, f(x2)[:, None], order=2)
        one = pce.fit_pce(x2[:100], 3.0 * x2[:100, :1], order=1)
        sob = pce.fit_pce(x3, (5.0 * x3[:, 0] + 0.5 * x3[:, 2])[:, None], order=2)
        return {"predict": pce.predict_pce(fit, xt)[:, 0], "truth": f(xt),
                "point": pce.predict_pce(one, torch.tensor([1.0, 0.0], **kw)),
                "sobol": pce.sobol_first_order(sob), "coeff": fit.coefficients,
                "lhs": pce.latin_hypercube(torch.Generator().manual_seed(0), 100, 3, **kw)}

    lanes.put("pce", lanes.run("PCE", pce_lanes))
    central = torch.as_tensor(mc.IPB98_CENTRAL, **kw)
    lanes.put("closures lane 4", {f"tau{p:g}": mc.ipb98_tau_e(mc.PlasmaScenario(
        i_p_ma=15.0, b_t=5.3, p_heat_mw=p, n_e_19=10.0, r_major=6.2, aspect=3.1, kappa=1.7),
        central) for p in (50.0, 100.0)})

    # the CLI's forward channels, float32 (cli.py:470-505)
    def channels():
        grid = Grid.from_bounds(65, 65, 4.0, 8.4, -2.2, 2.2, dtype=f32, device=device)
        rho = torch.sqrt(((grid.RR - 6.2) / 2.0) ** 2 + (grid.ZZ / 3.6) ** 2)
        ne = 1e20 * torch.clamp(1.0 - rho**2, min=0.0)
        pts = torch.tensor([[6.2, 0.0], [7.0, 0.0]], dtype=f32, device=device)
        return fw.generate_forward_channels(
            ne_m3=ne, te_kev=20.0 * torch.clamp(1.0 - rho**2, min=0.0) ** 1.5,
            neutron_source=1e18 * torch.clamp(1.0 - rho**2, min=0.0) ** 2, grid=grid,
            chords=torch.tensor([[[6.2, -2.2], [6.2, 2.2]], [[5.0, -2.2], [5.0, 2.2]]], dtype=f32,
                                device=device), thomson_points=pts, ece_channels=pts,
            volume_element_m3=grid.dR * grid.dZ * 2 * np.pi * 6.2)

    # the CLI prints the first three; ne^2 of 1e40 m^-6 overflows float32 in the soft X-ray
    # and bolometer channels, as in the JAX package
    cli = lanes.run("CLI forward channels 65^2 f32", channels)
    lanes.put("cli channels", {k: getattr(cli, k) for k in cli._fields[:4]}, f32=True)

    # tomography at tests/test_tomography.py's geometry
    res, r_min, r_max, z_min, z_max, iters = TOMO

    def tomography():
        s1, e1 = tomo.fan_chords(13.0, 0.0, n_chords=24, r_target=2.5, z_span=4.5, **kw)
        r_hits = torch.tensor(np.linspace(4.5, 8.0, 24), **kw)
        starts = torch.cat([s1, torch.stack([r_hits, torch.full_like(r_hits, 4.0)], 1)])
        ends = torch.cat([e1, torch.stack([r_hits, torch.full_like(r_hits, -4.0)], 1)])
        a = tomo.build_geometry_matrix(starts, ends, r_min, r_max, z_min, z_max, res=res,
                                       n_samples=120)
        rr, zz = np.meshgrid(np.linspace(r_min, r_max, res), np.linspace(z_min, z_max, res))
        phantom = torch.tensor(np.exp(-((rr - 6.2) ** 2 + zz**2) / 0.8).reshape(-1), **kw)
        out = {"a": a, "phantom": phantom}
        for method in ("nnls", "sart", "ridge"):
            out[method] = tomo.reconstruct(a, a @ phantom, res=res, lambda_reg=0.01,
                                           method=method, n_iters=iters)
        return out

    lanes.put("tomography", lanes.run("tomography", tomography))

    # the magnetic probes on (b)'s 129^2 free-boundary psi
    if psi_129 is not None:
        grid = Grid.from_config(free_boundary_config(129), **kw)
        rng = np.random.default_rng(129)
        pts = torch.tensor(np.stack([rng.uniform(grid.R_min + 0.5, grid.R_max - 0.5, 24),
                                     rng.uniform(grid.Z_min + 0.5, grid.Z_max - 0.5, 24)], 1),
                           **kw)
        lanes.put("probes", dict(zip(("psi", "b_r", "b_z"), lanes.run(
            "magnetic probes", lambda: fw.synthetic_magnetic_probes(
                torch.tensor(psi_129, **kw), grid, pts)))))

    # the quasi-3D chain at its defaults
    def quasi3d():
        base, stellar = st.StellaratorConfig(**Q3D_BASE), st.StellaratorConfig(**Q3D_STELLAR)
        obs = q3.quasi_3d_force_balance(torch.Generator().manual_seed(42), base=base,
                                        stellar=stellar, samples=720, **kw)
        mean, p95 = q3.solve_quasi_3d_force_residual(obs.asymmetry_index, obs.n1_amp,
                                                     obs.n2_amp, **kw)
        hall = q3.hall_mhd_zonal_ratio(torch.Generator().manual_seed(42 + 911), grid=18,
                                       steps=36, **kw)
        ref, _ = q3.jet_solps_reference_profile(list(JET_TEST_STATS), 48)
        div = q3.build_divertor_profiles(n1_amp=obs.n1_amp, n2_amp=obs.n2_amp,
                                         z_n1_amp=obs.z_n1_amp, zonal_ratio=hall["zonal_ratio"],
                                         reference_profile_w_m2=ref, **kw)
        tbr = q3.calibrate_tbr_with_erosion(
            mean_heat_flux_w_m2=float(np.mean(div["predicted_profile_w_m2"])),
            thickness_cm=260.0, asdex_erosion_ref_mm_year=0.25, **kw)
        return obs, (mean, p95), hall, div, tbr

    obs, (mean, p95), hall, div, tbr = lanes.run("quasi-3D chain", quasi3d)
    lanes.put("q3d force balance", obs)
    lanes.put("q3d residual", {"mean": mean, "p95": p95})
    lanes.put("q3d", {"zonal": hall["zonal_ratio"], "profile": div["predicted_profile_w_m2"],
                      "gain": div["cooling_gain_pct"], **div["two_fluid_diag"],
                      **div["divertor_state"]})
    lanes.put("q3d tbr", {k: v for k, v in tbr.items() if not isinstance(v, bool)})
    lanes.verdicts["q3d"] = (hall["backend"], tbr["calibration_triggered"])

    return lanes.as_dict()


def zm_lanes(device) -> dict:
    """(zm)'s lanes in float64 but where said: ``run_kuramoto`` at
    ``tests/test_phase.py``'s sizes (256 oscillators; 2000 steps strongly
    coupled, 1000 weakly, 2000 driven), the 8 x 50 monitor and the
    strong-coupling ``run_upde`` through row U (one launch each on the
    card), and the gates of ``tests/test_phase_monitor.py`` (20 oscillators
    a layer, seed 3, float32 as JAX's ``init_monitor`` forces; its 200-tick
    run also in float64)."""
    import io
    import torch
    from scpn_fusion_tpu_torch.models.phase import guard, knm, kuramoto, monitor as mon
    lanes, f64 = Lanes(), torch.float64
    rng = np.random.default_rng(0)
    theta0, normal = rng.uniform(-np.pi, np.pi, 256), rng.normal(size=256)
    for label, th0, omega, k, zeta, mode, n in (
            ("sync", theta0, 0.1 * normal, 2.0, 0.0, "mean_field", 2000),
            ("no sync", theta0, 2.0 * normal, 0.05, 0.0, "mean_field", 1000),
            ("driven", np.linspace(-2.0, 2.0, 64), np.zeros(64), 0.0, 2.0, "external", 2000)):
        tr = lanes.run(f"kuramoto {label}", lambda: kuramoto.run_kuramoto(
            th0, omega, dt=0.01, k_coupling=k, zeta=zeta, psi_external=1.0, psi_mode=mode,
            n_steps=n, dtype=f64, device=device))
        lanes.put(f"kuramoto {label}", {"r": tr.r, "v": tr.v, "lambda": tr.lambda_exp,
                                        "v_end": kuramoto.lyapunov_v(tr.theta[-1], 1.0)})
    for label in ("monitor 8 x 50", "run_upde 4 x 32 external"):
        run, _, n_ticks = phase_case(label, f64, device)
        out = lanes.run(label, lambda: run(n_ticks))
        if label.startswith("monitor"):
            final, trace = out
            lanes.put(label, trace)
            lanes.put(f"{label} final", {"theta": final.theta, "ring": final.guard.v_buffer,
                                         "seen": final.guard.n_seen,
                                         "consecutive": final.guard.consecutive})
        else:
            lanes.put(label, dict(zip(("theta", "r_layer", "r_global", "v_layer", "v_global"),
                                      out)))

    def monitor_gates():
        spec = knm.build_knm_plasma("baseline", 8)
        st, ar = mon.init_monitor(spec, n_per=20, seed=3, device=device)
        new, snap = mon.monitor_tick(st, ar)
        final, trace = mon.run_monitor(st, ar, n_ticks=200)
        cfg = mon.MonitorConfig(psi_driver=float(np.pi), guard=guard.GuardConfig(
            window=20, max_violations=1, lambda_threshold=-10.0))
        _, bad = mon.run_monitor(st, ar, cfg=cfg, n_ticks=100)
        _, five = mon.run_monitor(st, ar, n_ticks=5)
        codec, buf = mon.PhaseStreamCodec(token="s3cret"), io.BytesIO()
        frames = mon.stream_trace(five, codec, buf)
        first = codec.decode(buf.getvalue().splitlines()[0])
        last = trace.snapshot(199)
        st64, ar64 = mon.init_monitor(spec, n_per=20, seed=3, dtype=f64, device=device)
        ref64 = mon.run_monitor(st64, ar64, n_ticks=200)[1]
        return {"tick1": int(new.tick), "r_layer1": tuple(snap["r_layer"].shape),
                "r_global1_in_0_1": 0.0 <= float(snap["r_global"]) <= 1.0,
                "ticks": trace.n_ticks, "final_tick": int(final.tick),
                "finite": bool(torch.isfinite(trace.v_global).all()),
                "last_snapshot": (last["tick"], type(last["guard_approved"]).__name__),
                "divergence_refused": not bool(bad.guard_approved[-1]), "frames": frames,
                "first": (first["type"], first["tick"]), "trace": trace, "ref64": ref64}

    gates = lanes.run("monitor gates", monitor_gates)
    lanes.verdicts["monitor gates"] = {k: v for k, v in gates.items()
                                       if k not in ("trace", "ref64")}
    lanes.put("monitor gates", gates["trace"], f32=True)
    lanes.put("monitor gates", gates["ref64"])
    return lanes.as_dict()


def slice21_on_cpu(conn, psi_129) -> None:
    """The CPU twins of (zl) and (zm) on two threads: their lanes, and lane 1
    of ``run_multi_machine.py`` in float32 plain ops."""
    dev = on_cpu(2)
    import torch
    conn.send({"zl": zl_lanes(dev, psi_129), "zm": zm_lanes(dev),
               "machines": multi_machine_solves(dev, torch.float32)})
    conn.close()


def zl_gates(r: dict) -> dict:
    """The gates of (zl): ``tests/test_wdm.py``, ``test_uq.py``,
    ``test_tomography.py``, ``test_quasi3d.py`` and
    ``test_diagnostics_surrogates.py``'s forward models, lane 4 of
    ``run_physics_closures.py`` and the force-balance lane of
    ``run_quasi3d_contracts.py``."""
    num, f32r, verdicts = r["num"], r["f32"], r["verdicts"]
    w_acc = num["wdm test accumulates w_impurity_total"]
    col = num["wdm test collapse collapsed"]
    k = int(np.argmax(col))
    te = num["wdm test collapse te_core_kev"]
    tau_p = num["uq tau_e_percentiles"]
    res, *_ = TOMO
    rr, zz = np.meshgrid(np.linspace(TOMO[1], TOMO[2], res), np.linspace(TOMO[3], TOMO[4], res))
    truth = np.exp(-((rr - 6.2) ** 2 + zz**2) / 0.8)

    def tomo_ok(method):
        img = num[f"tomography {method}"]
        pk_t = np.unravel_index(truth[1:-1, 1:-1].argmax(), (res - 2, res - 2))
        pk_r = np.unravel_index(img[1:-1, 1:-1].argmax(), (res - 2, res - 2))
        return (bool(np.all(img >= 0)) and abs(pk_t[0] - pk_r[0]) <= 2
                and abs(pk_t[1] - pk_r[1]) <= 2
                and np.corrcoef(truth.reshape(-1), img.reshape(-1))[0, 1] > 0.6)

    ratio = float(num["closures lane 4 tau100"] / num["closures lane 4 tau50"])
    gates = {
        "wdm: inventory never decreases, time 0.01 k, redeposition in [0, 0.99]":
        bool(np.all(np.diff(w_acc) >= -1e-6))
        and np.allclose(num["wdm test accumulates time_s"], 0.01 * np.arange(1, 41), rtol=1e-5)
        and bool(np.all((num["wdm test accumulates redeposition_fraction"] >= 0)
                        & (num["wdm test accumulates redeposition_fraction"] <= 0.99))),
        "wdm: the collapse latches and freezes Te":
        bool(col.any()) and bool(np.all(te[k + 1:] == te[k + 1]))
        and verdicts["wdm test collapse collapse"] is not None,
        "wdm: no collapse without penetration": verdicts["wdm test clean collapse"] is None
        and abs(float(num["wdm test clean w_impurity_total"][-1])) <= 1e-8,
        "wdm: EOS regimes": abs(float(num["eos tf"][0]) / (1e20 * 1e4 * 1.602176634e-19) - 1.0)
        <= 1e-3 and float(num["eos tf"][2]) > float(num["eos tf"][1])
        and bool(np.all(np.diff(num["eos redep"]) >= 0)),
        "uq: ordered percentiles, median inside, sigmas > 0": bool(np.all(np.diff(tau_p) >= 0))
        and tau_p[0] < float(num["uq tau_e"]) < tau_p[-1] and float(num["uq tau_e_sigma"]) > 0
        and float(num["uq q_sigma"]) > 0,
        "uq: the full chain widens tau_E": float(num["uq full 3000 tau_e_sigma"])
        > float(num["uq base 3000 tau_e_sigma"])
        and bool(np.all(np.diff(num["uq full 3000 q_bands"]) >= 0)),
        "pce: the fit recovers the polynomial, 1e-4":
        float(np.max(np.abs(num["pce predict"] - num["pce truth"]))) <= 1e-4
        and abs(float(num["pce point"][0]) - 3.0) <= 1e-5,
        "pce: Sobol finds the dominant input": float(num["pce sobol"][0]) > 0.9
        and float(num["pce sobol"][1]) < 0.05 and abs(float(num["pce sobol"].sum()) - 1.0) <= 0.05,
        "pce: LHS stratified": all(len(np.unique(np.floor(num["pce lhs"][:, d] * 100))) == 100
                                   for d in range(3)),
        "closures lane 4: tau(2P)/tau(P) = 2^-0.69 +-1%, ITER tau in [2.8, 4.2] s":
        abs(ratio / 2.0 ** -0.69 - 1.0) < 0.01
        and 2.8 <= float(num["closures lane 4 tau100"]) <= 4.2,
        "cli channels finite": all(bool(np.all(np.isfinite(v))) for k_, v in f32r.items()
                                   if k_.startswith("cli channels")),
        "tomography: geometry >= 0, >= 40 chords cross": bool(np.all(num["tomography a"] >= 0))
        and int((num["tomography a"].sum(axis=1) > 0).sum()) >= 40,
        **{f"tomography {m}: peak within 2 pixels, correlation > 0.6": tomo_ok(m)
           for m in ("nnls", "sart", "ridge")},
        "quasi-3D: force balance (contract lane: rmse <= 8 %, p95 <= 12 %)":
        float(num["q3d force balance force_balance_rmse_pct"])
        <= Q3D_THRESHOLDS["max_force_balance_rmse_pct"]
        and float(num["q3d residual p95"]) <= Q3D_THRESHOLDS["max_force_residual_p95_pct"],
        "quasi-3D: n1 ~ 0.057, asymmetry > 0.01, p95 > mean > 0":
        abs(float(num["q3d force balance n1_amp"]) / 0.057 - 1.0) <= 0.05
        and float(num["q3d force balance asymmetry_index"]) > 0.01
        and 0.0 < float(num["q3d residual mean"]) < float(num["q3d residual p95"]),
        "quasi-3D: cooling gain in (0.1, 30) %, Te > 2 keV, zonal ratio in (0, 1)":
        0.1 < float(num["q3d gain"]) < 30.0 and float(num["q3d electron_temp_mean_kev"]) > 2.0
        and 0.0 < float(num["q3d zonal"]) < 1.0 and verdicts["q3d"][0] == "hall_mhd",
        "quasi-3D: calibrated TBR <= raw, factor in (0, 1]": float(num["q3d tbr calibrated_tbr"])
        <= float(num["q3d tbr raw_tbr"]) + 1e-9 and 0.0 < float(num["q3d tbr calibration_factor"])
        <= 1.0,
    }
    if "probes psi" in num:
        gates["probes finite"] = all(bool(np.all(np.isfinite(num[f"probes {c}"])))
                                     for c in ("psi", "b_r", "b_z"))
    return {k_: bool(v) for k_, v in gates.items()}


def zm_gates(r: dict) -> dict:
    """The gates of (zm): ``tests/test_phase.py``'s Kuramoto and UPDE runs
    and ``tests/test_phase_monitor.py``'s monitor."""
    num, g = r["num"], r["verdicts"]["monitor gates"]
    gates = {
        "kuramoto: sync above critical (r 0.9 at the end, < 0.7 at the start)":
        float(num["kuramoto sync r"][-1]) > 0.9 and float(num["kuramoto sync r"][0]) < 0.7,
        "kuramoto: no sync below critical (r < 0.4)": float(num["kuramoto no sync r"][-1]) < 0.4,
        "kuramoto: the driver entrains (V < 1e-3, lambda < 0)":
        float(num["kuramoto driven v_end"]) < 1e-3 and float(num["kuramoto driven lambda"]) < 0.0,
        "upde: strong coupling synchronises (r > 0.9, V < 0.1)":
        float(num["run_upde 4 x 32 external r_global"][-1]) > 0.9
        and float(num["run_upde 4 x 32 external v_global"][-1]) < 0.1,
        "monitor: one tick, 8 layers, 0 <= R <= 1": g["tick1"] == 1 and g["r_layer1"] == (8,)
        and g["r_global1_in_0_1"],
        "monitor: 200 ticks recorded, finite V, snapshot 200": g["ticks"] == 200
        and g["final_tick"] == 200 and g["finite"] and g["last_snapshot"] == (200, "bool"),
        "monitor: the guard refuses anti-phase driving": g["divergence_refused"],
        "stream: five frames, the first a snapshot of tick 1": g["frames"] == 5
        and g["first"] == ("snapshot", 1),
    }
    return {k: bool(v) for k, v in gates.items()}


def phase_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                 measured_plain: dict, plain_card) -> int:
    """(zm) row U: every :data:`PHASE_CASES` case ONE launch of
    ``csrc/phase.cu`` in float32 and float64, ``torch.equal`` to the plain
    twin on the card (``plain_card``: :func:`slice21_plain_on_card`'s);
    row U's times against its bound and chain.  Returns its counted
    launches."""
    import torch
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_phase as cp

    print(f"(zm) csrc/phase.cu's PTX (nvcc -ptx, sm_90a): {orbit_ptx('phase.cu')} (the kernel's "
          f"own divisions and roots are .rn; approx forms and FMAs are libdevice's sin, cos, "
          f"atan2 and log, as in torch's kernels); ptxas: "
          f"{ptxas_registers(cb.BUILD_LOG.get('phase.cu', ''))}; threads at most "
          f"{cp.max_threads(torch.float32)} f32, {cp.max_threads(torch.float64)} f64")
    one = {name: int(name == "phase_run") for name in KERNELS}
    plain = plain_card()
    launches = 0
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        for label, n_layers, n_per, *_ in PHASE_CASES:
            kernel, _, n_ticks = phase_case(label, dtype, dev)
            out, calls, launched = counted(functools.partial(kernel, n_ticks))
            require(calls == one and launched == {f"scpn_phase_run_{tag}": 1},
                    f"(zm) row U {label} {tag}: {calls} / {launched}, not one launch")
            by_path[f"phase_run {label} {tag}"] = calls
            launches += 1
            ref = plain[(str(dtype), label)]
            equal = phase_equal(out, ref)
            n_pad = cp.pow2(n_per)
            print(f"(zm) row U {tag} {label} x {n_ticks} ticks: one launch of "
                  f"{cp.threads_for(n_layers, n_pad, cp.max_threads(dtype))} threads, "
                  f"{cp.tick_stages(n_layers, n_pad)} "
                  f"barrier stages a tick; torch.equal to the plain twin {equal} [{card}]")
            require(equal, f"(zm) row U {tag} {label}: the kernel differs from its plain twin")
            if label == PHASE_TIMED and dtype == torch.float32:
                results["phase_run"] = {"max_abs_err": float(np.max(np.abs(
                    out[1].r_global.cpu().numpy() - np.asarray(ref[1][0]))))}
    measured_plain["phase_run"] = plain[(str(torch.float32), PHASE_TIMED, "ms")]
    kernel, plain_fn, n_ticks = phase_case(PHASE_TIMED, torch.float32, dev)
    timing["phase_run"] = (functools.partial(kernel, n_ticks), functools.partial(plain_fn, n_ticks),
                           f"the monitor, 8 x 50 x {n_ticks} ticks f32",
                           phase_work(PHASE_TIMED, n_ticks, 4))
    for dtype in (torch.float32, torch.float64):
        item = 4 if dtype == torch.float32 else 8
        for label, n_layers, n_per, *_ in PHASE_CASES:
            kernel, _, n_ticks = phase_case(label, dtype, dev)
            work = phase_work(label, n_ticks, item)
            ms_k = cuda_ms(functools.partial(kernel, n_ticks))
            b, by = bound(work)
            stages = n_ticks * cp.tick_stages(n_layers, cp.pow2(n_per))
            print(f"time (zm) row U phase_run ({label} x {n_ticks} ticks "
                  f"{'f32' if item == 4 else 'f64'}): kernel {ms_k:.4f} ms (CUDA events, median of "
                  f"5), bound {b:.4g} ms ({by}: {work[0] / 1e6:.4g} MB, "
                  f"{work[1] / 1e6:.4g} Mflop); "
                  f"{stages} dependent barrier stages, {1e3 * ms_k / stages:.4f} us a stage; plain "
                  f"{plain[(str(dtype), label, 'ms')]:.1f} ms (once, in the spawned process); "
                  f"library_ms null (no PyTorch call runs a monitored UPDE) [{card}]")
    return launches


def zl_checks(dev, card: str, counted, by_path: dict, twin: dict, psi_129) -> None:
    """(zl) on the card: :func:`zl_lanes` (row T on the transport and TEMHD
    steps, no other kernel), the CLI's discharge in float32, the
    ``multi_machine`` campaign's lane 1 solves in float32 (kernels 2 and 3
    once each a Picard iteration, counted exactly, against the CPU's plain
    float32 solves at 1e-3 of the span, iterations within one; the campaign
    itself, float64 as its script solves, runs in (zs)), the gates of
    :func:`zl_gates`;
    float64 within 1e-9 of the CPU (``twin``: :func:`slice21_on_cpu`'s), the
    collapse times and verdicts equal, the float32 channels within 1e-5."""
    import torch
    (r, ms), calls, _ = counted(lambda: events_ms(lambda: zl_lanes(dev, psi_129)))
    allowed = {"thomas_solve_batched"}
    require(all(set(c) <= allowed for c in r["counts"].values()),
            f"(zl) lane kernel calls {r['counts']}: only row T expected")
    q3d = {"thomas_solve_batched": 120 + 1}    # a two-fluid step each, the blanket's group
    require(r["counts"].get("quasi-3D chain") == q3d,
            f"(zl) quasi-3D chain: {r['counts'].get('quasi-3D chain')}, expected {q3d}")
    by_path["zl_lanes"] = calls
    (lanes32, ms32), calls32, _ = counted(lambda: events_ms(lambda: _discharge_f32(dev)))
    by_path["discharge f32"] = calls32
    (solves, ms_mm), calls_mm, launched_mm = counted(
        lambda: events_ms(lambda: multi_machine_solves(dev, torch.float32)))
    iters = sum(it for _, _, it, _ in solves.values())
    require(calls_mm["fused_topology_source"] == calls_mm["fused_coarse_vcycle"] == iters
            and all(v == 0 for k, v in calls_mm.items()
                    if k not in ("fused_topology_source", "fused_coarse_vcycle")),
            f"(zl) multi-machine lane 1: calls {calls_mm} over {iters} Picard iterations, not one "
            f"source and one V-cycle an iteration")
    by_path["multi_machine lane 1 f32"] = calls_mm
    cpu = twin["zl"]
    gates = zl_gates(r)
    num = r["num"]
    print(f"(zl) whole-device, UQ, diagnostics, tomography and quasi-3D lanes on the card: gates "
          f"{gates}; discharge 200 steps f64: Te core "
          f"{float(num['discharge te_core_kev'][-1])!r} keV, W "
          f"{float(num['discharge w_impurity_total'][-1])!r}, collapse "
          f"{r['verdicts']['discharge collapse']} (CPU {cpu['verdicts']['discharge collapse']}); "
          f"f32: Te core {float(lanes32['f32']['discharge f32 te_core_kev'][-1])!r} keV, collapse "
          f"{lanes32['verdicts']['discharge f32 collapse']} ({ms32:.1f} ms, row T "
          f"{calls32['thomas_solve_batched']} launches); UQ tau_E {float(num['uq tau_e'])!r} s, "
          f"sigma {float(num['uq tau_e_sigma'])!r}; quasi-3D rmse "
          f"{float(num['q3d force balance force_balance_rmse_pct'])!r} %, p95 "
          f"{float(num['q3d residual p95'])!r} %, cooling {float(num['q3d gain'])!r} %; row T "
          f"{calls['thomas_solve_batched']} launches {r['counts']}; {ms:.1f} ms (CUDA events) "
          f"[{card}]")
    print(f"(zl) multi-machine lane 1's solves in f32 through kernels 2 and 3: "
          f"{ {k: v[1:] for k, v in solves.items()} } (converged, iterations, span); "
          f"{calls_mm['fused_topology_source']} source and {calls_mm['fused_coarse_vcycle']} "
          f"V-cycle calls = {iters} Picard iterations; launched {launched_mm}; {ms_mm:.1f} ms "
          f"[{card}]")
    require(all(gates.values()), "(zl): the port misses a gate of the JAX tests or validations")
    for name, (psi, conv, it, _) in solves.items():
        psi_c, conv_c, it_c, _ = twin["machines"][name]
        dev_psi = span_rel(torch.from_numpy(psi).double(), torch.from_numpy(psi_c).double())
        require(conv == conv_c and abs(it - it_c) <= 1 and dev_psi <= SLICE_TOL,
                f"(zl) multi-machine {name}: kernels {conv, it} against CPU plain {conv_c, it_c}, "
                f"psi {dev_psi:.3e}")
    require(r["verdicts"] == cpu["verdicts"],
            "(zl): a verdict or collapse time differs from the CPU's")
    require(lanes32["verdicts"]["discharge f32 collapse"] == cpu["verdicts"]["discharge collapse"],
            "(zl): the float32 discharge's collapse differs from the float64 one's")
    agree_noise(num, cpu["num"], "(zl) lanes", card)
    worst = max(max_rel(torch_from(r["f32"][k]), torch_from(cpu["f32"][k])) for k in cpu["f32"])
    print(f"(zl) the CLI's float32 channels against the CPU: max relative deviation {worst:.3e} "
          f"(limit {SCAN_F32_TOL:.0e}) [{card}]")
    require(worst <= SCAN_F32_TOL, "(zl): a float32 channel deviates from the CPU")


def _discharge_f32(dev) -> dict:
    """The CLI's discharge (``WDMConfig()``, 200 steps) in float32."""
    import torch
    from scpn_fusion_tpu_torch.models import wdm
    lanes = Lanes()
    discharge_lane(lanes, "discharge f32", wdm.WDMConfig(), torch.float32, dev, WDM_STEPS,
                   f32=True)
    return lanes.as_dict()


def zm_checks(dev, card: str, counted, by_path: dict, twin: dict, replay) -> int:
    """(zm)'s lanes on the card: :func:`zm_lanes` (row U once on the monitor,
    once on ``run_upde`` and four times in the monitor's gates, no other
    kernel), :func:`zm_gates`; float64 within 1e-9 of the CPU, the gates'
    verdicts equal; lanes 1 and 3 of the replay certificate (``replay``:
    :func:`replay_on_card`'s).  Returns row U's counted launches."""
    (r, ms), calls, _ = counted(lambda: events_ms(lambda: zm_lanes(dev)))
    expect = {"kuramoto sync": {}, "kuramoto no sync": {}, "kuramoto driven": {},
              "monitor 8 x 50": {"phase_run": 1}, "run_upde 4 x 32 external": {"phase_run": 1},
              "monitor gates": {"phase_run": 4}}
    require(r["counts"] == expect, f"(zm) lane kernel calls {r['counts']}, expected {expect}")
    by_path["zm_lanes"] = calls
    gates = zm_gates(r)
    cpu = twin["zm"]
    print(f"(zm) Kuramoto, UPDE and monitor lanes on the card: gates {gates}; sync r "
          f"{float(r['num']['kuramoto sync r'][-1])!r}, upde r_global "
          f"{float(r['num']['run_upde 4 x 32 external r_global'][-1])!r}; row U "
          f"{calls['phase_run']} launches; {ms:.1f} ms (CUDA events) [{card}]")
    require(all(gates.values()), "(zm): the port misses a gate of the JAX tests")
    require(r["verdicts"] == cpu["verdicts"], f"(zm): the monitor gates' verdicts "
            f"{r['verdicts']} differ from the CPU's {cpu['verdicts']}")
    agree(r["num"], cpu["num"], "(zm) lanes", card)
    # the float32 monitor's trace is held to the float64 one no further than
    # MONITOR_F32_FACTOR times the CPU's float32 run is; its verdicts equal the CPU's
    gap = {}
    for k in cpu["f32"]:
        ref = torch_from(cpu["num"][k])
        gap[k] = (max_rel(torch_from(r["f32"][k]), ref), max_rel(torch_from(cpu["f32"][k]), ref))
    print(f"(zm) the float32 monitor (row U on the card, its plain twin on the CPU) from the "
          f"float64 trace, card / CPU: { {k: f'{a:.2e} / {b:.2e}' for k, (a, b) in gap.items()} } "
          f"[{card}]")
    require(all(a <= MONITOR_F32_FACTOR * b + 1e-12 for a, b in gap.values())
            and all(np.array_equal(r["f32"][k], cpu["f32"][k]) for k in cpu["f32"]
                    if k.endswith(("guard_approved", "guard_violations"))),
            "(zm): the float32 monitor deviates from the float64 trace more than the CPU's")

    (h1, ms1), calls1, _ = counted(lambda: events_ms(lambda: replay_episodes(dev)))
    h2 = replay_episodes(dev)
    fresh_hash, fresh = replay()
    require(calls1 == {name: int(name == "phase_run") for name in KERNELS},
            f"(zm) replay episodes: kernel calls {calls1}, expected one launch of row U")
    by_path["replay"] = calls1
    comb = replay_combined(h1)
    lanes = {"double_run_determinism": h1 == h2, "cross_process_replay": fresh_hash == comb}
    print(f"(zm) replay certificate on the port: combined {comb}; lane 1 (two in-process runs) "
          f"{lanes['double_run_determinism']}; lane 3 (a fresh process, PYTHONHASHSEED="
          f"{REPLAY_HASHSEED}) {lanes['cross_process_replay']}; lane 2 not run: it compares with "
          f"the JAX package's committed hash, which the port's libdevice bits cannot give (not a "
          f"pass); components {h1}; {ms1:.1f} ms [{card}]")
    require(all(lanes.values()), f"(zm) replay certificate: {lanes} (fresh process {fresh})")
    return calls["phase_run"] + calls1["phase_run"]


# ── the twenty-second slice: (zn) row W and the GyroSwin benchmark, the
# committed artifacts, the surrogate trainers and the closed loops ──

# (label, samples, iterations, seed) of row W's cases: run_speed_benchmark's 1024 x 20,000
# (gyro_swin.py:143-146, seed 7) and the JAX test's 64 x 2000 (test_force_balance_gyroswin.py:121)
PROXY_CASES = (("benchmark 1024 x 20,000 (seed 7)", 1024, 20_000, 7),
               ("JAX test 64 x 2000 (seed 3)", 64, 2000, 3))
PROXY_TIMED = PROXY_CASES[0][0]
# operations of a step of a sample on row W (csrc/gene_proxy.cu: the factor 3, six feature
# products, the closure 20, the update 3; a tanh counted as one), and the dependent ones
# on a sample's chain (two tanh and an IEEE division among them)
PROXY_OPS, PROXY_DEPTH = 32, 20
SPEEDUP_GATE, PROXY_RMSE_GATE = 2.0, 5.0        # test_force_balance_gyroswin.py:151-153
GYRO_FIT_GATES = (7.0, 8.0)                      # :107-117: 8000 fitted, 500 held out (RMSE %)
TRANSPORT_GATE = 0.0943                          # tests/test_pretrained.py:28
FNO_GATE, FNO_REFERENCE = 0.25, 0.055            # tests/test_surrogate_artifacts.py:27; docstring
QLKNN_GATE, MULTI_REGIME_GATE = 0.25, 0.5        # tests/test_qlknn.py:98; test_fno_multi_regime:56
EQUILIBRIUM_GATE, EQUILIBRIUM_COMMITTED = 0.05, 0.0040   # test_surrogate_artifacts.py:112; artifact
LATENCY_REF_MS = (1.05, 2.69)                    # run_surrogate_latency.py:37-38: mean, P95
FNO_CARD_TOL = 1e-4      # the committed FNO on the card against the CPU port (cuFFT, pocketfft)


def proxy_case(label: str, dtype, device):
    """(features, iterations) of a :data:`PROXY_CASES` case."""
    import torch
    from scpn_fusion_tpu_torch.models.surrogates import gyro_swin as gs
    _, n, iterations, seed = next(c for c in PROXY_CASES if c[0] == label)
    x, _ = gs.generate_synthetic_dataset(seed, n)
    return torch.from_numpy(x).to(dtype=dtype, device=device), iterations


def proxy_work(n: int, iterations: int, item: int):
    """Row W: (bytes, operations, peak rate): six values read and one written
    a sample, :data:`PROXY_OPS` a step."""
    return (float(item * 7 * n), float(PROXY_OPS * n * iterations),
            F32_FLOP_PER_S if item == 4 else F64_FLOP_PER_S)


def slice22_plain_on_card(conn) -> None:
    """Row W's plain twin on the card, in a process of its own: every
    :data:`PROXY_CASES` case in float32 and float64 between CUDA events after a
    warm-up, as numpy arrays by (dtype, case)."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from scpn_fusion_tpu_torch.ops import cuda_proxy as cp
    dev, out = torch.device("cuda"), {}
    for dtype in (torch.float32, torch.float64):
        cp.gene_proxy_plain(proxy_case(PROXY_CASES[1][0], dtype, dev)[0], 2)   # a warm-up
    for dtype in (torch.float32, torch.float64):
        for label, *_ in PROXY_CASES:
            x, iterations = proxy_case(label, dtype, dev)
            chi, ms = events_ms(functools.partial(cp.gene_proxy_plain, x, iterations))
            out[(str(dtype), label)] = chi.cpu().numpy()
            out[(str(dtype), label, "ms")] = ms
    conn.send(out)
    conn.close()


@contextlib.contextmanager
def inner_iterations(log: list):
    """Append the Picard iterations of every inner solve of the free-boundary
    loop to ``log`` (the loop looks its solver up in its own module)."""
    from scpn_fusion_tpu_torch.models.equilibrium import free_boundary as fb
    solve = fb.solve_fixed_boundary_impl

    def recorded(*args, **kw):
        eq = solve(*args, **kw)
        log.append(int(eq.iterations))
        return eq

    fb.solve_fixed_boundary_impl = recorded
    try:
        yield log
    finally:
        fb.solve_fixed_boundary_impl = solve


def slice22_equilibrium_on_card(conn) -> None:
    """``pretrained.train_equilibrium_artifact()`` at its defaults on the card
    (65^2, 160 + 20 float32 free-boundary solves through kernels 2 and 3), in
    a process of its own, into a temporary directory, then loaded back:
    the metrics, the kernel calls and launches, the inner Picard iterations of
    every solve, the seconds, and the loaded artifact's metrics."""
    import tempfile
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    cb.library()
    log = []
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp, inner_iterations(log):
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = tp.train_equilibrium_artifact(out_dir=Path(tmp), device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        calls, launched = dict(cb.CALLS), dict(cb.LAUNCHES)
        sur, loaded = tp.load_equilibrium_artifact(weights_dir=Path(tmp), device="cuda")
        psi = sur.predict(sur.x_mean * 1.05).cpu().numpy()
    conn.send({"metrics": metrics, "calls": calls, "launched": launched, "inner": log,
               "seconds": seconds, "loaded": loaded, "psi_finite": bool(np.isfinite(psi).all())})
    conn.close()


def slice22_fno_trainers_on_card(conn) -> None:
    """``pretrained.train_fno_turbulence()`` (384 fields, width 24, modes 12, 3
    layers, 2500 cosine steps in segments of 1500) and
    ``train_fno_multi_regime`` (its defaults, seed 3) on the card, in a
    process of its own (~50 s of host time), the artifact into a temporary
    directory and loaded back: each one's result, kernel calls and
    seconds."""
    import tempfile
    import torch
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from scpn_fusion_tpu_torch.models.surrogates import fno_multi_regime as fmr
    from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    dev, out = torch.device("cuda"), {}
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        cb.reset_launch_counts()
        metrics, ms = events_ms(lambda: tp.train_fno_turbulence(out_dir=Path(tmp), device=dev))
        calls = dict(cb.CALLS)
        predict, loaded = tp.load_fno_turbulence(weights_dir=Path(tmp), device=dev)
        x, _ = fresh_fno_fields(metrics["grid"])
        with torch.no_grad():
            finite = bool(torch.isfinite(predict(torch.from_numpy(x).to(dev))).all())
    out["fno"] = {"metrics": metrics, "loaded": loaded, "finite": finite, "ms": ms,
                  "calls": calls}
    cb.reset_launch_counts()
    ((_, val, idx), ms) = events_ms(
        lambda: fmr.train_fno_multi_regime(torch.Generator().manual_seed(3), device=dev))
    out["multi"] = {"val": val, "n": int(idx.numel()), "ms": ms, "calls": dict(cb.CALLS)}
    conn.send(out)
    conn.close()


def esn_sine_params(device):
    """The ESN sine lane's reservoir from the JAX test's draw
    (``bench_config.ESN_SINE_JAX_INIT``), float32."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import ESN_SINE_JAX_INIT
    from scpn_fusion_tpu_torch.models.surrogates import esn
    with np.load(ESN_SINE_JAX_INIT) as f:
        w_in, w = (torch.from_numpy(f[k]).to(device) for k in ("w_in", "w_masked"))
    return esn._init_esn(w_in, w, torch.zeros_like(w))


def sine_inputs(device, dtype=None):
    """``tests/test_drift_wave_esn.py:90-92``'s two sines, 800 samples."""
    import torch
    t = np.linspace(0.0, 40.0, 800)
    u = torch.from_numpy(np.stack([np.sin(t), np.sin(0.5 * t + 0.3)], axis=1)).to(device)
    return u if dtype is None else u.to(dtype)


def zn_lanes(device) -> dict:
    """(zn)'s float64 lanes: the heat-shadow fit and its held-out predictions,
    the QLKNN profile features and analytic targets, the multi-regime pairs
    (16 x 32^2) on fixed draws, the suppression loop (seed 42, 200 steps) and
    its gain gradient on fixed draws, the ESN sine harvest and
    ``train_readout`` (reservoir 300); each lane's kernel calls counted."""
    import torch
    from scpn_fusion_tpu_torch.models.surrogates import esn
    from scpn_fusion_tpu_torch.models.surrogates import fno_multi_regime as fmr
    from scpn_fusion_tpu_torch.models.surrogates import heat_shadow as hs
    from scpn_fusion_tpu_torch.models.surrogates import qlknn
    from scpn_fusion_tpu_torch.models.surrogates import turbulence_suppressor as ts
    f64 = torch.float64
    lanes = Lanes()

    def shadow():
        w = hs.fit_synthetic(seed=42, samples=2048, dtype=f64, device=device)
        hold = hs.generate_shadow_dataset(99, 512, dtype=f64, device=device)
        return {"weights": w, "holdout": hs.predict_shadow_fraction(w, hold.features),
                "flux": hs.predict_divertor_flux(w, 1e7, hold.features)}

    lanes.put("heat shadow", lanes.run("heat shadow", shadow))

    def qlknn_lane():
        r = torch.linspace(0.2, 2.0, 33, dtype=f64, device=device)
        te, ti = 3.0 * torch.exp(-r / 0.6), 2.5 * torch.exp(-r / 0.7)
        q, ne = 1.0 + 2.0 * (r / 2.0) ** 2, 5.0 * (1.0 - (r / 2.2) ** 2)
        feats = qlknn.qlknn_features_from_profiles(te, ti, ne, q, r, r0=6.2, a=2.0, b0=5.3)
        u = torch.rand((2048, 10), generator=torch.Generator().manual_seed(2), dtype=f64)
        scan = torch.as_tensor(qlknn.FEATURE_BOUNDS[:, 0], dtype=f64) + u * torch.as_tensor(
            np.ptp(qlknn.FEATURE_BOUNDS, axis=1), dtype=f64)
        return {"features": feats, "targets": qlknn.analytic_targets(scan.to(device))}

    lanes.put("qlknn", lanes.run("qlknn", qlknn_lane))

    def pairs():
        x, y, idx = fmr.generate_multi_regime_pairs(torch.Generator().manual_seed(1),
                                                    n_samples=16, grid_size=32, dtype=f64,
                                                    device=device)
        return {"x": x, "y": y, "regime": idx}

    lanes.put("multi-regime pairs", lanes.run("multi-regime pairs", pairs))

    def suppression():
        run = ts.run_suppression_loop(seed=42, n_steps=200, control_on_step=50, dtype=f64,
                                      device=device)
        gain = torch.tensor(1.6, dtype=f64, device=device, requires_grad=True)
        late = ts.run_suppression_loop(seed=3, n_steps=80, control_on_step=20, gain=gain,
                                       dtype=f64, device=device).mean_energy_last20
        (grad,) = torch.autograd.grad(late, gain)
        return {**run._asdict(), "gain gradient": grad}

    lanes.put("suppression", lanes.run("suppression", suppression))

    def readout():
        params = esn.init_esn(torch.Generator().manual_seed(5), 2, reservoir_size=300,
                              dtype=f64, device=device)
        u = sine_inputs(device, f64)
        states = esn.harvest_states(params, u[:600])
        return {"states": states, "w_out": esn.train_readout(states, u[1:601], 1e-2).w_out}

    lanes.put("esn readout", lanes.run("esn readout", readout))
    return lanes.as_dict()


def fresh_fno_fields(grid: int):
    """``tests/test_surrogate_artifacts.py:30-42``'s fresh fields (seed 99):
    (x as (3, grid, grid, 1) float32, the streamfunction y)."""
    from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp
    rng = np.random.default_rng(99)
    x = np.stack([tp._gene_like_field(grid, r, rng) for r in ("ITG", "TEM", "ETG")])
    y = np.stack([tp._periodic_streamfunction(f) for f in x])
    return x[..., None].astype(np.float32), y


def transport_probe() -> np.ndarray:
    """``tests/test_pretrained.py:34-38``'s 50 local inputs (seed 1)."""
    g = np.random.default_rng(1)
    return np.stack([g.uniform(2, 10, 50), g.uniform(2, 10, 50), g.uniform(0, 5, 50),
                     g.uniform(1, 4, 50), g.uniform(0, 2, 50), g.uniform(0.5, 2, 50),
                     g.uniform(0.05, 0.8, 50)], axis=1)


def slice22_on_cpu(conn) -> None:
    """The CPU twin of (zn): :func:`zn_lanes` in float64 and the committed FNO
    and transport artifacts' predictions on the fresh fields and the probe
    inputs, on two threads."""
    import torch
    dev = on_cpu(2)
    from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp
    predict, metrics = tp.load_fno_turbulence(device=dev)
    x, _ = fresh_fno_fields(int(metrics["grid"]))
    transport, _ = tp.load_transport_surrogate(device=dev)
    with torch.no_grad():
        fno = predict(torch.from_numpy(x)).numpy()
    conn.send({"zn": zn_lanes(dev), "fno": fno,
               "transport": transport(torch.from_numpy(transport_probe())).numpy()})
    conn.close()


def proxy_checks(dev, card: str, counted, by_path: dict, results: dict, timing: dict,
                 measured_plain: dict, plain_card) -> int:
    """(zn) row W: ``gene_proxy`` on every :data:`PROXY_CASES` case ONE launch
    of ``csrc/gene_proxy.cu`` in float32 and float64, ``torch.equal`` to the
    plain twin on the card (``plain_card``: :func:`slice22_plain_on_card`'s);
    ``run_speed_benchmark`` at its defaults with the JAX test's gates (two
    launches); the GyroSwin fit's gates; row W's times against its bound and
    chain.  Returns its counted launches."""
    import torch
    from scpn_fusion_tpu_torch.models.surrogates import gyro_swin as gs
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_proxy as cp

    print(f"(zn) csrc/gene_proxy.cu's PTX (nvcc -ptx, sm_90a): {orbit_ptx('gene_proxy.cu')} (the "
          f"kernel's own divisions are .rn; FMAs are libdevice's tanh, as in torch's kernel); "
          f"ptxas: {ptxas_registers(cb.BUILD_LOG.get('gene_proxy.cu', ''))}; {cp.THREADS} threads "
          f"a CTA: {-(-1024 // cp.THREADS)} CTAs for the benchmark's 1024 samples")
    one = {name: int(name == "gene_proxy") for name in KERNELS}
    plain = plain_card()
    launches = 0
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        for label, *_ in PROXY_CASES:
            x, iterations = proxy_case(label, dtype, dev)
            chi, calls, launched = counted(functools.partial(gs.gene_proxy_predict, x,
                                                             iterations))
            require(calls == one and launched == {f"scpn_gene_proxy_{tag}": 1},
                    f"(zn) row W {label} {tag}: {calls} / {launched}, not one launch")
            by_path[f"gene_proxy {label} {tag}"] = calls
            launches += 1
            ref = torch.from_numpy(plain[(str(dtype), label)])
            equal = torch.equal(chi.cpu(), ref)
            print(f"(zn) row W {tag} {label}: one launch, torch.equal to the plain twin {equal}; "
                  f"chi in [{float(chi.min())!r}, {float(chi.max())!r}] [{card}]")
            require(equal, f"(zn) row W {tag} {label}: the kernel differs from its plain twin")
            if label == PROXY_TIMED and dtype == torch.float32:
                results["gene_proxy"] = {"max_abs_err": float((chi.cpu() - ref).abs().max())}

    bench, calls, _ = counted(lambda: gs.run_speed_benchmark(samples=1024, iterations=20_000,
                                                             device=dev))
    require(calls == {name: 2 * v for name, v in one.items()},
            f"(zn) run_speed_benchmark: kernel calls {calls}, expected two of row W")
    by_path["speed benchmark"] = calls
    launches += 2
    print(f"(zn) run_speed_benchmark(1024, 20,000) on the card: speedup {bench.speedup:.2f} "
          f"(gate > {SPEEDUP_GATE}), RMSE {bench.rmse_percent:.4f} % (gate < {PROXY_RMSE_GATE}); "
          f"the proxy {1e6 * bench.gene_proxy_s_per_sample:.4f} us a sample, the surrogate "
          f"{1e6 * bench.surrogate_s_per_sample:.4f} us a sample [{card}]")
    require(bench.speedup > SPEEDUP_GATE and bench.rmse_percent < PROXY_RMSE_GATE,
            "(zn): run_speed_benchmark misses the JAX test's gates")

    (fit, held), calls, _ = counted(lambda: gyro_fit_gates(dev))
    require(all(v == 0 for v in calls.values()), f"(zn) GyroSwin fit: kernel calls {calls}")
    print(f"(zn) GyroSwin fit on the card: RMSE {fit:.4f} % on 8000 fitted (gate < "
          f"{GYRO_FIT_GATES[0]}), {held:.4f} % on 500 held out (gate < {GYRO_FIT_GATES[1]}) "
          f"[{card}]")
    require(fit < GYRO_FIT_GATES[0] and held < GYRO_FIT_GATES[1],
            "(zn): the GyroSwin fit misses the JAX tests' gates")

    measured_plain["gene_proxy"] = plain[(str(torch.float32), PROXY_TIMED, "ms")]
    x, iterations = proxy_case(PROXY_TIMED, torch.float32, dev)
    timing["gene_proxy"] = (functools.partial(cp.gene_proxy, x, iterations),
                            functools.partial(cp.gene_proxy_plain, x, iterations),
                            "the benchmark's 1024 samples x 20,000 steps f32",
                            proxy_work(1024, iterations, 4))
    for dtype in (torch.float32, torch.float64):
        item = 4 if dtype == torch.float32 else 8
        for label, n, iterations, _ in PROXY_CASES:
            x, _ = proxy_case(label, dtype, dev)
            work = proxy_work(n, iterations, item)
            ms_k = cuda_ms(functools.partial(cp.gene_proxy, x, iterations))
            b, by = bound(work)
            chain = iterations * PROXY_DEPTH
            print(f"time (zn) row W gene_proxy ({label} {'f32' if item == 4 else 'f64'}): kernel "
                  f"{ms_k:.4f} ms (CUDA events, median of 5), bound {b:.4g} ms ({by}: "
                  f"{work[0] / 1e6:.4g} MB, {work[1] / 1e6:.4g} Mflop); the dependent chain "
                  f"{chain} operations, ~{ladder_chain_ms(chain, 1):.4f} ms at a nominal 4 cycles "
                  f"each and {SM_CLOCK_HZ / 1e9:.2f} GHz (a count, not a bound: two tanh and an "
                  f"IEEE division a step on the chain); plain "
                  f"{plain[(str(dtype), label, 'ms')]:.1f} ms (once, in the spawned process); "
                  f"library_ms null (no PyTorch call relaxes the proxy) [{card}]")
    return launches


def gyro_fit_gates(device) -> tuple[float, float]:
    """``tests/test_force_balance_gyroswin.py:107-117``: the RMSE (%) of the
    GyroSwin fit (8000 samples, seed 0) on its data and on 500 held out."""
    import torch
    from scpn_fusion_tpu_torch.models.surrogates import gyro_swin as gs
    x, y = gs.generate_synthetic_dataset(0, 8000)
    model = gs.fit_gyro_swin(x, y, ridge=5e-3, device=device)
    x_t, y_t = gs.generate_synthetic_dataset(99, 500)
    return (gs.rmse_percent(y, model.predict(torch.from_numpy(x).to(device)).cpu().numpy()),
            gs.rmse_percent(y_t, model.predict(torch.from_numpy(x_t).to(device)).cpu().numpy()))


def artifact_checks(dev, card: str, counted, by_path: dict, twin: dict) -> None:
    """(zn) the committed artifacts at their full width on the card: the FNO
    (64^2, width 32, modes 16, 4 layers) on the fresh fields of
    ``tests/test_surrogate_artifacts.py:30-42`` with its gate, within
    :data:`FNO_CARD_TOL` of the CPU port; the transport closure's gate and its
    predictions within 1e-5 of the CPU's (a float32 MLP); the 129^2
    equilibrium surrogate against a fresh 129^2 float32 free-boundary solve
    (rel-L2 < 0.05), kernels 2 and 3 once each an inner Picard iteration,
    counted; lanes 1-2 of ``validation/run_surrogate_latency.py``."""
    import torch
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import (
        coilset_from_config, solve_free_boundary,
    )
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp

    predict, metrics = tp.load_fno_turbulence(device=dev)
    x, y = fresh_fno_fields(int(metrics["grid"]))
    with torch.no_grad():
        (pred, ms), calls, _ = counted(lambda: events_ms(lambda: predict(
            torch.from_numpy(x).to(dev)).cpu().numpy()))
    scale = metrics["y_scale"]
    err = float(np.linalg.norm(pred[..., 0] - y / scale) / np.linalg.norm(y / scale))
    dev_cpu = max_rel(torch.from_numpy(pred), torch.from_numpy(twin["fno"]))
    gate = 2.0 * metrics["test_rel_l2"] + 0.05
    print(f"(zn) committed FNO (grid {metrics['grid']}, width {metrics['width']}, modes "
          f"{metrics['modes']}, {metrics['n_layers']} layers): fresh-field rel-L2 {err:.5f} (gate "
          f"< {gate:.4f}), against the CPU port {dev_cpu:.3e} (limit {FNO_CARD_TOL:.0e}); "
          f"{ms:.2f} ms for 3 fields [{card}]")
    require(metrics["test_rel_l2"] < FNO_GATE and err < gate and dev_cpu <= FNO_CARD_TOL,
            "(zn): the committed FNO misses its gate or deviates from the CPU port")
    transport, t_metrics = tp.load_transport_surrogate(device=dev)
    out = transport(torch.from_numpy(transport_probe()).to(dev)).cpu()
    dev_t = max_rel(out, torch.from_numpy(twin["transport"]))
    print(f"(zn) committed transport closure: test rel-L2 {t_metrics['test_rel_l2']!r} (gate < "
          f"{TRANSPORT_GATE}); its 50 probe predictions against the CPU port {dev_t:.3e} (limit "
          f"{SURROGATE_TOL:.0e}) [{card}]")
    require(t_metrics["test_rel_l2"] < TRANSPORT_GATE and dev_t <= SURROGATE_TOL
            and bool((out >= 0.0).all()), "(zn): the transport closure misses its gate")

    sur, e_metrics = tp.load_equilibrium_artifact(device=dev)
    n = int(e_metrics["grid"])
    cfg = tp.equilibrium_training_config(n)
    coils = coilset_from_config(cfg, torch.float32, dev)
    currents = (coils.currents.cpu().numpy() * np.random.default_rng(555).uniform(0.8, 1.2, 6)
                ).astype(np.float32)
    log = []

    def fresh():
        with inner_iterations(log):
            return solve_free_boundary(
                cfg, coils._replace(currents=torch.from_numpy(currents).to(dev)),
                grid=Grid.from_config(cfg, dtype=torch.float32, device=dev), mu0_green=1.0,
                dtype=torch.float32, device=dev)

    (res, ms), calls, launched = counted(lambda: events_ms(fresh))
    inner = sum(log)
    require(calls["fused_topology_source"] == calls["fused_coarse_vcycle"] == inner > 0
            and all(v == 0 for k, v in calls.items()
                    if k not in ("fused_topology_source", "fused_coarse_vcycle")),
            f"(zn) fresh 129^2 solve: calls {calls} over {inner} inner Picard iterations")
    by_path["equilibrium fresh 129"] = calls
    with torch.no_grad():
        psi = sur.predict(torch.from_numpy(currents).to(dev))
    rel = float(torch.linalg.norm(psi - res.psi) / torch.clamp(torch.linalg.norm(res.psi),
                                                               min=1e-30))
    print(f"(zn) committed equilibrium surrogate ({n}^2) against a fresh {n}^2 float32 "
          f"free-boundary solve ({res.outer_iterations} outer, inner {log}; "
          f"{calls['fused_topology_source']} source and {calls['fused_coarse_vcycle']} V-cycle "
          f"calls, launched {launched}; {ms:.1f} ms): rel-L2 {rel:.5f} (gate < "
          f"{EQUILIBRIUM_GATE}) [{card}]")
    require(res.converged and rel < EQUILIBRIUM_GATE,
            "(zn): the committed equilibrium surrogate misses the fresh-solve gate")

    # lanes 1-2 of run_surrogate_latency.py: the artifact is the 129^2 row, and 200 single
    # CPU predictions beat the reference's mean and P95; the card's per-call time beside them
    lane1 = n == 129 and e_metrics["test_rel_l2"] < 0.02
    sur_cpu, _ = tp.load_equilibrium_artifact(device="cpu")
    x_cpu = sur_cpu.x_mean * 1.07
    x_dev = x_cpu.to(dev)

    def single_calls(run, sync):
        with torch.no_grad():
            run()
            sync()
            times = []
            for _ in range(200):
                t0 = time.perf_counter()
                run()
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
        return float(np.mean(times)), float(np.percentile(times, 95))

    mean_ms, p95_ms = single_calls(lambda: sur_cpu.predict(x_cpu), lambda: None)
    card_mean, card_p95 = single_calls(lambda: sur.predict(x_dev), torch.cuda.synchronize)
    print(f"(zn) run_surrogate_latency lane 1: grid {n}, test rel-L2 {e_metrics['test_rel_l2']!r} "
          f"(gate < 0.02) {lane1}; lane 2: 200 single CPU predictions mean {mean_ms:.4f} ms, P95 "
          f"{p95_ms:.4f} ms (gates < {LATENCY_REF_MS[0]} / {LATENCY_REF_MS[1]}); the card's "
          f"single calls (synchronised) mean {card_mean:.4f} ms, P95 {card_p95:.4f} ms [{card}]")
    require(lane1 and mean_ms < LATENCY_REF_MS[0] and p95_ms < LATENCY_REF_MS[1],
            "(zn): run_surrogate_latency lanes 1-2 fail on the port")


def trainer_checks(dev, card: str, counted, by_path: dict, fno_trainers, equilibrium) -> None:
    """(zn) the trainers at their defaults on the card, each artifact written
    into a temporary directory and loaded back through the port's loader:
    ``train_transport_surrogate()`` (gate < 0.0943) and ``train_qlknn`` (8192
    samples, 3000 steps; held-out relative RMSE < 0.25) in line;
    ``train_fno_turbulence()`` (gate < 0.25, printed against the JAX
    trainer's 0.055) and ``train_fno_multi_regime`` (val rel-L2 < 0.5) in
    ``fno_trainers`` (:func:`slice22_fno_trainers_on_card`'s process); no
    kernel on any; ``train_equilibrium_artifact()`` (65^2, 160 + 20 solves)
    in ``equilibrium`` (:func:`slice22_equilibrium_on_card`'s process):
    held-out rel-L2 < 0.05, kernels 2 and 3 once each an inner Picard
    iteration."""
    import tempfile
    import torch
    from scpn_fusion_tpu_torch.models.surrogates import pretrained as tp
    from scpn_fusion_tpu_torch.models.surrogates import qlknn
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb

    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        out = Path(tmp)
        (m_t, ms_t), calls_t, _ = counted(lambda: events_ms(
            lambda: tp.train_transport_surrogate(out_dir=out, device=dev)))
        predict_t, loaded_t = tp.load_transport_surrogate(weights_dir=out, device=dev)
        probe_t = predict_t(torch.from_numpy(transport_probe()).to(dev))
    print(f"(zn) train_transport_surrogate() on the card: test rel-L2 {m_t['test_rel_l2']!r} "
          f"(gate < {TRANSPORT_GATE}), {ms_t / 1e3:.2f} s; loaded back "
          f"{loaded_t == m_t} [{card}]")
    require(m_t["test_rel_l2"] < TRANSPORT_GATE and loaded_t == m_t
            and bool(torch.isfinite(probe_t).all()), "(zn): the transport trainer misses its gate")

    def qlknn_run():
        model = qlknn.train_qlknn(torch.Generator().manual_seed(1), device=dev)
        x_test = qlknn.generate_parameter_scan(torch.Generator().manual_seed(2), 1024, device=dev)
        y_true, y_pred = qlknn.analytic_targets(x_test), qlknn.predict_fluxes(model, x_test)
        return float(torch.sqrt(((y_pred - y_true) ** 2).mean())
                     / torch.clamp(torch.sqrt((y_true**2).mean()), min=1e-9)), bool(
            (y_pred >= 0.0).all())

    ((q_err, q_pos), ms_q), calls_q, _ = counted(lambda: events_ms(qlknn_run))
    print(f"(zn) train_qlknn (8192, 3000 steps) on the card: held-out relative RMSE {q_err:.5f} "
          f"(gate < {QLKNN_GATE}), {ms_q / 1e3:.2f} s [{card}]")
    require(q_err < QLKNN_GATE and q_pos, "(zn): the QLKNN trainer misses its gate")
    fno = fno_trainers()
    m_f, multi = fno["fno"]["metrics"], fno["multi"]
    print(f"(zn) train_fno_turbulence() on the card (in a spawned process): test rel-L2 "
          f"{m_f['test_rel_l2']!r} (gate < {FNO_GATE}; the JAX trainer's docstring "
          f"{FNO_REFERENCE}), {fno['fno']['ms'] / 1e3:.2f} s; loaded back "
          f"{fno['fno']['loaded'] == m_f}; train_fno_multi_regime (defaults, seed 3): val rel-L2 "
          f"{multi['val']:.5f} (gate < {MULTI_REGIME_GATE}), {multi['ms'] / 1e3:.2f} s [{card}]")
    require(m_f["test_rel_l2"] < FNO_GATE and fno["fno"]["loaded"] == m_f and fno["fno"]["finite"],
            "(zn): the FNO trainer misses its gate")
    require(multi["val"] < MULTI_REGIME_GATE and multi["n"] == 256,
            "(zn): the multi-regime trainer misses its gate")
    for label, calls in (("train_transport_surrogate", calls_t),
                         ("train_fno_turbulence", fno["fno"]["calls"]), ("train_qlknn", calls_q),
                         ("train_fno_multi_regime", multi["calls"])):
        calls = {name: calls.get(name, 0) for name in KERNELS}
        require(all(v == 0 for v in calls.values()), f"(zn) {label}: kernel calls {calls}")
        by_path[label] = calls

    eq = equilibrium()
    inner = sum(eq["inner"])
    calls = {name: eq["calls"].get(name, 0) for name in KERNELS}
    print(f"(zn) train_equilibrium_artifact() on the card (65^2, 160 + 20 float32 solves, "
          f"{inner} inner Picard iterations; in a spawned process): held-out rel-L2 "
          f"{eq['metrics']['test_rel_l2']!r} (gate < {EQUILIBRIUM_GATE}; the committed 129^2 "
          f"artifact {EQUILIBRIUM_COMMITTED}); {calls['fused_topology_source']} source and "
          f"{calls['fused_coarse_vcycle']} V-cycle calls, launched {eq['launched']}; "
          f"{eq['seconds']:.1f} s; loaded back {eq['loaded'] == eq['metrics']} [{card}]")
    require(calls["fused_topology_source"] == calls["fused_coarse_vcycle"] == inner > 0
            and all(v == 0 for k, v in calls.items()
                    if k not in ("fused_topology_source", "fused_coarse_vcycle"))
            and eq["launched"] == {"scpn_fused_source": inner, "scpn_fused_vcycle": inner},
            f"(zn) equilibrium trainer: calls {calls} over {inner} inner Picard iterations")
    require(eq["metrics"]["test_rel_l2"] < EQUILIBRIUM_GATE and eq["loaded"] == eq["metrics"]
            and eq["psi_finite"], "(zn): the equilibrium trainer misses its gate")
    by_path["train_equilibrium_artifact"] = calls


def loop_checks(dev, card: str, counted, by_path: dict, twin: dict) -> None:
    """(zn) the closed loops on the card: lane 3 of
    ``validation/run_pulsed_suppression.py`` (controlled against free over 200
    steps, ratio < 0.5, the replay exactly equal), the gain's gradient by
    autograd negative (``tests/test_turbulence_suppressor.py:71-79``), the ESN
    sine horizon > 50 on the JAX test's draw, the drift-wave oracle (32^2, 16
    probes, reservoir 300: a finite horizon, one-step relative error < 0.5);
    no kernel; :func:`zn_lanes` in float64 within 1e-9 of the CPU (``twin``:
    :func:`slice22_on_cpu`'s), no kernel."""
    import torch
    from scpn_fusion_tpu_torch.models.physics import drift_wave as dw
    from scpn_fusion_tpu_torch.models.surrogates import esn
    from scpn_fusion_tpu_torch.models.surrogates import turbulence_suppressor as ts

    def lane3():
        ctrl = ts.run_suppression_loop(seed=42, n_steps=200, control_on_step=50, device=dev)
        free = ts.run_suppression_loop(seed=42, n_steps=200, control_on_step=10_000, device=dev)
        again = ts.run_suppression_loop(seed=42, n_steps=200, control_on_step=50, device=dev)
        gain = torch.tensor(1.6, device=dev, requires_grad=True)
        late = ts.run_suppression_loop(seed=3, n_steps=80, control_on_step=20, gain=gain,
                                       device=dev).mean_energy_last20
        (grad,) = torch.autograd.grad(late, gain)
        return (float(ctrl.mean_energy_last20), float(free.mean_energy_last20),
                torch.equal(again.mean_energy_last20, ctrl.mean_energy_last20),
                float(ctrl.suppression.max()), float(grad))

    ((e_ctrl, e_free, replay, peak, grad), ms), calls, _ = counted(lambda: events_ms(lane3))
    by_path["suppression loops"] = calls
    print(f"(zn) run_pulsed_suppression lane 3 on the card (f32): controlled "
          f"{e_ctrl!r} / free {e_free!r} = {e_ctrl / e_free:.4f} (gate < 0.5), replay equal "
          f"{replay}, peak command {peak:.4f}; d late energy / d gain {grad!r} (< 0); {ms:.1f} ms "
          f"[{card}]")
    require(e_ctrl < 0.5 * e_free and replay and peak > 0.1 and np.isfinite(grad) and grad < 0.0,
            "(zn): the suppression loop misses lane 3's or the gradient's gate")

    def oracles():
        params = esn_sine_params(dev)
        u = sine_inputs(dev)
        readout, x_last = esn.fit_esn(params, u[:600], u[1:601], reg=1e-2)
        preds = esn.predict_closed_loop(params, readout, x_last, u[600], steps=100)
        sine_h, _ = esn.trust_horizon(u[601:701].float(), preds)
        cfg = dw.DriftWaveConfig(n=32)
        s = dw.initial_state(torch.Generator().manual_seed(7), cfg, device=dev)
        _, data = dw.simulate_probes(s, cfg, dw.default_probe_indices(cfg.n, 16, device=dev),
                                     warmup=200, steps=500)
        p = esn.init_esn(torch.Generator().manual_seed(8), 16, reservoir_size=300, device=dev)
        r, x = esn.fit_esn(p, data[:400], data[1:401])
        horizon, mse = esn.trust_horizon(
            data[401:481], esn.predict_closed_loop(p, r, x, data[400], steps=80))
        one = esn.harvest_states(p, data[:400]) @ r.w_out.T
        err = float(torch.linalg.norm(one - data[1:401]) / torch.linalg.norm(data[1:401]))
        return int(sine_h), int(horizon), bool(torch.isfinite(mse).all()), err

    ((sine_h, horizon, finite, err), ms), calls, _ = counted(lambda: events_ms(oracles))
    by_path["esn oracles"] = calls
    print(f"(zn) ESN on the card (f32): sine horizon {sine_h} of 100 (gate > 50; the JAX test's "
          f"reservoir draw); drift-wave oracle horizon {horizon} of 80, MSE finite {finite}, "
          f"one-step relative error {err:.4f} (gate < 0.5); {ms:.1f} ms [{card}]")
    require(sine_h > 50 and 0 <= horizon <= 80 and finite and err < 0.5,
            "(zn): an ESN oracle misses the JAX tests' gates")
    for label, c in (("suppression loops", by_path["suppression loops"]),
                     ("esn oracles", calls)):
        require(all(v == 0 for v in c.values()), f"(zn) {label}: kernel calls {c}")

    (r, ms), calls, _ = counted(lambda: events_ms(lambda: zn_lanes(dev)))
    require(all(not c for c in r["counts"].values()) and all(v == 0 for v in calls.values()),
            f"(zn) lane kernel calls {r['counts']}: none expected")
    by_path["zn_lanes"] = calls
    num = r["num"]
    print(f"(zn) f64 lanes on the card: heat-shadow weights[0] "
          f"{float(num['heat shadow weights'][0])!r}, suppression mean energy (last 20) "
          f"{float(num['suppression mean_energy_last20'])!r}, gain gradient "
          f"{float(num['suppression gain gradient'])!r}; {ms:.1f} ms [{card}]")
    agree(num, twin["zn"]["num"], "(zn) lanes", card)


# ── the twenty-third slice: (zo) the batched equilibrium ensembles through the
# batched kernels 2 and 3, (zp) the Z-slab and 2D-tile sharded solves on one
# card's virtual shards (parallel/) ──

ENSEMBLE_SHAPES = (33, 129, 257)          # the batched kernels' check levels
ENSEMBLE_CHECK_BATCHES = (1, 16, 256)
ENSEMBLE_TIMED = (129, 16)                # the kernels line's shape: 129^2, B = 16
PARITY_GATE = 5e-3          # run_batched_amortisation.py lane 1 (the fixed-point scale, f32)
MIXED_PARITY_GATE = 1e-5    # lane 4: element parity of the mixed batch


def card_mesh(device, n: int, axes=("z",), sizes=None):
    """``n`` virtual shards of one device: the sharded programs' arithmetic
    and launch structure on one card (no interconnect)."""
    from scpn_fusion_tpu_torch.parallel.mesh import Mesh
    return Mesh.of([device] * n, axes, sizes)


def ensemble_case(key, dtype, device):
    """The validation's currents and targets for ``key`` of
    ``bench_config.amortisation_draws``, as tensors."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import amortisation_draws
    cur, tgt = amortisation_draws()[key]
    return (torch.from_numpy(cur).to(dtype=dtype, device=device),
            torch.from_numpy(tgt).to(dtype=dtype, device=device))


def mixed_batch(device, key=("mixed", 16)):
    """Lane 4's batched mixed solve of the ``key`` draws on ``device``: (psi,
    converged, iterations, gs_residual_best)."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import amortisation_config
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch_mixed
    cfg = amortisation_config(129)
    grid = Grid.from_config(cfg, dtype=torch.float64, device=device)
    cur, tgt = ensemble_case(key, torch.float64, device)
    return solve_equilibrium_batch_mixed(cfg, grid, cur, tgt)


def ensemble_mixed_on_cpu(conn) -> None:
    """(zo)'s CPU twin: lane 4's B = 16 mixed batch on the CPU (plain ops)."""
    dev = on_cpu(4)
    t0 = time.perf_counter()
    out = mixed_batch(dev)
    conn.send({"psi": out.psi.numpy(), "converged": out.converged.numpy(),
               "iterations": out.iterations.numpy(), "s": time.perf_counter() - t0})
    conn.close()


def ensemble_work(n: int, b: int, kind: str) -> tuple[float, float]:
    """B times the unbatched call's bytes and flops at n x n."""
    if kind == "source":
        return b * 4.0 * (3 * n * n + n), b * 28.0 * n * n
    nbytes, flops = vcycle_work(n, 3, 3, 5, 50)
    return b * nbytes, b * flops


def batched_kernel_checks(dev, card: str, results: dict, timing: dict,
                          measured_plain: dict) -> None:
    """(zo) the batched kernels 2 and 3 against their unbatched launches
    element by element (``torch.equal``) at 33^2, 129^2 and 257^2 with B = 1,
    16 and 256, the last element a straggler (another amplitude and, for the
    source, its own target current); against their plain twins at 129^2, B =
    16 (the plain twins timed once there, a loop of B plain calls); the
    clusters the device holds; the times at B = 16 / 64 / 256 beside B
    unbatched launches."""
    import torch
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_source

    rng = np.random.default_rng(SEED + 23)
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=torch.float32, device=dev).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=torch.float32, device=dev).unbind())
    for n in ENSEMBLE_SHAPES:
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        mask = (g.ZZ < g.Z_min * 0.5).to(torch.float32).contiguous()
        vc_kw = dict(pre_smooth=3, post_smooth=3, min_grid=5, coarse_sweeps=50)
        plan = cuda_mg.vcycle_plan_struct(n, 5, float(g.dR), float(g.dZ), 1.0, 3, 3, 50)
        clusters = cb.library().scpn_fused_vcycle_clusters(ctypes.addressof(plan))
        require(clusters >= 1, f"(zo) no cluster of the {n}^2 V-cycle fits the device")
        for b in ENSEMBLE_CHECK_BATCHES:
            amp = torch.ones(b, 1, 1, device=dev)
            amp[-1] = 1e3      # the straggler element
            psi = torch.tensor(rng.standard_normal((b, n, n)), dtype=torch.float32,
                               device=dev) * amp
            src = torch.tensor(rng.standard_normal((b, n, n)), dtype=torch.float32,
                               device=dev) * amp
            i_t = torch.full((b,), 15.0, device=dev)
            i_t[-1] = 2.0
            params = cuda_source.pack_source_params_batched(p_c, ff_c, i_t, like=psi)
            cb.reset_launch_counts()
            out_v = cuda_mg.fused_coarse_vcycle_batched(psi, src, g.R, g.dR, g.dZ, 1.0, **vc_kw)
            launched_v = dict(cb.LAUNCHES)
            cb.reset_launch_counts()
            out_s, sc = cuda_source.fused_topology_source_batched(
                psi, g.R, mask, params, d_r=g.dR, d_z=g.dZ, mu0=1.0, h_mode=b == 16,
                with_scalars=True)
            launched_s = dict(cb.LAUNCHES)
            require(launched_v == {"scpn_fused_vcycle_batched": 1}
                    and launched_s == {"scpn_fused_source_batched": 3},
                    f"(zo) batched launches at {n}^2 B={b}: {launched_v}, {launched_s}")
            equal_v = equal_s = sites = True
            for e in range(b):
                ref_v = cuda_mg.fused_coarse_vcycle(psi[e], src[e], g.R, g.dR, g.dZ, 1.0, **vc_kw)
                ref_s, ref_sc = cuda_source.fused_topology_source(
                    psi[e], g.R, mask, p_c, ff_c, i_t[e], d_r=g.dR, d_z=g.dZ, mu0=1.0,
                    h_mode=b == 16, with_scalars=True)
                equal_v &= torch.equal(out_v[e], ref_v)
                equal_s &= torch.equal(out_s[e], ref_s)
                sites &= int(sc.x_index[e]) == int(ref_sc.x_index)
            torch.cuda.synchronize()
            print(f"(zo) batched kernels at {n}^2, B = {b} ({'H' if b == 16 else 'L'}-mode "
                  f"source, the last element x1e3 with I_target 2): V-cycle one launch of {b} "
                  f"cluster(s) of {plan.n_cta} CTA(s), the device holds {clusters} at once "
                  f"({-(-b // clusters)} wave(s)), torch.equal to the unbatched launches "
                  f"{equal_v}; source three launches, torch.equal {equal_s}, X-point sites "
                  f"equal {sites}")
            require(equal_v and equal_s and sites,
                    f"(zo) a batched kernel differs from its unbatched launch at {n}^2 B={b}")

    n, b = ENSEMBLE_TIMED
    g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
    mask = (g.ZZ < g.Z_min * 0.5).to(torch.float32).contiguous()
    cases = {}
    for bb in (16, 64, 256):
        psi = torch.tensor(rng.standard_normal((bb, n, n)), dtype=torch.float32, device=dev)
        src = torch.tensor(rng.standard_normal((bb, n, n)), dtype=torch.float32, device=dev)
        i_t = torch.tensor(14.0 + rng.random(bb), dtype=torch.float32, device=dev)
        cases[bb] = (psi, src, cuda_source.pack_source_params_batched(p_c, ff_c, i_t, like=psi))
    psi, src, params = cases[b]
    vc = functools.partial(cuda_mg.fused_coarse_vcycle_batched, psi, src, g.R, g.dR, g.dZ, 1.0)
    vc_plain = functools.partial(cuda_mg.fused_coarse_vcycle_batched_plain, psi, src, g.R,
                                 g.dR, g.dZ, 1.0)
    skw = dict(d_r=g.dR, d_z=g.dZ, mu0=1.0, h_mode=False)
    so = functools.partial(cuda_source.fused_topology_source_batched, psi, g.R, mask, params,
                           **skw)
    so_plain = functools.partial(cuda_source.fused_topology_source_batched_plain, psi, g.R,
                                 mask, params, **skw)
    for name, fk, fp in (("fused_coarse_vcycle_batched", vc, vc_plain),
                         ("fused_topology_source_batched", so, so_plain)):
        out_k = fk()
        out_p, measured_plain[name] = events_ms(fp)
        err = span_rel(out_k, out_p)
        print(f"check {name} {n}^2 B={b}: span-rel {err:.3e} of its plain twin (limit "
              f"{SPAN_TOL:.0e})")
        require(err <= SPAN_TOL, f"(zo) {name} differs from its plain twin: {err:.3e}")
        results[name] = {"max_abs_err": float((out_k - out_p).abs().max())}
    timing["fused_coarse_vcycle_batched"] = (vc, vc_plain, f"{n}^2 B={b} (3,3)",
                                             ensemble_work(n, b, "vcycle"))
    timing["fused_topology_source_batched"] = (so, so_plain, f"{n}^2 B={b} L-mode",
                                               ensemble_work(n, b, "source"))
    for bb, (psi, src, params) in cases.items():
        def one_by_one(psi=psi, src=src):
            for e in range(psi.shape[0]):
                cuda_mg.fused_coarse_vcycle(psi[e], src[e], g.R, g.dR, g.dZ, 1.0)

        def src_one_by_one(psi=psi, params=params):
            for e in range(psi.shape[0]):
                cuda_source.fused_topology_source(psi[e], g.R, mask, p_c, ff_c,
                                                  params.i_targets[e], **skw)

        t_v, t_v1 = cuda_ms_pair(functools.partial(cuda_mg.fused_coarse_vcycle_batched, psi,
                                                   src, g.R, g.dR, g.dZ, 1.0), one_by_one)
        t_s, t_s1 = cuda_ms_pair(functools.partial(cuda_source.fused_topology_source_batched,
                                                   psi, g.R, mask, params, **skw),
                                 src_one_by_one)
        bv, _ = bound(ensemble_work(n, bb, "vcycle"))
        bs, _ = bound(ensemble_work(n, bb, "source"))
        print(f"time (zo) batched kernel 3 at {n}^2 (3,3), B = {bb}: {t_v:.4f} ms a launch, "
              f"{bb} unbatched launches {t_v1:.4f} ms (in turns), bound {bv:.4g} ms (bytes); "
              f"batched kernel 2 {t_s:.4f} ms (three launches), {bb} unbatched {t_s1:.4f} ms, "
              f"bound {bs:.4g} ms (bytes) [{card}]")


def host_ms(run) -> tuple:
    """(result, wall ms) of ``run()`` on the host clock, ending in a
    synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def ensemble_checks(dev, card: str, counted, by_path: dict, mixed_cpu) -> dict:
    """(zo) the straggler freeze in float32 against standalone solves at the
    fixed-point scale; the 16-batch over a 4-shard mesh of the one card
    against the whole batch; the mixed B = 16 batch against its CPU twin
    (``mixed_cpu``).  Returns the batched kernels' counted calls, by kernel
    (:func:`batched_campaign` runs the ``batched_amortisation`` campaign
    once the card is otherwise idle)."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import amortisation_config
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch

    f32 = torch.float32
    cfg = amortisation_config(129)
    grid = Grid.from_config(cfg, dtype=f32, device=dev)
    batched = ("fused_topology_source_batched", "fused_coarse_vcycle_batched")

    def solve(key, sl=slice(None), mesh=None):
        cur, tgt = ensemble_case(key, f32, dev)
        return solve_equilibrium_batch(cfg, grid, cur[sl], tgt[sl], mesh=mesh)

    def batched_only(calls, tag, iterations):
        require(calls["fused_topology_source_batched"] == calls["fused_coarse_vcycle_batched"]
                == iterations > 0 and all(v == 0 for k, v in calls.items() if k not in batched),
                f"(zo) {tag}: kernel calls {calls}, expected one of each batched kernel an "
                f"iteration ({iterations})")

    total = dict.fromkeys(batched, 0)

    def add(calls):
        for name in batched:
            total[name] += calls[name]

    # the straggler freeze: [base, base] at I_target 15 and 2
    base = torch.tensor([c.current for c in cfg.coils], dtype=f32, device=dev)
    cur, tgt = torch.stack([base, base]), torch.tensor([15.0, 2.0], dtype=f32, device=dev)
    (out, calls, _) = counted(lambda: solve_equilibrium_batch(cfg, grid, cur, tgt))
    batched_only(calls, "straggler", int(out.iterations.max()))
    add(calls)
    by_path["ensemble straggler"] = calls
    its = out.iterations.tolist()
    require(bool(out.converged.all()) and its[0] != its[1],
            f"(zo) straggler: converged {out.converged.tolist()}, iterations {its}")
    for e in range(2):
        alone = solve_equilibrium_batch(cfg, grid, cur[e:e + 1], tgt[e:e + 1])
        d = span_rel(out.psi[e], alone.psi[0])
        print(f"(zo) straggler freeze f32: element {e} (I_target {float(tgt[e])}) "
              f"{its[e]} iterations in the batch, {int(alone.iterations[0])} alone, span-rel "
              f"{d:.3e} (gate {PARITY_GATE}), torch.equal {torch.equal(out.psi[e], alone.psi[0])}"
              f" [{card}]")
        require(d < PARITY_GATE, "(zo) a frozen element drifted from its standalone solve")

    # the 16-batch over a 4-shard mesh on the one card: four chunks stepped in lockstep
    from scpn_fusion_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh.of((dev,) * 4, "batch")
    whole, ms_whole = host_ms(lambda: solve("parity"))
    (sharded, calls, _), ms_mesh = host_ms(lambda: counted(lambda: solve("parity", mesh=mesh)))
    require(calls["fused_topology_source_batched"] == calls["fused_coarse_vcycle_batched"] > 0
            and all(v == 0 for k, v in calls.items() if k not in batched),
            f"(zo) mesh: kernel calls {calls}")
    add(calls)
    by_path["ensemble mesh 4 B=16"] = calls
    worst = max(span_rel(sharded.psi[e], whole.psi[e]) for e in range(16))
    print(f"(zo) the 16-batch over Mesh((cuda:0,) * 4), chunks in lockstep: worst element span-rel "
          f"{worst:.3e} of the whole batch (gate {PARITY_GATE}), iterations equal "
          f"{torch.equal(sharded.iterations, whole.iterations)}, {calls['fused_coarse_vcycle_batched']}"
          f" batched V-cycle launches for {int(sharded.iterations.max())} iterations; "
          f"{ms_mesh:.3f} ms against {ms_whole:.3f} ms for the whole batch (one card, host clock) "
          f"[{card}]")
    require(bool(sharded.converged.all()) and worst < PARITY_GATE,
            "(zo) the batch over a mesh differs from the whole batch")

    # the mixed B = 16 batch, its f32 V-cycles through the batched kernel 3,
    # against its CPU twin (plain f32 V-cycles)
    res16, calls, _ = counted(lambda: mixed_batch(dev))
    require(calls["fused_coarse_vcycle_batched"] > 0
            and all(v == 0 for k, v in calls.items() if k != "fused_coarse_vcycle_batched"),
            f"(zo) mixed B = 16: kernel calls {calls}")
    add(calls)
    by_path["ensemble mixed B=16"] = calls
    twin = mixed_cpu()
    ref = torch.from_numpy(twin["psi"])
    worst = max(span_rel(res16.psi[e].cpu(), ref[e]) for e in range(16))
    print(f"(zo) mixed B = 16 against the CPU twin (plain f32 V-cycles, {twin['s']:.1f} s): worst "
          f"element span-rel {worst:.3e} (gate {MIXED_PARITY_GATE}); iterations card "
          f"{res16.iterations.tolist()}, CPU {twin['iterations'].tolist()}; converged "
          f"{bool(twin['converged'].all())} [{card}]")
    require(worst < MIXED_PARITY_GATE and bool(twin["converged"].all())
            and bool(res16.converged.all()), "(zo) the mixed batch differs from its CPU twin")
    return total


def batched_campaign(dev, card: str, counted, by_path: dict) -> dict:
    """(zo) the ``batched_amortisation`` campaign on the card (lanes 1-4: the
    f32 batches through the batched kernels 2 and 3, the mixed batches'
    V-cycles through the batched kernel 3, lane 3's cold call in a fresh
    process), its status the committed report's.  Returns the batched
    kernels' counted calls, by kernel."""
    from scpn_fusion_tpu_torch.validation import REPORTS_DIR, run_batched_amortisation
    batched = ("fused_topology_source_batched", "fused_coarse_vcycle_batched")
    (rc, ms), calls, launched = counted(lambda: host_ms(
        lambda: run_batched_amortisation.main(device=dev)))
    campaign_check("batched_amortisation", rc, card, "(zo)")
    lanes = {lane["name"]: lane["metrics"] for lane in json.loads(
        (REPORTS_DIR / "batched_amortisation.json").read_text())["lanes"]}
    require(calls["fused_topology_source_batched"] > 0
            and calls["fused_coarse_vcycle_batched"] > calls["fused_topology_source_batched"]
            and all(v == 0 for k, v in calls.items() if k not in batched),
            f"(zo) batched_amortisation: kernel calls {calls}, expected the batched kernels "
            f"only (more 3b, the mixed lane's)")
    by_path["batched_amortisation"] = calls
    print(f"(zo) batched_amortisation (129^2): {ms / 1e3:.1f} s; lane 1 "
          f"{lanes['batched_element_parity']}; "
          f"lane 2 {lanes['batched_amortisation']}; lane 3 (cold: the first B = 256 call of a "
          f"fresh process) {lanes['warm_cold_compile']}; lane 4 "
          f"{lanes['batched_mixed_amortisation']}; batched kernel calls {calls}, launches "
          f"{launched} [{card}]")
    return {name: calls[name] for name in batched}


def sharded_on_card(conn, card: str) -> None:
    """(zp) in a spawned process: the ``sharded_gs`` campaign on
    ``Mesh((cuda:0,) * n)``, f64, no kernel, its status the committed
    report's; sends its seconds and kernel launches."""
    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.validation import REPORTS_DIR, run_sharded_gs
    t0 = time.perf_counter()
    cb.reset_launch_counts()
    rc = run_sharded_gs.main(device=torch.device("cuda"))
    torch.cuda.synchronize()
    launches = sum(cb.LAUNCHES.values())
    campaign_check("sharded_gs", rc, card, "(zp)")
    lanes = json.loads((REPORTS_DIR / "sharded_gs.json").read_text())["lanes"]
    for lane in lanes:
        print(f"(zp) sharded_gs / {lane['name']}: {lane['status']} {lane['metrics']} [{card}]")
    sys.stdout.flush()
    conn.send({"s": time.perf_counter() - t0, "launches": launches})
    conn.close()


def sharded_checks(card: str, twin) -> None:
    """(zp): the sharded_gs campaign's seconds from :func:`sharded_on_card`;
    no kernel may launch on it."""
    r = twin()
    print(f"(zp) the sharded_gs campaign on Mesh((cuda:0,) * n) (virtual shards of one card: the "
          f"exchanges' arithmetic and the launch structure, no interconnect), f64, in a "
          f"spawned process: {r['s']:.1f} s, {r['launches']} kernel launches [{card}]")
    require(r["launches"] == 0, f"(zp): {r['launches']} kernel launches on the sharded lanes")


# ── the twenty-fourth slice: (zq) parallel/gk_shard on one card's virtual
# shards, (zr) the carried-over host lanes ──
GK_SHARD_MESH = (2, 2, 2)      # run_sharded_convergence.py lane 7: (sx, sy, v)
GK_SHARD_STATE_GATE = 1e-12    # lane 7 (:356-368): the state, of max |f|
GK_SHARD_TRACE_GATE = 1e-9     # lane 7: each trace field, of its max |value|
GK_SHARD_TEST_GATE = 1e-10     # tests/test_gk_spatial_shard.py: f of max |f| (the other meshes)
GK_INVARIANCE_GATE = 1e-5      # run_gk_scenario.py lane 1: phi_rms, relative
GK_SCENARIO_1 = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=8, n_mu=8, n_steps=10, save_interval=5,
                     dtype="complex64")                   # run_gk_scenario.py:62-64, seed 7
GK_SHARD_SMALL = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=6, n_mu=8, n_steps=6, save_interval=3,
                      nonlinear=True, collisions=True, dtype="complex128")   # the JAX test's
GK_ENSEMBLE_SEEDS = (3, 11, 17, 29)
GK_SHARD_TIMED_STEPS = 5


def trace_dev(mono, sharded) -> float:
    """run_sharded_convergence.py lane 7's trace deviation: the largest of
    max |a - b| / max |a| over the trace fields but the times."""
    return max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-300)
               for a, b in zip(mono[1:], sharded[1:]))


def phi_tiles(phi, shape):
    """Monolithic phi as each shard of an (sx, sy, v) mesh holds it."""
    return [t.contiguous() for xb in phi.chunk(shape[0], 0) for yb in xb.chunk(shape[1], 1)
            for t in [yb] * shape[2]]


def gk_shard_checks(dev, card: str, counted, by_path: dict, lane7: dict) -> tuple:
    """(zq) ``parallel/gk_shard`` on :func:`card_mesh`'s virtual shards of the
    card (the collectives' arithmetic and the launch structure, not an
    interconnect): the pencil bracket on lane 7's initial state; lane 7 of
    the ``sharded_convergence`` campaign (``lane7``: the campaign's
    ``gk_runs``, and the campaign's kernel calls: row G on every shard, exactly
    8 x 4 x 50, and 4 x 50 for its monolithic run); the ms of a sharded and a
    monolithic step; ``run_gk_scenario.py`` lanes 1 and 3 (lane 2 is (u)'s
    linear ITG lane); the (sy, v) = (2, 4) mesh and the (data, v) = (2, 4)
    ensemble of 4 members, f64 at the JAX test's size, against their
    monolithic runs.  Returns (row G's launches on lane 7, lane 7's final
    state as a GKState, the lanes' LaneResults)."""
    import torch
    from scpn_fusion_tpu_torch.bench_config import GK_SPEC_32, GK_SPEC_32_SEED
    from scpn_fusion_tpu_torch.control.scenario import FluxBudget, standard_shot_schedule
    from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as nl
    from scpn_fusion_tpu_torch.models.physics.integrated_scenario import run_shot
    from scpn_fusion_tpu_torch.parallel import gk_shard as gs
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult
    from scpn_fusion_tpu_torch.validation import REPORTS_DIR

    lanes = []
    cfg = nl.NonlinearGKConfig(**GK_SPEC_32)
    mesh = card_mesh(dev, 8, ("sx", "sy", "v"), GK_SHARD_MESH)
    # before any drift is looked for: the pencil bracket on lane 7's initial state
    g = nl.build_grids(cfg, device=dev)
    st0 = nl.init_state(cfg, g, seed=GK_SPEC_32_SEED)
    layout = gs._Layout.of(mesh)
    run = gs._ShardedRun(cfg, g, layout)
    phi0 = nl.field_solve(cfg, g, st0.f)
    act = [f[:1] for f in gs._shard_f(st0.f, layout)]
    bracket = gs.ShardedGKState(tuple(run.bracket(phi_tiles(phi0, GK_SHARD_MESH), act)),
                                st0.time, layout).f
    ref_bracket = nl.exb_bracket(g, phi0, st0.f[:1])
    br_equal, br_dev = torch.equal(bracket, ref_bracket), max_rel(bracket, ref_bracket)
    del run, bracket, ref_bracket, act

    fin, tr = lane7["sharded"]
    mono, tr_mono = lane7["mono"]
    f_mono = mono.f
    calls, launched = lane7["calls"], lane7["launched"]
    lane = next(ln for ln in json.loads((REPORTS_DIR / "sharded_convergence.json").read_text())[
        "lanes"] if ln["name"] == "gk_shard_memory")
    n_launch = (8 + 1) * 4 * cfg.n_steps     # the 8 shards' run and the monolithic one
    print(f"(zq) lane 7 gk_shard_memory (run_sharded_convergence.py:323-383) on "
          f"Mesh((cuda:0,) * 8, (sx, sy, v) = {GK_SHARD_MESH}), virtual shards of one card (the "
          f"collectives' arithmetic and the launch structure, no interconnect): 2x32x32x16x16x8 "
          f"c128, 50 steps, sharded and monolithic: {lane['status']} {lane['metrics']}; the "
          f"campaign {lane7['ms'] / 1e3:.1f} s (CUDA events), row G launches {launched} (want "
          f"{n_launch}: one a shard a stage, and the monolithic run's); peak memory "
          f"{lane7['peak']:.1f} MiB; pencil bracket on the initial state torch.equal to "
          f"exb_bracket: {br_equal} ({br_dev:.3e}) [{card}]")
    require(br_dev <= GK_SHARD_STATE_GATE, "(zq): the pencil bracket differs from exb_bracket")
    require(calls == {name: n_launch * (name == "gk_rhs") for name in KERNELS}
            and launched == {"scpn_gk_stage_c128": n_launch},
            f"(zq) sharded_convergence: {calls} / {launched}, not one row-G launch a shard a "
            f"stage")
    by_path["sharded_convergence"] = calls

    # ms a step: the sharded step and the monolithic one, in turns
    spec, gram_inv = nl.stage_spec(cfg, g), nl._gram_inv(cfg, g, f_mono.dtype)
    run = gs._ShardedRun(cfg, g, fin.layout)
    mono0 = nl.GKState(f_mono, fin.time)

    def steps_sharded():
        fs, t = list(fin.shards), fin.time
        for _ in range(GK_SHARD_TIMED_STEPS):
            fs, t = run.step(fs, t)

    def steps_mono():
        st = mono0
        for _ in range(GK_SHARD_TIMED_STEPS):
            st = nl._rk4_step(cfg, g, spec, st, gram_inv)

    t_s, t_m = cuda_ms_pair(steps_sharded, steps_mono, reps=3)
    print(f"time (zq) lane 7 a step: 8 shards {t_s / GK_SHARD_TIMED_STEPS:.4f} ms, monolithic "
          f"{t_m / GK_SHARD_TIMED_STEPS:.4f} ms (CUDA events around {GK_SHARD_TIMED_STEPS} "
          f"steps, median of 3, in turns) [{card}]")
    final7 = nl.GKState(fin.f, fin.time)
    del run, fin

    # run_gk_scenario.py lane 1: the 8-shard velocity mesh, c64
    cfg1 = nl.NonlinearGKConfig(**GK_SCENARIO_1)
    (_, t_ref), _, _ = counted(lambda: nl.run_nonlinear_gk(cfg1, seed=7, device=dev))
    (_, t_sh), calls1, launched1 = counted(
        lambda: gs.run_nonlinear_gk_sharded(cfg1, card_mesh(dev, 8, ("v",)), seed=7))
    dev1 = float((t_sh.phi_rms - t_ref.phi_rms).abs().max()) \
        / max(float(t_ref.phi_rms.abs().max()), 1e-30)
    n1 = 8 * 4 * cfg1.n_steps
    print(f"(zq) run_gk_scenario.py lane 1 gk_shard_invariance: 8x8x8x8x8 c64, 10 steps, seed 7 "
          f"on Mesh((cuda:0,) * 8, v): phi_rms relative deviation {dev1:.3e} (gate "
          f"{GK_INVARIANCE_GATE}); row G launches {launched1} (want {n1}) [{card}]")
    require(calls1["gk_rhs"] == n1 and launched1 == {"scpn_gk_stage_c64": n1},
            f"(zq) lane 1: {launched1}")
    lanes.append(LaneResult(
        name="gk_shard_invariance", status="pass" if dev1 < GK_INVARIANCE_GATE else "fail",
        metrics={"rel_deviation": dev1, "n_devices": 8},
        thresholds={"rel_deviation_max": GK_INVARIANCE_GATE},
        notes="velocity-space sharding vs single device, virtual shards of one card"))
    by_path["gk_scenario_lane1"] = calls1
    print("(zq) run_gk_scenario.py lane 2 gk_linear_growth: (u)'s linear ITG lane, above")

    # run_gk_scenario.py lane 3: the ITER-like shot with the lane's own schedule
    sched = standard_shot_schedule(ip_flat_ma=15.0, ramp_s=60.0, flattop_s=300.0,
                                   ne_flat_19=10.0, p_aux_flat_mw=50.0)
    (_, report), calls3, _ = counted(lambda: run_shot(
        sched, FluxBudget(phi_cs_vs=280.0, l_plasma_uh=7.0, r0_m=6.2), device=dev))
    ok3 = (bool(report.reached_burn) and not bool(report.flux_exhausted)
           and not bool(report.greenwald_violated))
    print(f"(zq) run_gk_scenario.py lane 3 iter_shot_q: q_flattop {float(report.q_flattop)!r}, "
          f"P_fus peak {float(report.p_fusion_peak_mw)!r} MW, H-mode "
          f"{float(report.h_mode_duration_s)!r} s; burn reached {bool(report.reached_burn)}, "
          f"flux exhausted {bool(report.flux_exhausted)}, Greenwald violated "
          f"{bool(report.greenwald_violated)} [{card}]")
    require(sum(calls3.values()) == 0, f"(zq) lane 3 launched {calls3}")
    lanes.append(LaneResult(
        name="iter_shot_q", status="pass" if ok3 else "fail",
        metrics={"q_flattop": float(report.q_flattop),
                 "p_fusion_peak_mw": float(report.p_fusion_peak_mw),
                 "h_mode_duration_s": float(report.h_mode_duration_s)},
        thresholds={"q_flattop_min": 5.0},
        notes="staged density H-mode access, Ejima flux budget"))

    # the other mesh kinds, f64 at the JAX test's size, against their monolithic runs
    small = nl.NonlinearGKConfig(**GK_SHARD_SMALL)
    mono_s, tr_s = nl.run_nonlinear_gk(small, seed=5, device=dev)
    (fin2, tr2), calls2, _ = counted(lambda: gs.run_nonlinear_gk_spatial_sharded(
        small, card_mesh(dev, 8, ("sy", "v"), (2, 4)), seed=5))
    dev2, dev2_t = max_rel(fin2.f, mono_s.f), trace_dev(tr_s, tr2)
    ((ens, tr_e), ms_e), calls_e, _ = counted(lambda: events_ms(lambda: gs.run_gk_ensemble_sharded(
        small, card_mesh(dev, 8, ("data", "v"), (2, 4)), np.array(GK_ENSEMBLE_SEEDS))))
    g_s = nl.build_grids(small, device=dev)
    base = nl.init_state(small, g_s, seed=0).f
    dev_e = dev_e_t = 0.0
    for m, seed in enumerate(GK_ENSEMBLE_SEEDS):
        f_m = base + 1e-6 * gs.member_noise(seed, base.shape).to(dev, base.dtype)
        mono_m, tr_m = nl.run_nonlinear_gk(
            small, state=nl.GKState(f_m, torch.zeros((), dtype=torch.float64, device=dev)),
            device=dev)
        dev_e = max(dev_e, max_rel(ens.f[m], mono_m.f))
        dev_e_t = max(dev_e_t, trace_dev(tr_m, [t[m] for t in tr_e]))
    n2, n_e = 8 * 4 * small.n_steps, len(GK_ENSEMBLE_SEEDS) * 4 * 4 * small.n_steps
    print(f"(zq) (sy, v) = (2, 4), 2x8x8x8x6x8 c128, 6 steps: f {dev2:.3e}, trace {dev2_t:.3e}; "
          f"ensemble (data, v) = (2, 4), 4 members (seeds {GK_ENSEMBLE_SEEDS}), {ms_e:.1f} ms: "
          f"f {dev_e:.3e}, trace {dev_e_t:.3e} of each member's monolithic card run (gates "
          f"{GK_SHARD_TEST_GATE}, {GK_SHARD_TRACE_GATE}); row G launches {calls2['gk_rhs']} / "
          f"{calls_e['gk_rhs']} (want {n2} / {n_e}) [{card}]")
    require(max(dev2, dev_e) < GK_SHARD_TEST_GATE and max(dev2_t, dev_e_t) < GK_SHARD_TRACE_GATE,
            "(zq): a sharded run deviates from its monolithic run")
    require(calls2["gk_rhs"] == n2 and calls_e["gk_rhs"] == n_e,
            f"(zq): {calls2['gk_rhs']} / {calls_e['gk_rhs']} row G launches")
    by_path["gk_shard_sy_v"], by_path["gk_shard_ensemble"] = calls2, calls_e
    require(all(lane.status == "pass" for lane in lanes),
            f"(zq) lanes failed: {[lane.name for lane in lanes if lane.status != 'pass']}")
    return calls["gk_rhs"], final7, lanes


def carried_lanes_checks(dev, card: str, counted, by_path: dict, gk_final, gk_lanes) -> None:
    """(zr) the carried-over lanes: the ``implementation_parity`` campaign
    (lane 3 one launch of kernel 1, nothing else) and ``error_audit`` (no
    kernel), each its status the committed report's; a GKState checkpoint
    written from the card (lane 7's final state) and loaded on the CPU, equal;
    (zq)'s ``gk_lanes`` written with the port's ``write_report`` into a
    temporary directory and its checksum read back."""
    import hashlib
    import tempfile

    import torch
    from scpn_fusion_tpu_torch.models.gyrokinetics.nonlinear import GKState
    from scpn_fusion_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from scpn_fusion_tpu_torch.utils.evidence import write_report
    from scpn_fusion_tpu_torch.validation import run_error_audit, run_implementation_parity

    t0 = time.perf_counter()
    (rc, calls, launched) = counted(lambda: run_implementation_parity.main(device=dev))
    campaign_check("implementation_parity", rc, card, "(zr)")
    print(f"(zr) implementation_parity: lane 3's kernel 1 wrapper calls "
          f"{ {k: v for k, v in calls.items() if v} }, launches {launched} [{card}]")
    require(calls == {name: int(name == "sor_sweeps") for name in KERNELS}
            and sum(launched.values()) == 1, f"(zr) lane 3: {calls} / {launched}")
    by_path["implementation_parity"] = calls
    t_parity = time.perf_counter() - t0
    (rc, audit_calls, _) = counted(lambda: run_error_audit.main(device=dev))
    t_audit = time.perf_counter() - t0 - t_parity
    campaign_check("error_audit", rc, card, "(zr)")
    by_path["error_audit"] = audit_calls
    require(sum(audit_calls.values()) == 0, f"(zr): the error audit launched {audit_calls}")
    with tempfile.TemporaryDirectory(prefix="smoke_zr_") as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "gk.ckpt", gk_final, metadata={"lane": "gk_shard_memory"})
        example = GKState(torch.zeros(gk_final.f.shape, dtype=gk_final.f.dtype),
                          torch.zeros((), dtype=gk_final.time.dtype))
        loaded, meta = load_checkpoint(tmp / "gk.ckpt", example)
        ck_equal = (loaded.f.device.type == "cpu" and torch.equal(loaded.f, gk_final.f.cpu())
                    and torch.equal(loaded.time, gk_final.time.cpu()))
        print(f"(zr) GKState checkpoint of lane 7's final state ({gk_final.f.numel() * 16} bytes "
              f"of f) written from the card, loaded on the CPU: equal {ck_equal}, metadata "
              f"{meta} [{card}]")
        require(ck_equal, "(zr): the GK checkpoint did not load back equal on the CPU")
        path = write_report("gk_scenario_and_shard", gk_lanes, out_dir=tmp)
        payload = json.loads(path.read_text())
        sha = payload.pop("payload_sha256")
        again = hashlib.sha256(json.dumps(payload, sort_keys=True, default=str)
                               .encode()).hexdigest()
        for lane in gk_lanes:
            print(f"(zr) gk_scenario_and_shard / {lane.name}: {lane.status} {lane.metrics}")
    print(f"(zr) gk_scenario_and_shard report: {payload['overall_status']}, sha256 {sha[:16]}, "
          f"checksum read back {sha == again}; implementation_parity {t_parity:.1f} s, "
          f"error_audit {t_audit:.1f} s [{card}]")
    require(payload["overall_status"] == "pass" and sha == again,
            f"(zr): the (zq) lanes' report {payload['overall_status']}")


def slice24_on_card(conn, card: str) -> None:
    """(zq) and (zr) in a spawned process on the card, started in
    :func:`late_twins` (host-bound Python beside (m)-(zp)): the
    ``sharded_convergence`` campaign (lanes 1-6 in f64 on virtual shards, no
    kernel; lane 7's monolithic and sharded GK runs through row G), its
    status the committed report's, :func:`gk_shard_checks` on its lane 7,
    then :func:`carried_lanes_checks`; each prints its numbers and fails on
    its gates; sends the port kernel calls by path and each phase's seconds."""
    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.validation import run_sharded_convergence

    def counted(run):
        cb.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        return out, {name: cb.CALLS[name] for name in KERNELS}, dict(cb.LAUNCHES)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    def campaign():
        runs = run_sharded_convergence.gk_runs(dev)
        return runs, run_sharded_convergence.write_lanes(dev, runs)

    ((lane7, rc), ms), calls, launched = counted(lambda: events_ms(campaign))
    lane7.update(calls=calls, launched=launched, ms=ms,
                 peak=torch.cuda.max_memory_allocated() / 2**20)
    campaign_check("sharded_convergence", rc, card, "(zq)")
    by_path = {}
    _, gk_final, lanes = gk_shard_checks(dev, card, counted, by_path, lane7)
    del lane7
    t1 = time.perf_counter()
    carried_lanes_checks(dev, card, counted, by_path, gk_final, lanes)
    sys.stdout.flush()
    conn.send({"by_path": by_path, "zq_s": t1 - t0, "zr_s": time.perf_counter() - t1})
    conn.close()


# ── the twenty-fifth slice: (zs) the CLI and ui/ on the card ──

# Campaign lanes whose status on the card may differ from the committed JAX
# report's, each printed with its metrics beside the report's when it does
# (ROADMAP Queue 3).  neg_triangularity's divertor lane reports the 200th
# iterate of the lithium vapor shield's Picard map, which is unstable at its
# fixed point at that load (1.16e8 W/m^2) in both packages: the iterate
# follows the last-bit rounding of exp, and the card's lands off the lane's
# gates where XLA's CPU exp (the report) and torch's CPU exp land inside.
#
# free_boundary_forward's three 129^2 timing lanes gate the port's forward
# against the original reference's H100 rows (BASELINE.md:13): 26.3 ms a
# float32 solve, 13.0 ms in float64 and mixed precision.  The port's forward
# is host-driven (one host read an outer iteration, an inner Picard loop of
# small launches): 74.8 ms a float32 solve, 1198.1 ms in float64 (plain
# ops), 150.4 ms mixed on an H100 doing nothing else, each short of its row
# (a finding for the speed work, ROADMAP Queue 1 item 7).
VALIDATE_STANDING = {("neg_triangularity", "divertor_contract"),
                     ("free_boundary_forward", "warm_forward_129_device"),
                     ("free_boundary_forward", "warm_forward_129_device_f64"),
                     ("free_boundary_forward", "warm_forward_129_device_mixed")}
# Lanes that read the reference's data (validation/_lanes.REFERENCE_DATA in
# the port), which the repository does not hold: blocked on the card as in
# the JAX scripts off it.
REFERENCE_BLOCKED = {("equilibrium_parity", "geqdsk_reconstruction"),
                     ("io_roundtrip", "sparc_efit_reparse")}
# The campaigns an earlier phase runs (each lane runs once a smoke); (zs)
# runs the others through the CLI's validate mode.
PHASE_CAMPAIGNS = {"resolution_scaling": "(5b)", "free_boundary_forward": "(8b)",
                   "adjoint_fd": "(g)", "tracking_acceptance": "chip_smoke.py tracking",
                   "batched_amortisation": "(zo)",
                   "sharded_gs": "(zp)", "sharded_convergence": "(zq)",
                   "implementation_parity": "(zr)", "error_audit": "(zr)"}
# The exit rule of each campaign (its JAX script's): 0 when the overall
# status is pass, or when every lane that is not blocked passes.
OVERALL_RULE = {"equilibrium_parity", "io_roundtrip", "tracking_acceptance", "adjoint_fd",
                "sharded_gs", "sharded_convergence", "precision_budget", "scpn_replay",
                "stellarator_lane", "transport_conservation"}


def campaign_check(name: str, rc: int | None, card: str, tag: str) -> dict:
    """A campaign's report in ``validation/reports_torch/`` against the
    committed JAX report: the same lanes in order, every lane's status the
    JAX report's but the lanes of :data:`VALIDATE_STANDING` (printed with
    their numbers beside their gates) and of :data:`REFERENCE_BLOCKED`
    (blocked), and ``rc`` (unless None) the script's exit rule.  Returns
    {lane: status}."""
    from scpn_fusion_tpu_torch.validation import REPORTS_DIR
    from scpn_fusion_tpu_torch.validation._lanes import REFERENCE_DATA
    ours = json.loads((REPORTS_DIR / f"{name}.json").read_text())
    ref = json.loads((ROOT / "validation" / "reports" / f"{name}.json").read_text())
    ref_lanes = {lane["name"]: lane for lane in ref["lanes"]}
    names = [lane["name"] for lane in ours["lanes"]]
    require(names == list(ref_lanes),
            f"{tag} {name}: lanes {names}, the committed JAX report's {list(ref_lanes)}")
    off, statuses = [], {}
    for lane in ours["lanes"]:
        statuses[lane["name"]] = lane["status"]
        ref_lane = ref_lanes[lane["name"]]
        key = (name, lane["name"])
        if key in VALIDATE_STANDING:
            print(f"{tag} standing {name} / {lane['name']}: {lane['status']} {lane['metrics']} "
                  f"beside its gates {lane['thresholds']} (the committed JAX report's "
                  f"{ref_lane['status']} {ref_lane['metrics']}) [{card}]")
            continue
        if lane["status"] == ref_lane["status"]:
            continue
        if key in REFERENCE_BLOCKED and lane["status"] == "blocked" \
                and not REFERENCE_DATA.exists():
            print(f"{tag} {name} / {lane['name']}: blocked ({lane['notes']}), the committed "
                  f"JAX report's {ref_lane['status']} ran on the reference's files")
            continue
        print(f"{tag} {name} / {lane['name']}: {lane['status']} {lane['metrics']} (thresholds "
              f"{lane['thresholds']}; notes {lane['notes']!r}; the committed JAX report's "
              f"{ref_lane['status']} {ref_lane['metrics']})")
        off.append(lane["name"])
    require(not off, f"{tag} {name}: lanes {off} differ in status from the committed JAX report's")
    overall = ours["overall_status"]
    rule = (int(overall != "pass") if name in OVERALL_RULE
            else int(any(st == "fail" for st in statuses.values())))
    require(rc is None or rc == rule, f"{tag} {name} exited {rc}, its script's rule gives {rule}")
    print(f"{tag} {name}: {overall} (rc {rc}), lanes {statuses} [{card}]")
    return statuses

# The JAX CLI's JSON keys of each mode (``scpn_fusion_tpu/cli.py``; nested
# objects flattened with dots), written here because the card host has no
# jax: the port's mode must print the same keys.
CLI_KEYS = {
    "kernel": "converged gs_residual iterations reactor residual",
    "free-boundary": "coil_currents converged final_diff outer_iterations",
    "geqdsk": "converged file grid iterations span_rel_rmse span_rel_rmse_core",
    "transport": "he_ash_peak steps te_core_kev ti_core_kev z_eff",
    "flight-sim": "disruption_fraction r_err_final r_err_p95 ticks z_err_final z_err_p95",
    "realtime": "controller_actions diagnostics.disrupted_any diagnostics.n_distinct "
                "diagnostics.n_seen diagnostics.r_err_rms_window final_r_err_m final_z_err_m "
                "open_loop_r_err_m stale_action_reads ticks wall_s",
    "burn": "P_fusion_MW Q T_keV converged tau_E_s",
    "tglf": "chi_e_m2_s chi_i_m2_s d_e_m2_s dominant_mode gamma_max_cs_a",
    "stress": "disruption_rate n_shots r_err_p95_m r_err_p99_m",
    "design-scan": "best.a_m best.b0_t best.ip_ma best.p_net_mw best.q_fusion best.r_m "
                   "n_feasible_q10",
    "disruption": "halo_peak_ma i_re_final_ma mitigated structural_screen.failures "
                  "structural_screen.halo_force_mn structural_screen.passed "
                  "structural_screen.tau_cq_ms tau_cq_ms",
    "startup": "breakdown_ok burn_through_ok ionization_fraction prefill_pa succeeded",
    "gk": "n_saves phi_rms_final q_ion_final_gb zonal_rms_final",
    "divertor": "lambda_q_mm lithium_surface_C q_target_MW_m2 temhd_stable tungsten_melted "
                "tungsten_surface_C",
    "breeding": "li6_enrichment tbr thickness_cm",
    "optimizer": "best.B0_T best.Ip_MA best.P_fusion_MW best.Q best.R0_m best.a_m n_feasible",
    "heating": "absorbed_fraction peak_MW_per_bin peak_rho",
    "wdm": "collapse_time_s collapsed final_te_core_keV final_w_total_1e19 steps",
    "safety": "fpr n_shots recall",
    "sawtooth": "rho_mix rho_q1 t_core_after_keV t_core_before_keV triggered",
    "diagnostics": "interferometer_rad neutron_rate_hz thomson_v",
    "optimal": "feasible final_loss ip_ma iterations ne_1e19 p_aux_mw q_flattop",
    "learning": "final_core_temp final_external_shear final_flow max_external_shear "
                "mean_core_temp mean_flow mean_turbulence q_table_max_abs q_table_mean "
                "total_reward",
    "digital-twin": "max_danger_fraction max_island_width steps t_core_final",
    "control-room": "estimator_rmse final_z max_abs_z mean_abs_z mean_bottom_action "
                    "mean_top_action measurement_rmse",
    "sandpile": "final_mean_slope fraction_quiet max_avalanche mean_avalanche total_flux_out",
    "nuclear": "material peak_erosion_mm_year t_at_peak_ev threshold_t_ev",
    "geometry": "final_residual initial_residual iterations w7x_eps_eff_s0p5",
    "neuro-control": "final_abs_err_r final_abs_err_z final_r final_z mean_abs_err_r "
                     "mean_abs_err_z mean_spike_rate safety_interlock_trips "
                     "safety_position_allow_rate",
    "neural": "artifact forward_finite n_train output_shape seed sha256 test_rel_l2",
}


def cli_exit_rule(mode: str, out: dict) -> int:
    """The exit code the JAX CLI's rule gives for ``mode``'s JSON ``out``."""
    if mode in ("kernel", "free-boundary", "geqdsk"):
        return 0 if out["converged"] else 1
    if mode == "flight-sim":
        return 0 if out["disruption_fraction"] == 0.0 else 1
    if mode == "realtime":
        return 0 if (out["final_r_err_m"] < 0.5 * out["open_loop_r_err_m"]
                     and not out["diagnostics"].get("disrupted_any", True)) else 1
    if mode == "stress":
        return 0 if out["disruption_rate"] == 0.0 else 1
    if mode == "design-scan":
        return 0 if out["n_feasible_q10"] > 0 else 1
    if mode == "optimizer":
        return 0 if out["n_feasible"] > 0 else 1
    if mode == "startup":
        return 0 if out["succeeded"] else 1
    if mode == "safety":
        return 0 if out["recall"] >= 0.9 else 1
    return 0


def flat_keys(d: dict, prefix: str = "") -> set:
    out = set()
    for k, v in d.items():
        out |= flat_keys(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k}
    return out


def cli_call(argv: list, parse: bool = True) -> tuple[int, dict | str, float]:
    """(exit code, the JSON object it printed (with ``parse``, else the whole
    stdout), wall seconds) of one call of the port's CLI in this process,
    its stdout captured."""
    import io
    from scpn_fusion_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue().strip()
    if not parse:
        return rc, text, wall
    try:
        return rc, json.loads(text), wall
    except ValueError:
        return rc, json.loads(text.splitlines()[-1]), wall


ZS_SPARC = "fuzz/seeds/geqdsk/sparc_lmode_hv.geqdsk"
# (zs)'s mode calls: the JAX test's arguments (tests/test_cli_utils.py), else
# the parser's defaults where the smoke already runs that path at that size
ZS_MODES = (
    ["free-boundary", "{cfg33}"], ["geqdsk", ZS_SPARC], ["transport"],
    ["flight-sim", "--hz", "1000", "--duration", "0.2"], ["realtime"],
    ["burn", "--ne19", "10", "--p-aux", "50"], ["tglf"], ["stress"], ["design-scan"],
    ["disruption"], ["startup"], ["gk"], ["divertor"], ["breeding", "--thickness", "80",
                                                         "--li6", "0.9"],
    ["optimizer", "--samples", "1024"], ["heating"], ["wdm"], ["safety"],
    ["sawtooth", "--q0", "0.9"], ["diagnostics", "--n", "33"], ["optimal", "--iters", "3"],
    ["learning", "--steps", "120"], ["digital-twin", "--steps", "30"],
    ["control-room", "--steps", "40", "--n", "16"], ["sandpile", "--steps", "200", "--n", "32"],
    ["nuclear", "--n", "20"], ["geometry", "--iters", "3"], ["neuro-control", "--steps", "40"],
    ["neural"],
)
# the JAX CLI test's 33^2 configuration (tests/test_cli_utils.py)
CLI_TEST_CFG = {
    "reactor_name": "cli-test", "grid_resolution": [33, 33],
    "dimensions": {"R_min": 2.0, "R_max": 10.0, "Z_min": -4.0, "Z_max": 4.0},
    "physics": {"plasma_current_target": 15.0, "vacuum_permeability": 1.0},
    "coils": [{"r": 8.0, "z": 4.8, "current": 4.0}, {"r": 10.8, "z": 0.0, "current": 6.0},
              {"r": 8.0, "z": -4.8, "current": 4.0}],
    "solver": {"max_iterations": 200, "convergence_threshold": 1e-4, "relaxation_factor": 0.1,
               "solver_method": "multigrid"},
}
LIVE_TICKS = 3          # (zs): at least this many converged ticks a configuration
LIVE_PERIOD_S = 0.25    # the worker's wait between ticks in (zs)
MAIN_PATH_KERNELS = ("fused_topology_source", "fine_presmooth_restrict", "fine_prolong_smooth",
                     "fused_coarse_vcycle")


def http_get(port: int, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.headers, r.read()


def live_server_lane(cfg, label: str, card: str) -> float:
    """(zs) the live server on the card: ``LiveSolveWorker`` (on CUDA,
    float32) behind ``make_server(port=0)``; polls its status until
    :data:`LIVE_TICKS` ticks were seen, each converged, fetches its three
    endpoints (security headers on each), stops and joins the worker;
    returns the wall ms a tick (the worker's period taken off)."""
    import threading

    from scpn_fusion_tpu_torch.ui import live_server

    worker = live_server.LiveSolveWorker(cfg, period_s=LIVE_PERIOD_S, device="cuda")
    srv = live_server.make_server(worker, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    seen = {}
    try:
        worker.start()
        deadline = time.time() + 300
        while len(seen) < LIVE_TICKS + 1 and time.time() < deadline \
                and worker.error is None:
            snap = json.loads(http_get(port, "/api/status")[2])
            if snap["solver"] and snap["tick"] not in seen:
                seen[snap["tick"]] = (snap["solver"]["converged"], time.perf_counter(),
                                      snap["solver"]["iterations"], snap["solver"]["grid"])
            time.sleep(0.01)
        for path, ctype in (("/", "text/html"), ("/api/status", "application/json"),
                            ("/api/psi.svg", "image/svg+xml")):
            status, headers, body = http_get(port, path)
            require(status == 200 and headers.get("Content-Type") == ctype and body,
                    f"(zs) live server {label}: {path} {status}")
            for name, value in live_server.SECURITY_HEADERS:
                require(headers.get(name) == value, f"(zs) live server {label}: {path} {name}")
    finally:
        srv.shutdown()
        srv.server_close()
        worker.stop()
        worker.join(timeout=300)
    require(worker.error is None, f"(zs) live server {label}: the worker failed: {worker.error!r}")
    require(not worker.is_alive(), f"(zs) live server {label}: the worker did not end")
    ticks = sorted(seen)
    require(ticks == list(range(len(ticks))) and len(ticks) > LIVE_TICKS,
            f"(zs) live server {label}: ticks seen {ticks}")
    require(all(seen[t][0] for t in ticks), f"(zs) live server {label}: not converged {seen}")
    times = [seen[t][1] for t in ticks]
    ms = (times[-1] - times[0]) / (len(ticks) - 1) * 1e3 - LIVE_PERIOD_S * 1e3
    print(f"(zs) live server {label} {seen[0][3]}: ticks 0-{ticks[-1]} converged, Picard "
          f"iterations {[seen[t][2] for t in ticks]}, {ms:.1f} ms a tick (wall, the "
          f"{LIVE_PERIOD_S * 1e3:.0f} ms period taken off); security headers on every "
          f"response; worker stopped and joined [{card}]")
    return ms


def live_dashboard_mode(card: str) -> None:
    """(zs) the ``live-dashboard`` mode itself: ``python -m
    scpn_fusion_tpu_torch.cli live-dashboard --port 0`` in a child process,
    until its status shows a converged tick; SIGINT ends it (the mode stops
    and joins its worker) with exit code 0."""
    import signal
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "scpn_fusion_tpu_torch.cli", "live-dashboard", "--port",
         "0", "--period", str(LIVE_PERIOD_S)], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        head, m = [], None
        while m is None:
            line = proc.stdout.readline()
            require(line != "", f"(zs) live-dashboard ended before serving: {''.join(head)}")
            head.append(line)
            m = re.search(r"http://127\.0\.0\.1:(\d+)/", line)
        port = int(m.group(1))
        deadline = time.time() + 300
        snap = {}
        while time.time() < deadline:
            snap = json.loads(http_get(port, "/api/status")[2])
            if snap["solver"]:
                break
            time.sleep(0.05)
        require(snap.get("solver", {}).get("converged") is True,
                f"(zs) live-dashboard mode: {snap}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=300)
        rest = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(rc == 0, f"(zs) live-dashboard mode ended with {rc}: {rest[-2000:]}")
    print(f"(zs) live-dashboard mode (a child process): tick {snap['tick']} converged on "
          f"{snap['solver']['grid']}, SIGINT -> exit 0 [{card}]")


def slice25_on_card(conn, card: str) -> None:
    """(zs) the CLI and ``ui/`` on the card, in a spawned process started in
    :func:`late_twins`: the ``kernel`` mode at 513^2 through kernels 2-5 against
    a direct ``solve_equilibrium`` call (counts equal, psi ``torch.equal``) and
    the plain float32 solve, the live server at 65^2 and 513^2, the dashboards,
    every other mode once, ``validate --all`` in float64 and
    ``stellarator-replay``; sends the kernel calls by path and the seconds."""
    import os
    import tempfile

    import torch
    sys.path.insert(0, str(ROOT))
    from scpn_fusion_tpu_torch.bench_config import BENCH_SOLVER, config_dict
    from scpn_fusion_tpu_torch.core.config import config_from_dict, load_config
    from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ui.dashboard import generate_dashboard
    from scpn_fusion_tpu_torch.validation import CAMPAIGNS, REPORTS_DIR

    def counted(run):
        cb.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        return out, {name: cb.CALLS[name] for name in KERNELS}

    os.chdir(ROOT)                        # the modes' relative paths are the checkout's
    t0 = time.perf_counter()
    by_path, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="zs_") as tmp_dir:
        tmp = Path(tmp_dir)
        cfg513 = tmp / "bench_513.json"
        cfg513.write_text(json.dumps(config_dict(513, **BENCH_SOLVER)))
        cfg33 = tmp / "cli_test_33.json"
        cfg33.write_text(json.dumps(CLI_TEST_CFG))

        # ── the kernel mode at 513^2, the main path ──
        npz = tmp / "kernel_513.npz"
        cb.library()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def kernel_mode():
            start.record()
            out = cli_call(["kernel", str(cfg513), "--output", str(npz)])
            end.record()
            return out

        (rc, out, wall), calls = counted(kernel_mode)
        event_ms = start.elapsed_time(end)
        # the same call again: the first of a process pays its first launches
        (rc_w, out_w, wall_w), calls_w = counted(kernel_mode)
        event_ms_w = start.elapsed_time(end)
        require(rc_w == 0 and out_w == out and calls_w == calls,
                f"(zs) kernel mode, second call: rc {rc_w}, {out_w}, {calls_w}")
        require(rc == 0 and out["converged"] is True and set(out) == set(CLI_KEYS["kernel"].split()),
                f"(zs) kernel mode: rc {rc}, {out}")
        cfg_k = load_config(cfg513)
        direct, calls_direct = counted(lambda: solve_equilibrium(cfg_k, dtype=torch.float32,
                                                                 device="cuda"))
        psi_cli = torch.from_numpy(np.load(npz)["psi"])
        require(torch.equal(psi_cli, direct.psi.cpu()),
                "(zs) kernel mode: the npz psi is not the direct solve's")
        require(calls == calls_direct, f"(zs) kernel mode counts {calls} != direct {calls_direct}")
        require(all(calls[name] > 0 for name in MAIN_PATH_KERNELS),
                f"(zs) kernel mode: kernels 2-5 not all launched: {calls}")
        cfg_p = config_from_dict(config_dict(513, **BENCH_SOLVER, use_pallas=False))
        plain, calls_plain = counted(lambda: solve_equilibrium(cfg_p, dtype=torch.float32,
                                                               device="cuda"))
        require(sum(calls_plain.values()) == 0, f"(zs) the plain solve launched {calls_plain}")
        dev_plain = span_rel(direct.psi, plain.psi)
        n_it, n_plain = int(direct.iterations), int(plain.iterations)
        require(dev_plain <= SLICE_TOL and abs(n_it - n_plain) <= 1,
                f"(zs) kernel mode vs plain f32: {dev_plain:.3e}, iterations {n_it} / {n_plain}")
        by_path["zs_kernel_mode"] = calls
        per_it = {name: calls[name] / n_it for name in MAIN_PATH_KERNELS}
        print(f"(zs) kernel mode 513^2 f32 (cli.main): converged in {out['iterations']} Picard "
              f"iterations, the process's first call {wall * 1e3:.1f} ms wall, {event_ms:.3f} ms by "
              f"CUDA events, the second {wall_w * 1e3:.1f} ms wall, {event_ms_w:.3f} ms, kernel "
              f"calls {({k: v for k, v in calls.items() if v})} ({per_it} a Picard iteration), "
              f"equal to the direct solve_equilibrium call's; npz psi torch.equal to it; "
              f"{dev_plain:.3e} span-rel from the plain f32 solve ({n_plain} iterations) [{card}]")
        t1 = time.perf_counter()
        secs["kernel"] = t1 - t0

        # ── the live server at 65^2 (its default) and at 513^2, and the mode ──
        live_ms = {"65": live_server_lane(None, "65^2 default", card),
                   "513": live_server_lane(cfg_k, "513^2 bench", card)}
        live_dashboard_mode(card)
        t2 = time.perf_counter()
        secs["live"] = t2 - t1

        # ── the dashboards: the mode in a temporary directory, the 513^2 snapshot ──
        dash = tmp / "dashboard"
        dash.mkdir()
        os.chdir(dash)
        try:
            rc, _, _ = cli_call(["dashboard"], parse=False)
        finally:
            os.chdir(ROOT)
        files = sorted(p.name for p in dash.iterdir())
        require(rc == 0 and files == ["DASHBOARD.html", "DASHBOARD.md", "studio_manifest.json"],
                f"(zs) dashboard mode: rc {rc}, {files}")
        md = generate_dashboard(tmp / "snapshot.md", config_path=str(cfg513)).read_text()
        require("- converged: True in " in md and "- grid: 513 x 513" in md,
                "(zs) generate_dashboard's 513^2 snapshot did not converge")
        print(f"(zs) dashboard mode wrote {files} into its working directory; "
              f"generate_dashboard's 513^2 snapshot converged [{card}]")
        t3 = time.perf_counter()
        secs["dashboard"] = t3 - t2

        # ── every other mode once ──
        mode_s = {}
        for argv in ZS_MODES:
            argv = [a.format(cfg33=cfg33) for a in argv]
            t = time.perf_counter()
            rc, out, _ = cli_call(argv)
            mode_s[argv[0]] = time.perf_counter() - t
            rule = cli_exit_rule(argv[0], out)
            keys = set(CLI_KEYS[argv[0]].split())
            require(rc == rule and flat_keys(out) == keys,
                    f"(zs) mode {argv}: rc {rc} (the JAX rule gives {rule}), keys "
                    f"{sorted(flat_keys(out) ^ keys)} differ")
        print("(zs) every other mode once (rc by the JAX CLI's rule, the JAX keys): "
              + ", ".join(f"{k} {v:.2f} s" for k, v in mode_s.items()) + f" [{card}]")
        t4 = time.perf_counter()
        secs["modes"] = t4 - t3

        # ── validate: each campaign no earlier phase runs, one call of the
        # mode each (the phases' campaigns run where their kernel gates are) ──
        rest = sorted(set(CAMPAIGNS) - set(PHASE_CAMPAIGNS))
        statuses, standing, camp_s, camp_calls = {}, {}, {}, {}
        for name in rest:
            t = time.perf_counter()
            (rc, _, _), calls_v = counted(
                lambda name=name: cli_call(["validate", "--campaign", name], parse=False))
            camp_s[name] = time.perf_counter() - t
            camp_calls[name] = calls_v
            lanes = campaign_check(name, rc, card, "(zs)")
            statuses[name] = json.loads((REPORTS_DIR / f"{name}.json").read_text())[
                "overall_status"]
            standing.update({f"{name} / {k}": v for k, v in lanes.items()
                             if (name, k) in VALIDATE_STANDING})
            if name == "gk_eigenvalue_perf":
                gk = json.loads((REPORTS_DIR / f"{name}.json").read_text())["lanes"][0]["metrics"]
            if name == "precision_budget":
                pb = {lane["name"]: lane["metrics"] for lane in json.loads(
                    (REPORTS_DIR / f"{name}.json").read_text())["lanes"]}
        for name in ("equilibrium_parity", "io_roundtrip"):
            require(camp_calls[name]["fused_coarse_vcycle"] > 0
                    and camp_calls[name]["fused_topology_source"] > 0,
                    f"(zs) {name}: kernels 2 and 3 not launched on its float32 solves: "
                    f"{camp_calls[name]}")
            by_path[name] = camp_calls[name]
        require((REPORTS_DIR / "RESULTS.md").exists(), "(zs) validate wrote no RESULTS.md")
        t5 = time.perf_counter()
        secs["validate"] = t5 - t4
        print(f"(zs) validate --campaign, one call each: {statuses}, every lane's status the "
              f"committed JAX report's but the standing differences {standing or 'none'} "
              f"(ROADMAP Queue 3); seconds "
              + ", ".join(f"{k} {v:.1f}" for k, v in camp_s.items())
              + f"; kernel calls of equilibrium_parity "
              f"{ {k: v for k, v in camp_calls['equilibrium_parity'].items() if v} }, io_roundtrip "
              f"{ {k: v for k, v in camp_calls['io_roundtrip'].items() if v} }; "
              f"gk_eigenvalue_perf {gk['per_ky_solve_s']} s a k_y (gate 0.3); precision_budget "
              f"lane 1 (kernels 2, 3 at 129^2) f32 deviation "
              f"{pb['fixed_boundary_f32_penalty']['span_rel_deviation_f32_vs_f64']:.3e}, iterations "
              f"{pb['fixed_boundary_f32_penalty']['iterations_f32']}, lane 3 mixed 513^2 GS "
              f"residual {pb['mixed_precision_513_residual_gated']['gs_residual_rms']:.3e}; "
              f"{secs['validate']:.1f} s [{card}]")
        rc, _, _ = cli_call(["stellarator-replay"], parse=False)
        require(rc == 0, f"(zs) stellarator-replay exited {rc}")
        secs["stellarator_replay"] = time.perf_counter() - t5
        sys.stdout.flush()
        conn.send({"by_path": by_path, "secs": secs, "live_ms": live_ms,
                   "kernel": {"iterations": n_it, "wall_ms": (wall * 1e3, wall_w * 1e3),
                              "event_ms": (event_ms, event_ms_w), "calls": calls}})
        conn.close()


def torch_from(a):
    import torch
    return torch.from_numpy(np.asarray(a, np.float64))


def early_twins(stack: contextlib.ExitStack, card: str) -> dict:
    """Start, right after the build, the processes whose results later
    paths wait for: the CPU twins of (k), (o), (v), (z)-(zg) and (zo), and the host-bound
    card-side runs of (k)'s plain Thomas loop, (o)'s :data:`CARD_LANES` and (zf)'s plain
    references,
    each in a spawned process that drives the card beside this one (the card
    is idle > 90% of their time).  ``stack`` ends them on the way out."""
    targets = {"torax_plain": torax_plain_on_card, "control_card": control_lanes_on_card,
               "torax_cpu": torax_on_cpu, "control_cpu": control_lanes_on_cpu,
               "gk_lanes_cpu": gk_lanes_on_cpu, "slice16_cpu": slice16_on_cpu,
               "slice17_cpu": slice17_on_cpu, "slice18_cpu": slice18_on_cpu,
               "slice18_card": slice18_plain_on_card, "ensemble_cpu": ensemble_mixed_on_cpu}
    twins = {name: stack.enter_context(cpu_twin(target)) for name, target in targets.items()}
    return twins


def late_twins(stack: contextlib.ExitStack, psi_129, card: str) -> dict:
    """Start (zh)-(zi)'s, (zj)-(zk)'s, (zl)-(zm)'s and (zn)'s CPU twins (the
    third on (b)'s 129^2 psi, ``psi_129``), the plain runs of rows F, E, H, U
    and W on the card (~230 s, ~40 s, ~300 s, ~20 s and ~12 s of host time),
    (zn)'s FNO and equilibrium trainers on the card (~50 s each) and the
    replay certificate's fresh process, (zp)'s sharded lanes, (zq)-(zr) on
    the card (~20 s) and (zs) on the card once the host-bound early paths,
    (a)-(l), are done: started with the others, they slowed those paths on an
    8-core host with one H100 (the whole smoke 899 s, where it had taken 770 s
    without them)."""
    targets = {"slice19_cpu": slice19_on_cpu, "slice19_card": slice19_plain_on_card,
               "slice20_cpu": slice20_on_cpu, "slice20_card": slice20_plain_on_card,
               "slice21_card": slice21_plain_on_card, "slice22_card": slice22_plain_on_card,
               "slice22_cpu": slice22_on_cpu, "slice22_fno": slice22_fno_trainers_on_card,
               "slice22_equilibrium": slice22_equilibrium_on_card}
    twins = {name: stack.enter_context(cpu_twin(target)) for name, target in targets.items()}
    twins["sharded_card"] = stack.enter_context(cpu_twin(sharded_on_card, card))
    twins["slice21_cpu"] = stack.enter_context(cpu_twin(slice21_on_cpu, psi_129))
    twins["slice24_card"] = stack.enter_context(cpu_twin(slice24_on_card, card))
    twins["slice25_card"] = stack.enter_context(cpu_twin(slice25_on_card, card))
    with environment(PYTHONHASHSEED=REPLAY_HASHSEED):
        twins["replay"] = stack.enter_context(cpu_twin(replay_on_card))
    return twins


def main(argv: list[str]) -> int:
    """``chip_smoke.py``: every path but the ``tracking_acceptance``
    campaign; ``chip_smoke.py tracking``: that campaign alone (see
    :func:`tracking_main`)."""
    if argv not in ([], ["tracking"]):
        print("usage: chip_smoke.py [tracking]", file=sys.stderr)
        return 2
    with contextlib.ExitStack() as stack:
        return tracking_main(stack) if argv else _main(stack)


def tracking_main(stack: contextlib.ExitStack) -> int:
    """The second command of the smoke: (o)'s ``tracking_acceptance`` campaign
    on the card, its 11 shots (132 ticks of seven f64 plant solves each,
    host-bound launches) in the four processes of :data:`TRACKING_BINS`, its
    lanes built by the module's ``finish``, its status the committed
    report's.  Beside the main command, whose budget its shots' host time
    does not fit."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "scpn_fusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    twins = [stack.enter_context(cpu_twin(tracking_shots_on_card, card, indices))
             for indices in TRACKING_BINS]
    calls = tracking_campaign(card, twins)
    print(f"(o) tracking_acceptance kernel calls {sum(calls.values())}; smoke seconds: "
          f"{time.perf_counter() - t0:.1f} [{card}]")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _main(stack: contextlib.ExitStack) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "scpn_fusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from scpn_fusion_tpu_torch.bench_config import (
        BENCH_SOLVER, FREE_BOUNDARY_MU0_GREEN, bench_config, config_dict, free_boundary_config,
        rect_config,
    )
    from scpn_fusion_tpu_torch.core.config import config_from_dict
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.io.geqdsk import read_geqdsk
    from scpn_fusion_tpu_torch.models.equilibrium.eqdsk_solve import (
        _eqdsk_problem, _solve_eqdsk_impl, solve_from_geqdsk,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
        solve_equilibrium, solve_equilibrium_fmg,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import (
        coilset_from_config, interp_psi_at_points, mutual_inductance_matrix,
    )
    from scpn_fusion_tpu_torch.models.equilibrium.newton import solve_equilibrium_newton
    from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    from scpn_fusion_tpu_torch.ops import cuda_mg, cuda_mg_tiled, cuda_source, cuda_stencil, leg_plan
    from scpn_fusion_tpu_torch.ops.cuda_mg import level_plan
    from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl
    from scpn_fusion_tpu_torch.validation import REPORTS_DIR
    from scpn_fusion_tpu_torch.validation import run_free_boundary_forward as fbf
    from scpn_fusion_tpu_torch.validation import run_resolution_scaling as rs

    phases: dict[str, float] = {}
    t_start = t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = now - t_phase
        t_phase = now

    # ── 1. preflight ──
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"card: {card}")
    dev = torch.device("cuda")
    # this run's campaign reports only
    for stale in list(REPORTS_DIR.glob("*.json")) + list(REPORTS_DIR.glob("*.md")):
        stale.unlink()
    phase_done("preflight")

    # ── 2. build ──
    cb.library()
    print(f"build: {time.perf_counter() - t_phase:.2f} s (one nvcc per source, "
          f"{' '.join(cb.NVCC_FLAGS)})")
    for source in ("sor_band.cu", "fine_legs.cu", "tiled_legs.cu", "tiled_legs_slab.cu",
                   "vcycle_fused.cu", "source.cu", "closed_loop.cu", "reduced_shot.cu",
                   "ladder.cu", "gk_rhs.cu", "digital_twin.cu", "ballooning.cu",
                   "disruption.cu", "sandpile.cu", "compression.cu", "orbits.cu", "burn.cu",
                   "quench.cu", "phase.cu", "gene_proxy.cu"):
        for line in cb.BUILD_LOG.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {source}: {line.strip()}")
    for n, pre, posts, t_rows in TILED_SHAPES:
        for leg, sweeps in (("down", pre), *(("up", post) for post in posts)):
            plan = cuda_mg_tiled.launch_plan(leg, n, n, sweeps, t_rows)
            occ = cuda_mg_tiled.launch_occupancy(plan)
            print(f"  tiled {leg} leg {n}^2 sweeps={sweeps}: tile {plan.tile_rows}x"
                  f"{plan.tile_cols}, halo {plan.halo}, {plan.n_seg} bands of {plan.seg_len} rows, "
                  f"{plan.threads} threads, {plan.smem_bytes} B shared; {occ['ctas_per_sm']} CTAs "
                  f"an SM, {occ['resident']} resident, grid {occ['grid']} = {occ['waves']:.2f} "
                  f"waves")
            require(occ["ctas_per_sm"] >= 1, f"the tiled {leg} leg's block does not fit an SM")
    for nz, nr, pre, posts in FINE_SHAPES:
        for leg, sweeps in (("down", pre), *(("up", post) for post in posts)):
            plan = cuda_mg.fine_launch_plan(leg, nz, nr, sweeps)
            occ = cuda_mg.fine_launch_occupancy(plan)
            print(f"  fine {leg} leg {nz}x{nr} sweeps={sweeps}: tile {plan.tile_rows}x"
                  f"{plan.tile_cols}, halo {plan.halo}, {plan.n_seg} bands of {plan.seg_len} rows, "
                  f"{plan.threads} threads, {plan.smem_bytes} B shared; {occ['ctas_per_sm']} CTAs "
                  f"an SM, {occ['resident']} resident, grid {occ['grid']} = {occ['waves']:.2f} "
                  f"waves, {occ['grid'] * plan.threads / 32 / cuda_mg.SM_COUNT:.1f} warps an SM")
            require(occ["ctas_per_sm"] >= 1, f"the fine {leg} leg's block does not fit an SM")
    # A refused launch raises below; these two lines say how much room there is.
    plan_257 = cuda_mg.vcycle_launch_plan(257, 5)
    clusters = cb.library().scpn_fused_vcycle_clusters(
        ctypes.addressof(cuda_mg.vcycle_plan_struct(257, 5, 1.0, 1.0, 1.0, 1, 2, 50)))
    print(f"fused V-cycle from 257^2: one cluster of {plan_257.n_cta} CTAs x "
          f"{plan_257.smem_bytes} bytes of shared memory; the device holds {clusters} such "
          f"clusters at once")
    resident = cb.library().scpn_source_resident_blocks()
    print(f"fused source: up to {cb.source_blocks(1 << 30)} blocks in a cooperative launch; "
          f"the device holds {resident} at once")
    require(clusters >= 1, f"no cluster of the fused V-cycle fits the device ({clusters})")
    require(resident >= cb.source_blocks(1 << 30),
            f"the fused source's blocks are not all resident ({resident})")
    twins = early_twins(stack, card)
    phase_done("build")

    # ── 3. kernels against their plain versions, float32, the paths' shapes ──
    rng = np.random.default_rng(SEED)

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def rand_coarse(n):
        """A compact coarse error for an n x n level, zero on its ring."""
        e = rand((n + 1) // 2, (n + 1) // 2)
        e[0, :] = 0.0
        e[-1, :] = 0.0
        e[:, 0] = 0.0
        e[:, -1] = 0.0
        return e

    def level(n):
        g = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32, device=dev)
        return g, g.R, g.dR, g.dZ

    results = {}

    def record(name, err, tol, note):
        if not err <= tol:
            raise AssertionError(f"{name}: {note} span-rel {err:.3e} > {tol:.0e}")
        results.setdefault(name, {"max_abs_err": 0.0})
        print(f"check {name} {note}: span-rel {err:.3e} (limit {tol:.0e})")

    def abs_err(name, a, b):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           float((a - b).abs().max()))

    g513, r513, dr513, dz513 = level(513)
    psi = rand(513, 513)
    src = rand(513, 513)
    timing = {}     # name -> (kernel call, plain call, shape, work) at the path's shape
    extra_times = []    # (label, (name, call), (name, call), work or None): printed only
    staged = {}     # name -> the predecessor's call at the timed shape
    turn_times = []     # (label, new call, earlier call, work): timed in turns, printed only

    # sor_sweeps on each route (A: one CTA holds the level; B: tiles; D: the
    # staged half-sweeps without the copy): against the plain version and, bit
    # for bit, against the staged route it replaced (a copy, then a launch a
    # half-sweep); launches a call as the plan says
    sor_regs = ptxas_registers(cb.BUILD_LOG.get("sor_band.cu", ""))
    for nz, nr, n in SOR_SHAPES:
        g_n = Grid.from_bounds(nr, nz, 0.9, 2.6, -1.5, 1.5, dtype=torch.float32, device=dev)
        omega = SOR_OMEGA if n == SOR_SWEEPS else 1.0
        args = (rand(nz, nr), rand(nz, nr), g_n.R, g_n.dR, g_n.dZ, omega, n)
        what = f"{nz}x{nr} n={n} omega={omega}"
        plan = leg_plan.sor_launch_plan(nz, nr, n)
        cb.reset_launch_counts()
        out_k = cuda_stencil.sor_sweeps(*args)
        made = cb.kernel_launches()
        out_p = cuda_stencil.sor_sweeps_plain(*args)
        out_s = cuda_stencil._sor_sweeps_staged(*args)
        torch.cuda.synchronize()
        record("sor_sweeps", span_rel(out_k, out_p), SPAN_TOL, what)
        abs_err("sor_sweeps", out_k, out_p)
        require(ring_equal(out_k, args[0]), f"sor_sweeps changed the Dirichlet ring at {what}")
        require(torch.equal(out_k, out_s), f"sor_sweeps differs from the staged route at {what}")
        require(made == plan.launches, f"sor_sweeps made {made} launches at {what}, its route "
                                       f"{plan.route} {plan.launches}")
        detail = ""
        if plan.launch is not None:
            lp = plan.launch
            occ = leg_plan.launch_occupancy("scpn_sor_ctas_per_sm", lp)
            require(occ["ctas_per_sm"] >= 1, f"the sor_sweeps block does not fit an SM at {what}")
            key = f"ILi{lp.seg_len}ELi{leg_plan.SOR_VARIANTS[lp.variant][1]}E"
            regs = [v for name, v in sor_regs.items() if key in name]
            detail = (f": tile {lp.tile_rows}x{lp.tile_cols}, halo {lp.halo}, {lp.n_seg} bands "
                      f"of {lp.seg_len} rows, {lp.threads} threads, {lp.smem_bytes} B shared; "
                      f"{occ['ctas_per_sm']} CTAs an SM, grid {occ['grid']}; ptxas "
                      f"{regs[0] if regs else '(no line)'}")
        print(f"  sor_sweeps {what}: route {plan.route}, {made} launch(es){detail}; equal to "
              f"the staged route")
        kernel = lambda a=args: cuda_stencil.sor_sweeps(*a)   # noqa: E731
        staged_call = lambda a=args: cuda_stencil._sor_sweeps_staged(*a)   # noqa: E731
        work = sor_work(nz, nr, n)
        if (nz, nr, n) == (129, 129, SOR_SWEEPS):
            timing["sor_sweeps"] = (kernel, lambda a=args: cuda_stencil.sor_sweeps_plain(*a),
                                    what, work)
            staged["sor_sweeps"] = staged_call
        elif (nz, nr, n) in ((257, 129, 2), (9, 5, 50), (513, 513, 50)):
            turn_times.append((f"sor_sweeps {what} (route {plan.route})", kernel, staged_call,
                               work))
    for bad in ((2, 9, 1), (9, 2, 1)):
        try:
            cuda_stencil.sor_sweeps(rand(bad[0], bad[1]), rand(bad[0], bad[1]),
                                    torch.ones(bad[1], device=dev), 0.1, 0.1, 1.0, bad[2])
        except ValueError as exc:
            print(f"  sor_sweeps {bad[0]}x{bad[1]} raises: {exc}")
        else:
            raise AssertionError(f"sor_sweeps took a {bad[0]}x{bad[1]} level")

    # fused topology + source: 513^2 in L and H mode, 1025^2 (the cascade's
    # own 1025^2 level runs the kernel), 257^2 and 129^2 (the free-boundary
    # paths' grids) in L mode; against the plain version and, bit for bit,
    # against the three-launch entry
    vals = 0.3 + rng.random(8)
    p_c = ProfileCoeffs(*torch.tensor(vals[:4], dtype=torch.float32, device=dev).unbind())
    ff_c = ProfileCoeffs(*torch.tensor(vals[4:], dtype=torch.float32, device=dev).unbind())
    i_t = torch.full((), 15.0, dtype=torch.float32, device=dev)
    packed = cuda_source.pack_source_params(p_c, ff_c, i_t)
    source_shapes = ((513, 513, "513^2", (False, True)), (1025, 1025, "1025^2", (False,)),
                     (257, 257, "257^2", (False,)), (129, 129, "129^2", (False,)),
                     *((nz, nr, tag, (False,)) for nz, nr, tag in SOURCE_SHAPES))
    for nz, nr, tag, modes in source_shapes:
        if nz == nr:
            g_n, r_n, dr_n, dz_n = level(nz)
            centre, width = (6.0, 0.0), 2.0
        else:       # the rectangular path's grid
            g_n = Grid.from_bounds(nr, nz, 0.9, 2.6, -1.5, 1.5, dtype=torch.float32, device=dev)
            r_n, dr_n, dz_n = g_n.R, g_n.dR, g_n.dZ
            centre, width = (1.75, 0.0), 0.5
        rr, zz = g_n.RR, g_n.ZZ
        blob = torch.exp(-(((rr - centre[0]) / width) ** 2 + (zz / width) ** 2))
        psi_src = 3.0 * blob + 0.01 * rand(nz, nr)
        psi_other = 2.0 * torch.exp(-(((rr - centre[0] + 0.5 * width) / (0.75 * width)) ** 2
                                      + ((zz - 0.25 * width) / (1.25 * width)) ** 2)) \
            + 0.01 * rand(nz, nr)
        mask = (zz < g_n.Z_min * 0.5).to(torch.float32).contiguous()
        blocks = cb.source_blocks(nz * nr)
        print(f"  fused source {tag}: {blocks} blocks in one cooperative launch; the device "
              f"holds {resident} at once")
        require(blocks <= resident, f"the fused source's {blocks} blocks at {tag} are not all "
                                    f"resident ({resident})")
        for h_mode in modes:
            kw = dict(d_r=dr_n, d_z=dz_n, mu0=1.0, h_mode=h_mode, with_scalars=True)
            mode = "H" if h_mode else "L"
            cb.reset_launch_counts()
            s_k, sc_k = cuda_source.fused_topology_source(psi_src, r_n, mask, packed, **kw)
            require(dict(cb.LAUNCHES) == {"scpn_fused_source": 1},
                    f"fused_topology_source made {dict(cb.LAUNCHES)}, not one launch")
            s_p, sc_p = cuda_source.fused_topology_source_plain(psi_src, r_n, mask, p_c, ff_c,
                                                                i_t, **kw)
            s_s, sc_s = cuda_source._fused_topology_source_staged(psi_src, r_n, mask, p_c, ff_c,
                                                                  i_t, **kw)
            torch.cuda.synchronize()
            record("fused_topology_source", span_rel(s_k, s_p), SPAN_TOL, f"{tag} {mode}-mode")
            abs_err("fused_topology_source", s_k, s_p)
            if int(sc_k.x_index) != int(sc_p.x_index):
                raise AssertionError(f"X-point index {int(sc_k.x_index)} != {int(sc_p.x_index)}")
            if not torch.equal(sc_k.psi_axis, sc_p.psi_axis):
                raise AssertionError("psi_axis differs between kernel and plain version")
            require(torch.equal(s_k, s_s) and all(torch.equal(a, b) for a, b in zip(sc_k, sc_s)),
                    f"one-launch source differs from the three-launch entry at {tag} {mode}-mode")
            # another psi through the same cached workspace, then the first
            # again (given as the three arguments, packed on the fly): the
            # workspace carries nothing from call to call
            o_k, oc_k = cuda_source.fused_topology_source(psi_other, r_n, mask, packed, **kw)
            o_p, oc_p = cuda_source.fused_topology_source_plain(psi_other, r_n, mask, p_c, ff_c,
                                                                i_t, **kw)
            a_k, ac_k = cuda_source.fused_topology_source(psi_src, r_n, mask, p_c, ff_c, i_t,
                                                          **kw)
            torch.cuda.synchronize()
            record("fused_topology_source", span_rel(o_k, o_p), SPAN_TOL,
                   f"{tag} {mode}-mode, second psi on the same workspace")
            require(int(oc_k.x_index) == int(oc_p.x_index)
                    and torch.equal(oc_k.psi_axis, oc_p.psi_axis),
                    "second call on the same workspace: X-point or psi_axis differ from plain")
            require(torch.equal(a_k, s_k) and all(torch.equal(a, b) for a, b in zip(ac_k, sc_k)),
                    "the source kernel's result depends on the call before it")
            print(f"  {mode}-mode X-point index {int(sc_k.x_index)} (same), psi_axis "
                  f"{float(sc_k.psi_axis)!r} (same), psi_b {float(sc_k.psi_boundary)!r} vs "
                  f"{float(sc_p.psi_boundary)!r}, I_current {float(sc_k.i_current)!r} vs "
                  f"{float(sc_p.i_current)!r}; equal to the three-launch entry; one launch")
        if tag == "513^2":
            n = nz
            src_args = (psi_src, r_n, mask)
            src_kw = dict(d_r=dr_n, d_z=dz_n, mu0=1.0, h_mode=False)
            timing["fused_topology_source"] = (
                lambda: cuda_source.fused_topology_source(*src_args, packed, **src_kw),
                lambda: cuda_source.fused_topology_source_plain(*src_args, p_c, ff_c, i_t,
                                                                **src_kw),
                "513^2 L-mode", (4.0 * (3 * n * n + n), 28.0 * n * n))
            # as the Picard loop called it before: parameters packed in every call
            staged["fused_topology_source"] = (
                lambda: cuda_source._fused_topology_source_staged(*src_args, p_c, ff_c, i_t,
                                                                  **src_kw))

    # fine legs (kernels 4 and 5): against the plain versions and, bit for
    # bit, against the staged launchers (one launch per dependent stage); one
    # launch a call.  post = 0 checks the prolongation alone (omega = 1
    # sweeps overwrite the red phases of the correction).
    e_c = rand_coarse(513)
    pre_args = (psi, src, r513, dr513, dz513, 1.0)
    post_args = (psi, src, e_c, r513, dr513, dz513, 1.0)
    for nz, nr, pre, posts in FINE_SHAPES:
        if (nz, nr) == (513, 513):
            a, pa = pre_args, post_args
        else:
            g_n = Grid.from_bounds(nr, nz, 2.0, 10.0, -4.0, 4.0, dtype=torch.float32,
                                   device=dev)
            e_n = rand((nz + 1) // 2, (nr + 1) // 2)
            e_n[0, :] = e_n[-1, :] = 0.0
            e_n[:, 0] = e_n[:, -1] = 0.0
            a = (rand(nz, nr), rand(nz, nr), g_n.R, g_n.dR, g_n.dZ, 1.0)
            pa = (a[0], a[1], e_n, g_n.R, g_n.dR, g_n.dZ, 1.0)
        tag = f"{nz}^2" if nz == nr else f"{nz}x{nr}"
        cb.reset_launch_counts()
        ps_k, dc_k = cuda_mg.fine_presmooth_restrict(*a, pre_smooth=pre)
        require(dict(cb.LAUNCHES) == {"scpn_fine_pre": 1},
                f"fine_presmooth_restrict made {dict(cb.LAUNCHES)}, not one launch")
        ps_p, dc_p = cuda_mg.fine_presmooth_restrict_plain(*a, pre_smooth=pre)
        ps_s, dc_s = cuda_mg._presmooth_restrict_launch(*a, pre_smooth=pre)
        torch.cuda.synchronize()
        require(torch.equal(ps_k, ps_s) and torch.equal(dc_k, dc_s),
                f"fine_presmooth_restrict differs from the staged launchers at {tag} pre={pre}")
        record("fine_presmooth_restrict", span_rel(ps_k, ps_p), SPAN_TOL, f"{tag} pre={pre} psi_s")
        record("fine_presmooth_restrict", span_rel(dc_k, dc_p), SPAN_TOL, f"{tag} pre={pre} d_c")
        abs_err("fine_presmooth_restrict", ps_k, ps_p)
        abs_err("fine_presmooth_restrict", dc_k, dc_p)
        require(ring_equal(ps_k, a[0]), f"fine_presmooth_restrict changed the ring at {tag}")
        require(ring_equal(dc_k, torch.zeros_like(dc_k)), f"coarse defect ring not zero at {tag}")
        for post in posts:
            cb.reset_launch_counts()
            po_k = cuda_mg.fine_prolong_smooth(*pa, post_smooth=post)
            require(dict(cb.LAUNCHES) == {"scpn_fine_post": 1},
                    f"fine_prolong_smooth made {dict(cb.LAUNCHES)}, not one launch")
            po_p = cuda_mg.fine_prolong_smooth_plain(*pa, post_smooth=post)
            po_s = cuda_mg._prolong_smooth_launch(*pa, post_smooth=post)
            torch.cuda.synchronize()
            require(torch.equal(po_k, po_s),
                    f"fine_prolong_smooth differs from the staged launchers at {tag} post={post}")
            record("fine_prolong_smooth", span_rel(po_k, po_p), SPAN_TOL, f"{tag} post={post}")
            abs_err("fine_prolong_smooth", po_k, po_p)
            require(ring_equal(po_k, pa[0]), f"fine_prolong_smooth changed the ring at {tag}")
        print(f"  fine legs {tag} pre={pre} post={posts}: psi and coarse defect equal to the "
              f"staged launchers'; one launch a call")
    timing["fine_presmooth_restrict"] = (
        lambda: cuda_mg.fine_presmooth_restrict(*pre_args, pre_smooth=1),
        lambda: cuda_mg.fine_presmooth_restrict_plain(*pre_args, pre_smooth=1),
        "513^2 pre=1", leg_work(513, 1, "down"))
    timing["fine_prolong_smooth"] = (
        lambda: cuda_mg.fine_prolong_smooth(*post_args, post_smooth=2),
        lambda: cuda_mg.fine_prolong_smooth_plain(*post_args, post_smooth=2),
        "513^2 post=2", leg_work(513, 2, "up"))
    staged["fine_presmooth_restrict"] = (
        lambda: cuda_mg._presmooth_restrict_launch(*pre_args, pre_smooth=1))
    staged["fine_prolong_smooth"] = (
        lambda: cuda_mg._prolong_smooth_launch(*post_args, post_smooth=2))
    try:
        cuda_mg.fine_presmooth_restrict(*pre_args, pre_smooth=40)
    except ValueError as exc:
        print(f"  fine_presmooth_restrict 513^2 pre=40 raises: {exc}")
    else:
        raise AssertionError("fine_presmooth_restrict took pre_smooth=40")

    # fused_coarse_vcycle: the cascades' (1, 2) and the mixed path's (3, 3) at
    # 257^2 and 129^2, and a small entry; against the plain version and, bit
    # for bit, against the staged route (one launch per dependent stage)
    for n, pre, post in ((257, 1, 2), (257, 3, 3), (129, 1, 2), (129, 3, 3), (17, 1, 2)):
        _, r_n, dr_n, dz_n = level(n)
        psi_n, src_n = rand(n, n), rand(n, n)
        vc_args = (psi_n, src_n, r_n, dr_n, dz_n, 1.0)
        vc_kw = dict(pre_smooth=pre, post_smooth=post, min_grid=5, coarse_sweeps=50)
        cb.reset_launch_counts()
        v_k = cuda_mg.fused_coarse_vcycle(*vc_args, **vc_kw)
        require(dict(cb.LAUNCHES) == {"scpn_fused_vcycle": 1},
                f"fused_coarse_vcycle made {dict(cb.LAUNCHES)}, not one launch")
        v_s = cuda_mg._fused_coarse_vcycle_staged(*vc_args, **vc_kw)
        staged_launches = cb.kernel_launches() - 1
        v_p = cuda_mg.fused_coarse_vcycle_plain(*vc_args, **vc_kw)
        torch.cuda.synchronize()
        tag = f"{n}^2 ({pre},{post})"
        record("fused_coarse_vcycle", span_rel(v_k, v_p), SPAN_TOL, tag)
        abs_err("fused_coarse_vcycle", v_k, v_p)
        require(ring_equal(v_k, psi_n), f"fused_coarse_vcycle changed the Dirichlet ring at {tag}")
        require(torch.equal(v_k, v_s), f"one-launch V-cycle differs from the staged route at {tag}")
        print(f"  {tag}: equal to the staged route ({staged_launches} launches); one launch, "
              f"{vcycle_stages(n, pre, post, 5, 50)} dependent stages")
        if (n, pre) == (257, 1):
            timing["fused_coarse_vcycle"] = (
                lambda a=vc_args, kw=vc_kw: cuda_mg.fused_coarse_vcycle(*a, **kw),
                lambda a=vc_args, kw=vc_kw: cuda_mg.fused_coarse_vcycle_plain(*a, **kw),
                "257^2 (1,2)", vcycle_work(257, 1, 2, 5, 50))
            staged["fused_coarse_vcycle"] = (
                lambda a=vc_args, kw=vc_kw: cuda_mg._fused_coarse_vcycle_staged(*a, **kw))
    for bad_n, bad_min in ((513, 5), (257, 2)):
        _, r_n, dr_n, dz_n = level(bad_n)
        try:
            cuda_mg.fused_coarse_vcycle(rand(bad_n, bad_n), rand(bad_n, bad_n), r_n, dr_n, dz_n,
                                        1.0, min_grid=bad_min)
        except ValueError as exc:
            print(f"  fused_coarse_vcycle {bad_n}^2 min_grid={bad_min} raises: {exc}")
        else:
            raise AssertionError(f"fused_coarse_vcycle took {bad_n}^2 min_grid={bad_min}")

    # tiled legs (kernels 6 and 7): the cascade's 1025^2 level (1, 2), the
    # 2049^2 V-cycle's (3, 3) at 2049^2 and 4097^2, a ragged 129^2 tiling and
    # 513^2 (1, 2); against the plain version and, bit for bit, against the
    # first design of the kernels; one launch a call
    versus_fine = {}
    for n, pre, posts, t_rows in TILED_SHAPES:
        _, r_n, dr_n, dz_n = level(n)
        psi_n, src_n, e_n = rand(n, n), rand(n, n), rand_coarse(n)
        a = (psi_n, src_n, r_n, dr_n, dz_n, 1.0)
        pa = (psi_n, src_n, e_n, r_n, dr_n, dz_n, 1.0)
        tag = f"{n}^2" + ("" if t_rows is None else f" t_rows={t_rows}")
        cb.reset_launch_counts()
        ps_k, dc_k = cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=pre, t_rows=t_rows)
        require(dict(cb.LAUNCHES) == {"scpn_tiled_pre": 1},
                f"tiled_presmooth_restrict made {dict(cb.LAUNCHES)}, not one launch")
        ps_p, dc_p = cuda_mg_tiled.tiled_presmooth_restrict_plain(*a, pre_smooth=pre)
        ps_e, dc_e = cuda_mg_tiled._tiled_presmooth_restrict_slab(*a, pre_smooth=pre,
                                                                  t_rows=t_rows)
        torch.cuda.synchronize()
        require(torch.equal(ps_k, ps_e) and torch.equal(dc_k, dc_e),
                f"tiled_presmooth_restrict differs from its first design at {tag} pre={pre}")
        record("tiled_presmooth_restrict", span_rel(ps_k, ps_p), SPAN_TOL, f"{tag} pre={pre} psi_s")
        record("tiled_presmooth_restrict", span_rel(dc_k, dc_p), SPAN_TOL, f"{tag} pre={pre} d_c")
        abs_err("tiled_presmooth_restrict", ps_k, ps_p)
        abs_err("tiled_presmooth_restrict", dc_k, dc_p)
        require(ring_equal(ps_k, psi_n), f"tiled_presmooth_restrict changed the ring at {tag}")
        require(ring_equal(dc_k, torch.zeros_like(dc_k)), f"coarse defect ring not zero at {tag}")
        po_k = {}
        for post in posts:
            cb.reset_launch_counts()
            po_k[post] = cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=post, t_rows=t_rows)
            require(dict(cb.LAUNCHES) == {"scpn_tiled_post": 1},
                    f"tiled_prolong_smooth made {dict(cb.LAUNCHES)}, not one launch")
            po_p = cuda_mg_tiled.tiled_prolong_smooth_plain(*pa, post_smooth=post)
            po_e = cuda_mg_tiled._tiled_prolong_smooth_slab(*pa, post_smooth=post, t_rows=t_rows)
            torch.cuda.synchronize()
            require(torch.equal(po_k[post], po_e),
                    f"tiled_prolong_smooth differs from its first design at {tag} post={post}")
            record("tiled_prolong_smooth", span_rel(po_k[post], po_p), SPAN_TOL,
                   f"{tag} post={post}")
            abs_err("tiled_prolong_smooth", po_k[post], po_p)
            require(ring_equal(po_k[post], psi_n),
                    f"tiled_prolong_smooth changed the ring at {tag}")
        print(f"  tiled legs {tag} pre={pre} post={posts}: psi and coarse defect equal to the "
              f"first design's; one launch a call")
        if n == 1025:
            for sweeps in (3, 1):
                turn_times.append((
                    f"tiled down leg 1025^2 pre={sweeps}",
                    lambda a=a, k=sweeps: cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=k),
                    lambda a=a, k=sweeps: cuda_mg_tiled._tiled_presmooth_restrict_slab(
                        *a, pre_smooth=k),
                    leg_work(1025, sweeps, "down")))
            for sweeps in (3, 2):
                turn_times.append((
                    f"tiled up leg 1025^2 post={sweeps}",
                    lambda pa=pa, k=sweeps: cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=k),
                    lambda pa=pa, k=sweeps: cuda_mg_tiled._tiled_prolong_smooth_slab(
                        *pa, post_smooth=k),
                    leg_work(1025, sweeps, "up")))
            # against the fine legs, which take any size
            fs_k, fd_k = cuda_mg.fine_presmooth_restrict(*a, pre_smooth=pre)
            fo_k = cuda_mg.fine_prolong_smooth(*pa, post_smooth=2)
            torch.cuda.synchronize()
            record("tiled_presmooth_restrict", span_rel(ps_k, fs_k), SPAN_TOL,
                   "1025^2 pre=1 psi_s vs fine_presmooth_restrict")
            record("tiled_presmooth_restrict", span_rel(dc_k, fd_k), SPAN_TOL,
                   "1025^2 pre=1 d_c vs fine_presmooth_restrict")
            record("tiled_prolong_smooth", span_rel(po_k[2], fo_k), SPAN_TOL,
                   "1025^2 post=2 vs fine_prolong_smooth")
        if n == 2049:
            timing["tiled_presmooth_restrict"] = (
                lambda a=a: cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=3),
                lambda a=a: cuda_mg_tiled.tiled_presmooth_restrict_plain(*a, pre_smooth=3),
                "2049^2 pre=3", leg_work(2049, 3, "down"))
            timing["tiled_prolong_smooth"] = (
                lambda pa=pa: cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=3),
                lambda pa=pa: cuda_mg_tiled.tiled_prolong_smooth_plain(*pa, post_smooth=3),
                "2049^2 post=3", leg_work(2049, 3, "up"))
            staged["tiled_presmooth_restrict"] = (
                lambda a=a: cuda_mg_tiled._tiled_presmooth_restrict_slab(*a, pre_smooth=3))
            staged["tiled_prolong_smooth"] = (
                lambda pa=pa: cuda_mg_tiled._tiled_prolong_smooth_slab(*pa, post_smooth=3))
            versus_fine["tiled_presmooth_restrict"] = (
                lambda a=a: cuda_mg.fine_presmooth_restrict(*a, pre_smooth=3))
            versus_fine["tiled_prolong_smooth"] = (
                lambda pa=pa: cuda_mg.fine_prolong_smooth(*pa, post_smooth=3))

    # the tiled legs at 513^2 (1, 2), where the paths take the fine legs:
    # held against those and timed beside them (printed only)
    a = (psi, src, r513, dr513, dz513, 1.0)
    pa = (psi, src, e_c, r513, dr513, dz513, 1.0)
    ts_k, td_k = cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=1)
    fs_k, fd_k = cuda_mg.fine_presmooth_restrict(*a, pre_smooth=1)
    to_k = cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=2)
    fo_k = cuda_mg.fine_prolong_smooth(*pa, post_smooth=2)
    torch.cuda.synchronize()
    record("tiled_presmooth_restrict", span_rel(ts_k, fs_k), SPAN_TOL,
           "513^2 pre=1 psi_s vs fine_presmooth_restrict")
    record("tiled_presmooth_restrict", span_rel(td_k, fd_k), SPAN_TOL,
           "513^2 pre=1 d_c vs fine_presmooth_restrict")
    record("tiled_prolong_smooth", span_rel(to_k, fo_k), SPAN_TOL,
           "513^2 post=2 vs fine_prolong_smooth")
    turn_times.append((
        "tiled down leg 513^2 pre=1",
        lambda a=a: cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=1),
        lambda a=a: cuda_mg_tiled._tiled_presmooth_restrict_slab(*a, pre_smooth=1),
        leg_work(513, 1, "down")))
    turn_times.append((
        "tiled up leg 513^2 post=2",
        lambda pa=pa: cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=2),
        lambda pa=pa: cuda_mg_tiled._tiled_prolong_smooth_slab(*pa, post_smooth=2),
        leg_work(513, 2, "up")))
    extra_times.append((
        "down leg 513^2 pre=1",
        ("tiled", lambda a=a: cuda_mg_tiled.tiled_presmooth_restrict(*a, pre_smooth=1)),
        ("fine leg", lambda a=a: cuda_mg.fine_presmooth_restrict(*a, pre_smooth=1)),
        leg_work(513, 1, "down")))
    extra_times.append((
        "up leg 513^2 post=2",
        ("tiled", lambda pa=pa: cuda_mg_tiled.tiled_prolong_smooth(*pa, post_smooth=2)),
        ("fine leg", lambda pa=pa: cuda_mg.fine_prolong_smooth(*pa, post_smooth=2)),
        leg_work(513, 2, "up")))
    phase_done("kernel checks")

    @contextlib.contextmanager
    def staged_kernels():
        """Run the solvers through the staged predecessors of the two
        one-launch kernels (the solvers look both up in their modules), the
        source's parameters packed anew in every call as they used to be."""
        def staged_source(psi_k, r_1d, mask, params, **kw):
            return cuda_source._fused_topology_source_staged(
                psi_k, r_1d, mask, params.p_coeffs, params.ff_coeffs, params.i_target, **kw)

        saved = cuda_mg.fused_coarse_vcycle, cuda_source.fused_topology_source
        cuda_mg.fused_coarse_vcycle = cuda_mg._fused_coarse_vcycle_staged
        cuda_source.fused_topology_source = staged_source
        try:
            yield
        finally:
            cuda_mg.fused_coarse_vcycle, cuda_source.fused_topology_source = saved

    @contextlib.contextmanager
    def staged_fine_legs():
        """Run the solvers' 513^2 levels through the staged fine legs, one
        launch per dependent stage (``_vcycle_impl`` looks the legs up in
        their module)."""
        saved = cuda_mg.fine_presmooth_restrict, cuda_mg.fine_prolong_smooth
        cuda_mg.fine_presmooth_restrict = cuda_mg._presmooth_restrict_launch
        cuda_mg.fine_prolong_smooth = cuda_mg._prolong_smooth_launch
        try:
            yield
        finally:
            cuda_mg.fine_presmooth_restrict, cuda_mg.fine_prolong_smooth = saved

    @contextlib.contextmanager
    def staged_sor():
        """Run the solvers' ``sor_sweeps`` calls through the staged route (a
        copy, then one launch a half-sweep; the solvers and ``multigrid.smooth``
        look the wrapper up in its module)."""
        saved = cuda_stencil.sor_sweeps
        cuda_stencil.sor_sweeps = cuda_stencil._sor_sweeps_staged
        try:
            yield
        finally:
            cuda_stencil.sor_sweeps = saved

    @contextlib.contextmanager
    def first_design_tiled_legs():
        """Run the solvers' tiled levels through the first design of the
        tiled kernels (``_vcycle_impl`` looks the legs up in their module)."""
        saved = cuda_mg_tiled.tiled_presmooth_restrict, cuda_mg_tiled.tiled_prolong_smooth
        cuda_mg_tiled.tiled_presmooth_restrict = cuda_mg_tiled._tiled_presmooth_restrict_slab
        cuda_mg_tiled.tiled_prolong_smooth = cuda_mg_tiled._tiled_prolong_smooth_slab
        try:
            yield
        finally:
            cuda_mg_tiled.tiled_presmooth_restrict, cuda_mg_tiled.tiled_prolong_smooth = saved

    # ── 4. the first slice: FMG 129 -> 257 -> 513 on the card ──
    cfg_k = bench_config(513, use_pallas=True)
    cfg_p = bench_config(513, use_pallas=False)
    fmg = dict(min_coarse=129, device=dev)

    cb.reset_launch_counts()
    res_k, info_k = solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)
    torch.cuda.synchronize()
    fmg_513 = res_k      # its X-point is refined in path (i)
    launches_513 = {name: cb.CALLS[name] for name in KERNELS}
    print(f"FMG with kernels: levels {info_k}")
    print(f"wrapper calls in the 513^2 FMG run: {launches_513}; __global__ launches "
          f"{cb.kernel_launches()} ({dict(cb.LAUNCHES)})")
    if [d["n"] for d in info_k] != [129, 257, 513]:
        raise AssertionError(f"unexpected cascade {info_k}")
    if not all(d["converged"] for d in info_k):
        raise AssertionError("the kernel cascade did not converge at every level")
    # One source and one V-cycle per Picard iteration; every V-cycle ends in
    # one fused coarse V-cycle (257^2 and below: one launch, its coarsest
    # solve inside it, so sor_sweeps is not called); only the 513^2
    # iterations take the fine legs.
    picard = sum(d["iterations"] for d in info_k)
    fine = info_k[-1]["iterations"]
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(fused_topology_source=picard, fine_presmooth_restrict=fine,
                    fine_prolong_smooth=fine, fused_coarse_vcycle=picard)
    if launches_513 != expected:
        raise AssertionError(f"wrapper calls {launches_513} != expected {expected}")
    if not (cb.LAUNCHES["scpn_fused_vcycle"] == cb.LAUNCHES["scpn_fused_source"] == picard):
        raise AssertionError(f"the one-launch kernels made {dict(cb.LAUNCHES)}, not one launch "
                             f"a call over {picard} Picard iterations")
    psi_k = res_k.psi
    if tuple(psi_k.shape) != (513, 513) or not bool(torch.isfinite(psi_k).all()):
        raise AssertionError("kernel cascade psi is not a finite 513x513 field")

    res_p, info_p = solve_equilibrium_fmg(cfg_p, dtype=torch.float32, **fmg)
    res_64, info_64 = solve_equilibrium_fmg(cfg_p, dtype=torch.float64, **fmg)
    torch.cuda.synchronize()
    dev_p = span_rel(psi_k, res_p.psi)
    dev_64 = span_rel(psi_k.double(), res_64.psi)
    print(f"FMG plain f32: levels {info_p}")
    print(f"FMG plain f64: levels {info_64}")
    print(f"per-level iterations: kernels {[d['iterations'] for d in info_k]}, "
          f"plain f32 {[d['iterations'] for d in info_p]}, "
          f"plain f64 {[d['iterations'] for d in info_64]}")
    print(f"psi span-rel: kernels vs plain f32 {dev_p:.3e}, kernels vs plain f64 {dev_64:.3e} "
          f"(limit {SLICE_TOL:.0e})")
    if not (res_p.converged and res_64.converged):
        raise AssertionError("a plain cascade did not converge")
    if abs(info_k[-1]["iterations"] - info_p[-1]["iterations"]) > 1:
        raise AssertionError("fine-level iteration counts differ by more than 1")
    if not (dev_p <= SLICE_TOL and dev_64 <= SLICE_TOL):
        raise AssertionError("kernel cascade deviates from the plain cascades")

    with staged_kernels():
        res_s, info_s = solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)
    torch.cuda.synchronize()
    print(f"FMG with the staged kernels: levels {info_s}; psi equal to the one-launch "
          f"kernels' {torch.equal(res_s.psi, psi_k)}")
    if info_s != info_k or not torch.equal(res_s.psi, psi_k):
        raise AssertionError("the 513^2 cascade differs between one-launch and staged kernels")

    cb.reset_launch_counts()
    with staged_fine_legs():
        res_f, info_f = solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)
    torch.cuda.synchronize()
    print(f"FMG with the staged fine legs: levels {info_f}; psi equal to the one-launch "
          f"legs' {torch.equal(res_f.psi, psi_k)}; launches {dict(cb.LAUNCHES)}")
    if info_f != info_k or not torch.equal(res_f.psi, psi_k):
        raise AssertionError("the 513^2 cascade differs between one-launch and staged fine legs")
    if (cb.LAUNCHES["scpn_defect_restrict"], cb.LAUNCHES["scpn_prolong_correct"],
            cb.LAUNCHES["scpn_fine_pre"], cb.LAUNCHES["scpn_fine_post"]) != (fine, fine, 0, 0):
        raise AssertionError(f"the staged-fine-leg run launched {dict(cb.LAUNCHES)}")

    res_d = solve_equilibrium(cfg_k, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"direct 513^2 solve with kernels: converged {res_d.converged}, "
          f"iterations {res_d.iterations}, span-rel vs FMG {span_rel(res_d.psi, psi_k):.3e}")
    if not res_d.converged or not bool(torch.isfinite(res_d.psi).all()):
        raise AssertionError("the direct 513^2 solve did not converge")

    src_v = torch.zeros_like(psi)
    src_v.copy_(src)
    cb.reset_launch_counts()
    _vcycle_impl(psi, src_v, r513, dr513, dz513, 1.0, 1, 2, 5, 50, True)
    torch.cuda.synchronize()
    print(f"one 513^2 V-cycle (1,2) with kernels: {cb.kernel_launches()} __global__ launches "
          f"({dict(cb.LAUNCHES)}), wrapper calls {dict(cb.CALLS)}")
    if dict(cb.LAUNCHES) != {"scpn_fine_pre": 1, "scpn_fine_post": 1, "scpn_fused_vcycle": 1}:
        raise AssertionError(f"513^2 V-cycle made {dict(cb.LAUNCHES)}, not one launch a fine "
                             "leg and one fused V-cycle")
    if dict(cb.CALLS) != {"fine_presmooth_restrict": 1, "fine_prolong_smooth": 1,
                          "fused_coarse_vcycle": 1}:
        raise AssertionError(f"513^2 V-cycle did not take the fine route: {dict(cb.CALLS)}")
    phase_done("513^2 slice")

    # ── 5. the second slice: FMG 129 -> ... -> 1025 (f32) -> 2049 mixed on the card ──
    # the cascade of run_resolution_scaling.py's capability_2049_mixed lane
    # (validation/run_resolution_scaling.py in the port), one element:
    # solve_equilibrium_mixed_fmg from 129^2
    cas2_k = rs.Cascade(2049, dev, mixed=True)
    cas2_p = rs.Cascade(2049, dev, mixed=True, use_pallas=False)
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launch_counts()
    res2_k, info2_k = cas2_k.solve()
    torch.cuda.synchronize()
    launches = {name: cb.CALLS[name] for name in KERNELS}
    peak_mb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e6
    print(f"mixed 2049^2 cascade with kernels: levels {info2_k}")
    print(f"wrapper calls in the 2049^2 mixed run: {launches}; __global__ launches "
          f"{cb.kernel_launches()} ({dict(cb.LAUNCHES)})")
    print(f"peak device memory of the mixed cascade: {peak_mb:.1f} MB above the "
          f"{base_bytes / 1e6:.1f} MB already allocated [{card}]")
    if [d["n"] for d in info2_k] != [129, 257, 513, 1025, 2049]:
        raise AssertionError(f"unexpected mixed cascade {info2_k}")
    if not all(d["converged"] for d in info2_k):
        raise AssertionError("the mixed kernel cascade did not converge at every level")
    gs_k = float(res2_k.gs_residual)
    print(f"final f64 GS residual {gs_k!r} (limit {GS_TOL:.0e})")
    if not gs_k < GS_TOL:
        raise AssertionError(f"final f64 GS residual {gs_k} >= {GS_TOL}")
    psi2_k = res2_k.psi
    if (tuple(psi2_k.shape) != (2049, 2049) or psi2_k.dtype != torch.float64
            or not bool(torch.isfinite(psi2_k).all())):
        raise AssertionError("mixed cascade psi is not a finite 2049x2049 float64 field")
    # Per level: one source and one V-cycle per f32 Picard iteration; the
    # 2049^2 level takes the plain f64 source and n_refine = 2 f32 V-cycles
    # (2049 -> 1025 tiled, 513 fine legs, 257 fused) per iteration.
    it = {d["n"]: d["iterations"] for d in info2_k}
    f32_its = it[129] + it[257] + it[513] + it[1025]
    vcycles = f32_its + 2 * it[2049]
    expected2 = dict.fromkeys(KERNELS, 0)
    expected2.update(fused_topology_source=f32_its,
                     fine_presmooth_restrict=it[513] + it[1025] + 2 * it[2049],
                     fine_prolong_smooth=it[513] + it[1025] + 2 * it[2049],
                     fused_coarse_vcycle=vcycles,
                     tiled_presmooth_restrict=it[1025] + 4 * it[2049],
                     tiled_prolong_smooth=it[1025] + 4 * it[2049])
    if launches != expected2:
        raise AssertionError(f"wrapper calls {launches} != expected {expected2}")
    if (cb.LAUNCHES["scpn_fused_vcycle"], cb.LAUNCHES["scpn_fused_source"]) != (vcycles, f32_its):
        raise AssertionError(f"the one-launch kernels made {dict(cb.LAUNCHES)}, not one launch "
                             "a call")

    with staged_kernels():
        res2_s, info2_s = cas2_k.solve()
    torch.cuda.synchronize()
    print(f"mixed 2049^2 cascade with the staged kernels: levels {info2_s}, final f64 GS "
          f"residual {float(res2_s.gs_residual)!r}; psi equal to the one-launch kernels' "
          f"{torch.equal(res2_s.psi, psi2_k)}")
    if info2_s != info2_k or not torch.equal(res2_s.psi, psi2_k):
        raise AssertionError("the mixed cascade differs between one-launch and staged kernels")

    fine2 = launches["fine_presmooth_restrict"]
    cb.reset_launch_counts()
    with staged_fine_legs():
        res2_f, info2_f = cas2_k.solve()
    torch.cuda.synchronize()
    print(f"mixed 2049^2 cascade with the staged fine legs: levels {info2_f}, final f64 GS "
          f"residual {float(res2_f.gs_residual)!r}; psi equal to the one-launch legs' "
          f"{torch.equal(res2_f.psi, psi2_k)}; launches {dict(cb.LAUNCHES)}")
    if (info2_f != info2_k or not torch.equal(res2_f.psi, psi2_k)
            or float(res2_f.gs_residual) != gs_k):
        raise AssertionError("the mixed cascade differs between one-launch and staged fine legs")
    if (cb.LAUNCHES["scpn_defect_restrict"], cb.LAUNCHES["scpn_prolong_correct"],
            cb.LAUNCHES["scpn_fine_pre"], cb.LAUNCHES["scpn_fine_post"]) != (fine2, fine2, 0, 0):
        raise AssertionError(f"the staged-fine-leg run launched {dict(cb.LAUNCHES)}")

    cb.reset_launch_counts()
    with first_design_tiled_legs():
        res2_e, info2_e = cas2_k.solve()
    torch.cuda.synchronize()
    print(f"mixed 2049^2 cascade with the first design of the tiled legs: levels {info2_e}, "
          f"final f64 GS residual {float(res2_e.gs_residual)!r}; psi equal to the redesigned "
          f"kernels' {torch.equal(res2_e.psi, psi2_k)}; launches {dict(cb.LAUNCHES)}")
    if (info2_e != info2_k or not torch.equal(res2_e.psi, psi2_k)
            or float(res2_e.gs_residual) != gs_k):
        raise AssertionError("the mixed cascade differs between the tiled legs and their "
                             "first design")
    if (cb.LAUNCHES["scpn_tiled_pre_slab"], cb.LAUNCHES["scpn_tiled_post_slab"],
            cb.LAUNCHES["scpn_tiled_pre"], cb.LAUNCHES["scpn_tiled_post"]) != (
                launches["tiled_presmooth_restrict"], launches["tiled_prolong_smooth"], 0, 0):
        raise AssertionError(f"the first-design run launched {dict(cb.LAUNCHES)}")

    res2_p, info2_p = cas2_p.solve()
    torch.cuda.synchronize()
    dev2 = span_rel(psi2_k, res2_p.psi)
    print(f"mixed 2049^2 cascade plain: levels {info2_p}, final f64 GS residual "
          f"{float(res2_p.gs_residual)!r}")
    print(f"per-level iterations: kernels {[d['iterations'] for d in info2_k]}, "
          f"plain {[d['iterations'] for d in info2_p]}")
    print(f"psi span-rel: mixed kernels vs mixed plain {dev2:.3e} (limit {SLICE_TOL:.0e})")
    if not res2_p.converged:
        raise AssertionError("the plain mixed cascade did not converge")
    if abs(info2_k[-1]["iterations"] - info2_p[-1]["iterations"]) > 1:
        raise AssertionError("2049^2 iteration counts differ by more than 1")
    if not dev2 <= SLICE_TOL:
        raise AssertionError("mixed kernel cascade deviates from the plain cascade")

    g2049, r2049, dr2049, dz2049 = level(2049)
    defect = rand(2049, 2049)
    cb.reset_launch_counts()
    _vcycle_impl(torch.zeros_like(defect), defect, r2049, dr2049, dz2049, 1.0, 3, 3, 5, 50, True)
    torch.cuda.synchronize()
    print(f"one 2049^2 V-cycle (3,3) with kernels: {cb.kernel_launches()} __global__ launches "
          f"({dict(cb.LAUNCHES)}), wrapper calls {dict(cb.CALLS)}")
    if dict(cb.CALLS) != {"tiled_presmooth_restrict": 2, "tiled_prolong_smooth": 2,
                          "fine_presmooth_restrict": 1, "fine_prolong_smooth": 1,
                          "fused_coarse_vcycle": 1}:
        raise AssertionError(f"2049^2 V-cycle did not take the tiled route: {dict(cb.CALLS)}")
    if cb.LAUNCHES["scpn_fused_vcycle"] != 1:
        raise AssertionError(f"2049^2 V-cycle made {dict(cb.LAUNCHES)}: not one fused launch")
    phase_done("2049^2 mixed slice")


    # ── 6. the anderson solver at 129^2: 50 sweeps of sor_sweeps an iteration ──
    def sor_cfg(use_pallas):
        return config_from_dict(config_dict(
            129, **{**BENCH_SOLVER, "solver_method": "anderson", "inner_sweeps": SOR_SWEEPS,
                    "sor_omega": SOR_OMEGA}, use_pallas=use_pallas))

    cb.reset_launch_counts()
    res3_k = solve_equilibrium(sor_cfg(True), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    launches_sor = {name: cb.CALLS[name] for name in KERNELS}
    launches3 = dict(cb.LAUNCHES)
    res3_p = solve_equilibrium(sor_cfg(False), dtype=torch.float32, device=dev)
    with staged_sor():
        res3_s = solve_equilibrium(sor_cfg(True), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    dev3 = span_rel(res3_k.psi, res3_p.psi)
    print(f"anderson 129^2 solve ({SOR_SWEEPS} inner SOR sweeps, omega {SOR_OMEGA}): kernels "
          f"converged {res3_k.converged} in {res3_k.iterations}, plain converged "
          f"{res3_p.converged} in {res3_p.iterations}, psi span-rel {dev3:.3e} "
          f"(limit {SLICE_TOL:.0e}); wrapper calls {launches_sor}, __global__ launches "
          f"{launches3}; through the staged sor_sweeps {res3_s.iterations} iterations, psi "
          f"equal {torch.equal(res3_s.psi, res3_k.psi)}")
    if not (res3_k.converged and res3_p.converged):
        raise AssertionError("an anderson 129^2 solve did not converge")
    if abs(res3_k.iterations - res3_p.iterations) > 1:
        raise AssertionError("anderson 129^2 iteration counts differ by more than 1")
    if not dev3 <= SLICE_TOL or not bool(torch.isfinite(res3_k.psi).all()):
        raise AssertionError("the anderson 129^2 kernel solve deviates from the plain solve")
    if res3_s.iterations != res3_k.iterations or not torch.equal(res3_s.psi, res3_k.psi):
        raise AssertionError("the anderson 129^2 solve differs through the staged sor_sweeps")
    expected3 = {name: 0 for name in KERNELS}
    expected3.update(sor_sweeps=res3_k.iterations, fused_topology_source=res3_k.iterations)
    if launches_sor != expected3:
        raise AssertionError(f"wrapper calls {launches_sor} != expected {expected3}")
    if launches3 != {"scpn_sor_band": res3_k.iterations, "scpn_fused_source": res3_k.iterations}:
        raise AssertionError(f"anderson solve made {launches3}: not one launch a sor_sweeps call")
    phase_done("anderson 129^2 slice")

    # ── 7. this slice: the rectangular 257 x 129 solve on the card ──
    cfg4_k, cfg4_p = rect_config(use_pallas=True), rect_config(use_pallas=False)
    cb.reset_launch_counts()
    res4_k = solve_equilibrium(cfg4_k, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    launches_rect = {name: cb.CALLS[name] for name in KERNELS}
    launches4 = dict(cb.LAUNCHES)
    res4_p = solve_equilibrium(cfg4_p, dtype=torch.float32, device=dev)
    cb.reset_launch_counts()
    with staged_sor():
        res4_s = solve_equilibrium(cfg4_k, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    staged4 = dict(cb.LAUNCHES)
    dev4 = span_rel(res4_k.psi, res4_p.psi)
    it4 = res4_k.iterations
    print(f"rectangular {cfg4_k.grid_resolution[1]}x{cfg4_k.grid_resolution[0]} solve: kernels "
          f"converged {res4_k.converged} in {it4}, plain f32 converged {res4_p.converged} in "
          f"{res4_p.iterations}, psi span-rel {dev4:.3e} (limit {SLICE_TOL:.0e}); wrapper calls "
          f"{launches_rect}, __global__ launches {launches4}; through the staged sor_sweeps "
          f"{res4_s.iterations} iterations, psi equal {torch.equal(res4_s.psi, res4_k.psi)}, "
          f"launches {staged4}")
    if tuple(res4_k.psi.shape) != (257, 129) or not bool(torch.isfinite(res4_k.psi).all()):
        raise AssertionError("the rectangular solve's psi is not a finite 257x129 field")
    if not (res4_k.converged and res4_p.converged):
        raise AssertionError("a rectangular solve did not converge")
    if abs(it4 - res4_p.iterations) > 1:
        raise AssertionError("rectangular iteration counts differ by more than 1")
    if not dev4 <= SLICE_TOL:
        raise AssertionError("the rectangular kernel solve deviates from the plain solve")
    # One V-cycle an iteration: levels 257x129, 129x65, 65x33, 33x17, 17x9 at
    # one pre- and one post-smoothing call each, and the 9x5 coarsest solve.
    expected4 = {name: 0 for name in KERNELS}
    expected4.update(sor_sweeps=11 * it4, fused_topology_source=it4)
    if launches_rect != expected4:
        raise AssertionError(f"wrapper calls {launches_rect} != expected {expected4}")
    if launches4 != {"scpn_sor_band": 11 * it4, "scpn_fused_source": it4}:
        raise AssertionError(f"the rectangular solve made {launches4}: not one launch a "
                             "sor_sweeps call")
    if res4_s.iterations != it4 or not torch.equal(res4_s.psi, res4_k.psi):
        raise AssertionError("the rectangular solve differs through the staged sor_sweeps")
    phase_done("rectangular slice")

    # ── 8. this slice: the free-boundary forward, the G-EQDSK reconstruction
    # and the Newton-Krylov solve on the card ──
    f32, f64 = torch.float32, torch.float64

    def counted(run):
        """``run()`` between a reset and a read of the counters: (result,
        wrapper calls by kernel, __global__ launches by C entry)."""
        cb.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        return out, {name: cb.CALLS[name] for name in KERNELS}, dict(cb.LAUNCHES)

    def fb_solve(n, use_pallas, dtype=f32, coils=None, **kw):
        """The forward of run_free_boundary_forward.py's lanes (its module in
        the port), Anderson's Gram in f32 where the solve is f64."""
        return fbf.forward_solve(n, device=dev, dtype=dtype, use_pallas=use_pallas, coils=coils,
                                 **kw)

    def fb_line(res):
        return (f"converged {res.converged} in {res.outer_iterations} outer iterations (last "
                f"inner solve {res.equilibrium.iterations}), final max |dpsi| "
                f"{float(res.final_diff)!r}")

    def source_and_vcycle(tag, calls, launched):
        """Kernels 2 and 3 once each an inner Picard iteration, one launch a
        call, and no other kernel."""
        n_src = calls["fused_topology_source"]
        require(n_src == calls["fused_coarse_vcycle"] > 0,
                f"{tag}: source and V-cycle calls {calls}, not equal and > 0")
        require(all(v == 0 for k, v in calls.items()
                    if k not in ("fused_topology_source", "fused_coarse_vcycle")),
                f"{tag}: other kernels called: {calls}")
        require(launched == {"scpn_fused_source": n_src, "scpn_fused_vcycle": n_src},
                f"{tag}: launches {launched}, not one a call")

    by_path = {"fmg_513": launches_513, "mixed_2049": dict(launches),
               "anderson_129": launches_sor, "rect_257x129": launches_rect}
    fb_runs = {}    # tag -> (kernel solve, plain solve) for the times
    fb_results = {}   # tag -> the kernel solve's result

    # (a) and (b): the validation's warm forward lanes, 257^2 and 129^2 in
    # float32, kernels against plain float32
    for tag, n, kw in (("fb_257", 257, dict(max_outer_iter=40, tol=3e-4)),
                       ("fb_129", 129, dict(max_outer_iter=16, tol=2.5e-4))):
        res_k, calls, launched = counted(lambda n=n, kw=kw: fb_solve(n, True, **kw))
        res_p = fb_solve(n, False, **kw)
        torch.cuda.synchronize()
        dev_fb = span_rel(res_k.psi, res_p.psi)
        print(f"free boundary {n}^2 f32 (max_outer {kw['max_outer_iter']}, tol {kw['tol']}): "
              f"kernels {fb_line(res_k)}; plain f32 {fb_line(res_p)}; psi span-rel {dev_fb:.3e} "
              f"(limit {SLICE_TOL:.0e}); wrapper calls {calls}, __global__ launches {launched}")
        require(tuple(res_k.psi.shape) == (n, n) and bool(torch.isfinite(res_k.psi).all()),
                f"free boundary {n}^2: psi is not a finite {n}x{n} field")
        require(res_k.converged and res_p.converged, f"a free-boundary {n}^2 solve did not "
                                                     "converge")
        require(abs(res_k.outer_iterations - res_p.outer_iterations) <= 1,
                f"free boundary {n}^2: outer iteration counts differ by more than 1")
        require(dev_fb <= SLICE_TOL, f"free boundary {n}^2: kernels deviate from plain f32")
        source_and_vcycle(f"free boundary {n}^2", calls, launched)
        by_path[tag] = calls
        fb_results[tag] = res_k
        fb_runs[tag] = (lambda n=n, kw=kw: fb_solve(n, True, **kw),
                        lambda n=n, kw=kw: fb_solve(n, False, **kw))

    # (c): 129^2 float64, the plain f64 solve against the mixed solve (f64
    # outer loop and source, f32 V-cycles through the kernel, n_refine 2)
    kw64 = dict(max_outer_iter=16, tol=1e-4)
    res_64 = fb_solve(129, False, f64, **kw64)
    res_mx, calls_mx, launched_mx = counted(
        lambda: fb_solve(129, True, f64, mixed_n_refine=2, **kw64))
    dev_mx = span_rel(res_mx.psi, res_64.psi)
    print(f"free boundary 129^2 f64: plain {fb_line(res_64)}; mixed with kernels "
          f"{fb_line(res_mx)}; psi span-rel {dev_mx:.3e} (limit {MIXED_FB_TOL:.0e}); wrapper "
          f"calls {calls_mx}, __global__ launches {launched_mx}")
    require(res_64.converged and res_mx.converged, "a free-boundary 129^2 f64 solve did not "
                                                   "converge")
    require(res_mx.outer_iterations == res_64.outer_iterations,
            "free boundary 129^2: mixed and plain f64 outer counts differ")
    require(res_mx.psi.dtype == f64 and dev_mx <= MIXED_FB_TOL,
            "free boundary 129^2: the mixed solve deviates from plain f64")
    n_vc = calls_mx["fused_coarse_vcycle"]
    require(n_vc > 0 and n_vc % 2 == 0 and calls_mx["fused_topology_source"] == 0
            and sum(calls_mx.values()) == n_vc and launched_mx == {"scpn_fused_vcycle": n_vc},
            f"free boundary 129^2 mixed: calls {calls_mx}, launches {launched_mx}; expected "
            "V-cycles only (two an inner iteration), one launch each, and no source kernel")
    by_path["fb_mixed_129"] = calls_mx
    fb_runs["fb_mixed_129"] = (lambda: fb_solve(129, True, f64, mixed_n_refine=2, **kw64),
                               lambda: fb_solve(129, False, f64, **kw64))

    # (d): 129^2 float32, coil currents re-fitted to 16 isoflux points within
    # limits of 8 every outer iteration, the plasma's wall flux in the ring
    fb_cfg = free_boundary_config(129)
    theta = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    iso_pts = torch.tensor(np.stack([6.0 + 2.0 * np.cos(theta), 2.4 * np.sin(theta)], 1),
                           dtype=f32, device=dev)
    coils0 = coilset_from_config(fb_cfg, f32, dev)._replace(
        target_flux_points=iso_pts, current_limits=torch.full((6,), 8.0, device=dev))
    kw_d = dict(max_outer_iter=16, tol=2.5e-4, optimize_shape=True, use_wall_response=True,
                coils=coils0)
    res_dk, calls_d, launched_d = counted(lambda: fb_solve(129, True, **kw_d))
    res_dp = fb_solve(129, False, **kw_d)
    torch.cuda.synchronize()
    m_iso = mutual_inductance_matrix(coils0.r, coils0.z, coils0.turns, iso_pts,
                                     FREE_BOUNDARY_MU0_GREEN)
    grid129 = Grid.from_config(fb_cfg, dtype=f32, device=dev)
    samples = interp_psi_at_points(res_dk.psi, grid129, iso_pts)
    target = samples.mean()
    rmse_new = float(((m_iso.T @ res_dk.coil_currents - target) ** 2).mean().sqrt())
    rmse_old = float(((m_iso.T @ coils0.currents - target) ** 2).mean().sqrt())
    dev_d = span_rel(res_dk.psi, res_dp.psi)
    print(f"free boundary 129^2 f32, optimize_shape + use_wall_response: kernels "
          f"{fb_line(res_dk)}, currents {res_dk.coil_currents.tolist()}; plain f32 "
          f"{fb_line(res_dp)}; psi span-rel {dev_d:.3e} (limit {SLICE_TOL:.0e}); isoflux RMSE "
          f"{rmse_new!r} with the fitted currents, {rmse_old!r} with the initial ones; wrapper "
          f"calls {calls_d}, __global__ launches {launched_d}")
    cur = res_dk.coil_currents
    require(bool(torch.isfinite(cur).all()) and bool((cur.abs() <= 8.0).all()),
            "optimize_shape: currents not finite or outside their limits")
    require(rmse_new <= rmse_old, "optimize_shape: the fitted currents miss the isoflux target "
                                  "by more than the initial currents")
    require(dev_d <= SLICE_TOL and bool(torch.isfinite(res_dk.psi).all()),
            "optimize_shape + wall: kernels deviate from plain f32")
    source_and_vcycle("free boundary 129^2 optimize_shape + wall", calls_d, launched_d)
    by_path["fb_shape_wall_129"] = calls_d
    shape_run = lambda: fb_solve(129, True, **kw_d)   # noqa: E731
    phase_done("free-boundary slice")


    # (e): the SPARC L-mode g-file on its 129 x 129 grid, float32, kernels
    # against plain float32
    eq_sparc = read_geqdsk(ROOT / "fuzz" / "seeds" / "geqdsk" / "sparc_lmode_hv.geqdsk")
    res_ek, calls_e, launched_e = counted(
        lambda: solve_from_geqdsk(eq_sparc, dtype=f32, device=dev))
    sparc_problem = _eqdsk_problem(eq_sparc, 0.1, None, f32, dev)

    def sparc_plain():
        """The entry point's solve (its defaults) with the kernels off."""
        return _solve_eqdsk_impl(*sparc_problem, max_iter=300, n_inner_cycles=1,
                                 use_pallas=False)

    res_ep = sparc_plain()
    torch.cuda.synchronize()
    dev_e = span_rel(res_ek.psi, res_ep.psi)
    print(f"SPARC g-file {eq_sparc.nh}x{eq_sparc.nw} f32: kernels converged {res_ek.converged} in "
          f"{res_ek.iterations}, span_rel_rmse vs the file {float(res_ek.span_rel_rmse)!r} "
          f"(core {float(res_ek.span_rel_rmse_core)!r}); plain f32 converged {res_ep.converged} in "
          f"{res_ep.iterations}, span_rel_rmse {float(res_ep.span_rel_rmse)!r} (core "
          f"{float(res_ep.span_rel_rmse_core)!r}); psi span-rel {dev_e:.3e} (limit "
          f"{SLICE_TOL:.0e}); wrapper calls {calls_e}, __global__ launches {launched_e}")
    require(res_ek.converged and res_ep.converged, "a SPARC reconstruction did not converge")
    require(abs(res_ek.iterations - res_ep.iterations) <= 1,
            "SPARC reconstruction: iteration counts differ by more than 1")
    require(dev_e <= SLICE_TOL and bool(torch.isfinite(res_ek.psi).all()),
            "SPARC reconstruction: kernels deviate from plain f32")
    require(calls_e["fused_coarse_vcycle"] == res_ek.iterations
            and sum(calls_e.values()) == res_ek.iterations
            and launched_e == {"scpn_fused_vcycle": res_ek.iterations},
            f"SPARC reconstruction: calls {calls_e}, launches {launched_e}; expected one fused "
            "V-cycle launch an iteration and nothing else")
    by_path["eqdsk_sparc"] = calls_e
    eq_runs = (lambda: solve_from_geqdsk(eq_sparc, dtype=f32, device=dev),
               sparc_plain)

    # (f): Newton-Krylov at 129^2 in float64 on the card (plain ops) against
    # the port's Picard float64 solve of the same machine
    nk_cfg = free_boundary_config(129, use_pallas=False)
    res_nk, calls_nk, _ = counted(lambda: solve_equilibrium_newton(nk_cfg, dtype=f64, device=dev))
    res_pic = solve_equilibrium(nk_cfg, dtype=f64, device=dev)
    torch.cuda.synchronize()
    dev_nk = span_rel(res_nk.psi, res_pic.psi)
    hist = res_nk.residual_history[:res_nk.iterations].tolist()
    print(f"Newton-Krylov 129^2 f64: converged {res_nk.converged} in {res_nk.iterations} "
          f"(limit {NEWTON_MAX_ITERS}), residual history {hist}; Picard f64 converged "
          f"{res_pic.converged} in {res_pic.iterations}; psi span-rel {dev_nk:.3e} (limit "
          f"{SLICE_TOL:.0e}); kernel calls {sum(calls_nk.values())}")
    require(res_nk.converged and res_nk.iterations <= NEWTON_MAX_ITERS,
            f"Newton did not converge in {NEWTON_MAX_ITERS} iterations")
    require(res_pic.converged and dev_nk <= SLICE_TOL,
            "Newton deviates from the Picard f64 fixed point")
    require(sum(calls_nk.values()) == 0, "Newton launched a kernel: it runs plain ops")
    phase_done("G-EQDSK and Newton slice")

    # ── the eighth slice: (g) the adjoint lane, (h) the real-shot reconstruction and
    # its profile refit, (i) the small lanes, each on plain ops; (g)'s FD
    # check last ──
    # (g) with its FD check and (h) run on the card in spawned processes beside
    # (i)-(l) (in line they took 130-190 s and ~120 s of host time)
    with cpu_twin(adjoint_on_card, card) as adjoint_card, \
            cpu_twin(recon_on_card) as recon_card, cpu_twin(recon_on_cpu) as recon_cpu:
        small_lanes(dev, card, counted, by_path, fmg_513, cfg_k, fb_results["fb_129"],
                    free_boundary_config(129), FREE_BOUNDARY_MU0_GREEN)
        phase_done("small lanes")

        # ── the ninth slice: the Thomas kernel against its plain version, then
        # (j) the coupled GS <-> transport solve, (k) the TORAX coarse tier and
        # (l) the small transport lanes ──
        library = {}    # name -> one PyTorch call of the same function, timed beside the kernel
        thomas_checks(dev, rng, results, timing, library, extra_times)
        phase_done("Thomas kernel checks")
        coupled_calls = coupled_lane(dev, card, counted, by_path)
        phase_done("coupled GS <-> transport")
        torax_lane(dev, card, counted, by_path, twins["torax_plain"], twins["torax_cpu"])
        phase_done("TORAX coarse tier")
        transport_lanes(dev, card, counted, by_path)
        phase_done("transport lanes")
        recon_lane(card, by_path, recon_card, recon_cpu)
        phase_done("real-shot reconstruction (h), spawned")
        by_path.update(adjoint_card())
        phase_done("adjoint lane and FD check (g), spawned")
    # (zh)'s twins start here, past the host-bound early paths they would slow
    psi_129 = fb_results["fb_129"].psi.detach().cpu().numpy()
    twins.update(late_twins(stack, psi_129, card))

    # ── the tenth slice: (m) the flight simulator's full lane (kernels 2-5 on
    # every tick), (n) the SCPN closed loop (one launch of csrc/closed_loop.cu
    # a shot) and (o) the plain-op control lanes ──
    flight_full_lane(dev, card, counted, by_path)
    phase_done("flight simulator full lane")
    measured_plain = {}     # name -> the plain version's ms, measured once on its path
    closed_calls = closed_loop_checks(dev, card, counted, by_path, results, timing,
                                      measured_plain)
    phase_done("SCPN closed loop")
    control_lanes(dev, card, counted, by_path, twins["control_card"], twins["control_cpu"])
    phase_done("control lanes")

    # ── the eleventh slice: (p) row R with the stress campaign and the PID
    # tuner through it, (q) the classical and robust controllers ──
    reduced_calls = reduced_shot_checks(dev, card, counted, by_path, results, timing,
                                        measured_plain)
    phase_done("reduced-shot kernel and campaigns (p)")
    controller_lanes(dev, card, counted, by_path, fmg_513, cfg_k)
    phase_done("controllers (q)")

    # ── the twelfth slice: (r) the ladder through rows L and N, (s) the
    # disruption predictors, (t) the learned controllers ──
    ladder_calls = ladder_checks(dev, card, counted, by_path, results, timing, measured_plain)
    phase_done("ladder (r)")
    predictor_lanes(dev, card, counted, by_path)
    phase_done("predictors (s)")
    learned_lanes(dev, card, counted, by_path)
    phase_done("learned controllers (t)")

    # ── the fourteenth slice: (u) the nonlinear GK run through row G, (v) the
    # reduced GK lanes on plain ops ──
    gk_calls = gk_nonlinear_lane(dev, card, counted, by_path, results, timing)
    phase_done("nonlinear GK (u)")
    gk_reduced_lanes(dev, card, counted, by_path, twins["gk_lanes_cpu"])
    phase_done("reduced GK lanes (v)")

    # ── the fifteenth slice: (w) row N's kinds 2 and 3 (the fueling shot, the
    # TORAX-style campaign), (x) row D (the digital twin) with the realtime twin
    # sessions, the FPGA export's report and the directed mission, (y) the bus
    # oracle through row R and the three-process bus session ──
    with cpu_twin(fueling_lanes_on_cpu) as fueling_cpu, cpu_twin(twin_lanes_on_cpu) as twin_cpu:
        fueling_checks(dev, card, counted, by_path, fueling_cpu)
        phase_done("fueling and campaign (w)")
        twin_calls = twin_checks(dev, card, counted, by_path, results, timing, measured_plain,
                                 twin_cpu)
        phase_done("digital twin (x)")
    bus_checks(dev, card, counted, by_path)
    phase_done("realtime bus (y)")

    # ── the sixteenth slice: (z) row B with the ballooning and EPED tiers,
    # (za) the controllers, RMF, the converters and the HIL lanes, (zb) rt-EFIT
    # at 129^2 and the control room (its psi lane on the 513^2 FMG psi) ──
    slice16 = twins["slice16_cpu"]()
    newcomb_calls = ballooning_checks(dev, card, counted, by_path, results, timing,
                                      measured_plain, slice16)
    phase_done("ballooning and EPED (z)")
    control_4b_checks(dev, card, counted, by_path, slice16)
    phase_done("controllers and HIL (za)")
    room_and_efit_checks(dev, card, counted, by_path, fmg_513.psi, slice16)
    phase_done("rt-EFIT and control room (zb)")

    # ── the seventeenth slice: (zc) row Q with the runaway models and SPI, (zd)
    # row S, (ze) the MHD modes, sawteeth, the stability suite (its eigen lane
    # through row B), ELMs and edge events ──
    slice17 = twins["slice17_cpu"]()
    disruption_calls = disruption_checks(dev, card, counted, by_path, results, timing,
                                         measured_plain, slice17)
    phase_done("disruption, runaways and SPI (zc)")
    sandpile_calls = sandpile_checks(dev, card, counted, by_path, results, timing, measured_plain,
                                     slice17)
    phase_done("sandpile (zd)")
    mhd_checks(dev, card, counted, by_path, slice17)
    phase_done("MHD, stability, ELMs and edge events (ze)")

    # ── the eighteenth slice: (zf) row P and its adjoint with the FRC, tilt and
    # Faraday lanes, (zg) the pulsed carrier and the Hall-MHD sandbox ──
    slice18 = twins["slice18_cpu"]()
    compression_calls = compression_checks(dev, card, counted, by_path, results, timing,
                                           measured_plain, twins["slice18_card"], slice18)
    phase_done("compression, FRC and Faraday recovery (zf)")
    hall_checks(dev, card, counted, by_path, slice18)
    phase_done("Hall-MHD carrier and sandbox (zg)")

    # ── the nineteenth slice: (zh) row F, the fast-ion ensemble and the
    # guiding-centre orbit, with the fast-ion lanes and the plain Boris and
    # lambda-field lanes; (zi) ICRH, ECRH, current drive, drift waves, the
    # divertor lab and the stellarator lane ──
    slice19 = twins["slice19_cpu"]()
    orbit_calls = orbit_checks(dev, card, counted, by_path, results, timing, measured_plain,
                               twins["slice19_card"], slice19)
    phase_done("fast ions and orbits (zh)")
    heating_checks(dev, card, counted, by_path, slice19)
    phase_done("heating, drift waves, divertor and stellarator (zi)")

    # ── the twentieth slice: (zj) rows E and H, the design scans, the quench
    # screen and the plant lanes; (zk) the blanket and TEMHD through row T,
    # wall loading, PWI, the heating-neutronics candidates and CAD loading ──
    slice20 = twins["slice20_cpu"]()
    burn_calls, quench_calls = plant_checks(dev, card, counted, by_path, results, timing,
                                            measured_plain, twins["slice20_card"], slice20)
    phase_done("rows E and H, design scans and plant lanes (zj)")
    zk_burns, _ = nuclear_checks(dev, card, counted, by_path, slice20)
    burn_calls += zk_burns
    phase_done("nuclear, heating-neutronics and CAD (zk)")

    # ── the twenty-first slice: (zl) the whole-device discharge, UQ, the
    # synthetic diagnostics, tomography and the quasi-3D contracts with their
    # validation lanes; (zm) row U, the Kuramoto and monitor lanes and the
    # replay certificate ──
    slice21 = twins["slice21_cpu"]()
    zl_checks(dev, card, counted, by_path, slice21, psi_129)
    phase_done("discharge, UQ, diagnostics, tomography and quasi-3D (zl)")
    phase_calls = phase_checks(dev, card, counted, by_path, results, timing, measured_plain,
                               twins["slice21_card"])
    phase_calls += zm_checks(dev, card, counted, by_path, slice21, twins["replay"])
    phase_done("row U, Kuramoto, monitor and replay (zm)")

    # ── the twenty-second slice: (zn) row W and the GyroSwin benchmark, the
    # committed artifacts, the surrogate trainers, the suppression loop and the
    # ESN oracles ──
    slice22 = twins["slice22_cpu"]()
    proxy_calls = proxy_checks(dev, card, counted, by_path, results, timing, measured_plain,
                               twins["slice22_card"])
    phase_done("row W and the GyroSwin benchmark (zn)")
    artifact_checks(dev, card, counted, by_path, slice22)
    phase_done("committed surrogate artifacts (zn)")
    trainer_checks(dev, card, counted, by_path, twins["slice22_fno"], twins["slice22_equilibrium"])
    phase_done("surrogate trainers (zn)")
    loop_checks(dev, card, counted, by_path, slice22)
    phase_done("suppression loop, ESN oracles and float64 lanes (zn)")

    # ── the twenty-third slice: (zo) the ensembles through the batched kernels 2
    # and 3, (zp) the sharded solves on one card's virtual shards ──
    batched_kernel_checks(dev, card, results, timing, measured_plain)
    phase_done("batched kernels 2 and 3 (zo)")
    ensemble_calls = ensemble_checks(dev, card, counted, by_path, twins["ensemble_cpu"])
    phase_done("ensemble lanes 1-4 and the straggler (zo)")
    sharded_checks(card, twins["sharded_card"])
    phase_done("sharded solves on virtual shards (zp)")

    # ── the twenty-fourth slice: (zq) the sharded 5-D GK runs through row G on
    # every shard, (zr) the carried-over host lanes, in a spawned process ──
    slice24 = twins["slice24_card"]()
    by_path.update(slice24["by_path"])
    print(f"(zq) and (zr) on the card in a spawned process (started after (l)): "
          f"{slice24['zq_s']:.1f} s and {slice24['zr_s']:.1f} s [{card}]")
    phase_done("sharded GK (zq) and carried-over lanes (zr), spawned")

    # ── the twenty-fifth slice: (zs) the CLI and ui/ on the card, in a
    # spawned process (the kernel mode's 513^2 solve through kernels 2-5) ──
    t_wait = time.perf_counter()
    slice25 = twins["slice25_card"]()
    waited = time.perf_counter() - t_wait
    by_path.update(slice25["by_path"])
    print(f"(zs) the CLI and ui/ on the card in a spawned process (started after (l)): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in slice25["secs"].items())
          + f"; the main line waited {waited:.2f} s for it [{card}]")
    phase_done("the CLI and ui/ (zs), spawned")

    # the campaigns whose lanes gate a time (the reference's H100 rows,
    # on_scaling's ratio, batched amortisation, cold against warm) run here,
    # every spawned process ended and the card doing nothing else: beside
    # (g)-(zo) their times rose two to four times
    import multiprocessing
    print(f"(zo), (5b) and (8b): the timed campaigns in the main line, "
          f"{len(multiprocessing.active_children())} other processes of the smoke alive "
          f"[{card}]")
    for name, calls in batched_campaign(dev, card, counted, by_path).items():
        ensemble_calls[name] += calls
    phase_done("batched_amortisation (zo), the card otherwise idle")
    by_path.update(equilibrium_campaigns(card))
    phase_done("resolution_scaling (5b) and free_boundary_forward (8b), the card otherwise idle")

    # every campaign of the port but tracking_acceptance (the second command,
    # ``chip_smoke.py tracking``) ran once on the card, in its phase or in
    # (zs): each report's lanes against the committed JAX report's
    from scpn_fusion_tpu_torch.validation import CAMPAIGNS, collect_results
    overall = {}
    for name in sorted(set(CAMPAIGNS) - {"tracking_acceptance"}):
        require((REPORTS_DIR / f"{name}.json").exists(), f"campaign {name} wrote no report")
        campaign_check(name, None, card, "(campaigns)")
        overall[name] = json.loads((REPORTS_DIR / f"{name}.json").read_text())["overall_status"]
    collect_results.main()
    print(f"{len(overall)} of the {len(CAMPAIGNS)} campaigns ran once on the card (the "
          f"20th, tracking_acceptance, is `chip_smoke.py tracking`), each lane's status the "
          f"committed JAX report's but {sorted(VALIDATE_STANDING)} and the lanes blocked for "
          f"want of the reference's data: {overall} [{card}]")

    # every kernel's launches over the path that runs it: kernels 2 and 3
    # over this slice's main path, the 257^2 free-boundary forward
    launches["sor_sweeps"] = launches_rect["sor_sweeps"]
    launches["fused_topology_source"] = by_path["fb_257"]["fused_topology_source"]
    launches["fused_coarse_vcycle"] = by_path["fb_257"]["fused_coarse_vcycle"]
    launches["thomas_solve_batched"] = coupled_calls["thomas_solve_batched"]
    launches["closed_loop"] = closed_calls["closed_loop"]
    launches["reduced_shot"] = reduced_calls
    launches["ladder"] = ladder_calls
    launches["gk_rhs"] = gk_calls
    launches["twin_shot"] = twin_calls
    launches["newcomb_min_xi"] = newcomb_calls
    launches["disruption_sequence"] = disruption_calls
    launches["sandpile_run"] = sandpile_calls
    launches["compression_run"], launches["compression_adjoint"] = compression_calls
    launches["gc_ensemble"], launches["gc_orbit"] = orbit_calls
    launches["burn_relax"], launches["quench_run"] = burn_calls, quench_calls
    launches["phase_run"] = phase_calls
    launches["gene_proxy"] = proxy_calls
    launches.update(ensemble_calls)
    missing = [name for name in KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on a path: {missing}")

    # ── 8. times (CUDA events, one warm-up, median of 5) and bounds ──
    kernels = []
    for name in KERNELS:
        fk, fp, shape, work = timing[name]
        earlier_ms = None
        if name in staged:
            # the kernel and its predecessor in turns
            ms_k, earlier_ms = cuda_ms_pair(fk, staged[name])
            ms_p = cuda_ms(fp)
        elif name in measured_plain:
            # a plain version of seconds: timed once, on its path
            ms_k, ms_p = cuda_ms(fk), measured_plain[name]
        else:
            ms_k, ms_p = cuda_ms_pair(fk, fp)
        bound_ms, bound_by = bound(work)
        extra = ""
        if name in versus_fine:
            extra = f", fine leg {cuda_ms(versus_fine[name]):.4f} ms"
        if name in staged:
            extra += (f", earlier design {earlier_ms:.4f} ms (in turns); 50 calls back to back "
                      f"{back_to_back_ms(fk):.4f} ms a call, earlier design "
                      f"{back_to_back_ms(staged[name]):.4f} ms a call")
        if name == "fused_coarse_vcycle":
            extra += (f"; {vcycle_stages(257, 1, 2, 5, 50)} dependent stages bound it, "
                      "not the bytes")
        library_ms = cuda_ms(library[name]) if name in library else None
        if library_ms is not None:
            extra += f", library (torch.linalg.solve, dense) {library_ms:.4f} ms"
        print(f"time {name} {shape}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms{extra}, "
              f"bound {bound_ms:.4g} ms ({bound_by}: {work[0] / 1e6:.4g} MB, "
              f"{work[1] / 1e6:.4g} Mflop) [{card}]")
        src_path, replaces = SOURCES[name]
        row = {"name": name, "route": "cuda",
               "source": f"scpn_fusion_tpu_torch/{src_path}", "replaces": replaces,
               "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
               "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        if earlier_ms is not None:
            row["earlier_ms"] = earlier_ms
        row["launches_by_path"] = {path: calls[name] for path, calls in by_path.items()}
        kernels.append(row)
    for label, fn_new, fn_earlier, work in turn_times:
        bound_ms, bound_by = bound(work)
        ms_new, ms_earlier = cuda_ms_pair(fn_new, fn_earlier)
        print(f"time {label}: kernel {ms_new:.4f} ms, earlier design {ms_earlier:.4f} ms (in "
              f"turns), 50 calls back to back {back_to_back_ms(fn_new):.4f} vs "
              f"{back_to_back_ms(fn_earlier):.4f} ms a call, bound {bound_ms:.4g} ms "
              f"({bound_by}) [{card}]")
    for label, (name_a, fn_a), (name_b, fn_b), work in extra_times:
        bound_ms, bound_by = bound(work)
        print(f"time {label}: {name_a} {cuda_ms(fn_a):.4f} ms, {name_b} {cuda_ms(fn_b):.4f} ms, "
              f"bound {bound_ms:.4g} ms ({bound_by}) [{card}]")

    def under(context, solve):
        """``solve`` run inside the context manager ``context()``."""
        def run():
            with context():
                solve()
        return run

    def fmg_run():
        solve_equilibrium_fmg(cfg_k, dtype=torch.float32, **fmg)

    def mixed_run():
        cas2_k.solve()

    fmg_k, fmg_s = cuda_ms_pair(fmg_run, under(staged_kernels, fmg_run))
    fmg_p = cuda_ms(lambda: solve_equilibrium_fmg(cfg_p, dtype=torch.float32, **fmg),
                    reps=SLOW_REPS)
    print(f"time FMG 129->257->513 f32: kernels {fmg_k:.3f} ms, with the staged kernels "
          f"{fmg_s:.3f} ms (in turns), plain {fmg_p:.3f} ms (median of {SLOW_REPS}) [{card}]")
    mix_k, mix_s = cuda_ms_pair(mixed_run, under(staged_kernels, mixed_run))
    mix_p = cuda_ms(cas2_p.solve, reps=2)
    print(f"time mixed FMG 129->...->2049: kernels {mix_k:.3f} ms, with the staged kernels "
          f"{mix_s:.3f} ms (in turns, median of 5), plain {mix_p:.3f} ms (median of 2) [{card}]")
    fmg_n, fmg_f = cuda_ms_pair(fmg_run, under(staged_fine_legs, fmg_run))
    print(f"time FMG 129->257->513 f32: kernels {fmg_n:.3f} ms, with the staged fine legs "
          f"{fmg_f:.3f} ms (in turns, median of 5) [{card}]")
    mix_n, mix_f = cuda_ms_pair(mixed_run, under(staged_fine_legs, mixed_run))
    print(f"time mixed FMG 129->...->2049: kernels {mix_n:.3f} ms, with the staged fine legs "
          f"{mix_f:.3f} ms (in turns, median of 5) [{card}]")
    mix_n, mix_e = cuda_ms_pair(mixed_run, under(first_design_tiled_legs, mixed_run))
    print(f"time mixed FMG 129->...->2049: kernels {mix_n:.3f} ms, with the first design of the "
          f"tiled legs {mix_e:.3f} ms (in turns, median of 5) [{card}]")
    def sor_run():
        solve_equilibrium(sor_cfg(True), dtype=torch.float32, device=dev)

    def rect_run():
        solve_equilibrium(cfg4_k, dtype=torch.float32, device=dev)

    sor_k, sor_s = cuda_ms_pair(sor_run, under(staged_sor, sor_run))
    sor_p = cuda_ms(lambda: solve_equilibrium(sor_cfg(False), dtype=torch.float32, device=dev),
                    reps=2)
    print(f"time anderson 129^2 solve: kernels {sor_k:.3f} ms, with the staged sor_sweeps "
          f"{sor_s:.3f} ms (in turns, median of 5), plain {sor_p:.3f} ms (median of 2) [{card}]")
    rect_k, rect_s = cuda_ms_pair(rect_run, under(staged_sor, rect_run))
    rect_p = cuda_ms(lambda: solve_equilibrium(cfg4_p, dtype=torch.float32, device=dev), reps=2)
    print(f"time rectangular 257x129 solve: kernels {rect_k:.3f} ms, with the staged sor_sweeps "
          f"{rect_s:.3f} ms (in turns, median of 5), plain {rect_p:.3f} ms (median of 2) "
          f"[{card}]")
    for tag, label in (("fb_257", "free boundary 257^2 f32"), ("fb_129", "free boundary 129^2 f32"),
                       ("fb_mixed_129", "free boundary 129^2 f64")):
        fn_k, fn_p = fb_runs[tag]
        t_k, t_p = cuda_ms_pair(fn_k, fn_p, reps=SLOW_REPS)
        if tag == "fb_mixed_129":
            print(f"time {label}: mixed with kernels {t_k:.3f} ms, plain f64 {t_p:.3f} ms (in "
                  f"turns, median of {SLOW_REPS}); yardstick: the original reference's warm "
                  f"129^2 FP64 free-boundary forward on an H100, {REFERENCE_FB_FP64_MS} ms "
                  f"(BASELINE.md:13) [{card}]")
        else:
            print(f"time {label}: kernels {t_k:.3f} ms, plain {t_p:.3f} ms (in turns, median of "
                  f"{SLOW_REPS}) [{card}]")
    print(f"time free boundary 129^2 f32 optimize_shape + wall: kernels "
          f"{cuda_ms(shape_run, reps=SLOW_REPS):.3f} ms (median of {SLOW_REPS}) [{card}]")
    t_k, t_p = cuda_ms_pair(*eq_runs, reps=SLOW_REPS)
    print(f"time SPARC g-file 129x129 f32 reconstruction: kernels {t_k:.3f} ms, plain "
          f"{t_p:.3f} ms (in turns, median of {SLOW_REPS}) [{card}]")
    t_n, t_pic = cuda_ms_pair(lambda: solve_equilibrium_newton(nk_cfg, dtype=f64, device=dev),
                              lambda: solve_equilibrium(nk_cfg, dtype=f64, device=dev),
                              reps=SLOW_REPS)
    print(f"time Newton-Krylov 129^2 f64 (plain ops): {t_n:.3f} ms, the Picard f64 solve "
          f"{t_pic:.3f} ms (in turns, median of {SLOW_REPS}) [{card}]")
    phase_done("times")
    print("phase seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
    print(f"smoke seconds: {time.perf_counter() - t_start:.1f} (every phase, the build included)")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
