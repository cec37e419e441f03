"""Fueling mode + TORAX-style hybrid loop (port of
``scpn_fusion_tpu/control/fueling_torax.py``).

* :func:`run_fueling_mode`: ice-pellet density control, a PI path plus a
  gated SCPN term on a reduced 0-D ITER-like density model;
* :func:`run_torax_hybrid_campaign`: an NSTX-U-like campaign on a reduced
  TORAX-style 4-state plant (beta_N, q95, li3, W_th) with a linear policy
  head, an SCPN corrector and a risk signal, across disturbance episodes.

The JAX package runs each shot as one ``lax.scan`` (the campaign ``vmap``s
its episodes).  Here a shot is one launch of row N's plant kind 2 and the
whole campaign one launch of its plant kind 3, one CTA an episode
(``ops/cuda_closed_loop.closed_loop_fueling`` / ``closed_loop_torax``).  On
the CPU those wrappers loop the plain ticks below, :func:`fueling_step` and
:func:`torax_step` (the campaign's episodes as one ``torch.func.vmap``
batch), which are also the kernel's plain twin.

Both loops fire fractionally and draw nothing from the controller.  The
campaign draws one uniform an episode (the disturbance amplitude) and two
normals a tick: :func:`run_torax_hybrid_campaign` draws them from a
``torch.Generator`` and hands them to :func:`_run_torax_hybrid_campaign`,
which takes them as tensors (the parity tests feed it JAX's draws).

Divisions by constants divide by a tensor: on a CUDA tensor, division by a
Python number multiplies by its reciprocal, which the kernel does not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
from scpn_fusion_tpu_torch.scpn.controller import (
    CompiledController,
    ControllerConfig,
    build_controller,
    controller_step,
)
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet


def _build_axis_controller(gain: float, dtype: torch.dtype,
                           device: torch.device | str) -> CompiledController:
    """Small R-axis regulation net reused as the neuromorphic pathway
    (the reference's fueling/hybrid controllers are the same shape)."""
    net = StochasticPetriNet()
    for p in ("e+", "e-", "c+", "c-", "sink"):
        net.add_place(p)
    for t, src, dst in (("t+", "e+", "c+"), ("t-", "e-", "c-")):
        net.add_transition(t, threshold=0.02)
        net.add_arc(src, t)
        net.add_arc(t, dst)
    for t, src in (("d+", "c+"), ("d-", "c-")):
        net.add_transition(t, threshold=0.0)
        net.add_arc(src, t)
        net.add_arc(t, "sink")
    compiled = net.compile()
    return build_controller(
        compiled,
        axis_targets=[6.2], axis_scales=[0.5],
        injections=[("e+", 0, True, 1.0, 0.0), ("e-", 0, False, 1.0, 0.0)],
        actions=[("c+", "c-", gain, 5000.0, 1e9)],
        dtype=dtype, device=device)


def _over(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` divided by a tensor (a true division on every device)."""
    return x / torch.full_like(x, c)


def _axis_obs(error: torch.Tensor) -> torch.Tensor:
    """The error mapped onto the controller's R-axis channel."""
    return (6.2 - 0.25 * torch.clamp(error, -1.0, 1.0)).reshape(1)


# ── Fueling mode ─────────────────────────────────────────────────────────


class FuelingResult(NamedTuple):
    final_density: torch.Tensor
    final_abs_error: torch.Tensor
    rmse: torch.Tensor
    density_trace: torch.Tensor
    command_trace: torch.Tensor


def fueling_step(ctrl: CompiledController, cfg: ControllerConfig, plant: ccl.FuelingPlant,
                 carry, k: int):
    """One tick of the fueling loop (JAX ``run_fueling_mode.step``):
    ``carry`` (density, integral, controller state) -> (new carry, (density,
    command, error, actions, firing))."""
    density, integ, cstate = carry
    error = plant.target - density
    integ = torch.clamp(integ + error * plant.dt, -0.5, 0.5)

    # Neuromorphic pathway on a mapped pseudo-observation of the error.
    cstate, actions, diag = controller_step(ctrl, cfg, cstate, _axis_obs(error), k)
    u_snn_raw = _over(actions[0], 5000.0)
    gate = torch.clamp(_over(error.abs(), 0.05), 0.0, 1.0)
    u_snn = 0.25 * gate * u_snn_raw

    u_pi = 1.95 * error + 7.2 * integ
    command = torch.clamp(u_pi + u_snn, -2.0, 2.0)
    density = torch.clamp(density + plant.dt * (ccl.LEAK * plant.target + ccl.LEAK * command
                                                - ccl.LEAK * density), min=0.0)
    return (density, integ, cstate), (density, command, error, actions, diag["firing"])


def run_fueling_mode(
    *,
    target_density: float = 1.0,
    initial_density: float = 0.82,
    steps: int = 3000,
    dt_s: float = 1e-3,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> FuelingResult:
    """PI + gated-SCPN density control on the 0D model (reference
    ``simulate_iter_density_control`` :132-186 dynamics: leak 1.15, fueling
    gain 1.15, commands clipped to [-2, 2]); on the card one launch."""
    ctrl = _build_axis_controller(5000.0, dtype, device)
    cfg = ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=dt_s)
    plant = ccl.FuelingPlant(target=target_density, density0=initial_density, dt=dt_s)
    _, final, trace = ccl.closed_loop_fueling(ctrl, cfg, plant, n_ticks=steps)
    density_f, err = final[0], trace["error"]
    return FuelingResult(
        final_density=density_f,
        final_abs_error=(target_density - density_f).abs(),
        rmse=torch.sqrt(torch.mean(err**2)),
        density_trace=trace["density"], command_trace=trace["command"])


# ── TORAX-style hybrid campaign ──────────────────────────────────────────


class ToraxCampaignResult(NamedTuple):
    beta_n_final: torch.Tensor      # (episodes,)
    q95_final: torch.Tensor
    beta_rmse: torch.Tensor         # (episodes,) vs the 1.85 target
    risk_peak: torch.Tensor
    within_limits: torch.Tensor     # (episodes,) bool


def _torax_policy(beta_n, q95):
    """Reduced TORAX-like policy head (reference :105-111)."""
    return torch.clamp(1.10 * (1.85 - beta_n) - 0.32 * (q95 - 4.9), -1.6, 1.6)


def _risk_signal(beta_n, q95, li3, disturbance):
    return (0.40 + 0.42 * torch.clamp(beta_n - 2.05, min=0.0)
            + 0.38 * torch.clamp(4.4 - q95, min=0.0)
            + 0.22 * torch.clamp(li3 - 1.25, min=0.0)
            + 0.30 * disturbance)


def torax_step(ctrl: CompiledController, cfg: ControllerConfig, carry, k: int,
               disturbance: torch.Tensor, noise: torch.Tensor):
    """One tick of one campaign episode (JAX ``episode.step``): ``carry``
    (beta_N, q95, li3, W_th, controller state), the tick's disturbance and
    its two normals (2,) -> (new carry, (beta_N, q95, risk, actions,
    firing))."""
    beta_n, q95, li3, w_th, cstate = carry
    cmd_policy = _torax_policy(beta_n, q95)
    # SCPN corrector rides on the beta error channel.
    cstate, actions, diag = controller_step(ctrl, cfg, cstate, _axis_obs(1.85 - beta_n), k)
    cmd = torch.clamp(cmd_policy + _over(0.2 * actions[0], 5000.0), -2.0, 2.0)

    n1 = 0.004 * noise[0]
    n2 = 0.006 * noise[1]
    beta_n = beta_n + 0.045 * (0.85 * cmd - (beta_n - 1.85) - 0.52 * disturbance + n1)
    q95 = q95 + 0.060 * (0.18 - 0.33 * cmd + 0.62 * disturbance - 0.16 * (q95 - 4.9) + n2)
    li3 = li3 + 0.050 * (0.06 * cmd - 0.11 * disturbance - 0.09 * (li3 - 0.95))
    w_th = w_th + 0.110 * (10.0 * cmd - 5.0 * disturbance - 0.06 * (w_th - 140.0))
    beta_n = torch.clamp(beta_n, 0.6, 3.2)
    q95 = torch.clamp(q95, 2.8, 7.5)
    li3 = torch.clamp(li3, 0.45, 1.8)
    w_th = torch.clamp(w_th, 50.0, 260.0)
    risk = _risk_signal(beta_n, q95, li3, disturbance)
    return (beta_n, q95, li3, w_th, cstate), (beta_n, q95, risk, actions, diag["firing"])


def torax_disturbance(amps: torch.Tensor, steps: int) -> torch.Tensor:
    """Each episode's mid-shot burst ``amp exp(-((k/steps - 0.5)/0.12)^2)``,
    (E, steps): the one input both the kernel and its plain loop read."""
    t_frac = torch.arange(steps, dtype=amps.dtype, device=amps.device) / steps
    return amps[:, None] * torch.exp(-((t_frac - 0.5) / 0.12) ** 2)[None, :]


def _run_torax_hybrid_campaign(amps: torch.Tensor, noise: torch.Tensor, *,
                               steps: int) -> ToraxCampaignResult:
    """:func:`run_torax_hybrid_campaign` with the draws given: ``amps`` (E,)
    each episode's disturbance amplitude and ``noise`` (E, steps, 2) the two
    normals of each tick, in the campaign's dtype on its device."""
    dtype, dev = amps.dtype, amps.device
    ctrl = _build_axis_controller(5000.0, dtype, dev)
    cfg = ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=1e-3)
    episodes = amps.shape[0]
    plant0 = tuple(torch.full((episodes,), v, dtype=dtype, device=dev)
                   for v in (1.7, 5.1, 0.95, 140.0))
    _, final, trace = ccl.closed_loop_torax(ctrl, cfg, plant0,
                                            torax_disturbance(amps, steps), noise)
    beta_tr, q95_tr = trace["beta_n"], trace["q95"]
    return ToraxCampaignResult(
        beta_n_final=final[:, 0], q95_final=final[:, 1],
        beta_rmse=torch.sqrt(torch.mean((beta_tr - 1.85) ** 2, dim=1)),
        risk_peak=trace["risk"].amax(dim=1),
        within_limits=(beta_tr < 2.6).all(dim=1) & (q95_tr > 3.2).all(dim=1))


def run_torax_hybrid_campaign(
    *,
    seed: int = 42,
    episodes: int = 16,
    steps: int = 220,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
) -> ToraxCampaignResult:
    """All episodes at once (reference ``run_nstxu_torax_hybrid_campaign``
    :153-250 dynamics/limits); on the card one launch, one CTA an episode.
    The draws come from ``generator`` (a CPU generator seeded with ``seed``
    when none is given), so the card and the CPU see the same draws."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    u = torch.rand((episodes,), generator=generator, dtype=torch.float64)
    noise = torch.randn((episodes, steps, 2), generator=generator, dtype=torch.float64)
    amps = (0.25 + 0.5 * u).to(dtype=dtype, device=device)
    return _run_torax_hybrid_campaign(amps, noise.to(dtype=dtype, device=device), steps=steps)
