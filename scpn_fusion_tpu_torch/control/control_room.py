"""Fusion control room: VDE closed loop + rendering (port of
``scpn_fusion_tpu/control/control_room.py``).

One session steps reduced vertical-displacement dynamics, a noisy probe with
periodic dropout, an input-aware Kalman observer on the exact discrete
linearisation of the plant (z' = 1.1 z + v + u, v' = 0.9 (v + 0.1 z + u)),
estimated-state feedback ``u = tanh(-(5 z_hat + 5 v_hat))`` with the
push-pull coil split, and a Miller-parameterised density frame a step (or,
in the kernel-backed psi lane, the frame of an externally solved flux map).
The JAX package runs the session as one ``lax.scan`` in float32; the port
runs it as a plain loop of float32 ops on ``device``.  Rendering is a host
post-process of the returned arrays.

The draws rule: each step takes four draws -- the disturbance normal, the
kick uniform, the measurement normal and the (size, size) noise frame.
:func:`run_control_room_session` draws them from a CPU ``torch.Generator``
seeded with ``seed`` (so the card and the CPU see the same);
:func:`_run_control_room_session` takes them as tensors (the tests feed it
JAX's).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import linspace

F32 = torch.float32


class ControlRoomTrace(NamedTuple):
    """Per-frame telemetry (leaves shaped (steps, ...))."""

    z_true: torch.Tensor
    z_measured: torch.Tensor
    z_filtered: torch.Tensor
    top_action: torch.Tensor
    bottom_action: torch.Tensor
    dropout: torch.Tensor
    density: torch.Tensor      # (steps, size, size)


class ControlRoomDraws(NamedTuple):
    """A session's random numbers: a disturbance normal, a kick uniform and a
    measurement normal a step ((steps,) each), a noise frame a step
    ((steps, size, size) standard normals)."""

    disturbance: torch.Tensor
    kick: torch.Tensor
    measurement: torch.Tensor
    noise: torch.Tensor


def _miller_density(rr, zz, z_pos, *, r0=3.0, a=1.0, kappa=1.7, delta=0.33, noise=None):
    """Analytic Miller-parameterised normalised density field (reference
    ``solve_flux_surfaces``)."""
    dr = rr - r0
    rho_sq = dr**2 + ((zz - z_pos) / kappa) ** 2 - 2.0 * delta * dr * dr**2
    psi = torch.clamp(rho_sq / a**2, min=0.0)
    dens = torch.where(psi < 1.0, torch.clamp(1.0 - psi, min=0.0) ** 1.5, torch.zeros_like(psi))
    if noise is not None:
        dens = torch.clamp(dens + noise * dens, min=0.0)
    return dens, psi


def session_draws(steps: int, size: int, seed: int, device) -> ControlRoomDraws:
    """The four draws of every step, from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    draws = (torch.randn(steps, generator=gen, dtype=F32),
             torch.rand(steps, generator=gen, dtype=F32),
             torch.randn(steps, generator=gen, dtype=F32),
             torch.randn((steps, size, size), generator=gen, dtype=F32))
    return ControlRoomDraws(*(d.to(device) for d in draws))


def _check(steps: int, size: int) -> None:
    if steps < 1:
        raise ValueError("steps must be >= 1.")
    if size < 16:
        raise ValueError("size must be >= 16.")


def run_control_room_session(*, steps: int = 200, size: int = 60, seed: int = 42,
                             dropout_every: int = 20, psi_kernel: torch.Tensor | None = None,
                             device: torch.device | str = "cuda"):
    """Run the control-room VDE loop; returns ``(trace, summary)``.

    ``psi_kernel``: optional externally solved (size, size) flux map (the
    reference's kernel-backed psi lane), normalised and used as the density
    base instead of the analytic Miller geometry; the session then runs on
    its device."""
    _check(steps, size)
    if psi_kernel is not None:
        device = psi_kernel.device
    return _run_control_room_session(steps=steps, size=size, dropout_every=dropout_every,
                                     psi_kernel=psi_kernel,
                                     draws=session_draws(steps, size, seed, device))


def _run_control_room_session(*, steps: int, size: int, dropout_every: int,
                              psi_kernel: torch.Tensor | None, draws: ControlRoomDraws):
    """The session on ``draws``' device, every step's draws given."""
    _check(steps, size)
    dev = draws.noise.device
    r = linspace(1.0, 5.0, size, F32, dev)
    z_1d = linspace(-3.0, 3.0, size, F32, dev)
    rr, zz = torch.meshgrid(r, z_1d, indexing="xy")

    if psi_kernel is not None:
        pk = torch.as_tensor(psi_kernel, dtype=F32, device=dev)
        pk = (pk - torch.min(pk)) / torch.clamp(torch.max(pk) - torch.min(pk), min=1e-9)
        dens_base = torch.where(pk < 1.0, torch.clamp(1.0 - pk, min=0.0) ** 1.5,
                                torch.zeros_like(pk))

    # Observer: the exact discrete plant linearisation with the control input.
    a_mat = torch.tensor([[1.1, 1.0], [0.09, 0.9]], dtype=F32, device=dev)
    b_vec = torch.tensor([1.0, 0.9], dtype=F32, device=dev)
    h = torch.tensor([[1.0, 0.0]], dtype=F32, device=dev)
    q_cov = torch.eye(2, dtype=F32, device=dev) * 0.01
    r_cov = torch.tensor([[0.05]], dtype=F32, device=dev)
    eye = torch.eye(2, dtype=F32, device=dev)
    k_z, k_v = 5.0, 5.0         # estimated-state feedback gains

    zero = torch.zeros((), dtype=F32, device=dev)
    z, v, top, bot = zero, zero, zero, zero
    kx = torch.zeros(2, dtype=F32, device=dev)
    kp_cov = eye * 0.1
    rows = []
    for k in range(steps):
        # 1. Plant: reduced VDE dynamics.
        control_force = (bot - top) * 0.2
        disturbance = 0.01 * draws.disturbance[k]
        disturbance = disturbance + torch.where(draws.kick[k] < 0.05, 0.2, 0.0)
        accel = 0.1 * z + control_force + disturbance
        v = v + accel
        z = z + v
        v = v * 0.9

        # 2. Density field for this frame.
        noise = 0.05 * draws.noise[k]
        if psi_kernel is not None:
            dens = torch.clamp(dens_base + noise * dens_base, min=0.0)
        else:
            dens, _ = _miller_density(rr, zz, z, noise=noise)

        # 3. Noisy probe + periodic dropout glitch.
        z_meas = z + 0.05 * draws.measurement[k]
        dropout = k % dropout_every == 0

        # 4. Kalman predict / correct with covariance inflation on dropout,
        #    input-aware prediction.
        u_prev = (bot - top) * 0.2
        x_pred = a_mat @ kx + b_vec * u_prev
        p_pred = a_mat @ kp_cov @ a_mat.T + q_cov
        if dropout:
            kx, kp_cov = x_pred, p_pred * 1.2
        else:
            innov = z_meas - (h @ x_pred)[0]
            s = (h @ p_pred @ h.T + r_cov)[0, 0]
            k_gain = (p_pred @ h.T)[:, 0] / s
            kx = x_pred + k_gain * innov
            kp_cov = (eye - torch.outer(k_gain, h[0])) @ p_pred

        # 5. Estimated-state feedback, tanh-saturated push-pull split.
        force = torch.tanh(-(k_z * kx[0] + k_v * kx[1]))
        push = force > 0.0
        top = torch.where(push, 0.0, torch.abs(force))
        bot = torch.where(push, torch.abs(force), 0.0)
        rows.append((z, z_meas, kx[0], top, bot, dens))

    z_tr, meas_tr, filt_tr, top_tr, bot_tr, dens_tr = (torch.stack(col) for col in zip(*rows))
    dropout_tr = torch.arange(steps, device=dev) % dropout_every == 0
    trace = ControlRoomTrace(z_tr, meas_tr, filt_tr, top_tr, bot_tr, dropout_tr, dens_tr)
    summary = {
        "final_z": trace.z_true[-1],
        "mean_abs_z": torch.mean(torch.abs(trace.z_true)),
        "max_abs_z": torch.max(torch.abs(trace.z_true)),
        "mean_top_action": torch.mean(trace.top_action),
        "mean_bottom_action": torch.mean(trace.bottom_action),
        "estimator_rmse": torch.sqrt(torch.mean((trace.z_filtered - trace.z_true) ** 2)),
        "measurement_rmse": torch.sqrt(torch.mean((trace.z_measured - trace.z_true) ** 2)),
    }
    return trace, summary


def render_control_room_report(trace: ControlRoomTrace, path_png: str, *,
                               path_gif: str | None = None, gif_stride: int = 4) -> dict:
    """Host-side rendering of the status report (and optionally the GIF
    animation).  Returns ``{"report_saved", "animation_saved", ...}``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def host(x):
        return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)

    dens = host(trace.density)
    z_hist = host(trace.z_true)
    top = host(trace.top_action)
    bot = host(trace.bottom_action)
    n = z_hist.shape[0]

    fig = plt.figure(figsize=(12, 8), facecolor="#1e1e1e")
    gs = fig.add_gridspec(2, 2)
    ax_plasma = fig.add_subplot(gs[:, 0])
    ax_plasma.set_facecolor("black")
    ax_plasma.set_title("Tokamak Cross-Section (final)", color="white")
    im = ax_plasma.imshow(dens[-1], extent=(1.0, 5.0, -3.0, 3.0), origin="lower",
                          cmap="plasma", vmin=0.0, vmax=1.0)
    ax_trace = fig.add_subplot(gs[0, 1])
    ax_trace.set_facecolor("#2e2e2e")
    ax_trace.set_title("Vertical Displacement (Z-Pos)", color="white")
    ax_trace.plot(z_hist, "c", lw=2)
    ax_trace.axhline(0.0, color="r", ls="--", alpha=0.5)
    ax_trace.grid(True, color="#444")
    ax_coils = fig.add_subplot(gs[1, 1])
    ax_coils.set_facecolor("#2e2e2e")
    ax_coils.set_title("PF Coil Commands", color="white")
    ax_coils.plot(top, "r", label="Top")
    ax_coils.plot(bot, "b", label="Bottom")
    ax_coils.legend()
    fig.tight_layout()
    result = {"report_saved": False, "animation_saved": False,
              "report_error": None, "animation_error": None}
    try:
        fig.savefig(path_png)
        result["report_saved"] = True
    except (OSError, RuntimeError, ValueError) as exc:
        result["report_error"] = str(exc)

    if path_gif is not None:
        try:
            from matplotlib.animation import FuncAnimation, PillowWriter
            frames = list(range(0, n, max(1, gif_stride)))

            def update(i):
                im.set_data(dens[frames[i]])
                return (im,)

            ani = FuncAnimation(fig, update, frames=len(frames), interval=100, blit=True)
            ani.save(path_gif, writer=PillowWriter(fps=10))
            result["animation_saved"] = True
        except (OSError, RuntimeError, ValueError) as exc:
            result["animation_error"] = str(exc)
    plt.close(fig)
    return result
