"""2D Fourier Neural Operator, the turbulence surrogates' backbone (port of
``scpn_fusion_tpu/models/surrogates/fno.py``).

A spectral convolution (full complex ``fft2`` -> the four low-mode corners
times complex weights -> ``ifft2``, real part) plus a pointwise (1x1) path,
GELU between layers; channels last.  The spectral path runs in complex64
whatever the input's dtype, as in JAX, so a float64 FNO is only float32
accurate.  It keeps ``fft2``/``ifft2``: the output spectrum is not exactly
Hermitian, so ``irfft2`` would compute another function.

Training is optax's Adam written out (``control/mpc._adam_update``) over a
Python loop of minibatch steps; the ``"cosine"`` schedule is
``optax.cosine_decay_schedule(lr, total_steps or n_steps, alpha=1/300)`` at
the step count before each step, and the Adam state (mu, nu, count) one call
returns the next takes back, so segments chain into one anneal.  The draws
rule: :func:`init_fno` and :func:`train_fno` draw from a ``torch.Generator``;
:func:`_train_fno` takes the (n_steps, batch) minibatch indices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class SpectralConvParams(NamedTuple):
    w_real: torch.Tensor    # (c_in, c_out, modes1, modes2): positive-row corner
    w_imag: torch.Tensor
    w2_real: torch.Tensor   # negative-row corner (independent weights)
    w2_imag: torch.Tensor


class FNOParams(NamedTuple):
    lift_w: torch.Tensor      # (c_in, width)
    lift_b: torch.Tensor
    spectral: tuple           # of SpectralConvParams
    pointwise: tuple          # of (width, width) tensors
    proj1_w: torch.Tensor
    proj1_b: torch.Tensor
    proj2_w: torch.Tensor
    proj2_b: torch.Tensor


def fno_leaves(params: FNOParams) -> list:
    """The parameters in ``jax.tree.flatten(FNOParams)`` order: lift_w,
    lift_b, four a spectral layer, the pointwise weights, proj1_w, proj1_b,
    proj2_w, proj2_b."""
    return [params.lift_w, params.lift_b, *(w for p in params.spectral for w in p),
            *params.pointwise, params.proj1_w, params.proj1_b, params.proj2_w, params.proj2_b]


def fno_from_leaves(leaves, n_layers: int) -> FNOParams:
    """:class:`FNOParams` from the :func:`fno_leaves` list of an FNO of
    ``n_layers`` spectral layers."""
    spec = leaves[2:2 + 4 * n_layers]
    rest = leaves[2 + 4 * n_layers:]
    return FNOParams(leaves[0], leaves[1],
                     tuple(SpectralConvParams(*spec[4 * i:4 * i + 4]) for i in range(n_layers)),
                     tuple(rest[:n_layers]), *rest[n_layers:])


def init_fno(generator: torch.Generator, *, in_channels: int = 1, out_channels: int = 1,
             width: int = 32, modes: int = 12, n_layers: int = 4, dtype=torch.float32,
             device: torch.device | str = "cuda") -> FNOParams:
    """He-scaled lift, pointwise and projection weights and 1/width^2-scaled
    spectral weights, the normals drawn from ``generator``."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    scale = 1.0 / (width * width)
    spectral, pointwise = [], []
    for _ in range(n_layers):
        spectral.append(SpectralConvParams(
            *(scale * normal(width, width, modes, modes) for _ in range(4))))
        pointwise.append(math.sqrt(2.0 / width) * normal(width, width))
    return FNOParams(
        lift_w=math.sqrt(2.0 / in_channels) * normal(in_channels, width),
        lift_b=zeros(width),
        spectral=tuple(spectral),
        pointwise=tuple(pointwise),
        proj1_w=math.sqrt(2.0 / width) * normal(width, 128),
        proj1_b=zeros(128),
        proj2_w=math.sqrt(2.0 / 128) * normal(128, out_channels),
        proj2_b=zeros(out_channels),
    )


def _spectral_conv_nd(x: torch.Tensor, p: SpectralConvParams) -> torch.Tensor:
    """The spectral convolution of (..., H, W, C_in) -> (..., H, W, C_out)."""
    m1, m2 = p.w_real.shape[2], p.w_real.shape[3]
    c_out = p.w_real.shape[1]
    x_ft = torch.fft.fft2(x.to(torch.complex64), dim=(-3, -2))
    wa = torch.complex(p.w_real, p.w_imag)        # rows+, cols+
    wb = torch.complex(p.w2_real, p.w2_imag)      # rows-, cols+

    def corner(xc, w):
        dt = torch.promote_types(xc.dtype, w.dtype)
        return torch.einsum("...xyi,ioxy->...xyo", xc.to(dt), w.to(dt)).to(torch.complex64)

    out_ft = torch.zeros((*x.shape[:-1], c_out), dtype=torch.complex64, device=x.device)
    out_ft[..., :m1, :m2, :] = corner(x_ft[..., :m1, :m2, :], wa)
    out_ft[..., -m1:, :m2, :] = corner(x_ft[..., -m1:, :m2, :], wb)
    # Hermitian-mirrored column corners carry the conjugate weights
    out_ft[..., :m1, -m2:, :] = corner(x_ft[..., :m1, -m2:, :], torch.conj(wb))
    out_ft[..., -m1:, -m2:, :] = corner(x_ft[..., -m1:, -m2:, :], torch.conj(wa))
    return torch.fft.ifft2(out_ft, dim=(-3, -2)).real.to(x.dtype)


def _require_dims(x: torch.Tensor, dims: int, what: str) -> None:
    """Raise ``ValueError`` unless ``x`` has ``dims`` dimensions (JAX's
    ``h, w, _ = x.shape`` raises it on another count)."""
    if x.dim() != dims:
        raise ValueError(f"{what} takes a {dims}-D input, got shape {tuple(x.shape)}")


def _spectral_conv(x: torch.Tensor, p: SpectralConvParams) -> torch.Tensor:
    """x: (H, W, C_in) -> (H, W, C_out) via the truncated-mode complex product."""
    _require_dims(x, 3, "_spectral_conv")
    return _spectral_conv_nd(x, p)


def _forward(params: FNOParams, x: torch.Tensor) -> torch.Tensor:
    h = x @ params.lift_w + params.lift_b
    for spec, pw in zip(params.spectral, params.pointwise):
        h = F.gelu(_spectral_conv_nd(h, spec) + h @ pw, approximate="tanh")
    h = F.gelu(h @ params.proj1_w + params.proj1_b, approximate="tanh")
    return h @ params.proj2_w + params.proj2_b


def fno_apply(params: FNOParams, x: torch.Tensor) -> torch.Tensor:
    """Forward pass. x: (H, W, C_in) -> (H, W, C_out)."""
    _require_dims(x, 3, "fno_apply")
    return _forward(params, x)


def fno_apply_batched(params: FNOParams, x: torch.Tensor) -> torch.Tensor:
    """Forward pass of a batch. x: (N, H, W, C_in) -> (N, H, W, C_out)."""
    _require_dims(x, 4, "fno_apply_batched")
    return _forward(params, x)


class FNOTrainResult(NamedTuple):
    params: FNOParams
    loss_history: torch.Tensor
    opt_state: object = None    # (mu leaves, nu leaves, count)


def cosine_lr(lr: float, decay_steps: int, count: int, alpha: float = 1.0 / 300.0) -> float:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)`` at ``count``."""
    count = min(count, decay_steps)
    decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    return lr * ((1.0 - alpha) * decay + alpha)


def _relative_l2(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    num = torch.sqrt(((pred - y) ** 2).sum(dim=(1, 2, 3)))
    den = torch.clamp(torch.sqrt((y**2).sum(dim=(1, 2, 3))), min=1e-12)
    return (num / den).mean()


def train_fno(params: FNOParams, x: torch.Tensor, y: torch.Tensor, generator: torch.Generator,
              *, n_steps: int = 500, batch_size: int = 8, lr: float = 1e-3,
              schedule: str = "const", total_steps: int | None = None,
              opt_state=None) -> FNOTrainResult:
    """Relative-L2 training run of ``n_steps`` Adam steps on minibatches of
    (N, H, W, C) ``x`` -> ``y`` drawn from ``generator``; ``schedule="cosine"``
    anneals lr -> lr/300 over ``total_steps`` (default: ``n_steps``) from the
    carried step count, and ``opt_state`` of an earlier call continues its
    Adam state."""
    idx = torch.randint(0, x.shape[0], (n_steps, batch_size), generator=generator,
                        device=generator.device).to(x.device)
    return _train_fno(params, x, y, idx, lr=lr, schedule=schedule, total_steps=total_steps,
                      opt_state=opt_state)


def _train_fno(params: FNOParams, x: torch.Tensor, y: torch.Tensor, batch_idx: torch.Tensor,
               *, lr: float = 1e-3, schedule: str = "const", total_steps: int | None = None,
               opt_state=None) -> FNOTrainResult:
    """:func:`train_fno` with the minibatch indices given, (n_steps, batch)."""
    from scpn_fusion_tpu_torch.control.mpc import _adam_update

    n_steps = batch_idx.shape[0]
    n_layers = len(params.spectral)
    flat = [p.detach() for p in fno_leaves(params)]
    if opt_state is None:
        mu = [torch.zeros_like(p) for p in flat]
        nu = [torch.zeros_like(p) for p in flat]
        count = 0
    else:
        mu, nu, count = list(opt_state[0]), list(opt_state[1]), int(opt_state[2])
    losses = []
    for k in range(n_steps):
        idx = batch_idx[k]
        live = [p.requires_grad_(True) for p in flat]
        loss = _relative_l2(fno_apply_batched(fno_from_leaves(live, n_layers), x[idx]), y[idx])
        grads = torch.autograd.grad(loss, live)
        step_lr = (cosine_lr(lr, total_steps or n_steps, count) if schedule == "cosine"
                   else lr)
        new = []
        for i, (p, g) in enumerate(zip(flat, grads)):
            upd, mu[i], nu[i], _ = _adam_update(g, mu[i], nu[i], count, step_lr)
            new.append(p.detach() + upd)
        flat = new
        count += 1
        losses.append(loss.detach())
    return FNOTrainResult(fno_from_leaves(flat, n_layers), torch.stack(losses),
                          (tuple(mu), tuple(nu), count))
