"""The GENE-like proxy as a hand-written CUDA kernel (``csrc/gene_proxy.cu``;
row W).

:func:`gene_proxy` runs every iteration of the proxy's saturation fixed
point (the JAX package's ``models/surrogates/gyro_swin.py:112-132``
``gene_proxy_predict``) for every sample of a call in ONE launch, one thread
a sample, and adds one to ``cb.CALLS["gene_proxy"]``.  The JAX package has
no Pallas kernel here: its loop is a ``lax.scan`` in one compiled program,
and this launch takes that program's place.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`gene_proxy_plain`, the loop of ``gyro_swin``'s closure on torch ops;
it keeps autograd.  On a CUDA tensor it launches the kernel or raises, and
an input that requires a gradient raises (the kernel has no backward, and
needs none: no JAX caller differentiates the proxy).
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.float32: "scpn_gene_proxy_f32", torch.float64: "scpn_gene_proxy_f64"}
THREADS = 64   # a CTA: the benchmark's 1024 samples on 16 SMs


class _Args(ctypes.Structure):
    """``ProxyArgs`` of ``csrc/gene_proxy.cu``, field for field."""

    _fields_ = [("features", ctypes.c_void_p), ("chi", ctypes.c_void_p),
                ("n", ctypes.c_int), ("iterations", ctypes.c_int)]


def gene_proxy_plain(features: torch.Tensor, iterations: int) -> torch.Tensor:
    """The loop the kernel replaces: ``iterations`` relaxation steps of every
    sample of the (n, 6) ``features`` from chi = 0."""
    from scpn_fusion_tpu_torch.models.surrogates.gyro_swin import (
        synthetic_core_turbulence_target,
    )

    chi = torch.zeros(features.shape[0], dtype=features.dtype, device=features.device)
    for _ in range(iterations):
        eff = features * (1.0 + 0.005 * torch.tanh(chi)[:, None])
        chi = chi + 0.05 * (synthetic_core_turbulence_target(eff) - chi)
    return chi


def check_inputs(features: torch.Tensor) -> None:
    """Raise unless row W takes ``features``: a float32 or float64 CUDA tensor
    of shape (n, 6) that requires no gradient."""
    if features.requires_grad:
        raise RuntimeError("gene_proxy: row W has no backward; features requires a gradient")
    if features.dtype not in _ENTRIES:
        raise TypeError(f"gene_proxy: float32 or float64, got {features.dtype}")
    if not features.is_cuda:
        raise ValueError(f"gene_proxy: the features must be a CUDA tensor, got {features.device}")
    if features.dim() != 2 or features.shape[1] != 6:
        raise ValueError(f"gene_proxy: features of shape (n, 6), got {tuple(features.shape)}")


def gene_proxy(features: torch.Tensor, iterations: int) -> torch.Tensor:
    """chi of every sample of the (n, 6) ``features`` after ``iterations``
    steps: as :func:`gene_proxy_plain`, in one launch on the card."""
    if not features.is_cuda:
        return gene_proxy_plain(features, iterations)
    check_inputs(features)
    x = features.contiguous()
    chi = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    if chi.numel() > 0:
        args = _Args(x.data_ptr(), chi.data_ptr(), n=x.shape[0], iterations=int(iterations))
        cb.launch(_ENTRIES[x.dtype], ctypes.addressof(args))
        cb.CALLS["gene_proxy"] += 1
    return chi
