"""Matmul precision for the small-matrix control path, and the solver's
bf16 rounding.

The counterpart of `jax.default_matmul_precision("highest")`: the estimator,
kinematics and SRB-simulation matrices are 3x3..28x28, where a reduced
product precision is significant (the Kalman filter's innovation covariance
goes indefinite under bf16 products). PyTorch's float32 products are exact
by default; `exact_matmuls` holds TF32 off for the call (cuBLAS and cuDNN)
and restores both flags afterwards, so a caller that turned TF32 on does not
lower the control path's precision. It never lowers precision itself.
"""

from __future__ import annotations

import functools

import torch


def exact_matmuls(fn):
    """Run `fn` (and everything it calls) with TF32 off for float32 products."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return wrapped


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Values rounded to bf16, kept in fp32: a product of two such tensors in
    fp32 is the JAX package's bf16 x bf16 product with fp32 output."""
    return t.to(torch.bfloat16).float()


def bmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matvec (B,i,j) x (B,j) -> (B,i) in fp32."""
    return torch.bmm(a, v[:, :, None])[:, :, 0]
