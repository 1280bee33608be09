"""Where the port's work runs.

The JAX package chose its Pallas branches by backend (`jax.default_backend()
== "tpu"` in `solver/admm.py` and `mpc/formation.py`). The port chooses by the
data: the kernel branch is taken when the tensors lie on a CUDA device, unless
the caller says otherwise. Nothing here moves work to another device or sets
any global state.

Precision: float32 products stay at PyTorch's default "highest" precision
(no TF32), the counterpart of `Precision.HIGHEST` in the JAX package
(`core/precision.py`). Nothing in the port calls
`torch.set_float32_matmul_precision("high")`: the JAX package records the
Kalman-filter Cholesky going NaN under reduced-precision products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve(dev=None) -> torch.device:
    """The device an entry point builds its tensors on: `dev` as given, or
    `cuda:0` when it is None. Raises when `cuda:0` is asked for implicitly
    and no CUDA device is present; the CPU is taken only when asked for
    (`device="cpu"`)."""
    if dev is not None:
        return torch.device(dev)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on cuda:0 by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", 0)


def use_kernels(t: torch.Tensor, use_kernels: bool | None = None) -> bool:
    """True when the kernel branch runs for data `t`: `t.is_cuda` unless the
    caller passes `use_kernels` explicitly."""
    return t.is_cuda if use_kernels is None else bool(use_kernels)


def constant(values, dev, dtype=torch.float32) -> torch.Tensor:
    """A constant array as a tensor on `dev`, built once per (values, dtype,
    device) and shared: the per-tick control code reads its tables (hip
    locations, gains, the gait tables) through this, so no tick copies them
    from the host again. Callers never write into the result."""
    arr = np.asarray(values)
    return _constant(arr.tobytes(), arr.shape, arr.dtype.str, dtype, torch.device(dev))


@functools.lru_cache(maxsize=512)
def _constant(data: bytes, shape: tuple, np_dtype: str, dtype, dev) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=np.dtype(np_dtype)).reshape(shape)
    return torch.as_tensor(arr.copy(), dtype=dtype, device=dev)
