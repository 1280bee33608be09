"""Checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch


def check(t: torch.Tensor, name: str, shape: tuple, device: torch.device | None = None):
    """Raise unless `t` is a contiguous float32 tensor of `shape` (None matches
    any size) on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when its data starts on a 16-byte boundary, else a contiguous
    copy of it, which the allocator aligns: the kernels read their inputs 16
    bytes at a time (float4 loads, 16-byte cp.async), and a view that starts
    at another offset would fault there."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def new_count(fn, tiles=(128, 256)):
    """Give a kernel wrapper its launch counts: `fn.launches` (every launch)
    and `fn.launches_by_tile` (per tile). Returns fn."""
    fn.launches = 0
    fn.launches_by_tile = dict.fromkeys(tiles, 0)
    return fn


def count(fn, tile: int):
    """One launch of fn's kernel at `tile`; called right after the launch."""
    fn.launches += 1
    fn.launches_by_tile[tile] += 1
