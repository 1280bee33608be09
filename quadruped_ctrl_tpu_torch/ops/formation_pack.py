"""Fused packed condensed-MPC formation (kernel K1).

The counterpart of `quadruped_ctrl_tpu/ops/formation_pack.py`. From the tiny
per-scenario operands (the sqrt(w)-scaled nilpotent B-family, the stance
selection matrix, the weighted reference residual and sqrt(step_mask)) it
builds the block-diagonally packed QP cost

    H_pair = 2 (bq_pair' bq_pair + alpha I),   g_pair = 2 bq_pair' r_pair

for `pack` scenarios per system, with the Gram in bf16x3 as the TPU kernel
computes it, for packed systems of up to 256 variables (the TPU kernel's 128
and 256 tiles). On a CUDA tensor `form_packed` launches the hand-written
kernel in `csrc/formation_pack.cu`; on a CPU tensor it runs
`form_packed_reference`, the same arithmetic in plain PyTorch.

A scenario's n_c = 3 n_slot columns are its foot slots' forces, and the
step of each slot comes from `slot_step`: either the TPU kernel's per-step
layout, `ms` slots a step (`slot_step` None), or a list of the slots'
steps, one for all scenarios (n_slot,) or one a scenario (B, n_slot), whose
steps never decrease (`mpc/formation.stance_slots`' lists).

The kernel (one block a scenario) builds bq once into bf16 hi/lo planes in
shared memory, with the gradient in fp32 from the same values, and runs the
Gram on the tensor cores: mma.sync bf16 in three passes, on the 32 x 32
tiles on and above the diagonal, each from its first chunk of rows that is
not zero (the library's `qct_form_packed_mma_count` says how many a
scenario). The planes take 4 bytes an entry of bq padded to 16 rows and 16
columns, plus 8 columns of row stride where that fits
(`qct_form_packed_smem_bytes`): every shape up to h = 36 at max_stance 1,
25 at 2, 20 at 3 and 17 at 4 fits in 227 KB, as with the fp32 bq of the
kernel's first design; past them the wrapper raises. What bounds it: the
build, which the Gram and the stores follow in series (PERF.md, section 6).
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device
from quadruped_ctrl_tpu_torch.ops import _build, _launch
from quadruped_ctrl_tpu_torch.ops.ns_inverse import _split
from quadruped_ctrl_tpu_torch.utils.timer import span

_SMEM_LIMIT = 227 * 1024     # shared memory one H100 block may use


def pair_tile(n_pair: int) -> int:
    """Lane tile of the TPU kernel for an n_pair-variable packed system: 128
    or 256 (cf. ns_inverse.pad_sizes)."""
    if n_pair <= 128:
        return 128
    if n_pair > 256:
        raise ValueError(f"packed system size {n_pair} exceeds 256")
    return 256


def per_step_slots(h: int, ms: int, dev) -> torch.Tensor:
    """The per-step layout's slot steps, int32 (h ms,): ms slots a step."""
    return device.constant(np.repeat(np.arange(h, dtype=np.int32), ms), dev, torch.int32)


def _slot_steps(smat, h: int, ms: int | None, slot_step):
    """The slot steps K1 reads: `slot_step` as given, else the per-step
    layout's of `ms` slots a step."""
    if slot_step is not None:
        return slot_step
    if ms is None or 3 * ms * h != smat.shape[-1]:
        raise ValueError(f"smat has {smat.shape[-1]} columns, not 3 x ms={ms} x h={h}: "
                         f"pass the slots' steps")
    return per_step_slots(h, ms, smat.device)


def _check(bfam_s, smat, slot_step, r, smask, h: int, pack: int):
    b = bfam_s.shape[0]
    n_c = smat.shape[-1]
    dev = bfam_s.device
    _launch.check(bfam_s, "bfam_s", (b, 3, 13, 12), dev)
    _launch.check(smat, "smat", (b, 12, None), dev)
    _launch.check(r, "r", (b, 13 * h), dev)
    _launch.check(smask, "smask", (b, h), dev)
    if n_c % 3 or slot_step.shape[-1] != n_c // 3 or slot_step.dim() not in (1, 2) \
            or (slot_step.dim() == 2 and slot_step.shape[0] != b):
        raise ValueError(f"slot_step: shape {tuple(slot_step.shape)}, expected "
                         f"({n_c // 3},) or ({b}, {n_c // 3})")
    if slot_step.dtype != torch.int32 or slot_step.device != dev:
        raise TypeError(f"slot_step: int32 on {dev}, got {slot_step.dtype} on "
                        f"{slot_step.device}")
    if b % pack:
        raise ValueError(f"batch {b} is not a multiple of pack={pack}")
    pair_tile(pack * n_c)


def form_packed_reference(bfam_s, smat, r, smask, h: int, ms: int | None, pack: int,
                          alpha: float, slot_step=None):
    """Plain PyTorch K1. Returns (hess (B/pack, n_pair, n_pair),
    grad (B/pack, n_pair))."""
    slot_step = _slot_steps(smat, h, ms, slot_step)
    b = bfam_s.shape[0]
    n_c = smat.shape[-1]
    n_pair = pack * n_c
    n_sys = b // pack
    f32, dev = torch.float32, bfam_s.device
    u = torch.einsum("bmpf,bfc->bmpc", bfam_s, smat)          # (B,3,13,n_c)
    cstep = torch.repeat_interleave(slot_step, 3, dim=-1).to(f32)   # (n_c,) or (B,n_c)
    k = torch.arange(h, dtype=f32, device=dev)[:, None] - cstep[..., None, :]
    tri = (k >= 0.0).to(f32)                                  # (h,n_c) or (B,h,n_c)
    phis = (tri, k * tri, 0.5 * k * (k - 1.0) * tri)
    bq = sum(phi[..., :, None, :] * u[:, m, None] for m, phi in enumerate(phis))
    bq = (bq * smask[:, :, None, None]).reshape(b, 13 * h, n_c)
    hi, lo = (t.float() for t in _split(bq))
    hi_t = hi.transpose(1, 2)
    gram = hi_t @ hi
    gram = gram + hi_t @ lo
    gram = gram + lo.transpose(1, 2) @ hi
    blocks = 2.0 * gram + (2.0 * alpha) * torch.eye(n_c, dtype=f32, device=dev)
    grad = 2.0 * torch.einsum("bk,bkc->bc", r, bq)
    hess = torch.zeros((n_sys, n_pair, n_pair), dtype=f32, device=dev)
    blocks = blocks.reshape(n_sys, pack, n_c, n_c)
    for j in range(pack):
        hess[:, j * n_c:(j + 1) * n_c, j * n_c:(j + 1) * n_c] = blocks[:, j]
    return hess, grad.reshape(n_sys, n_pair)


def mma_count(lib, h: int, slot_step) -> int:
    """mma.sync m16n8k16 K1's Gram runs for one scenario whose slots lie on
    the steps `slot_step` (n_slot,), over bf16x3's three passes: the count
    of `lib` (the built library or its CPU emulation)."""
    steps = torch.as_tensor(slot_step, dtype=torch.int32, device="cpu").contiguous()
    return int(lib.qct_form_packed_mma_count(_launch.ptr(steps), h, steps.numel()))


def form_packed(bfam_s, smat, r, smask, h: int, ms: int | None, pack: int, alpha: float,
                slot_step=None):
    """Packed QP cost. bfam_s (B,3,13,12), smat (B,12,n_c), r (B,13h),
    smask (B,h), float32 and contiguous, B a multiple of pack; `slot_step`
    the steps of the n_c / 3 slots, int32 (n_slot,) or (B, n_slot), never
    decreasing along a list, or None for the per-step layout of `ms` slots a
    step. Returns (hess (B/pack, n_pair, n_pair), grad (B/pack, n_pair)).

    A CPU tensor runs the reference; a CUDA tensor launches the kernel, at
    either tile (n_pair <= 128 or 128 < n_pair <= 256)."""
    with span("qct.ops.form_packed"):
        slot_step = _slot_steps(smat, h, ms, slot_step)
        _check(bfam_s, smat, slot_step, r, smask, h, pack)
        if not bfam_s.is_cuda:
            return form_packed_reference(bfam_s, smat, r, smask, h, ms, pack, alpha,
                                         slot_step=slot_step)
        n_slot = slot_step.shape[-1]
        n_pair = pack * 3 * n_slot
        bfam_s, smat, r, smask = map(_launch.aligned, (bfam_s, smat, r, smask))
        slot_step = slot_step.contiguous()
        lib = _build.load()
        smem = lib.qct_form_packed_smem_bytes(h, n_slot)
        if smem > _SMEM_LIMIT:
            raise ValueError(
                f"form_packed on CUDA at h={h}, {n_slot} slots: one scenario needs {smem} "
                f"bytes of shared memory, over the {_SMEM_LIMIT} one block may use")
        b = bfam_s.shape[0]
        hess = torch.empty((b // pack, n_pair, n_pair), dtype=torch.float32,
                           device=bfam_s.device)
        grad = torch.empty((b // pack, n_pair), dtype=torch.float32,
                           device=bfam_s.device)
        P = _launch.ptr
        with torch.cuda.device(bfam_s.device):
            rc = lib.qct_form_packed(P(bfam_s), P(smat), P(slot_step),
                                     n_slot if slot_step.dim() == 2 else 0, P(r), P(smask),
                                     P(hess), P(grad), b, h, n_slot, pack, float(alpha),
                                     _launch.stream(bfam_s))
        _launch.raise_on_error(rc, "form_packed")
        _launch.count(_K1, pair_tile(n_pair))
        return hess, grad


# The launch counts live on the function object; the private alias keeps them
# there when the module attribute is swapped for a wrapper.
_K1 = _launch.new_count(form_packed)
