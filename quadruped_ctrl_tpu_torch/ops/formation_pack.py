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

import torch

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


def _check(bfam_s, smat, r, smask, h: int, ms: int, pack: int):
    b = bfam_s.shape[0]
    n_c = 3 * ms * h
    dev = bfam_s.device
    _launch.check(bfam_s, "bfam_s", (b, 3, 13, 12), dev)
    _launch.check(smat, "smat", (b, 12, n_c), dev)
    _launch.check(r, "r", (b, 13 * h), dev)
    _launch.check(smask, "smask", (b, h), dev)
    if b % pack:
        raise ValueError(f"batch {b} is not a multiple of pack={pack}")
    pair_tile(pack * n_c)


def form_packed_reference(bfam_s, smat, r, smask, h: int, ms: int, pack: int,
                          alpha: float):
    """Plain PyTorch K1. Returns (hess (B/pack, n_pair, n_pair),
    grad (B/pack, n_pair))."""
    b = bfam_s.shape[0]
    n_c = 3 * ms * h
    n_pair = pack * n_c
    n_sys = b // pack
    f32, dev = torch.float32, bfam_s.device
    u = torch.einsum("bmpf,bfc->bmpc", bfam_s, smat)          # (B,3,13,n_c)
    cstep = torch.div(torch.arange(n_c, device=dev), 3 * ms,
                      rounding_mode="floor").to(f32)
    k = torch.arange(h, dtype=f32, device=dev)[:, None] - cstep[None, :]
    tri = (k >= 0.0).to(f32)                                  # (h,n_c)
    phis = (tri, k * tri, 0.5 * k * (k - 1.0) * tri)
    bq = sum(phi[None, :, None, :] * u[:, m, None] for m, phi in enumerate(phis))
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


def form_packed(bfam_s, smat, r, smask, h: int, ms: int, pack: int, alpha: float):
    """Packed QP cost. bfam_s (B,3,13,12), smat (B,12,n_c), r (B,13h),
    smask (B,h), float32 and contiguous, B a multiple of pack. Returns
    (hess (B/pack, n_pair, n_pair), grad (B/pack, n_pair)).

    A CPU tensor runs the reference; a CUDA tensor launches the kernel, at
    either tile (n_pair <= 128 or 128 < n_pair <= 256)."""
    with span("qct.ops.form_packed"):
        _check(bfam_s, smat, r, smask, h, ms, pack)
        if not bfam_s.is_cuda:
            return form_packed_reference(bfam_s, smat, r, smask, h, ms, pack, alpha)
        n_pair = pack * 3 * ms * h
        bfam_s, smat, r, smask = map(_launch.aligned, (bfam_s, smat, r, smask))
        lib = _build.load()
        smem = lib.qct_form_packed_smem_bytes(h, ms)
        if smem > _SMEM_LIMIT:
            raise ValueError(
                f"form_packed on CUDA at h={h}, ms={ms}: one scenario needs {smem} bytes of "
                f"shared memory, over the {_SMEM_LIMIT} one block may use")
        b = bfam_s.shape[0]
        hess = torch.empty((b // pack, n_pair, n_pair), dtype=torch.float32,
                           device=bfam_s.device)
        grad = torch.empty((b // pack, n_pair), dtype=torch.float32,
                           device=bfam_s.device)
        P = _launch.ptr
        with torch.cuda.device(bfam_s.device):
            rc = lib.qct_form_packed(P(bfam_s), P(smat), P(r), P(smask), P(hess),
                                     P(grad), b, h, ms, pack, float(alpha),
                                     _launch.stream(bfam_s))
        _launch.raise_on_error(rc, "form_packed")
        _launch.count(_K1, pair_tile(n_pair))
        return hess, grad


# The launch counts live on the function object; the private alias keeps them
# there when the module attribute is swapped for a wrapper.
_K1 = _launch.new_count(form_packed)
