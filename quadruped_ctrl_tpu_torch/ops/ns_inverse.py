"""Newton-Schulz SPD inversion (kernels K2, K3, K6, K7, K8, K9).

The counterpart of `quadruped_ctrl_tpu/ops/ns_inverse.py`:

* `ns_inverse_scaled` (K3): the NS schedule on a prebuilt Jacobi-scaled,
  tile-padded K;
* `ns_inverse_scaled_build` (K2): builds K = hp + blockdiag3(g9), Jacobi-
  scales it and runs the same schedule, returning (inv, ks, d_row);
* `ns_inverse_refine` (K6): the quadratic steps alone from a warm start
  whose residual is below 1, for the Woodbury polish;
* `ns_inverse_warm` (K7): a warm start held to a per-system residual guard,
  the short quadratic schedule below it and K3's cold schedule above it, for
  `solver/admm._batched_solver(prev_inv=...)`;
* `ns_inverse` (K8, one system) and `ns_inverse_blocked` (K9, a batch): plain
  fp32 NS, `iters` steps from I / ||K||_inf; `make_ns_inverse` returns a
  function that runs K8 on one matrix and K9 on a batch or under
  `torch.func.vmap`;
* `ns_inverse_schur_scaled` (K4, no kernel of its own): the 2 x 2 block
  inverse at the 128 boundary for ADMM-grade 128 < n <= 192 systems, K3 on
  the leading block and plain fp32 products around it.

The schedule: X0 = I / ||K||_inf, then `mu_schedule(a0, n_scaled)` scaled
steps X <- mu X (2I - mu K X) and n_quad quadratic steps in bf16x3, then n_hi
fp32 steps. On a CUDA tensor the wrappers launch the hand-written kernels:
K2 and K3 run `csrc/ns_inverse.cu` at the 128 tile (one block per system,
`mma.sync`); K2 and K3 at the 256 tile, K6, K7's guard and warm branch, and
K9 at the 128 tile run `csrc/ns_refine.cu` (its products as `wgmma`; as
many blocks, or 4-block clusters at 256, as the card holds at once, each
walking systems in turn), K7's cold branch K3's own kernel on the systems
whose guard tripped; the plain NS K8 and K9 at 256 run `csrc/ns_plain.cu`
(K8 on one cluster of 8 blocks at 128 and of 16 at 256, K9 at 256 on a
cluster of 4 a system).
Every wrapper hands its kernel 16-byte aligned inputs (`_launch.aligned`)
and runs in a `qct.ops.<wrapper>` span (`utils/timer.span`).
On a CPU tensor they run the `_reference` functions, the same arithmetic
in plain PyTorch.

The TPU kernels group G = 8 systems per grid step and need the batch padded
to a multiple of G; the CUDA kernels take any batch. `G` stays here because
the solver pads its batch as the JAX solver does, so that both compare line
for line.
"""

from __future__ import annotations

import ctypes

import torch

from quadruped_ctrl_tpu_torch.ops import _build, _launch
from quadruped_ctrl_tpu_torch.utils.timer import span

N = 128           # default padded system size (n <= 128, e.g. packed h=10)
N_BIG = 256       # large tile (128 < n <= 256, e.g. the full h=16 problem)
G = 8             # systems per TPU grid step; the solver's batch padding
_MAX_MUS = 16     # length of the kernels' mu table (csrc/ns_core.cuh)


def pad_sizes(n: int) -> int:
    """Smallest kernel tile for an n-variable system: 128 or 256."""
    if n <= N:
        return N
    if n > N_BIG:
        raise ValueError(f"system size {n} exceeds the {N_BIG} kernel tile")
    return N_BIG


def pad_to(k: torch.Tensor, n: int, n_pad: int | None = None) -> torch.Tensor:
    """Embed an (..., n, n) SPD block into (..., n_pad, n_pad) with identity
    padding (the padded block's inverse is the padded inverse)."""
    n_pad = pad_sizes(n) if n_pad is None else n_pad
    out = torch.zeros(k.shape[:-2] + (n_pad, n_pad), dtype=torch.float32,
                      device=k.device)
    out[..., :n, :n] = k
    idx = torch.arange(n, n_pad, device=k.device)
    out[..., idx, idx] = 1.0
    return out


def _split(a: torch.Tensor):
    """float32 -> (bf16 hi, bf16 lo) with a ~= hi + lo."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi, lo


def _mm3(a_hi: torch.Tensor, a_lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16x3 product: hi*hi + hi*lo + lo*hi of the bf16 parts, each an fp32
    product of bf16 values (exact) with fp32 accumulation, ~1e-6 relative."""
    b_hi, b_lo = _split(b)
    a_hi, a_lo, b_hi, b_lo = (t.float() for t in (a_hi, a_lo, b_hi, b_lo))
    acc = a_hi @ b_hi
    acc = acc + a_hi @ b_lo
    acc = acc + a_lo @ b_hi
    return acc


def mu_schedule(a0: float, n_scaled: int) -> list[float]:
    """Fixed scaling factors for the interval-[a,1] phase (host floats)."""
    mus = []
    a = a0
    for _ in range(n_scaled):
        mu = 2.0 / (1.0 + a)
        mus.append(mu)
        a = min(mu * a * (2.0 - mu * a), mu * (2.0 - mu))
    return mus


def _ns_schedule(ks: torch.Tensor, mus, n_quad: int, n_hi: int) -> torch.Tensor:
    """The NS schedule on a batch of Jacobi-scaled systems (B, npad, npad)."""
    eye = torch.eye(ks.shape[-1], dtype=torch.float32, device=ks.device)
    x = (1.0 / ks.abs().sum(-1).amax(-1))[:, None, None] * eye
    return _ns_steps(ks, x, mus, n_quad, n_hi)


def _ns_steps(ks: torch.Tensor, x: torch.Tensor, mus, n_quad: int, n_hi: int) -> torch.Tensor:
    """NS steps on ks from the iterate x: the scaled steps of `mus` and the
    quadratic steps in bf16x3, then the fp32 tail."""
    eye = torch.eye(ks.shape[-1], dtype=torch.float32, device=ks.device)
    k_hi, k_lo = _split(ks)
    for mu in mus:                        # scaled, bf16x3
        kx = _mm3(k_hi, k_lo, x)
        x_hi, x_lo = _split(x)
        x = mu * _mm3(x_hi, x_lo, 2.0 * eye - mu * kx)
    for _ in range(n_quad):               # quadratic, bf16x3
        kx = _mm3(k_hi, k_lo, x)
        x_hi, x_lo = _split(x)
        x = _mm3(x_hi, x_lo, 2.0 * eye - kx)
    for _ in range(n_hi):                 # quadratic, fp32 tail
        kx = ks @ x
        x = x @ (2.0 * eye - kx)
    return x


def _check_tile(npad: int):
    if npad not in (N, N_BIG):
        raise ValueError(f"tile {npad}: pad the system to {N} or {N_BIG} first")


def _check_schedule(n_scaled: int):
    if not 0 <= n_scaled <= _MAX_MUS:
        raise ValueError(f"n_scaled={n_scaled} outside 0..{_MAX_MUS}")


def _mus_arg(a0: float, n_scaled: int):
    return (ctypes.c_float * _MAX_MUS)(*mu_schedule(a0, n_scaled))


def ns_inverse_scaled_reference(ks, a0: float = 1e-5, n_scaled: int = 9,
                                n_quad: int = 2, n_hi: int = 1):
    """Plain PyTorch K3."""
    return _ns_schedule(ks, mu_schedule(a0, n_scaled), n_quad, n_hi)


def ns_inverse_scaled(ks, a0: float = 1e-5, n_scaled: int = 9, n_quad: int = 2,
                      n_hi: int = 1):
    """Scaled mixed-precision NS inverse of ks (B, npad, npad), Jacobi-scaled
    SPD with identity on the pad, npad in {128, 256}, any B. The defaults are
    the polish-grade schedule (SolverConfig.ns_a0 / ns_*_iters)."""
    with span("qct.ops.ns_inverse_scaled"):
        npad = ks.shape[-1] if ks.dim() == 3 else None
        _launch.check(ks, "ks", (None, npad, npad))
        _check_tile(npad)
        _check_schedule(n_scaled)
        if not ks.is_cuda:
            return ns_inverse_scaled_reference(ks, a0, n_scaled, n_quad, n_hi)
        ks = _launch.aligned(ks)
        lib = _build.load()
        entry = lib.qct_ns_inverse_scaled if npad == N else lib.qct_ns_inverse_scaled_256
        inv = torch.empty_like(ks)
        with torch.cuda.device(ks.device):
            rc = entry(_launch.ptr(ks), _launch.ptr(inv), ks.shape[0],
                       _mus_arg(a0, n_scaled), n_scaled, n_quad, n_hi, _launch.stream(ks))
        _launch.raise_on_error(rc, f"ns_inverse_scaled at the {npad} tile")
        _launch.count(_K3, npad)
        return inv


# The launch counts live on the function object; the private alias keeps them
# there when the module attribute is swapped for a wrapper.
_K3 = _launch.new_count(ns_inverse_scaled)


def _build_k(hp: torch.Tensor, g9: torch.Tensor) -> torch.Tensor:
    """K = hp + blockdiag3(g9): entry (3*(r%3) + c%3, r//3) of g9 lands on
    K[r, c] where r//3 == c//3 < nblk."""
    npad, nblk = hp.shape[-1], g9.shape[-1]
    idx = torch.arange(npad, device=hp.device)
    r, c = idx[:, None], idx[None, :]
    blk_r = torch.div(r, 3, rounding_mode="floor")
    blk_c = torch.div(c, 3, rounding_mode="floor")
    on_block = (blk_r == blk_c) & (blk_c < nblk)
    comp = (3 * (r % 3) + c % 3).expand(npad, npad)
    blk = blk_c.clamp(max=nblk - 1).expand(npad, npad)
    return hp + torch.where(on_block, g9[:, comp, blk], 0.0)


def ns_inverse_scaled_build_reference(hp, g9, a0: float = 1e-5,
                                      n_scaled: int = 9, n_quad: int = 2,
                                      n_hi: int = 1):
    """Plain PyTorch K2. Returns (inv, ks, d_row (B, 1, npad)), ks None at
    the 256 tile."""
    k = _build_k(hp, g9)
    d = torch.rsqrt(torch.clamp(torch.diagonal(k, dim1=-2, dim2=-1), min=1e-30))
    ks = k * d[:, :, None] * d[:, None, :]
    inv = _ns_schedule(ks, mu_schedule(a0, n_scaled), n_quad, n_hi)
    return inv, (ks if hp.shape[-1] == N else None), d[:, None, :]


def ns_inverse_scaled_build(hp, g9, a0: float = 1e-5, n_scaled: int = 9,
                            n_quad: int = 2, n_hi: int = 1):
    """Fused K-build + scaled NS inverse.

    hp (B, npad, npad): hess_n + sigma I on its leading 3 nblk rows and
    columns, diagonal beyond them (the callers pad with the identity);
    g9 (B, 9, nblk): the pyramid gram blocks, component-major. Returns
    (inv, ks, d_row) with d_row (B, 1, npad) the Jacobi scale; inv and ks are
    in the scaled space (K^-1 = d inv d). At the 256 tile ks comes back as
    None, as the JAX kernel's default (`emit_ks`) has it.

    That hp is diagonal from row and column 3 nblk on is a rule of the
    caller's, which nothing here checks (it would cost a host sync): at the
    256 tile a system of at most 192 variables runs on a kernel that reads
    only hp's diagonal there, while the reference inverts the whole tile, so
    the two agree only on such an hp."""
    with span("qct.ops.ns_inverse_scaled_build"):
        b = hp.shape[0] if hp.dim() == 3 else None
        npad = hp.shape[-1] if hp.dim() == 3 else None
        _launch.check(hp, "hp", (b, npad, npad))
        _launch.check(g9, "g9", (b, 9, None), hp.device)
        _check_tile(npad)
        if 3 * g9.shape[-1] > npad:
            raise ValueError(f"g9 has {g9.shape[-1]} blocks, more than a {npad} tile holds")
        _check_schedule(n_scaled)
        if not hp.is_cuda:
            return ns_inverse_scaled_build_reference(hp, g9, a0, n_scaled, n_quad, n_hi)
        hp, g9 = _launch.aligned(hp), _launch.aligned(g9)
        lib = _build.load()
        inv = torch.empty_like(hp)
        d_row = torch.empty((b, 1, npad), dtype=torch.float32, device=hp.device)
        sched = (_mus_arg(a0, n_scaled), n_scaled, n_quad, n_hi, _launch.stream(hp))
        P = _launch.ptr
        with torch.cuda.device(hp.device):
            if npad == N:
                ks = torch.empty_like(hp)
                rc = lib.qct_ns_inverse_scaled_build(P(hp), P(g9), g9.shape[-1], P(inv),
                                                     P(ks), P(d_row), b, *sched)
            else:
                ks = None
                rc = lib.qct_ns_inverse_scaled_build_256(P(hp), P(g9), g9.shape[-1], P(inv),
                                                         P(d_row), b, *sched)
        _launch.raise_on_error(rc, f"ns_inverse_scaled_build at the {npad} tile")
        _launch.count(_K2, npad)
        return inv, ks, d_row


_K2 = _launch.new_count(ns_inverse_scaled_build)


def ns_inverse_refine_reference(ks, init, n_quad: int = 1, n_hi: int = 1):
    """Plain PyTorch K6."""
    return _ns_steps(ks, init, [], n_quad, n_hi)


def ns_inverse_refine(ks, init, n_quad: int = 1, n_hi: int = 1):
    """Warm NS refinement of init, an approximate inverse of ks (both
    (B, npad, npad), npad in {128, 256}, any B) in the same Jacobi scaling,
    with ||I - ks init|| comfortably below 1: n_quad bf16x3 and n_hi fp32
    quadratic steps, each squaring the residual. There is no guard: the
    caller guarantees the residual bound (the Woodbury correction does, up
    to its fp32 floor)."""
    with span("qct.ops.ns_inverse_refine"):
        b = ks.shape[0] if ks.dim() == 3 else None
        npad = ks.shape[-1] if ks.dim() == 3 else None
        _launch.check(ks, "ks", (b, npad, npad))
        _launch.check(init, "init", (b, npad, npad), ks.device)
        _check_tile(npad)
        if not ks.is_cuda:
            return ns_inverse_refine_reference(ks, init, n_quad, n_hi)
        ks, init = _launch.aligned(ks), _launch.aligned(init)
        lib = _build.load()
        entry = lib.qct_ns_inverse_refine if npad == N else lib.qct_ns_inverse_refine_256
        inv = torch.empty_like(ks)
        with torch.cuda.device(ks.device):
            rc = entry(_launch.ptr(ks), _launch.ptr(init), _launch.ptr(inv), b, n_quad, n_hi,
                       _launch.stream(ks))
        _launch.raise_on_error(rc, f"ns_inverse_refine at the {npad} tile")
        _launch.count(_K6, npad)
        return inv


_K6 = _launch.new_count(ns_inverse_refine)


def ns_inverse_warm_reference(ks, init, a0: float = 1e-5, n_scaled: int = 9, n_quad: int = 2,
                              n_hi: int = 1, n_wquad: int = 3, n_whi: int = 1,
                              guard: float = 0.5):
    """Plain PyTorch K7, line for line with the TPU kernel: the guard
    r0 = max row sum of |I - K X0| from a bf16x3 product, the warm branch's
    first step reusing that product, and the cold branch K3's schedule,
    chosen per system. A NaN r0 fails the guard."""
    eye = torch.eye(ks.shape[-1], dtype=torch.float32, device=ks.device)
    k_hi, k_lo = _split(ks)
    kx0 = _mm3(k_hi, k_lo, init)
    r0 = (eye - kx0).abs().sum(-1).amax(-1)
    x0_hi, x0_lo = _split(init)
    warm = _mm3(x0_hi, x0_lo, 2.0 * eye - kx0)              # reuses K X0
    warm = _ns_steps(ks, warm, [], n_wquad - 1, n_whi)
    cold = _ns_schedule(ks, mu_schedule(a0, n_scaled), n_quad, n_hi)
    return torch.where((r0 < guard)[:, None, None], warm, cold)


def ns_inverse_warm(ks, init, a0: float = 1e-5, n_scaled: int = 9, n_quad: int = 2,
                    n_hi: int = 1, n_wquad: int = 3, n_whi: int = 1, guard: float = 0.5):
    """Warm-started NS inverse with a per-system divergence guard. ks, init
    (B, npad, npad), npad in {128, 256}, any B; init in the same Jacobi
    scaling as ks. A system whose start has row-sum residual
    r0 = max_i sum_j |I - ks init|_ij below `guard` runs max(n_wquad, 1)
    bf16x3 and n_whi fp32 quadratic steps from init; the others run the cold
    schedule (a0, n_scaled, n_quad, n_hi) of `ns_inverse_scaled`, so the
    result is factorization-grade either way. On the card one call makes
    two launches on the stream: the guard and the warm branch on
    `csrc/ns_refine.cu`'s persistent grid, which flags each system whose
    guard trips and stores nothing for it, then K3's own kernel on the
    flagged systems alone (a masked instance), so a tripped system's result
    is K3's bit for bit."""
    with span("qct.ops.ns_inverse_warm"):
        b = ks.shape[0] if ks.dim() == 3 else None
        npad = ks.shape[-1] if ks.dim() == 3 else None
        _launch.check(ks, "ks", (b, npad, npad))
        _launch.check(init, "init", (b, npad, npad), ks.device)
        _check_tile(npad)
        _check_schedule(n_scaled)
        if not ks.is_cuda:
            return ns_inverse_warm_reference(ks, init, a0, n_scaled, n_quad, n_hi, n_wquad,
                                             n_whi, guard)
        ks, init = _launch.aligned(ks), _launch.aligned(init)
        lib = _build.load()
        entry = lib.qct_ns_inverse_warm if npad == N else lib.qct_ns_inverse_warm_256
        inv = torch.empty_like(ks)
        tripped = torch.empty(b, dtype=torch.int32, device=ks.device)   # the guard's flags
        with torch.cuda.device(ks.device):
            rc = entry(_launch.ptr(ks), _launch.ptr(init), _launch.ptr(inv),
                       _launch.ptr(tripped), b, _mus_arg(a0, n_scaled), n_scaled, n_quad,
                       n_hi, n_wquad, n_whi, guard, _launch.stream(ks))
        _launch.raise_on_error(rc, f"ns_inverse_warm at the {npad} tile")
        _launch.count(_K7, npad)
        return inv


_K7 = _launch.new_count(ns_inverse_warm)


def ns_inverse_blocked_reference(ks, iters: int = 25):
    """Plain PyTorch K9: `iters` fp32 NS steps from I / ||K||_inf."""
    return _ns_schedule(ks, [], 0, iters)


def ns_inverse_reference(ks, iters: int = 25):
    """Plain PyTorch K8: K9's reference on one system."""
    return ns_inverse_blocked_reference(ks[None], iters)[0]


def ns_inverse(ks, iters: int = 25):
    """Plain fp32 NS inverse of one Jacobi-scaled SPD system ks, exactly
    (128, 128) or (256, 256) with identity on the pad: X0 = I / ||K||_inf,
    then `iters` steps X <- X (2I - K X). On the card one cluster runs it:
    2 x 4 blocks of 64 x 32 at 128, 4 x 4 blocks of 64 x 64 at 256."""
    with span("qct.ops.ns_inverse"):
        npad = ks.shape[-1] if ks.dim() == 2 else None
        _launch.check(ks, "ks", (npad, npad))
        _check_tile(npad)
        if not ks.is_cuda:
            return ns_inverse_reference(ks, iters)
        ks = _launch.aligned(ks)
        lib = _build.load()
        inv = torch.empty_like(ks)
        with torch.cuda.device(ks.device):
            rc = lib.qct_ns_inverse_plain_one(_launch.ptr(ks), _launch.ptr(inv), npad, iters,
                                              _launch.stream(ks))
        _launch.raise_on_error(rc, f"ns_inverse at the {npad} tile")
        _launch.count(_K8, npad)
        return inv


_K8 = _launch.new_count(ns_inverse)


def ns_inverse_blocked(ks, iters: int = 25):
    """`ns_inverse` on a batch ks (B, npad, npad), npad in {128, 256}, any B
    (the JAX kernel's multiple of G is the caller's padding contract). On the
    card: a 4-CTA cluster a system at 256; at 128 `csrc/ns_refine.cu`'s
    persistent grid, its fp32 step as `wgmma`."""
    with span("qct.ops.ns_inverse_blocked"):
        b = ks.shape[0] if ks.dim() == 3 else None
        npad = ks.shape[-1] if ks.dim() == 3 else None
        _launch.check(ks, "ks", (b, npad, npad))
        _check_tile(npad)
        if not ks.is_cuda:
            return ns_inverse_blocked_reference(ks, iters)
        ks = _launch.aligned(ks)
        lib = _build.load()
        entry = lib.qct_ns_inverse_plain if npad == N else lib.qct_ns_inverse_plain_256
        inv = torch.empty_like(ks)
        with torch.cuda.device(ks.device):
            rc = entry(_launch.ptr(ks), _launch.ptr(inv), b, iters, _launch.stream(ks))
        _launch.raise_on_error(rc, f"ns_inverse_blocked at the {npad} tile")
        _launch.count(_K9, npad)
        return inv


_K9 = _launch.new_count(ns_inverse_blocked)


# make_ns_inverse: the counterpart of the JAX package's custom_vmap. The
# unbatched operator runs K8; its vmap rule flattens the batch, pads it to a
# multiple of G with identity systems, as the JAX rule does, and runs the
# batched operator (K9), whose own vmap rule folds any outer vmap level into
# its batch, so nested vmaps still make one K9 launch. The operator bodies
# look the wrappers up at call time.

@torch.library.custom_op("qct::ns_inverse", mutates_args=())
def _ns_inverse_op(ks: torch.Tensor, iters: int) -> torch.Tensor:
    return ns_inverse(ks, iters)


@torch.library.custom_op("qct::ns_inverse_blocked", mutates_args=())
def _ns_inverse_blocked_op(ks: torch.Tensor, iters: int) -> torch.Tensor:
    return ns_inverse_blocked(ks, iters)


@_ns_inverse_op.register_fake
@_ns_inverse_blocked_op.register_fake
def _(ks, iters):
    return torch.empty_like(ks)


def _ns_inverse_padded(ks: torch.Tensor, iters: int) -> torch.Tensor:
    """K9 on ks (..., npad, npad): leading dims flattened, the batch padded
    to a multiple of G with identity systems, the padding sliced off."""
    lead, npad = ks.shape[:-2], ks.shape[-1]
    flat = ks.reshape(-1, npad, npad)
    b = flat.shape[0]
    pad = (-b) % G
    if pad:
        eye = torch.eye(npad, dtype=ks.dtype, device=ks.device)
        flat = torch.cat([flat, eye.expand(pad, npad, npad)], dim=0)
    return _ns_inverse_blocked_op(flat.contiguous(), iters)[:b].reshape(lead + (npad, npad))


# (ks is each operator's only tensor, so a vmap rule sees it batched)
@_ns_inverse_op.register_vmap
def _(info, in_dims, ks, iters):
    return _ns_inverse_padded(ks.movedim(in_dims[0], 0), iters), 0


@_ns_inverse_blocked_op.register_vmap
def _(info, in_dims, ks, iters):
    ks = ks.movedim(in_dims[0], 0)
    npad = ks.shape[-1]
    out = _ns_inverse_blocked_op(ks.reshape(-1, npad, npad).contiguous(), iters)
    return out.reshape(ks.shape), 0


def make_ns_inverse(iters: int = 25):
    """f(ks) -> the plain fp32 NS inverse of ks, Jacobi-scaled SPD padded to
    a tile: one (npad, npad) system runs K8 (`ns_inverse`); a batch
    (..., npad, npad), or one system under `torch.func.vmap`, runs K9
    (`ns_inverse_blocked`) once on the flattened batch padded to a multiple
    of G."""
    def f(ks):
        if ks.dim() > 2:
            return _ns_inverse_padded(ks, iters)
        return _ns_inverse_op(ks, iters)

    return f


def _ns_small(ss: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain fp32 NS inverse of a batch of small SPD blocks (B, m, m), Jacobi-
    prescaled inside: the counterpart of the JAX package's `_xla_ns_small`."""
    eye = torch.eye(ss.shape[-1], dtype=ss.dtype, device=ss.device)
    d = torch.rsqrt(torch.clamp(torch.diagonal(ss, dim1=-2, dim2=-1), min=1e-30))
    sshat = ss * d[:, :, None] * d[:, None, :]
    x = (1.0 / sshat.abs().sum(-1).amax(-1))[:, None, None] * eye
    for _ in range(iters):
        kx = sshat @ x
        x = x @ (2.0 * eye - kx)
    return x * d[:, :, None] * d[:, None, :]


def ns_inverse_schur_scaled(ks, a0: float = 5e-4, n_scaled: int = 6,
                            n_quad: int = 2, n_hi: int = 1, n_small: int = 13,
                            n_scrub: int = 1):
    """Schur-split NS inverse (K4) of Jacobi-scaled SPD ks (B, n, n),
    128 < n <= 192, for ADMM-grade conditioning only (cond <~ 1e3; the polish
    K keeps the 256 tile). With K = [[A, B], [B', D]] at the 128 boundary:
    A^-1 from K3 at the 128 tile (the batch G-padded as the JAX code pads
    it), the Schur complement S = D - B' A^-1 B inverted by `_ns_small`, the
    2 x 2 block inverse assembled, then n_scrub fp32 NS steps at the logical
    n. Returns the (B, n, n) inverse at the logical size. The products
    around K3 are fp32 `torch.matmul`s, as the JAX function's are
    `Precision.HIGHEST` XLA products."""
    with span("qct.ops.ns_inverse_schur_scaled"):
        b, n = ks.shape[0], ks.shape[-1]
        if not 128 < n <= 192:
            raise ValueError(f"the Schur split takes 128 < n <= 192, got n={n}")
        a = ks[:, :N, :N]
        bb = ks[:, :N, N:]
        dd = ks[:, N:, N:]
        pad_b = (-b) % G
        if pad_b:
            a = torch.cat([a, torch.eye(N, dtype=ks.dtype, device=ks.device).expand(
                pad_b, N, N)], dim=0)
        ainv = ns_inverse_scaled(a.contiguous(), a0, n_scaled, n_quad, n_hi)[:b]
        aib = ainv @ bb
        s = dd - bb.transpose(1, 2) @ aib
        sinv = _ns_small(s, n_small)
        aib_sinv = aib @ sinv
        tl = ainv + aib_sinv @ aib.transpose(1, 2)
        x = torch.cat([torch.cat([tl, -aib_sinv], dim=2),
                       torch.cat([-aib_sinv.transpose(1, 2), sinv], dim=2)], dim=1)
        eye = torch.eye(n, dtype=ks.dtype, device=ks.device)
        for _ in range(n_scrub):
            kx = ks @ x
            x = x @ (2.0 * eye - kx)
        return x
