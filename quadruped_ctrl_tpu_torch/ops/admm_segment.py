"""One ADMM segment of the batched MPC solve, every system in one launch.

`solver/admm.admm_mpc_batched`'s kernel branch runs its iterate in
tile-padded spaces: x (B, np), z and y (B, mp), the Jacobi scale folded into
the inverse `inv` (B, np, np). A is the friction pyramid of friction
coefficient mu, block diagonal in one 5 x 3 block (`formation.pyramid_dense`).
A segment is `n_lo` iterations with bf16 products and then `n_hi` with fp32
ones against one inverse (the adaptive-rho refactorization comes between two
segments). On a CUDA tensor `admm_segment` launches `csrc/admm_segment.cu`
where the system's true n x n inverse fits in a block's shared memory (`fits`,
the library's rule: n = 120, 144 and 192, every system the solver forms
today, and up to 234); on a CPU tensor, or where it does not fit, it runs
`admm_segment_reference`, the iterate as plain ops with A dense (the JAX
package's `mk_body` scan). The route follows n alone.

The kernel writes zeros on the carry's padding, where the reference, from the
solver's zero-padded carry, leaves zeros too.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from quadruped_ctrl_tpu_torch.core.precision import bf16_round, bmv
from quadruped_ctrl_tpu_torch.mpc import formation
from quadruped_ctrl_tpu_torch.ops import _build, _launch
from quadruped_ctrl_tpu_torch.utils.timer import span


def fits(n: int) -> bool:
    """Whether the kernel runs a segment of n-variable systems: n a positive
    multiple of 3 whose block fits in shared memory, as the built library
    decides it (`qct_admm_segment_threads` is 0 elsewhere)."""
    return _build.load().qct_admm_segment_threads(n) > 0


@functools.lru_cache(maxsize=16)
def pyramid_padded(mu: float, n: int, mp: int, np_: int, device: torch.device) -> torch.Tensor:
    """The pyramid A of n variables (5 n / 3 rows), zero-padded to (mp, np),
    float32 on `device`. Cached: callers only read it."""
    a = torch.zeros((mp, np_), dtype=torch.float32)
    a[:5 * n // 3, :n] = torch.from_numpy(formation.pyramid_dense(mu, n // 3))
    return a.to(device)


def admm_segment_reference(inv, grad, l, u, rho, carry, *, n, mu, sigma, alpha, n_lo, n_hi):
    """The segment as plain ops: `n_lo` iterations of
    rhs = sigma x - g + A'(rho z - y), x_t = bf16(inv) bf16(rhs) in fp32,
    z_t = A x_t, the alpha relaxations, the clamp to [l, u] and the dual
    update, then `n_hi` with x_t = inv rhs in fp32. Returns (x, z, y)."""
    a_pad = pyramid_padded(mu, n, l.shape[1], grad.shape[1], grad.device)
    inv16 = bf16_round(inv) if n_lo > 0 else None
    at_pad = a_pad.T
    inv_rho = 1.0 / rho
    x, z, y = carry
    for i in range(n_lo + n_hi):
        rhs = sigma * x - grad + (rho * z - y) @ a_pad
        if i < n_lo:
            x_t = bmv(inv16, bf16_round(rhs))
        else:
            x_t = bmv(inv, rhs)
        z_t = x_t @ at_pad
        x = alpha * x_t + (1.0 - alpha) * x
        z_relax = alpha * z_t + (1.0 - alpha) * z
        z_new = torch.clamp(z_relax + inv_rho * y, min=l, max=u)
        y = y + rho * (z_relax - z_new)
        z = z_new
    return x, z, y


def admm_segment(inv, grad, l, u, rho, carry, *, n, mu, sigma, alpha, n_lo, n_hi):
    """One ADMM segment on B systems of n variables and m = 5 n / 3 pyramid
    rows of friction coefficient mu: inv (B, np, np) the Jacobi-folded
    inverse (its [:n, :n] is read), grad (B, np), l, u, rho (B, mp), carry
    (x (B, np), z (B, mp), y (B, mp)), zero on the padding. Returns the carry
    after `n_lo` bf16 and `n_hi` fp32 iterations, fresh tensors."""
    with span("qct.ops.admm_segment"):
        x0, z0, y0 = carry
        b, np_ = grad.shape
        mp_ = l.shape[1]
        _launch.check(inv, "inv", (b, np_, np_))
        _launch.check(grad, "grad", (b, np_), inv.device)
        for name, t in (("l", l), ("u", u), ("rho", rho), ("z", z0), ("y", y0)):
            _launch.check(t, name, (b, mp_), inv.device)
        _launch.check(x0, "x", (b, np_), inv.device)
        if n % 3 or 5 * n // 3 > mp_ or n > np_:
            raise ValueError(f"{n} variables do not fit a {mp_} x {np_} pyramid")
        kw = dict(n=n, mu=mu, sigma=sigma, alpha=alpha, n_lo=n_lo, n_hi=n_hi)
        if not inv.is_cuda or not fits(n):
            return admm_segment_reference(inv, grad, l, u, rho, carry, **kw)
        ops = tuple(map(_launch.aligned, (inv, grad, l, u, rho, x0, z0, y0)))
        x, z, y = torch.empty_like(x0), torch.empty_like(z0), torch.empty_like(y0)
        P = _launch.ptr
        with torch.cuda.device(inv.device):
            rc = _build.load().qct_admm_segment(
                *map(P, ops), P(x), P(z), P(y), b, n, np_, mp_, sigma, alpha, 1.0 - alpha,
                1.0 / mu, n_lo, n_hi, _launch.stream(inv))
        _launch.raise_on_error(rc, "admm_segment")
        _launch.count(_KS, np_)
        return x, z, y


_KS = _launch.new_count(admm_segment)


@contextlib.contextmanager
def recorded_calls():
    """Record each `admm_segment` call made inside the block, as (operands,
    keywords), into the list it yields; the calls run as they would. For
    tools and tests that replay or hold a solve's own segments."""
    global admm_segment
    calls, real = [], admm_segment

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    admm_segment = record
    try:
        yield calls
    finally:
        admm_segment = real
