"""ADMM QP solver with active-set polish (OSQP/JCQP-style splitting).

The counterpart of `quadruped_ctrl_tpu/solver/admm.py`: min 0.5 x'Hx + g'x
s.t. l <= Ax <= u over the Schur-complement KKT matrix
K = H + sigma I + A' diag(rho) A, factorized by Newton-Schulz inversion.

The per-scenario solver: `admm_dense` (a dense A) and `admm_mpc` (A the
friction pyramid, applied structurally), each on one problem, written so that
`torch.func.vmap` batches them (`mpc/pipeline.solve_batch`): every update is
out of place and every data-dependent choice a `torch.where`. Its
factorization (`_make_solver`) is the plain fp32 NS `_ns_inverse`; the
adaptive-rho refactorization and the polish rounds after the first
warm-start it from the previous inverse behind a residual guard, as the JAX
code does. It launches no kernel, as the JAX function runs no Pallas kernel.
Its control flow reads no tensor value, so on a CUDA device outside a
transform `admm_mpc` replays its body `_admm_mpc_eager` as one CUDA graph,
captured on the first call for each shape, config, budget and matmul
precision: the same kernels in the same order, one host launch.

The batched solve `admm_mpc_batched` (A the friction pyramid, a batch axis
carried explicitly). Both branches of the JAX function are here:

* the kernel branch (`use_kernels`, the default for CUDA tensors): every cold
  factorization runs the fused K-build + NS kernel K2
  (`ops/ns_inverse.ns_inverse_scaled_build`), or the two-step build and K3
  when `_FUSED_BUILD` is False; ADMM-grade factorizations of 128 < n <= 160
  systems take the Schur split K4 (`ops/ns_inverse.ns_inverse_schur_scaled`)
  when `ns_schur_split` is on. The ADMM iterate runs in tile-padded spaces
  with the inverse quantized to bf16 for all but the last `f32_tail_iters`
  iterations, each segment (the iterations between two factorizations) one
  launch of the segment kernel (`ops/admm_segment.admm_segment`) where the
  system's inverse fits in a block's shared memory (n <= 234), else the
  same iterate as plain ops;
* the plain branch: plain 25-step fp32 NS and the structural pyramid.

With `polish_woodbury`, every polish round after the first updates the
previous round's inverse by a rank-limited Woodbury correction and refines it
with two NS steps: kernel K6 (`ops/ns_inverse.ns_inverse_refine`) on the
kernel branch, plain fp32 steps on the plain branch.

`admm_mpc_fused` is the single-launch solve (kernel K5,
`ops/fused_admm.fused_admm_solve`) that `solve_packed_batch(use_fused=True)`
runs.

`_batched_solver(prev_inv=..., prev_scale=...)` warm-starts a batched
factorization from a nearby system's inverse through kernel K7
(`ops/ns_inverse.ns_inverse_warm`), whose per-system guard falls back to the
cold schedule; as in JAX, `admm_mpc_batched` never passes `prev_inv`.

Where the batched JAX code updates an array with `.at[].set`, the port builds
a fresh tensor (zeros or ones) and writes into it; no caller's tensor is
modified. The `lax.scan` loops are Python loops.

Phases are `utils/timer.span`s: `qct.factorize` (one K build and inverse),
`qct.admm.iterate` (one ADMM segment), `qct.admm.rho_adapt` and
`qct.admm.polish` (one round), the last two with their refactorization
nested; `qct.admm.graph` around `admm_mpc`'s replay (its copies, the graph
launch, a first call's capture), where the others exist only while a
capture or the eager body runs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from quadruped_ctrl_tpu_torch.config import MPCConfig, SolverConfig
from quadruped_ctrl_tpu_torch import device
from quadruped_ctrl_tpu_torch.core.precision import bf16_round, bmv
from quadruped_ctrl_tpu_torch.mpc import formation
from quadruped_ctrl_tpu_torch.ops import admm_segment as AS
from quadruped_ctrl_tpu_torch.ops import fused_admm as FA
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from quadruped_ctrl_tpu_torch.utils.timer import span


def constraint_rho(cfg: SolverConfig, l, u):
    """Per-row penalty: equality / infinite / inequality (QpProblem.cpp:276-291)."""
    infinite = (l < -cfg.infty) & (u > cfg.infty)
    equality = torch.abs(u - l) < cfg.eql_tol
    inner = torch.where(equality, cfg.rho * cfg.rho_equality_scale, cfg.rho)
    return torch.where(infinite, cfg.rho_infty, inner).to(l.dtype)


def _ns_inverse(ks, iters: int, init=None):
    """Plain fp32 Newton-Schulz inverse of SPD, Jacobi-scaled matrices
    (..., n, n), each on its own: X <- X (2I - K X) from X0 = I / ||K||_inf,
    or from `init` (the inverse of a nearby matrix) where its residual
    max_i sum_j |I - K init|_ij is below 0.9, the divergence guard."""
    eye = torch.eye(ks.shape[-1], dtype=ks.dtype, device=ks.device)
    x = (1.0 / ks.abs().sum(-1).amax(-1))[..., None, None] * eye
    if init is not None:
        resid = (eye - ks @ init).abs().sum(-1).amax(-1)
        x = torch.where((resid < 0.9)[..., None, None], init, x)
    for _ in range(iters):
        kx = ks @ x
        x = x @ (2.0 * eye - kx)
    return x


@dataclasses.dataclass
class _ScenarioSolver:
    """One problem's factorization (the JAX `_make_solver`'s `solve`):
    K^-1 = D scaled_inv D with D = diag(scale), solve(b) with iterative
    refinement against the scaled K."""

    scaled_inv: torch.Tensor           # (n,n) Jacobi-scaled inverse
    scale: torch.Tensor                # (n,) Jacobi scale d
    ks: torch.Tensor                   # (n,n) Jacobi-scaled K

    def solve(self, b, refine: int = 2):
        """The NS inverse is accurate to ~eps cond; each refinement pass
        squares the error at the cost of two matvecs."""
        d = self.scale
        bs = d * b
        x = self.scaled_inv @ bs
        for _ in range(refine):
            x = x + self.scaled_inv @ (bs - self.ks @ x)
        return d * x

    __call__ = solve


def _make_solver(k, ns_iters: int = 25, prev_inv=None, prev_scale=None):
    """Jacobi-prescaled NS solver for one SPD k (n, n). (prev_inv,
    prev_scale), a previous solver's `.scaled_inv` / `.scale` for a nearby
    system, warm-start the NS iteration, rescaled across the two Jacobi
    scalings and guarded by `_ns_inverse`."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(k, dim1=-2, dim2=-1), min=1e-30))
    ks = k * d[..., :, None] * d[..., None, :]
    init = None
    if prev_inv is not None:
        r = prev_scale / d
        init = r[..., :, None] * prev_inv * r[..., None, :]
    return _ScenarioSolver(scaled_inv=_ns_inverse(ks, ns_iters, init=init), scale=d, ks=ks)


def _iterate(cfg: SolverConfig, solve, apply_a, apply_at, g, l, u, rho, n_iter: int,
             init=None):
    """The ADMM loop on one problem. apply_a: x -> Ax, apply_at: y -> A'y;
    init: (x, z, y), zeros when None. Returns (x, z, y)."""
    alpha = cfg.over_relax_alpha
    sigma = cfg.sigma
    inv_rho = 1.0 / rho
    if init is None:
        z0 = torch.zeros_like(rho).to(g.dtype)
        init = (torch.zeros_like(g), z0, z0)
    x, z, y = init
    with span("qct.admm.iterate"):
        for _ in range(n_iter):
            rhs = sigma * x - g + apply_at(rho * z - y)
            x_t = solve(rhs)
            z_t = apply_a(x_t)
            z_relax = alpha * z_t + (1.0 - alpha) * z
            x = alpha * x_t + (1.0 - alpha) * x
            z_new = torch.minimum(torch.maximum(z_relax + inv_rho * y, l), u)
            y = y + rho * (z_relax - z_new)
            z = z_new
    return x, z, y


def _adapt_rho_factor(cfg: SolverConfig, ax, z, hx, grad_n, aty):
    """OSQP adaptive-rho rule: sqrt of the scaled primal/dual residual ratio,
    clipped, per row of (B, m) / (B, n)."""
    eps = 1e-12
    r_pri = torch.abs(ax - z).amax(-1)
    s_pri = torch.clamp(torch.maximum(torch.abs(ax).amax(-1),
                                      torch.abs(z).amax(-1)), min=eps)
    r_du = torch.abs(hx + grad_n + aty).amax(-1)
    s_du = torch.maximum(
        torch.maximum(torch.abs(hx).amax(-1), torch.abs(aty).amax(-1)),
        torch.clamp(torch.abs(grad_n).amax(-1), min=eps))
    ratio = (r_pri / s_pri) / torch.clamp(r_du / s_du, min=eps)
    return torch.clamp(torch.sqrt(ratio), cfg.rho_adapt_clip_lo,
                       cfg.rho_adapt_clip_hi)


def _pyramid_dense(mu: float, h: int, nf: int):
    """Dense (5 h nf, 3 h nf) friction-pyramid matrix, as a numpy constant."""
    return formation.pyramid_dense(mu, h * nf)


def _gj_inverse(c: torch.Tensor, pivot: bool = True) -> torch.Tensor:
    """Batched (B, r, r) inverse by Gauss-Jordan elimination over the
    (B, r, 2r) augmented system, r batched steps. With `pivot`, partial
    pivoting picks the first row of largest |entry| at or below the
    diagonal (torch.argmax returns the first maximum, as jnp.argmax does),
    selected by a one-hot contraction as in the JAX function."""
    r = c.shape[-1]
    aug = torch.cat([c, torch.eye(r, dtype=c.dtype, device=c.device).expand(c.shape)], dim=-1)
    rows = torch.arange(r, device=c.device)
    for k in range(r):
        if pivot:
            col = torch.where(rows[None, :] >= k, aug[:, :, k].abs(), -1.0)
            p = torch.argmax(col, dim=1)                          # (B,)
            is_p = rows[None, :] == p[:, None]                    # (B,r)
            rowp = torch.einsum("br,brc->bc", is_p.to(c.dtype), aug)
            rowk = aug[:, k, :]
            aug = torch.where(is_p[:, :, None], rowk[:, None, :], aug)
            aug[:, k, :] = rowp
        pivrow = aug[:, k, :] / aug[:, k, k][:, None]
        aug = aug - aug[:, :, k][:, :, None] * pivrow[:, None, :]
        aug[:, k, :] = pivrow
    return aug[:, :, r:]


def _top_k_indices(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of v (B, m), ties broken
    by the lower index first: `lax.top_k`'s order, which torch.topk does not
    promise."""
    return torch.sort(v, dim=-1, descending=True, stable=True).indices[:, :k]


def _polish(cfg: SolverConfig, build_solver, apply_a, apply_at, grad, l, u, finite_u,
            x, z, y, rounds: int, w_act: float = 1e4, act_tol: float = 1e-4):
    """Active-set polish on one problem: enforce the ADMM-identified active
    constraints with penalty w_act and re-solve, carrying augmented-
    Lagrangian multiplier estimates; each round drops wrong-sign multipliers
    and adds violated rows, and the least-infeasible iterate is kept. Round
    0 factorizes cold; each later round warm-starts from the previous
    round's inverse (build_solver(w, prev_inv, prev_scale))."""
    dtype = x.dtype
    lo_act = (z - l) < act_tol
    hi_act = finite_u & ((u - z) < act_tol)

    def viol(v):
        av = apply_a(v)
        return torch.maximum(l - av, torch.where(finite_u, av - u, -1.0)).amax()

    def one_round(best_x, best_v, lo, hi, y_al, prev_inv, prev_scale):
        with span("qct.admm.polish"):
            act = lo | hi
            bound = torch.where(lo, l, torch.where(hi & finite_u, u, 0.0))
            w = torch.where(act, w_act, 0.0).to(dtype)
            solve = build_solver(w, prev_inv=prev_inv, prev_scale=prev_scale)
            y_act = torch.where(act, y_al, 0.0)
            x_p = solve(-grad + apply_at(w * bound - y_act))
            ax = apply_a(x_p)
            y_new = y_act + w * (ax - bound)
            v_p = torch.where(torch.isfinite(x_p).all(), viol(x_p), torch.inf)
            take = v_p < best_v
            best_x = torch.where(take, x_p, best_x)
            best_v = torch.where(take, v_p, best_v)
            lo = (lo & (y_new <= 1e-9)) | (ax < l - 1e-6)
            hi = (hi & (y_new >= -1e-9)) | (finite_u & (ax > u + 1e-6))
            y_al = torch.where(lo | hi, y_new, 0.0)
            return best_x, best_v, lo, hi, y_al, solve.scaled_inv, solve.scale

    y_seed = torch.where(lo_act | hi_act, y, 0.0)
    carry = one_round(x, torch.clamp(viol(x), min=0.0), lo_act, hi_act, y_seed, None, None)
    for _ in range(rounds - 1):
        carry = one_round(*carry)
    return carry[0]


def kkt_residuals(hess, grad, a_mat, l, u, x, y):
    """(primal, dual) infinity-norm residuals (QpProblem.cpp residual check)."""
    ax = a_mat @ x
    primal = (torch.clamp(ax - u, min=0.0) + torch.clamp(l - ax, min=0.0)).amax()
    dual = (hess @ x + grad + a_mat.T @ y).abs().amax()
    return primal, dual


def admm_dense(cfg: SolverConfig, hess, grad, a_mat, l, u, iterations: int | None = None,
               polish_rounds: int = 0):
    """ADMM on one QP with a dense constraint matrix a_mat (m, n). Returns
    (x, z, y)."""
    n_iter = cfg.iterations if iterations is None else iterations
    rho = constraint_rho(cfg, l, u)
    eye = torch.eye(hess.shape[-1], dtype=hess.dtype, device=hess.device)

    def build_solver(w, prev_inv=None, prev_scale=None):
        with span("qct.factorize"):
            k = hess + cfg.sigma * eye
            k = k + (a_mat.T * w[None, :]) @ a_mat
            return _make_solver(k, cfg.ns_iters, prev_inv, prev_scale)

    def apply_a(v):
        return a_mat @ v

    def apply_at(w):
        return a_mat.T @ w

    x, z, y = _iterate(cfg, build_solver(rho), apply_a, apply_at, grad, l, u, rho, n_iter)
    if polish_rounds > 0:
        x = _polish(cfg, build_solver, apply_a, apply_at, grad, l, u, u < cfg.infty,
                    x, z, y, polish_rounds)
    return x, z, y


def admm_mpc(cfg: SolverConfig, cfg_mpc: MPCConfig, hess, grad, gait_table,
             iterations: int | None = None, polish_rounds: int | None = None,
             warm=None, return_warm: bool = False):
    """The MPC QP of one scenario with the structural friction pyramid:
    hess (n, n), grad (n,), gait_table (h, nf) contact flags (nf = 4, or a
    stance-compressed table with its matching Hessian), n = 3 nf h. Swing
    feet get fz bounds [0, 0]. Returns forces (n,).

    `warm`: an (x_hat, z_hat, y_hat) triple in force-normalized units (what
    `return_warm=True` returned); zeros are exactly the cold start. With
    `return_warm`, returns (forces, (x_hat, z_hat, y_hat)), the pre-polish
    ADMM iterate.

    Where `_replayable` holds (CUDA tensors, no `torch.func` transform, no
    autograd, no capture under way), the solve replays one CUDA graph of
    `_admm_mpc_eager` (`_replay`); everywhere else it runs that body."""
    n_iter = cfg.iterations if iterations is None else iterations
    polish_rounds = cfg.polish_rounds if polish_rounds is None else polish_rounds
    tensors = (hess, grad, gait_table) + (() if warm is None else tuple(warm))
    if _replayable(tensors):
        return _replay(cfg, cfg_mpc, tensors, n_iter, polish_rounds, return_warm)
    return _admm_mpc_eager(cfg, cfg_mpc, hess, grad, gait_table, n_iter, polish_rounds,
                           warm, return_warm)


# (_graph_key) -> _QPGraph: the captured solves, oldest first
_GRAPHS: dict = {}
_MAX_GRAPHS = 16


@dataclasses.dataclass
class _QPGraph:
    """One captured `_admm_mpc_eager`: its static inputs (hess, grad,
    gait_table and the warm triple, if any) and outputs (forces and, with
    `return_warm`, the warm triple), overwritten by every replay."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple


def _replayable(tensors) -> bool:
    """Whether `admm_mpc` on these tensors can replay a CUDA graph: all on
    one CUDA device, none requiring grad, outside any `torch.func`
    transform (`solve_batch`'s vmap) and outside a capture."""
    return (all(t.is_cuda and not t.requires_grad for t in tensors)
            and len({t.device for t in tensors}) == 1
            and not torch._C._are_functorch_transforms_active()
            and not torch.cuda.is_current_stream_capturing())


def _graph_key(cfg: SolverConfig, cfg_mpc: MPCConfig, tensors, n_iter: int,
               polish_rounds: int, return_warm: bool) -> tuple:
    """Everything a capture of `_admm_mpc_eager` fixes: the configs, the
    resolved budgets, whether a warm triple comes in and goes out, each
    input's shape, dtype and device, and the float32 matmul precision in
    force (`control/controller.mpc_update` runs under `exact_matmuls`)."""
    return (cfg, cfg_mpc, n_iter, polish_rounds, len(tensors) > 3, return_warm,
            tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
            torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())


def _capture(body, tensors) -> _QPGraph:
    """Capture `body(*inputs)` on copies of `tensors`, after one warm-up
    run on a side stream (the libraries' lazy set-up stays out of the
    graph)."""
    inputs = tuple(t.clone(memory_format=torch.contiguous_format) for t in tensors)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body(*inputs)
    outputs = (out[0],) + tuple(out[1]) if isinstance(out, tuple) else (out,)
    return _QPGraph(graph=graph, inputs=inputs, outputs=outputs)


def _replay(cfg: SolverConfig, cfg_mpc: MPCConfig, tensors, n_iter: int,
            polish_rounds: int, return_warm: bool):
    """`_admm_mpc_eager` on `tensors` (hess, grad, gait_table, then the warm
    triple if any) as one replay of its CUDA graph, captured on the first
    call for its key: the inputs copied in, one graph launch, the outputs
    cloned out (a later replay overwrites the graph's own)."""
    key = _graph_key(cfg, cfg_mpc, tensors, n_iter, polish_rounds, return_warm)
    with span("qct.admm.graph"), torch.cuda.device(tensors[0].device):
        qp = _GRAPHS.get(key)
        if qp is None:
            def body(hess, grad, gait_table, *warm):
                return _admm_mpc_eager(cfg, cfg_mpc, hess, grad, gait_table, n_iter,
                                       polish_rounds, warm or None, return_warm)
            if len(_GRAPHS) >= _MAX_GRAPHS:
                del _GRAPHS[next(iter(_GRAPHS))]
            qp = _GRAPHS[key] = _capture(body, tensors)
        for static, t in zip(qp.inputs, tensors):
            static.copy_(t)
        qp.graph.replay()
        out = tuple(o.clone() for o in qp.outputs)
    return (out[0], out[1:]) if return_warm else out[0]


def _admm_mpc_eager(cfg: SolverConfig, cfg_mpc: MPCConfig, hess, grad, gait_table,
                    n_iter: int, polish_rounds: int, warm, return_warm: bool):
    """`admm_mpc`'s body, run op by op, with the budgets resolved."""
    h, nf = gait_table.shape
    n = 3 * nf * h
    dtype, dev = hess.dtype, hess.device

    # forces normalized by f_max: the SI problem's Hessian (diag ~1e-4)
    # against O(100 N) forces is hopeless in fp32; normalized, all is O(1)
    f_scale = float(cfg_mpc.f_max)
    hess_n = hess * (f_scale * f_scale)
    grad_n = grad * f_scale
    l3, u3 = formation.pyramid_bounds(cfg_mpc, gait_table.to(dtype))
    l = l3.reshape(-1) / f_scale
    u_raw = u3.reshape(-1)
    u = torch.where(u_raw > cfg.infty, u_raw, u_raw / f_scale)
    rho = constraint_rho(cfg, l, u)

    k0 = hess_n + cfg.sigma * torch.eye(n, dtype=dtype, device=dev)
    sel = torch.eye(h * nf, dtype=dtype, device=dev)

    def build_solver(w, prev_inv=None, prev_scale=None):
        with span("qct.factorize"):
            # the 3 x 3 gram blocks added on K's block diagonal
            gram = formation.pyramid_gram(cfg_mpc, w.reshape(h, nf, 5)).reshape(h * nf, 3, 3)
            k = k0 + (gram[:, :, None, :] * sel[:, None, :, None]).reshape(n, n)
            ns = cfg.ns_iters if prev_inv is None else cfg.ns_warm_iters
            return _make_solver(k, ns, prev_inv, prev_scale)

    def apply_a(v):
        return formation.pyramid_apply(cfg_mpc, v.reshape(h, nf, 3)).reshape(-1)

    def apply_at(w):
        return formation.pyramid_apply_t(cfg_mpc, w.reshape(h, nf, 5)).reshape(-1)

    segs = max(int(cfg.rho_adapt), 0) + 1
    seg_n = n_iter // segs
    rho_c = rho
    solver_c = build_solver(rho)
    carry = warm
    for s_i in range(segs):
        last = s_i == segs - 1
        n_seg = n_iter - seg_n * (segs - 1) if last else seg_n
        x, z, y = _iterate(cfg, solver_c, apply_a, apply_at, grad_n, l, u, rho_c, n_seg,
                           init=carry)
        carry = (x, z, y)
        if not last:
            with span("qct.admm.rho_adapt"):
                fac = _adapt_rho_factor(cfg, apply_a(x), z, hess_n @ x, grad_n, apply_at(y))
                rho_c = rho * fac
                solver_c = build_solver(rho_c, prev_inv=solver_c.scaled_inv,
                                        prev_scale=solver_c.scale)
    if polish_rounds > 0:
        x = _polish(cfg, build_solver, apply_a, apply_at, grad_n, l, u, u < cfg.infty,
                    x, z, y, polish_rounds)
    if return_warm:
        return x * f_scale, carry
    return x * f_scale


@dataclasses.dataclass
class _Solver:
    """A batched factorization: solve(b) -> x for K x = b, Jacobi-prescaled
    (K^-1 = D inv D), with iterative refinement against the scaled K."""

    inv: torch.Tensor                  # (B,n,n) Jacobi-scaled inverse
    scale: torch.Tensor                # (B,n) Jacobi scale d
    ks: torch.Tensor | None            # (B,n,n) Jacobi-scaled K, or None
    inv_padded: torch.Tensor | None    # (B,npad,npad) kernel output, or None
    k_scaled_mv: object = None         # x -> ks x when ks is None

    @functools.cached_property
    def inv16(self) -> torch.Tensor:
        return bf16_round(self.inv)

    def __call__(self, b_vec, refine: int = 2, lowp: bool = False):
        d = self.scale
        bs = d * b_vec
        if lowp:
            # bf16 inverse matvec: only for the bulk ADMM iterations, never
            # where the result is read out
            return d * bmv(self.inv16, bf16_round(bs))
        x = bmv(self.inv, bs)
        for _ in range(refine):
            ksx = bmv(self.ks, x) if self.ks is not None else self.k_scaled_mv(x)
            x = x + bmv(self.inv, bs - ksx)
        return d * x


def _batched_solver(k, cfg: SolverConfig, use_kernels: bool, schedule=None,
                    prev_inv=None, prev_scale=None, schur: bool = False):
    """k (B,n,n) SPD -> a _Solver, Jacobi-prescaled. The kernel branch pads
    to the kernel tile and runs K3 on the scaled K (the two-step build), or
    with `prev_inv`/`prev_scale` (a previous solver's `.inv_padded` and
    `.scale` for a nearby system) K7 from the rescaled previous inverse,
    whose per-system guard falls back to the cold `schedule`; the plain
    branch runs the plain 25-step NS."""
    n = k.shape[-1]
    d = torch.rsqrt(torch.clamp(torch.diagonal(k, dim1=-2, dim2=-1), min=1e-30))
    ks = k * d[:, :, None] * d[:, None, :]
    inv_padded = None
    if schedule is None:
        schedule = (cfg.ns_a0, cfg.ns_scaled_iters, cfg.ns_quad_iters,
                    cfg.ns_hi_iters)
    if use_kernels and schur and prev_inv is None and 128 < n <= 192:
        # ADMM-grade 128 < n <= 192: the Schur split at the 128 tile boundary
        # (K4, K3 on the leading block); not valid at polish conditioning
        inv = NI.ns_inverse_schur_scaled(ks, *schedule)
        inv_padded = NI.pad_to(inv, n)   # identity padding, as the kernels'
    elif use_kernels:
        b = ks.shape[0]
        npad = NI.pad_sizes(n)
        ksp = NI.pad_to(ks, n, npad)
        pad_b = (-b) % NI.G
        eye_pad = torch.eye(npad, device=ks.device).expand(pad_b, npad, npad)
        if pad_b:
            ksp = torch.cat([ksp, eye_pad], dim=0)
        if prev_inv is not None:
            # the previous inverse rescaled across the two Jacobi scalings;
            # the padded systems start from their exact inverse (r0 = 0)
            r = torch.ones((b, npad), dtype=ks.dtype, device=ks.device)
            r[:, :n] = prev_scale / d
            init = prev_inv * r[:, :, None] * r[:, None, :]
            if pad_b:
                init = torch.cat([init, eye_pad], dim=0)
            inv_padded = NI.ns_inverse_warm(
                ksp, init.contiguous(), *schedule, n_wquad=cfg.ns_warm_quad,
                n_whi=cfg.ns_warm_hi, guard=cfg.ns_warm_guard)[:b]
        else:
            inv_padded = NI.ns_inverse_scaled(ksp, *schedule)[:b]
        inv = inv_padded[:, :n, :n]
    else:
        inv = _ns_inverse(ks, cfg.ns_iters)
    return _Solver(inv=inv, scale=d, ks=ks, inv_padded=inv_padded)


# A/B switch for the fused K-build factorization (benchmarks and differential
# tests flip it to compare against the two-step build + K3).
_FUSED_BUILD = True


def _batched_solver_fused(hp_g, g9, n: int, bsz: int, cfg: SolverConfig,
                          schedule=None):
    """Fused-build factorization: K assembly, Jacobi prescale and scaled NS
    in kernel K2. hp_g (B_pad, npad, npad): hess_n + sigma I padded to the
    tile and to a G-multiple batch; g9 (B, 9, nblk) gram components."""
    nblk = n // 3
    pad_b = hp_g.shape[0] - bsz
    g9_u = g9
    if pad_b:
        g9 = torch.cat([g9, torch.zeros((pad_b,) + g9.shape[1:], dtype=g9.dtype,
                                        device=g9.device)], dim=0)
    if schedule is None:
        schedule = (cfg.ns_a0, cfg.ns_scaled_iters, cfg.ns_quad_iters,
                    cfg.ns_hi_iters)
    inv_p, ks_p, d_p = NI.ns_inverse_scaled_build(hp_g, g9.contiguous(), *schedule)
    inv_padded = inv_p[:bsz]
    inv = inv_padded[:, :n, :n]
    d = d_p[:bsz, 0, :n]
    k_scaled_mv = None
    if ks_p is not None:
        ks = ks_p[:bsz, :n, :n]
    else:
        # 256 tile: no ks output; refinement matvecs against the scaled K
        # are d*(K@(d*x)) with K = hp + blockdiag3(gram)
        ks = None
        hp_n = hp_g[:bsz, :n, :n]
        g4 = g9_u.transpose(1, 2).reshape(bsz, nblk, 3, 3)

        def k_scaled_mv(x):
            xu = d * x
            ku = bmv(hp_n, xu)
            ku = ku + torch.einsum("bdij,bdj->bdi", g4,
                                   xu.reshape(bsz, nblk, 3)).reshape(bsz, n)
            return d * ku
    return _Solver(inv=inv, scale=d, ks=ks, inv_padded=inv_padded,
                   k_scaled_mv=k_scaled_mv)


def admm_mpc_batched(
    cfg: SolverConfig,
    cfg_mpc: MPCConfig,
    hess,            # (B, n, n) with n = 3*nf*h
    grad,            # (B, n)
    gait_table,      # (B, h, nf)
    iterations: int | None = None,
    polish_rounds: int | None = None,
    use_kernels: bool | None = None,
    warm=None,
    return_warm: bool = False,
    pack: int = 1,
):
    """Batch-explicit MPC QP solve. Returns forces (B, n).

    `warm`/`return_warm`: an (x_hat (B,n), z_hat (B,m), y_hat (B,m)) triple
    in force-normalized units; zeros are exactly the cold start. The
    returned triple is the pre-polish ADMM iterate.

    `pack`: each system is `pack` independent scenarios stacked
    block-diagonally; the adaptive-rho ratio and the polish best-iterate
    selection are then taken per scenario."""
    n_iter = cfg.iterations if iterations is None else iterations
    polish_rounds = cfg.polish_rounds if polish_rounds is None else polish_rounds
    use_kernels = device.use_kernels(hess, use_kernels)
    bsz, h, nf = gait_table.shape
    n = 3 * nf * h
    dtype, dev = hess.dtype, hess.device

    f_scale = float(cfg_mpc.f_max)
    hess_n = hess * (f_scale * f_scale)
    grad_n = grad * f_scale

    u3 = torch.full((bsz, h, nf, 5), cfg_mpc.big_number, dtype=dtype, device=dev)
    u3[..., 4] = gait_table * (cfg_mpc.f_max / f_scale)
    l = torch.zeros((bsz, h * nf * 5), dtype=dtype, device=dev)
    u = u3.reshape(bsz, -1)
    rho = constraint_rho(cfg, l, u)

    eye = torch.eye(n, dtype=dtype, device=dev)
    sel = torch.eye(h * nf, dtype=dtype, device=dev)
    m_full = h * nf * 5

    def per_scn(v):
        """(B, pack*d) -> (B*pack, d): per-scenario view of packed rows."""
        return v.reshape(bsz * pack, v.shape[-1] // pack)

    def scn_fac_rows(fac, d):
        """(B*pack,) scenario factors -> (B, pack*d) row-aligned."""
        return fac.reshape(bsz, pack, 1).expand(bsz, pack, d).reshape(bsz, pack * d)

    admm_schedule = (cfg.ns_admm_a0, cfg.ns_admm_scaled_iters,
                     cfg.ns_quad_iters, cfg.ns_hi_iters)

    hp_g = None
    if use_kernels:
        # hess_n + sigma I, tile-padded (identity diagonal) and G-padded,
        # built once per solve; every cold factorization then runs K2 on it
        npad_f = NI.pad_sizes(n)
        hp_g = NI.pad_to(hess_n + cfg.sigma * eye[None], n, npad_f)
        pad_bf = (-bsz) % NI.G
        if pad_bf:
            hp_g = torch.cat([hp_g, torch.eye(npad_f, device=dev).expand(
                pad_bf, npad_f, npad_f)], dim=0)

    # the 256-tile K2 emits no ks; the Woodbury polish needs solve.ks, so
    # there every factorization takes the two-step build (K3)
    fused_ok = _FUSED_BUILD and not (
        cfg.polish_woodbury and polish_rounds > 1 and use_kernels
        and hp_g.shape[-1] > NI.N)

    def build_solver(w, schedule=None):
        # ADMM-grade factorizations (the only callers passing a schedule) of
        # 128 < n <= 160 systems take the Schur split (K4) at the 128 tile
        # boundary; polish factorizations (schedule None) keep the fused
        # 256-tile kernel
        schur = (cfg.ns_schur_split and use_kernels and schedule is not None
                 and 128 < n <= 160)
        if use_kernels and fused_ok and not schur:
            gram = formation.pyramid_gram(cfg_mpc, w.reshape(bsz, h, nf, 5))
            g9 = gram.reshape(bsz, h * nf, 9).transpose(1, 2)   # (B,9,hnf)
            return _batched_solver_fused(hp_g, g9, n, bsz, cfg, schedule=schedule)
        gram = formation.pyramid_gram(cfg_mpc, w.reshape(bsz, h, nf, 5))
        gram = gram.reshape(bsz, h * nf, 3, 3)
        delta = (gram[:, :, :, None, :] * sel[None, :, None, :, None]
                 ).reshape(bsz, n, n)
        k = hess_n + cfg.sigma * eye[None] + delta
        return _batched_solver(k, cfg, use_kernels, schedule=schedule,
                               schur=schur)

    def apply_a(v):
        return formation.pyramid_apply(cfg_mpc, v.reshape(bsz, h, nf, 3)
                                       ).reshape(bsz, -1)

    def apply_at(wv):
        return formation.pyramid_apply_t(cfg_mpc, wv.reshape(bsz, h, nf, 5)
                                         ).reshape(bsz, -1)

    # ---- ADMM iterations (batched) ----
    alpha = cfg.over_relax_alpha
    sigma = cfg.sigma
    adapt = max(int(cfg.rho_adapt), 0)
    segs = adapt + 1
    seg = n_iter // segs

    if use_kernels:
        # Tile-padded iterate: the Jacobi scale folded into the inverse, A
        # the pyramid. Padding is inert: zero A rows/cols
        # with l=u=0, rho=1 pin the padded z/y/x entries to 0. Each segment
        # runs the segment kernel where the system's inverse fits on chip,
        # else its reference, the same iterate as ops.
        m = 5 * nf * h
        np_ = NI.pad_sizes(n)          # every kernel-branch inverse's tile
        mp_ = -(-m // 128) * 128

        def padded_inverse(solver):
            dp = torch.ones((bsz, np_), dtype=dtype, device=dev)
            dp[:, :n] = solver.scale
            return solver.inv_padded * (dp[:, :, None] * dp[:, None, :])

        def pad_rows(v, width, fill=0.0):
            out = torch.full((bsz, width), fill, dtype=dtype, device=dev)
            out[:, :v.shape[-1]] = v
            return out

        with span("qct.factorize"):
            inv_fullp = padded_inverse(build_solver(rho, schedule=admm_schedule))
        gradp = pad_rows(grad_n, np_)
        lP = pad_rows(l, mp_)
        uP = pad_rows(u, mp_)
        rhoP = pad_rows(rho, mp_, 1.0)
        a_pad = AS.pyramid_padded(cfg_mpc.mu, n, mp_, np_, dev)
        at_pad = a_pad.T

        if warm is None:
            carry = (torch.zeros((bsz, np_), dtype=dtype, device=dev),
                     torch.zeros((bsz, mp_), dtype=dtype, device=dev),
                     torch.zeros((bsz, mp_), dtype=dtype, device=dev))
        else:
            wx, wz, wy = warm
            carry = (pad_rows(wx, np_), pad_rows(wz, mp_), pad_rows(wy, mp_))
        for s_i in range(segs):
            last = s_i == segs - 1
            n_seg = n_iter - seg * (segs - 1) if last else seg
            tail = min(cfg.f32_tail_iters, n_seg) if last else 0
            with span("qct.admm.iterate"):
                carry = AS.admm_segment(inv_fullp, gradp, lP, uP, rhoP, carry, n=n,
                                        mu=cfg_mpc.mu, sigma=sigma, alpha=alpha,
                                        n_lo=n_seg - tail, n_hi=tail)
            if not last:
                # per-scenario OSQP adaptive rho + one cold ADMM-grade
                # refactorization
                with span("qct.admm.rho_adapt"):
                    xs, zs, ys = carry
                    ax = (xs @ at_pad)[:, :m]
                    hx = bmv(hess_n, xs[:, :n].contiguous())
                    aty = (ys @ a_pad)[:, :n]
                    fac = _adapt_rho_factor(
                        cfg, per_scn(ax), per_scn(zs[:, :m]), per_scn(hx),
                        per_scn(grad_n), per_scn(aty))
                    rhoP = pad_rows(rho * scn_fac_rows(fac, m // pack), mp_, 1.0)
                    with span("qct.factorize"):
                        inv_fullp = padded_inverse(
                            build_solver(rhoP[:, :m], schedule=admm_schedule))
        xp, zp, yp = carry
        x = xp[:, :n]
        z = zp[:, :m]
        y = yp[:, :m]
    else:
        def run(carry, solve_c, rho_c, n_lo, n_hi):
            # inexact solves are fine inside ADMM (a fixed-point iteration):
            # no refinement; the bulk uses the bf16 inverse
            inv_rho_c = 1.0 / rho_c
            x, z, y = carry
            with span("qct.admm.iterate"):
                for i in range(n_lo + n_hi):
                    rhs = sigma * x - grad_n + apply_at(rho_c * z - y)
                    x_t = solve_c(rhs, refine=0, lowp=i < n_lo)
                    z_t = apply_a(x_t)
                    x = alpha * x_t + (1.0 - alpha) * x
                    z_relax = alpha * z_t + (1.0 - alpha) * z
                    z_new = torch.clamp(z_relax + inv_rho_c * y, min=l, max=u)
                    y = y + rho_c * (z_relax - z_new)
                    z = z_new
            return x, z, y

        if warm is None:
            carry = (torch.zeros_like(grad_n), torch.zeros_like(rho),
                     torch.zeros_like(rho))
        else:
            carry = tuple(w.to(dtype) for w in warm)
        rho_c = rho
        with span("qct.factorize"):
            solve_c = build_solver(rho, schedule=admm_schedule)
        for s_i in range(segs):
            last = s_i == segs - 1
            n_seg = n_iter - seg * (segs - 1) if last else seg
            # the plain branch runs its whole last segment in fp32
            tail = n_seg if last else 0
            carry = run(carry, solve_c, rho_c, n_seg - tail, tail)
            if not last:
                with span("qct.admm.rho_adapt"):
                    xs, zs, ys = carry
                    hx = bmv(hess_n, xs)
                    fac = _adapt_rho_factor(
                        cfg, per_scn(apply_a(xs)), per_scn(zs), per_scn(hx),
                        per_scn(grad_n), per_scn(apply_at(ys)))
                    rho_c = rho * scn_fac_rows(fac, m_full // pack)
                    with span("qct.factorize"):
                        solve_c = build_solver(rho_c, schedule=admm_schedule)
        x, z, y = carry

    warm_out = (x, z, y)          # pre-polish fixed-point iterate, normalized

    # ---- polish (batched, AL dual correction) ----
    finite_u = u < cfg.infty
    w_act = cfg.polish_w_act
    lo_act = (z - l) < 1e-4
    hi_act = finite_u & ((u - z) < 1e-4)
    if cfg.polish_dual_seed_tol > 0.0:
        dt_ = cfg.polish_dual_seed_tol
        lo_act = lo_act | (y < -dt_)
        hi_act = hi_act | (finite_u & (y > dt_))

    def viol(v):
        av = apply_a(v)
        per_row = torch.maximum(l - av, torch.where(finite_u, av - u, -1.0))
        return per_scn(per_row).amax(-1)                      # (B*pack,)

    def rhs_parts(lo, hi, y_al):
        act = lo | hi
        bound = torch.where(lo, l, torch.where(hi & finite_u, u, 0.0))
        w = torch.where(act, w_act, 0.0).to(dtype)
        y_act = torch.where(act, y_al, 0.0)
        return w, bound, y_act

    def apply_round(solve_fn, w, bound, y_act, best_x, best_v, lo, hi):
        """One polish solve at the current working set plus the refinement
        proposal (drop wrong-sign multipliers, add violated rows). A
        non-finite scenario keeps its incoming working set and duals."""
        x_p = solve_fn(-grad_n + apply_at(w * bound - y_act))
        ax = apply_a(x_p)
        y_new = y_act + w * (ax - bound)
        finite_p = torch.isfinite(per_scn(x_p)).all(-1)       # (B*pack,)
        v_p = torch.where(finite_p, viol(x_p), torch.inf)
        take = (v_p < best_v)[:, None]                        # per scenario
        nsc = n // pack
        best_x = torch.where(take, per_scn(x_p),
                             best_x.reshape(bsz * pack, nsc)).reshape(bsz, n)
        best_v = torch.minimum(v_p, best_v)
        lo_d = (lo & (y_new <= 1e-9)) | (ax < l - 1e-6)
        hi_d = (hi & (y_new >= -1e-9)) | (finite_u & (ax > u + 1e-6))
        fin_rows = scn_fac_rows(finite_p.to(dtype), m_full // pack) > 0.5
        lo_d = torch.where(fin_rows, lo_d, lo)
        hi_d = torch.where(fin_rows, hi_d, hi)
        y_al = torch.where(fin_rows, torch.where(lo_d | hi_d, y_new, 0.0), y_act)
        return best_x, best_v, lo_d, hi_d, y_al

    if polish_rounds > 0:
        # round 0: one cold polish-grade factorization at the ADMM-identified
        # active set, duals seeded from the ADMM iterate
        with span("qct.admm.polish"):
            y_seed = torch.where(lo_act | hi_act, y, 0.0)
            w0p, bound0, y_act0 = rhs_parts(lo_act, hi_act, y_seed)
            with span("qct.factorize"):
                solve_p0 = build_solver(w0p)
            carry = apply_round(solve_p0, w0p, bound0, y_act0,
                                x, torch.clamp(viol(x), min=0.0), lo_act, hi_act)
        if polish_rounds > 1 and cfg.polish_woodbury:
            state = (lo_act, hi_act, solve_p0.inv, solve_p0.ks, solve_p0.scale)
            a_dense = torch.as_tensor(_pyramid_dense(cfg_mpc.mu, h, nf), dtype=dtype,
                                      device=dev)
            rank = min(cfg.polish_woodbury_rank * pack, m_full)
            for _ in range(polish_rounds - 1):
                carry, state = _woodbury_round(
                    cfg, carry, state, a_dense, rank, w_act, use_kernels,
                    rhs_parts, apply_round)
        else:
            for _ in range(polish_rounds - 1):
                with span("qct.admm.polish"):
                    best_x, best_v, lo, hi, y_al = carry
                    w, bound, y_act = rhs_parts(lo, hi, y_al)
                    with span("qct.factorize"):
                        solve_r = build_solver(w)
                    carry = apply_round(solve_r, w, bound, y_act, best_x, best_v, lo, hi)
        x = carry[0]
    if return_warm:
        return x * f_scale, warm_out
    return x * f_scale


def _woodbury_round(cfg: SolverConfig, carry, state, a_dense, rank: int,
                    w_act: float, use_kernels: bool, rhs_parts, apply_round):
    """One Woodbury polish round (the JAX `wb_round`). The proposed working
    set is clamped to at most `rank` constraint additions (removals and the
    rest wait: the row keeps its previous bound), the previous round's
    inverse takes the rank-`rank` Woodbury correction, and two NS steps
    from that start refine it: K6 on the kernel branch (bf16x3 + fp32), plain
    fp32 steps on the plain branch. Returns (carry, state) for the next
    round; carry is apply_round's, state (lo, hi, inv, ks, scale) the
    applied working set and its Jacobi-scaled factorization."""
    with span("qct.admm.polish"):
        best_x, best_v, lo_d, hi_d, y_al = carry
        lo_p, hi_p, inv_p, ks_p, dd_p = state
        n = dd_p.shape[1]
        dtype = inv_p.dtype
        act_d = lo_d | hi_d
        act_p = lo_p | hi_p
        flip_w = act_d != act_p
        add_w = (act_d & ~act_p).to(dtype)
        idx = _top_k_indices(add_w, rank)                        # (B, rank)
        msel = torch.gather(add_w, 1, idx)                       # 1: an addition
        applied = torch.zeros_like(add_w).scatter(1, idx, msel) > 0.5
        keep = flip_w & ~applied
        lo_n = torch.where(keep, lo_p, lo_d)
        hi_n = torch.where(keep, hi_p, hi_d)
        s_sel = torch.where(torch.gather(lo_n | hi_n, 1, idx), 1.0, -1.0).to(dtype)
        with span("qct.factorize"):
            sqrt_w = float(np.sqrt(np.float32(w_act)))
            u_rows = (sqrt_w * msel)[:, :, None] * a_dense[idx] * dd_p[:, None, :]
            v_rows = u_rows @ inv_p                                  # (B, rank, n)
            cs = v_rows @ u_rows.transpose(1, 2) + s_sel[:, :, None] * torch.eye(
                rank, dtype=dtype, device=dd_p.device)
            cv_rows = _gj_inverse(cs) @ v_rows
            m_wb = inv_p - v_rows.transpose(1, 2) @ cv_rows
            ks1 = ks_p + (u_rows * s_sel[:, :, None]).transpose(1, 2) @ u_rows
            # re-equilibrate by the new Jacobi scale: the update moves the changed
            # rows' diagonals far from the previous unit diagonal
            d1 = torch.rsqrt(torch.clamp(torch.diagonal(ks1, dim1=-2, dim2=-1), min=1e-30))
            ks1s = ks1 * d1[:, :, None] * d1[:, None, :]
            init = m_wb / (d1[:, :, None] * d1[:, None, :])
            if use_kernels:
                npad = NI.pad_sizes(n)
                inv1 = NI.ns_inverse_refine(NI.pad_to(ks1s, n, npad), NI.pad_to(init, n, npad),
                                            cfg.ns_wb_quad, cfg.ns_wb_hi)[:, :n, :n]
            else:
                inv1 = NI._ns_steps(ks1s, init, [], 0, cfg.ns_wb_quad + cfg.ns_wb_hi)
            dd_n = dd_p * d1
            wsolve = _Solver(inv=inv1, scale=dd_n, ks=ks1s, inv_padded=None)
        w_n, bound_n, y_act_n = rhs_parts(lo_n, hi_n, y_al)
        carry = apply_round(wsolve, w_n, bound_n, y_act_n, best_x, best_v, lo_n, hi_n)
        return carry, (lo_n, hi_n, inv1, ks1s, dd_n)


def admm_mpc_fused(
    cfg: SolverConfig,
    cfg_mpc: MPCConfig,
    hess,            # (B, n, n) with n = 3*nf*h
    grad,            # (B, n)
    gait_table,      # (B, h, nf)
    iterations: int | None = None,
    polish_rounds: int | None = None,
    use_kernels: bool | None = None,
):
    """`admm_mpc_batched` semantics at a fixed rho through the single-launch
    solve K5 (`ops/fused_admm.fused_admm_solve`): K build, factorization,
    every ADMM iteration and every polish round in one kernel. Returns forces
    (B, n). The plain branch runs `fused_admm_solve_reference`."""
    n_iter = cfg.iterations if iterations is None else iterations
    if polish_rounds is None:
        # the single-launch ADMM phase rounds differently from the batched
        # path's bf16 iterate; its active-set seeds need one more polish
        # round to land the knife-edge rows the batched path resolves in
        # cfg.polish_rounds (the JAX function's default)
        polish_rounds = cfg.polish_rounds + 1
    use_kernels = device.use_kernels(hess, use_kernels)
    bsz, h, nf = gait_table.shape
    n = 3 * nf * h
    m = 5 * nf * h
    if n > FA.N or m > FA.M:
        raise ValueError(f"{n} variables / {m} rows exceed the {FA.N} x {FA.M} tile")
    dtype, dev = hess.dtype, hess.device

    f_scale = float(cfg_mpc.f_max)
    hess_n = hess * (f_scale * f_scale)
    grad_n = grad * f_scale
    u3 = torch.full((bsz, h, nf, 5), cfg_mpc.big_number, dtype=dtype, device=dev)
    u3[..., 4] = gait_table * (cfg_mpc.f_max / f_scale)
    l = torch.zeros((bsz, m), dtype=dtype, device=dev)
    u = u3.reshape(bsz, -1)
    rho = constraint_rho(cfg, l, u)

    # pad to the kernel's tile: variables to N (identity diagonal), rows to M
    # (zero A rows with l = u = 0, rho = 1: z pins to 0, the duals stay 0);
    # the batch to a multiple of G with identity systems, as the JAX code
    pad_b = (-bsz) % FA.G
    bp = bsz + pad_b
    hp = torch.eye(FA.N, dtype=torch.float32, device=dev).repeat(bp, 1, 1)
    hp[:bsz, :n, :n] = hess_n
    gp = torch.zeros((bp, FA.N), dtype=torch.float32, device=dev)
    gp[:bsz, :n] = grad_n
    lp = torch.zeros((bp, FA.M), dtype=torch.float32, device=dev)
    lp[:bsz, :m] = l
    up = torch.zeros((bp, FA.M), dtype=torch.float32, device=dev)
    up[:bsz, :m] = u
    rp = torch.ones((bp, FA.M), dtype=torch.float32, device=dev)
    rp[:bsz, :m] = rho
    a_pad = torch.zeros((FA.M, FA.N), dtype=torch.float32, device=dev)
    a_pad[:m, :n] = torch.as_tensor(_pyramid_dense(cfg_mpc.mu, h, nf), device=dev)

    solve = FA.fused_admm_solve if use_kernels else FA.fused_admm_solve_reference
    x = solve(a_pad, hp, gp, lp, up, rp,
              mus_a0=cfg.ns_a0, n_scaled=cfg.ns_scaled_iters,
              n_quad=cfg.ns_quad_iters, n_hi=cfg.ns_hi_iters,
              n_iter=n_iter, polish_rounds=polish_rounds, sigma=cfg.sigma,
              alpha_rx=cfg.over_relax_alpha, infty=cfg.infty)
    return x[:bsz, :n] * f_scale
