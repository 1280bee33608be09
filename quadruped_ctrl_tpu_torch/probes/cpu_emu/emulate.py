"""Run the kernels of csrc/ on the CPU, clusters included.

    python3 quadruped_ctrl_tpu_torch/probes/cpu_emu/emulate.py [k1 k2 k3 k5 k6 k7 k9 plain warm
                                                                 k23_256]

For a machine without nvcc: the CUDA sources are compiled by g++ (C++20)
against the stand-in headers beside this file (cuda_runtime.h, cuda_bf16.h,
emu_mma.h for the inline PTX of mma.cuh, cooperative_groups.h), each block
running as one std::thread per CUDA thread. Every csrc/*.cu is first
checked to compile that way; then ns_inverse.cu and ns_refine.cu are
built into one shared library (compile_ns: K7's entry point at 128 launches
K3's kernel of ns_inverse.cu) and the NS entry points run on
a few systems against the plain PyTorch references, printing residuals and
how far apart the two are, and the shared-memory wavefronts per ldmatrix
matrix (1.0 when free of bank conflicts). `k5` builds fused_admm.cu into a
library of its own and runs the single-launch solve K5 on the first two
systems of the h=10 fused path's operands against
fused_admm_solve_reference. `k1` builds formation_pack.cu into a library of
its own and runs the packed formation K1 at the four lanes' shapes (h=10 and
h=16 at max_stance 4, 2 and 3), with masked steps, at an n_c that is no
multiple of 4, and at the two largest shapes whose planes leave no room for
the padded row stride, against form_packed_reference, with the count of
mma.sync it runs and its ldmatrix wavefronts per matrix. `plain` builds
ns_plain.cu into a library of its own and runs the plain NS K8 on one
system at the 128 tile (a cluster of 2 x 4 CTAs) and K9 on two systems at
the 256 tile (4 x 1 CTAs each), the CTAs of a cluster concurrently, against
ns_inverse_reference and ns_inverse_blocked_reference (`plain k8_256` adds
K8 at the 256 tile, 4 x 4 CTAs). `k6` runs the warm refinement K6 of
ns_refine.cu on three systems at each tile (the emulated card holds two
blocks at 128 and two 4-CTA clusters at 256, so one of them walks two
systems) against ns_inverse_refine_reference; `warm` the guarded warm NS K7
at each tile on a batch of a tripped, two warm and a NaN start (its cold
branch K3's kernel of ns_inverse.cu at 128, ns_refine.cu's RF_SCALED at
256), and K9 at the 128 tile, against their references; `k23_256` K2 and
K3 at the 256 tile (ns_refine.cu's RF_BUILD and RF_SCALED) on two systems
against their references, and K3's masked walk on 600 systems. It shows
that the indexing, the layouts and the barriers are right; it says nothing
of speed. A run takes a few minutes.
"""

from __future__ import annotations

import ctypes
import inspect
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
PKG = HERE.parents[1]
sys.path.insert(0, str(PKG.parent))

from quadruped_ctrl_tpu_torch import default_config  # noqa: E402
from quadruped_ctrl_tpu_torch.mpc import formation, pipeline  # noqa: E402
from quadruped_ctrl_tpu_torch.ops import _build  # noqa: E402
from quadruped_ctrl_tpu_torch.ops import formation_pack as FP  # noqa: E402
from quadruped_ctrl_tpu_torch.ops import fused_admm as FA  # noqa: E402
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI  # noqa: E402

OUT = PKG / "_build" / "cpu_emu"
PTX_FUNCTIONS = ("to_tf32", "mma_bf16", "mma_tf32", "ldsm_x4_trans", "map_rank",
                 "ld_cluster", "wg_fence", "wg_commit", "wg_wait_all", "wg_hold_f", "wg_hold_r",
                 "fence_proxy_async", "wg_bar", "wgmma_n128", "wgmma_n32",
                 "wgmma_n16", "wgmma_bf16_n128", "cp_async16", "cp_async_wait_all")


def prepare(csrc: Path, out: Path):
    """Copy csrc into out with the CUDA-only syntax rewritten: dynamic
    shared memory reads the emulator's arena, static __shared__ variables
    become per-block copies in it (emu::cta_static), <<<...>>> launches
    become emu::launch calls (on clusters for a kernel declared with
    __cluster_dims__), and mma.cuh's inline-PTX functions give way to
    emu_mma.h's."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    sources = {path: path.read_text() for path in csrc.iterdir()}
    clusters = {m[2]: m[1] for src in sources.values() for m in re.finditer(
        r"__cluster_dims__\((\w+), 1, 1\)\s*(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)}
    static_ids = iter(range(1 << 20))

    def launch(m):
        name = re.sub(r"<.*>", "", m[1]).split("::")[-1]
        dims = clusters.get(name)
        cluster = "" if dims is None else ", " + (dims if dims.isdigit() else f"qct::{dims}")
        return f"emu::launch({m[2]}, [&] {{ {m[1]}({m[3]}); }}{cluster});"

    for path, src in sources.items():
        if path.name == "mma.cuh":
            for name in PTX_FUNCTIONS:
                start = re.search(rf"__device__ __forceinline__ \w+ {name}\(", src).start()
                src = src[:start] + src[src.index("\n}\n", start) + 3:]
            src = src.replace("namespace qct {\n", '#include "emu_mma.h"\n\nnamespace qct {\n', 1)
        src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                     r"\1* \2 = reinterpret_cast<\1*>(emu::arena);", src)
        src = re.sub(r"__shared__ (?:__align__\(\d+\) )?(\w+) (\w+)((?:\[[^\]]*\])*);",
                     lambda m: f"{m[1]} (&{m[2]}){m[3]} = "
                               f"emu::cta_static<{m[1]}{m[3]}, {next(static_ids)}>();", src)
        src = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
        (out / path.name).write_text(src)


FLAGS = ("g++", "-std=c++20", "-Wno-unknown-pragmas", f"-I{HERE}", "-x", "c++")


def compile_all(out: Path) -> ctypes.CDLL:
    """Check that every .cu in out compiles; the NS kernels' library
    (compile_ns)."""
    for cu in sorted(out.glob("*.cu")):
        subprocess.run([*FLAGS, "-fsyntax-only", str(cu)], check=True)
        print(f"compiles: {cu.name}")
    return compile_ns(out)


def compile_ns(out: Path) -> ctypes.CDLL:
    """One library of ns_inverse.cu and ns_refine.cu (K2, K3, K6, K7, K9):
    K7's entry point at 128 launches K3's kernel of ns_inverse.cu. Built
    once per out."""
    return _library(out, "ns", ("ns_inverse", "ns_refine"))


def compile_fused(out: Path) -> ctypes.CDLL:
    """fused_admm.cu's library (K5), apart from ns_inverse.cu's: each counts
    its own ldmatrix wavefronts."""
    return _library(out, "fused_admm")


def compile_formation(out: Path) -> ctypes.CDLL:
    """formation_pack.cu's library (K1), with its own mma.sync count."""
    return _library(out, "formation_pack")


def compile_plain(out: Path) -> ctypes.CDLL:
    """ns_plain.cu's library (K8, and K9 at the 256 tile)."""
    return _library(out, "ns_plain")


def _library(out: Path, stem: str, parts: tuple[str, ...] | None = None) -> ctypes.CDLL:
    """The library of out/<stem>.cu, or of the sources `parts` compiled as
    one translation unit; built once per out."""
    lib_path = out / f"lib{stem}_emu.so"
    if parts is not None:
        (out / f"{stem}.cc").write_text("".join(f'#include "{p}.cu"\n' for p in parts))
    if not lib_path.exists():
        subprocess.run([*FLAGS, "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                        str(out / (f"{stem}.cc" if parts else f"{stem}.cu")), "-lpthread"],
                       check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = restype
    lib.emu_ldsm_wavefronts_per_matrix.restype = ctypes.c_double
    lib.emu_mma_bf16_count.restype = ctypes.c_long
    lib.emu_reset_counts.restype = None
    return lib


def spd(seed: int, b: int, n: int, cond: float, npad: int = NI.N) -> torch.Tensor:
    """Jacobi-scaled SPD systems of condition ~cond, identity-padded to npad."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, npad, npad), np.float32)
    for i in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        k = (q * np.logspace(0, -np.log10(cond), n)[None]) @ q.T
        d = 1 / np.sqrt(np.diagonal(k))
        out[i, :n, :n] = k * d[:, None] * d[None]
        out[i, n:, n:] = np.eye(npad - n)
    return torch.from_numpy(out)


def resid(ks: torch.Tensor, inv: torch.Tensor) -> tuple[float, float]:
    """(max |I - ks inv|, max row sum of it)."""
    gap = (torch.eye(ks.shape[-1], dtype=torch.float64) - ks.double() @ inv.double()).abs()
    return float(gap.max()), float(gap.sum(-1).max())


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max() / ref.abs().max())


def run(lib: ctypes.CDLL, which=("k2", "k3", "k6", "k7", "k9")) -> dict:
    """The checks, each on b = 2 systems, as {name: numbers}; prints them."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    s = default_config().solver
    admm = (s.ns_admm_a0, s.ns_admm_scaled_iters, s.ns_quad_iters, s.ns_hi_iters)
    polish = (s.ns_a0, s.ns_scaled_iters, s.ns_quad_iters, s.ns_hi_iters)
    mus = lambda sched: NI._mus_arg(sched[0], sched[1])  # noqa: E731
    b, out = 2, {}
    lib.emu_reset_counts()  # the counters are one per process (inline variables)
    if "k3" in which:
        for name, cond, sched, metric in (("k3_admm", 2.1e3, admm, 0),
                                          ("k3_polish", 1e4, polish, 1)):
            ks = spd(3, b, 120, cond)
            inv = torch.empty_like(ks)
            rc = lib.qct_ns_inverse_scaled(ptr(ks), ptr(inv), b, mus(sched), *sched[1:], None)
            ref = NI.ns_inverse_scaled_reference(ks, *sched)
            out[name] = dict(rc=rc, residual=resid(ks, inv)[metric],
                             reference=resid(ks, ref)[metric], rel=rel(inv, ref))
    if "k2" in which:
        hp = spd(4, b, 120, 50.0) * 3.0
        g9 = torch.from_numpy(np.random.default_rng(5).uniform(0, 0.5, (b, 9, 40))
                              .astype(np.float32))
        g9[:, [0, 4, 8]] += 1.0
        inv, ks, d = torch.empty_like(hp), torch.empty_like(hp), torch.empty((b, 1, NI.N))
        rc = lib.qct_ns_inverse_scaled_build(ptr(hp), ptr(g9), 40, ptr(inv), ptr(ks), ptr(d), b,
                                             mus(admm), *admm[1:], None)
        inv_r, ks_r, d_r = NI.ns_inverse_scaled_build_reference(hp, g9, *admm)
        out["k2"] = dict(rc=rc, rel_ks=rel(ks, ks_r), rel_d=rel(d, d_r),
                         residual=resid(ks_r, inv)[0], reference=resid(ks_r, inv_r)[0])
    if "k6" in which:
        r = run_refine(lib, (NI.N,), b)[f"k6_{NI.N}"]
        out["k6"] = {k: v for k, v in r.items() if k not in ("finite", "equal")}
    if "k7" in which:
        ks = spd(8, b, 120, 1e3)
        init = torch.linalg.inv(ks.double()).float()
        init[1] = 17.0                      # system 1 trips the guard
        inv, cold = torch.empty_like(ks), torch.empty_like(ks)
        tripped = torch.empty(b, dtype=torch.int32)
        rc = lib.qct_ns_inverse_warm(ptr(ks), ptr(init), ptr(inv), ptr(tripped), b, mus(admm),
                                     *admm[1:], 3, 1, 0.5, None)
        lib.qct_ns_inverse_scaled(ptr(ks), ptr(cold), b, mus(admm), *admm[1:], None)
        ref = NI.ns_inverse_warm_reference(ks, init, *admm, 3, 1, 0.5)
        out["k7"] = dict(rc=rc, rel_warm=rel(inv[0], ref[0]),
                         tripped_is_k3=bool(torch.equal(inv[1], cold[1])))
    if "k9" in which:
        ks = spd(9, b, 120, 1e3)
        inv = torch.empty_like(ks)
        rc = lib.qct_ns_inverse_plain(ptr(ks), ptr(inv), b, 25, None)
        ref = NI.ns_inverse_blocked_reference(ks, 25)
        out["k9"] = dict(rc=rc, residual=resid(ks, inv)[0], reference=resid(ks, ref)[0],
                         rel=rel(inv, ref))
    out["ldmatrix_wavefronts"] = lib.emu_ldsm_wavefronts_per_matrix()
    for name, numbers in out.items():
        print(name, numbers)
    return out


def refine_operands(b: int, npad: int, seed: int = 7) -> tuple[torch.Tensor, torch.Tensor]:
    """(ks, init): b SPD systems of cond 1e4 (n = 96 at the 128 tile, 192 at
    256) and the warm start of the JAX package's refinement test, the exact
    inverse times (I + E) with ||E||_2 = 0.05."""
    ks = spd(seed, b, 96 if npad == NI.N else 192, 1e4, npad)
    e = torch.randn(b, npad, npad, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    e *= 0.05 / torch.linalg.matrix_norm(e, ord=2)[:, None, None]
    eye = torch.eye(npad, dtype=torch.float64)
    return ks, (torch.linalg.inv(ks.double()) @ (eye + e)).float()


def run_refine(lib: ctypes.CDLL, tiles=(NI.N, NI.N_BIG), b: int = 3,
               sched: tuple[int, int] = (1, 1)) -> dict:
    """K6 of ns_refine.cu (sched: n_quad bf16x3 and n_hi fp32 steps) on b
    systems at each tile against ns_inverse_refine_reference: the start's,
    the kernel's and the reference's largest row sum of |I - ks X|, the
    largest difference relative to max |reference|, whether the result is
    finite and whether it is the reference bit for bit; prints them."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    out = {}
    for npad in tiles:
        ks, init = refine_operands(b, npad)
        inv = torch.full_like(ks, float("nan"))
        entry = lib.qct_ns_inverse_refine if npad == NI.N else lib.qct_ns_inverse_refine_256
        rc = entry(ptr(ks), ptr(init), ptr(inv), b, *sched, None)
        ref = NI.ns_inverse_refine_reference(ks, init, *sched)
        out[f"k6_{npad}"] = dict(rc=rc, start=resid(ks, init)[1], residual=resid(ks, inv)[1],
                                 reference=resid(ks, ref)[1], rel=rel(inv, ref),
                                 finite=bool(inv.isfinite().all()),
                                 equal=bool(torch.equal(inv, ref)))
    for name, numbers in out.items():
        print(name, numbers)
    return out


# K7's batch: system 0 starts at 17.0 everywhere (its guard trips), 1 and 2
# at the exact inverse (warm), 3 at NaN (a NaN row sum trips). The emulated
# card's two units walk 0 then 2, and 1 then 3: a tripped system and a warm
# one each precede another system.
WARM_STARTS = ("tripped", "warm", "warm", "nan")
WARM_KW = (3, 1, 0.5)                          # n_wquad, n_whi, guard: the config's


def warm_operands(npad: int, seed: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(ks, init) of K7's batch: SPD systems of cond 1e3 (n = 120 at the 128
    tile, 192 at 256) and the starts of WARM_STARTS."""
    ks = spd(seed, len(WARM_STARTS), 120 if npad == NI.N else 192, 1e3, npad)
    init = torch.linalg.inv(ks.double()).float()
    for i, kind in enumerate(WARM_STARTS):
        if kind != "warm":
            init[i] = 17.0 if kind == "tripped" else float("nan")
    return ks, init


def run_warm(lib: ctypes.CDLL, tiles=(NI.N, NI.N_BIG), sched=None) -> dict:
    """K7 (qct_ns_inverse_warm[_256]: the guard and warm branch of
    ns_refine.cu, then K3's kernel on the tripped systems) on warm_operands
    with the cold schedule sched (default the ADMM one) against
    ns_inverse_warm_reference, and K3 (qct_ns_inverse_scaled[_256]) alone
    on the systems that should trip: the flags the guard set, the warm
    systems' largest difference relative to the reference's largest entry
    and their max |I - K X| beside the reference's, whether the tripped
    systems equal K3's result bit for bit, and whether all is finite;
    prints them."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    s = default_config().solver
    sched = sched or (s.ns_admm_a0, s.ns_admm_scaled_iters, s.ns_quad_iters, s.ns_hi_iters)
    warm = [i for i, k in enumerate(WARM_STARTS) if k == "warm"]
    cold = [i for i, k in enumerate(WARM_STARTS) if k != "warm"]
    out = {}
    for npad in tiles:
        ks, init = warm_operands(npad)
        b = ks.shape[0]
        inv = torch.full_like(ks, float("nan"))
        tripped = torch.full((b,), -1, dtype=torch.int32)
        entry = lib.qct_ns_inverse_warm if npad == NI.N else lib.qct_ns_inverse_warm_256
        rc = entry(ptr(ks), ptr(init), ptr(inv), ptr(tripped), b, NI._mus_arg(*sched[:2]),
                   *sched[1:], *WARM_KW, None)
        ks_c = ks[cold].contiguous()
        k3 = torch.full_like(ks_c, float("nan"))
        k3_entry = lib.qct_ns_inverse_scaled if npad == NI.N else lib.qct_ns_inverse_scaled_256
        rc3 = k3_entry(ptr(ks_c), ptr(k3), len(cold), NI._mus_arg(*sched[:2]), *sched[1:], None)
        ref = NI.ns_inverse_warm_reference(ks, init, *sched, *WARM_KW)
        out[f"k7_{npad}"] = dict(rc=rc, rc_k3=rc3, tripped=tripped.tolist(),
                                 rel_warm=rel(inv[warm], ref[warm]),
                                 residual=resid(ks[warm], inv[warm])[0],
                                 reference=resid(ks[warm], ref[warm])[0],
                                 cold_is_k3=bool(torch.equal(inv[cold], k3)),
                                 finite=bool(inv.isfinite().all()))
    for name, numbers in out.items():
        print(name, numbers)
    return out


def run_k23_256(lib: ctypes.CDLL, b: int = 2) -> dict:
    """K2 and K3 at the 256 tile (qct_ns_inverse_scaled_build_256 and
    qct_ns_inverse_scaled_256: ns_refine.cu's RF_BUILD and RF_SCALED) on the
    ADMM schedule against their references, b systems each (the emulated
    card's two clusters take one each): K3 on SPD n = 192 at cond 2.1e3,
    K2 on hp = 3 x SPD n = 192 at cond 50 with random g9 blocks (64 of
    them, which cross the CTAs' rows at 64 and 128). Max |I - ks X| of the kernel and of
    the reference (K2's against the reference's ks), the largest difference
    relative to max |reference|, K2's d_row against the reference's (relative)
    and whether all is finite; prints them."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    s = default_config().solver
    admm = (s.ns_admm_a0, s.ns_admm_scaled_iters, s.ns_quad_iters, s.ns_hi_iters)
    mus = NI._mus_arg(*admm[:2])
    out = {}
    ks = spd(3, b, 192, 2.1e3, NI.N_BIG)
    inv = torch.full_like(ks, float("nan"))
    rc = lib.qct_ns_inverse_scaled_256(ptr(ks), ptr(inv), b, mus, *admm[1:], None)
    ref = NI.ns_inverse_scaled_reference(ks, *admm)
    out["k3_256"] = dict(rc=rc, residual=resid(ks, inv)[0], reference=resid(ks, ref)[0],
                         rel=rel(inv, ref), finite=bool(inv.isfinite().all()))
    hp = spd(4, b, 192, 50.0, NI.N_BIG) * 3.0
    g9 = torch.from_numpy(np.random.default_rng(5).uniform(0, 0.5, (b, 9, 64))
                          .astype(np.float32))
    g9[:, [0, 4, 8]] += 1.0
    inv, d = torch.full_like(hp, float("nan")), torch.full((b, 1, NI.N_BIG), float("nan"))
    rc = lib.qct_ns_inverse_scaled_build_256(ptr(hp), ptr(g9), 64, ptr(inv), ptr(d), b, mus,
                                             *admm[1:], None)
    inv_r, _, d_r = NI.ns_inverse_scaled_build_reference(hp, g9, *admm)
    ks_r = NI._build_k(hp, g9) * d_r[:, 0, :, None] * d_r
    out["k2_256"] = dict(rc=rc, residual=resid(ks_r, inv)[0], reference=resid(ks_r, inv_r)[0],
                         rel=rel(inv, inv_r), rel_d=rel(d, d_r),
                         finite=bool(inv.isfinite().all() and d.isfinite().all()))
    for name, numbers in out.items():
        print(name, numbers)
    return out


def run_masked_walk(lib: ctypes.CDLL, b: int = 600) -> dict:
    """The masked K3 at 256 (qct_ns_inverse_scaled_masked_256) with an empty
    schedule, so that each flagged system's result is its start alpha I:
    on b random nonnegative systems with every third flag set at random and
    a run of 300 unflagged ones, so that the walk's block-wide scans cross
    256-flag chunks. Whether exactly the flagged systems were stored, and
    the largest difference of theirs from ns_inverse_scaled_reference's
    start, relative; prints them."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rng = np.random.default_rng(11)
    ks = torch.from_numpy(rng.uniform(0, 1, (b, NI.N_BIG, NI.N_BIG)).astype(np.float32))
    flags = torch.from_numpy((rng.uniform(size=b) < 1 / 3).astype(np.int32))
    flags[100:400] = 0
    inv = torch.full_like(ks, float("nan"))
    rc = lib.qct_ns_inverse_scaled_masked_256(ptr(ks), ptr(inv), ptr(flags), b,
                                              NI._mus_arg(0.0, 0), 0, 0, 0, None)
    on = flags.bool()
    ref = NI.ns_inverse_scaled_reference(ks[on], 0.0, 0, 0, 0)
    stored = inv.isfinite().all(-1).all(-1)
    out = {"masked_walk": dict(rc=rc, flagged=int(on.sum()), stored_is_flagged=bool(
        torch.equal(stored, on)), rel=rel(inv[on], ref))}
    for name, numbers in out.items():
        print(name, numbers)
    return out


def run_plain128(lib: ctypes.CDLL, b: int = 3, iters: int = 25) -> dict:
    """K9 at the 128 tile (ns_refine.cu's fp32 steps from I / ||K||_inf,
    qct_ns_inverse_plain) on b SPD systems of cond 1e3, n = 120, against
    ns_inverse_blocked_reference: max |I - K X| of both, the largest
    difference relative to max |reference|, finite; prints them. The
    emulated card's two blocks walk the systems in turn."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    ks = spd(9, b, 120, 1e3)
    inv = torch.full_like(ks, float("nan"))
    rc = lib.qct_ns_inverse_plain(ptr(ks), ptr(inv), b, iters, None)
    ref = NI.ns_inverse_blocked_reference(ks, iters)
    out = {"k9_128": dict(rc=rc, residual=resid(ks, inv)[0], reference=resid(ks, ref)[0],
                          rel=rel(inv, ref), finite=bool(inv.isfinite().all()))}
    for name, numbers in out.items():
        print(name, numbers)
    return out


# ns_plain.cu's cases: (name, npad, systems, n, entry point). Few steps on
# well-conditioned systems (cond 2): the indexing is the same for any count,
# and PLAIN_ITERS steps take the residual to fp32 rounding there.
PLAIN_CASES = {"k8_128": (128, 1, 120, "one"), "k9_256": (256, 2, 192, "batch"),
               "k8_256": (256, 1, 192, "one")}
PLAIN_ITERS, PLAIN_COND = 6, 2.0


def run_plain(lib: ctypes.CDLL, which=("k8_128", "k9_256"),
              inverses: dict | None = None) -> dict:
    """K8 / K9 of ns_plain.cu against ns_inverse_reference /
    ns_inverse_blocked_reference at PLAIN_ITERS steps: max |I - K X| of the
    kernel and of the reference, and the largest difference relative to
    max |reference|; prints them. `inverses`, if given, receives each case's
    inverses (systems, npad, npad)."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    out = {}
    for name in which:
        npad, b, n, entry = PLAIN_CASES[name]
        ks = spd(10, b, n, PLAIN_COND, npad)
        inv = torch.full_like(ks, float("nan"))
        if entry == "one":
            rc = lib.qct_ns_inverse_plain_one(ptr(ks), ptr(inv), npad, PLAIN_ITERS, None)
            ref = NI.ns_inverse_reference(ks[0], PLAIN_ITERS)[None]
        else:
            rc = lib.qct_ns_inverse_plain_256(ptr(ks), ptr(inv), b, PLAIN_ITERS, None)
            ref = NI.ns_inverse_blocked_reference(ks, PLAIN_ITERS)
        out[name] = dict(rc=rc, residual=resid(ks, inv)[0], reference=resid(ks, ref)[0],
                         rel=rel(inv, ref), finite=bool(inv.isfinite().all()))
        if inverses is not None:
            inverses[name] = inv
    for name, numbers in out.items():
        print(name, numbers)
    return out


K5_DEFAULTS = {k: p.default for k, p in inspect.signature(FA.fused_admm_solve).parameters.items()
               if p.kind is inspect.Parameter.KEYWORD_ONLY}


def fused_operands(b: int = 2, seed: int = 0) -> tuple:
    """The operands of the K5 call that solve_packed_batch(use_fused=True)
    makes at h=10 (the h10_fused lane's: n = 60 variables and m = 100 rows in
    the 128 x 256 tile), for its first b scenarios, on the CPU."""
    calls, real = [], FA.fused_admm_solve

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    FA.fused_admm_solve = record
    try:
        pipeline.solve_packed_batch(default_config(), pipeline.random_inputs(
            seed, b, 10, device="cpu"), use_fused=True, use_kernels=True, iterations=1,
            polish_rounds=0)
    finally:
        FA.fused_admm_solve = real
    a, *per_system = calls[0]
    return (a, *(t[:b].contiguous() for t in per_system))


def k5(lib: ctypes.CDLL, ops, **kw) -> torch.Tensor:
    """x from the emulated K5 on fused_admm_solve's operands ops, with its
    keyword arguments."""
    kw = {**K5_DEFAULTS, **kw}
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    x = torch.empty_like(ops[2])
    rc = lib.qct_fused_admm_solve(
        *map(ptr, ops), ptr(x), ops[1].shape[0], NI._mus_arg(kw["mus_a0"], kw["n_scaled"]),
        *(kw[k] for k in ("n_scaled", "n_quad", "n_hi", "n_iter", "polish_rounds", "sigma",
                          "alpha_rx", "w_act", "act_tol", "infty")), None)
    if rc != 0:
        raise RuntimeError(f"emulated K5 returned {rc}")
    return x


def run_k5(lib: ctypes.CDLL) -> dict:
    """K5 against fused_admm_solve_reference on fused_operands(): the whole
    solve (n_iter=60, polish_rounds=2) and the ADMM phase alone (n_iter=30,
    polish_rounds=0), each as its largest force difference (N, x f_max),
    that relative to max |x|, and whether x is finite and 0 on the padded
    variables; prints them."""
    ops = fused_operands()
    f_max = default_config().mpc.f_max
    out = {}
    lib.emu_reset_counts()  # the counters are one per process (inline variables)
    for name, kw in (("k5", dict(n_iter=60, polish_rounds=2)),
                     ("k5_admm", dict(n_iter=30, polish_rounds=0))):
        x = k5(lib, ops, **kw)
        ref = FA.fused_admm_solve_reference(*ops, **kw)
        out[name] = dict(max_force_diff=float((x - ref).abs().max()) * f_max, rel=rel(x, ref),
                         pad_zero=bool((x[:, 60:] == 0).all()), finite=bool(x.isfinite().all()))
    out["ldmatrix_wavefronts"] = lib.emu_ldsm_wavefronts_per_matrix()
    for name, numbers in out.items():
        print(name, numbers)
    return out


# K1's cases: (name, h, max_stance, pack, scenarios, masked trailing steps)
K1_CASES = (("h10", 10, 2, 2, 2, 0), ("h16_full", 16, 4, 1, 1, 0), ("h16_trot", 16, 2, 2, 2, 0),
            ("h16_midband", 16, 3, 1, 1, 0), ("h10_masked", 10, 2, 2, 2, 2),
            ("h5_ms1", 5, 1, 2, 2, 1), ("h36_ms1", 36, 1, 2, 2, 0), ("h25_ms2", 25, 2, 1, 1, 0))


def k1_operands(h: int, ms: int, b: int, masked: int, seed: int = 1) -> tuple:
    """form_packed's operands (bfam_s, smat, r, smask) for b scenarios of
    random_inputs at horizon h, max_stance ms, the last `masked` steps
    masked out, on the CPU (chip_smoke.check_k1's construction)."""
    cfg = default_config()
    inp = pipeline.random_inputs(seed, b, h, device="cpu")
    adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag, cfg.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            cfg.mpc.gravity)
    _, _, sel = formation.stance_selectors(inp.gait_table, ms)
    mask = torch.ones((b, h))
    if masked:
        mask[:, -masked:] = 0.0
    return formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel)


def run_k1(lib: ctypes.CDLL, cases=K1_CASES) -> dict:
    """K1 against form_packed_reference on each case: rel_H and rel_g (max
    difference over max |reference|), H finite and exactly 0 off the
    scenario blocks, the mma.sync the launch ran against the library's
    qct_form_packed_mma_count, ldmatrix's wavefronts per matrix, and the
    shared memory of a block. Prints them."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    alpha, out = float(default_config().mpc.alpha), {}
    for name, h, ms, pack, b, masked in cases:
        ops = k1_operands(h, ms, b, masked)
        n_c = 3 * ms * h
        hess = torch.full((b // pack, pack * n_c, pack * n_c), float("nan"))
        grad = torch.full((b // pack, pack * n_c), float("nan"))
        lib.emu_reset_counts()
        rc = lib.qct_form_packed(*map(ptr, ops), ptr(hess), ptr(grad), b, h, ms, pack, alpha, None)
        h_ref, g_ref = FP.form_packed_reference(*ops, h, ms, pack, alpha)
        block = torch.block_diag(*[torch.ones(n_c, n_c)] * pack).bool()
        out[name] = dict(rc=rc, rel_H=rel(hess, h_ref), rel_g=rel(grad, g_ref),
                         finite=bool(hess.isfinite().all() and grad.isfinite().all()),
                         zeros_exact=bool((hess[:, ~block] == 0).all()),
                         mma_count=lib.emu_mma_bf16_count(),
                         mma_expected=b * lib.qct_form_packed_mma_count(h, ms),
                         ldmatrix_wavefronts=lib.emu_ldsm_wavefronts_per_matrix(),
                         smem=lib.qct_form_packed_smem_bytes(h, ms))
    for name, numbers in out.items():
        print(name, numbers)
    return out


if __name__ == "__main__":
    which = sys.argv[1:] or ("k1", "k2", "k3", "k5", "k6", "k7", "k9", "plain", "warm",
                             "k23_256")
    # the checks apart from run()'s (warm: K7 at both tiles and K9/128 on
    # their own batches)
    own = {"k1", "k5", "k6", "plain", "k8_256", "warm", "k23_256"}
    prepare(PKG / "csrc", OUT)
    lib = compile_all(OUT)
    if set(which) - own:
        run(lib, [w for w in which if w not in own])
    if "plain" in which:
        run_plain(compile_plain(OUT), ("k8_128", "k9_256") + (("k8_256",) if "k8_256" in which
                                                              else ()))
    if "k6" in which:
        run_refine(compile_ns(OUT))
    if "warm" in which:
        run_warm(compile_ns(OUT))
        run_plain128(compile_ns(OUT))
    if "k23_256" in which:
        run_k23_256(compile_ns(OUT))
        run_masked_walk(compile_ns(OUT))
    if "k5" in which:
        run_k5(compile_fused(OUT))
    if "k1" in which:
        run_k1(compile_formation(OUT))
