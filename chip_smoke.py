#!/usr/bin/env python3
"""Drive the PyTorch port's MPC solves and entry points once on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds the CUDA kernels from quadruped_ctrl_tpu_torch/csrc (one nvcc per
   source, in parallel) and checks with cuobjdump that the factorization
   kernels of the 128 tile (K3's masked instance, K7/128's cold branch,
   among them), the fused solve K5 and both instances of the formation K1
   hold tensor-core code (HMMA in their SASS), and the three instances of
   the plain NS (csrc/ns_plain.cu: K8 at both tiles, K9 at 256) and the
   seven of csrc/ns_refine.cu (K6 and K7's guard and warm branch at both
   tiles, K9 at 128, K3 at 256, also K7/256's cold branch, and K2 at 256)
   wgmma (HGMMA), each with its registers and spill stores; prints each
   cluster kernel's cluster size and how many of its clusters (ns_refine.cu:
   CTAs or clusters) the card holds at once;
2b. calls every kernel wrapper (K1-K3, K5-K9 and the ADMM segment SEG, both
   tiles) on inputs that start 4 bytes past a 16-byte boundary and holds the
   result to the aligned call's, bit for bit;
3. holds each kernel (K1 form_packed, K2 ns_inverse_scaled_build, K3
   ns_inverse_scaled) against its plain PyTorch reference on the card at the
   128 tile, at the h=10 path's shapes, and times both (K1 by the host clock
   and by CUDA events over 20 chained calls, with the mma.sync its Gram
   runs; K2 and K3 with their share of the bound and their bf16x3 rate);
3b. the same at the h=16 shapes: K1 at each h=16 lane's shape (and, untimed,
   at h=36 and h=25, the largest shapes it takes), K2 and K3 at the 256
   tile (a 4-CTA cluster a system, persistent, wgmma; K2 on systems of at
   most 192 variables on 3-CTA clusters over the tile's leading 192, K2/192),
   each timed at both schedules on a real h16_full solve's calls by CUDA
   events beside torch.linalg.inv_ex with its share of the bound (K2/256 and
   K3 on those calls' K taken as 240 variables, g9 zero-extended; K2/192's
   bound counted at 192), K2/256 also on SPD systems of 240 variables, and
   the Schur split K4 (K3 at the 128 tile inside) against its plain version;
3c. the single-launch solve K5 (fused_admm_solve) at batch 2048, h=10, on the
   operands the fused path builds, with its time split by phase (the build,
   the ADMM iterate, the polish; the Grams timed with an empty NS schedule),
   and the warm NS refinement K6
   (ns_inverse_refine) at both tiles on 2048 SPD warm starts and on the
   operands of a real Woodbury solve (h=10 and h16_full, 2048 systems),
   against their references, K6 timed by the host clock and by CUDA events
   beside torch.linalg.inv_ex;
3d. the plain NS K8/K9 through make_ns_inverse (K9 under torch.func.vmap on
   the per-scenario path's 2048 ADMM-phase K at h=10 and on 2048 SPD systems
   at the 256 tile, K8 on one matrix of each) against their references and
   the plain NS, timed by the host clock and by CUDA events beside
   torch.linalg.inv_ex on the same matrices, and the guarded warm NS K7 through
   _batched_solver(prev_inv=...) on real warm pairs (an adaptive-rho
   refactorization, a polish round) of the h=10 and h16_full solves, with
   its guard share and K3 on the same systems, timed by events (the call
   and each of its two launches) beside torch.linalg.inv_ex, on starts of
   17.0 and of NaN (every guard trips: K3's result bit for bit), and on
   2048 SPD warm starts at each tile (every guard passes), timed;
4. drives `solve_packed_batch` at batch 4096, h=10 (2048 packed systems of
   120 variables) through the kernels, counts their launches, checks the
   forces and compares them with the plain branch on the same inputs, then
   runs the polish_rounds=0, form_only and two-step-build variants; holds
   the ADMM segment kernel SEG (csrc/admm_segment.cu, two launches a solve)
   on that solve's own segment operands against admm_segment_reference on
   the card (60 fp32 iterations within 1e-4 of each system's largest entry,
   the padding exact; the solver's bf16 segments within three times the
   CPU reference's distance from the card's), and times both by events
   beside the segment's bound;
4b. drives the three h=16 lanes of bench.py (h16_full, h16_trot,
   h16_midband) at batch 2048 the same way, SEG at 192 and 144 variables;
4c. drives the fused solve (h10_fused: use_fused=True, batch 2048, K5 alone)
   and the Woodbury polish (h10_woodbury: polish_woodbury=True, batch 4096,
   K6 for the polish rounds after the first) the same way, and one h16_full
   solve under the same option (K6 at the 256 tile), timed;
4d. drives the per-scenario path (solve_batch, solve_compressed_batch at
   batch 1024, h=10; torch.func.vmap over admm_mpc, no kernel, as in JAX):
   forces, and the share within 1 N of solve_packed_batch;
4e. drives the closed loop through `sim/batch_rollout.batch_rollout` at the
   sweep users run (batch 4096 on the plane: 16 mode-1 stand macros solved
   uncompressed, then 25 trot sweep macros stance-compressed and packed,
   h_sol 10, every MPC solve warm-started through K1/128 and K2/128): one MPC
   tick through the kernels against the plain branch from the same state at a
   stand tick and at a warm sweep tick (fr_des within 0.5 N, gated by the
   share, beside a plain run with its rpy nudged by one ulp), the launches
   per MPC tick, survival and safety rates, robot ticks/s, the MPC and plain
   tick times by CUDA events, and a profile of one macro;
4f. drives the single-robot sessions, whose paths run no kernel (as in the
   JAX package): `cli sim --gait trot --vx 0.5 --ticks 1000` through the
   port's CLI (the full model, h_max 16, the 200-tick stand, then trot) held
   to tests/test_closed_loop.py's trot gates on its tail and its first 100
   ticks to a CPU run (0.02 m); the articulated session (800 ticks, the
   400-tick stand) held to tests/test_articulated.py's height, torque and
   safety gates; `render_depth` at its last pose against the CPU; the
   stage-wise `solve_sparse` against `pipeline.solve` (tests/
   test_sparse_mpc.py's 3 N / 12 N); for both sessions, ms a tick of
   `controller_step` and of the simulator by CUDA events, kernel launches
   and host syncs a tick, and the realtime factor;
4g. drives `cli sweep --batch 4096` through the port's CLI: one macro with
   a checkpoint, then `--macros 2` resumed from it (it must print `resumed
   ... at macro 1/2`), against an uninterrupted `--macros 2` run: survival
   and safety equal, K1/128 and K2/128 launched on every MPC tick, and the
   largest difference of the two final states (and whether they are
   bit-equal);
4h. drives `solve_routed_batch` on one batch of the benchmark cell
   h14_gait_mix_solve (9,216 scenarios at h=14, drawn as benchmark/run.py
   draws them; groups of 72, 84, 120 and 168 variables): the launches (one
   K1, five K2 and two SEG a group, at its width's tile), the forces under
   the cell's own check and zero on every swing foot, a second solve bit for
   bit the first, and each group's own K1, K2 (and K3 on its systems) and
   SEG calls against their references under phases 3, 3b and 4's gates,
   and ms a call;
5. drives the port's other entry points, each with the launch counts set to
   0 just before it and read just after (the kernels line keeps them per
   path under `launches_phase5`):
5a. `cli bench` at bench.py's sizes (the bench twin: the eight lanes, 48 / 16
   chained reps timed by CUDA events): every lane measured, `lane_errors`
   null, every phase's share of its bound <= 100%, the launches exactly
   those of the lanes' chained solves and of the iterate's timing apart
   (h10_iterate: one solve, then its two segments replayed), h10 solves/s
   printed beside phase 4's;
5b. `cli latency` (the bench_latency.py twin: 200 host round trips of a
   tick, 200 launch+copy pairs, 40 13-tick macros), no kernel;
5c. `cli kernels-smoke --full`: every case at production batches, 0 failed,
   K1, K2, K3, K6 and SEG at both tiles, K4 and K5 launched;
5d. `cli scaling` on a one-rank NCCL group, then `sharded_mpc_solve` at world
   size 1 on batch 4096, h=10, bit-equal to `solve_packed_batch` with the
   reduced mean equal to the local one;
5e. `NativeController` through the native runtime's FFI: 10 pre_work and 300
   stand ticks of the SRB sim (base height 0.2-0.32, the library's latency
   summary), then 20 ticks bit-equal to direct `controller_step` calls;
   native/ unchanged;
5f. `graft_entry.entry()` once and `dryrun_multichip(1)` (K1/128 and K2/128);
6. profiles one solve of h10, h16_full, h16_trot, h16_midband, h10_fused,
   h10_woodbury, h16_full with the Woodbury polish and scenario_full (device
   time by kernel, device idle share);
7. prints a JSON line with the kernels (one entry per kernel and tile, with
   its bound on this card and the time of torch.linalg.inv beside K2/K3;
   K1/128's and K2/128's also carry their closed-loop and `cli sweep`
   launches per MPC tick, K1's, K2's and SEG's their launches in the routed
   solve), then the result line.

Exits non-zero when no CUDA device is present, when a kernel fails to build
or launch, or when any check fails. Needs no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import cli, default_config
from quadruped_ctrl_tpu_torch.control import controller as ctrl
from quadruped_ctrl_tpu_torch.core.types import Command, tree_map, vmap
from quadruped_ctrl_tpu_torch.models.floating_base import MiniCheetahModel
from quadruped_ctrl_tpu_torch.mpc import formation, pipeline, sparse
from quadruped_ctrl_tpu_torch.ops import _build, _launch
from quadruped_ctrl_tpu_torch.ops import admm_segment as AS
from quadruped_ctrl_tpu_torch.ops import formation_pack as FP
from quadruped_ctrl_tpu_torch.ops import fused_admm as FA
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from quadruped_ctrl_tpu_torch.sim import articulated, camera, engine, rollout
from quadruped_ctrl_tpu_torch.sim import batch_rollout as br
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
from quadruped_ctrl_tpu_torch.solver import admm

BATCH, H, MS, PACK = 4096, 10, 2, 2
N_SYS, N_VARS = BATCH // PACK, PACK * 3 * MS * H      # 2048 systems of n=120
B16, H16 = 2048, 16
N_SPD = 512                     # systems per SPD case at the 256 tile
# bench.py's h=16 lanes: (max_stance, pack, gait)
LANES16 = {"h16_full": (4, 1, "trot"), "h16_trot": (2, 2, "trot"),
           "h16_midband": (3, 1, "midband")}
B_FUSED = 2048                  # scenarios of the fused lane (one system each)
B_ALIGN = 256                   # scenarios (systems at 256: a quarter) of phase 2b
WRAPPERS = {"K1": FP.form_packed, "K2": NI.ns_inverse_scaled_build,
            "K3": NI.ns_inverse_scaled, "K5": FA.fused_admm_solve,
            "K6": NI.ns_inverse_refine, "K7": NI.ns_inverse_warm, "K8": NI.ns_inverse,
            "K9": NI.ns_inverse_blocked, "SEG": AS.admm_segment}
TILES = (128, 256)
KERNEL_INFO = {
    "K1/128": dict(name="form_packed", source="quadruped_ctrl_tpu_torch/csrc/formation_pack.cu",
                   replaces="quadruped_ctrl_tpu/ops/formation_pack.py:135"),
    "K1/256": dict(name="form_packed (n_pair > 128)",
                   source="quadruped_ctrl_tpu_torch/csrc/formation_pack.cu",
                   replaces="quadruped_ctrl_tpu/ops/formation_pack.py:135"),
    "K2/128": dict(name="ns_inverse_scaled_build",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_inverse.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:615"),
    "K2/256": dict(name="ns_inverse_scaled_build (256 tile)",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:615"),
    "K2/192": dict(name="ns_inverse_scaled_build (256 tile, at most 192 variables)",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:615", tile=256),
    "K3/128": dict(name="ns_inverse_scaled",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_inverse.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:259"),
    "K3/256": dict(name="ns_inverse_scaled (256 tile)",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:259"),
    "K5/128": dict(name="fused_admm_solve",
                   source="quadruped_ctrl_tpu_torch/csrc/fused_admm.cu",
                   replaces="quadruped_ctrl_tpu/ops/fused_admm.py:199"),
    "K6/128": dict(name="ns_inverse_refine",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:344"),
    "K6/256": dict(name="ns_inverse_refine (256 tile)",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:344"),
    "K7/128": dict(name="ns_inverse_warm",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:448"),
    "K7/256": dict(name="ns_inverse_warm (256 tile)",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:448"),
    "K8/128": dict(name="ns_inverse",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_plain.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:62"),
    "K8/256": dict(name="ns_inverse (256 tile)",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_plain.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:62"),
    "K9/128": dict(name="ns_inverse_blocked",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_refine.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:131"),
    "K9/256": dict(name="ns_inverse_blocked (256 tile)",
                   source="quadruped_ctrl_tpu_torch/csrc/ns_plain.cu",
                   replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:131"),
    # the batched ADMM segment: no TPU kernel, the JAX package's mk_body scan
    "SEG/128": dict(name="admm_segment", source="quadruped_ctrl_tpu_torch/csrc/admm_segment.cu",
                    replaces="quadruped_ctrl_tpu/solver/admm.py:818"),
    "SEG/256": dict(name="admm_segment (256 tile)",
                    source="quadruped_ctrl_tpu_torch/csrc/admm_segment.cu",
                    replaces="quadruped_ctrl_tpu/solver/admm.py:818"),
}
# Peak rates of one H100 SXM (data sheet, dense): the bf16 and tf32 tensor
# cores, the fp32 CUDA cores, device memory.
PEAK_BF16, PEAK_TF32, PEAK_FP32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12


# The kernels whose products must run on the tensor cores: the
# factorizations at the 128 tile (ns_inverse.cu; K3's <true> instance is
# K7/128's cold branch), the fused solve (fused_admm.cu), and both instances
# of the formation's Gram (formation_pack.cu), as mma.sync (HMMA in the
# SASS); the plain NS (ns_plain.cu: K8/128, K8/256, K9/256) and the NS steps
# of ns_refine.cu (modes 0 RF_REFINE, 1 RF_WARM, 2 RF_PLAIN, 3 RF_SCALED, 4
# RF_BUILD: K6 and K7's guard and warm branch at both tiles, K9/128, K3/256,
# whose instance masked is K7/256's cold branch, and K2/256 at both widths:
# 4-CTA clusters over the tile, 3-CTA ones over its leading 192) as wgmma
# (HGMMA).
TC_KERNELS = ("ns_inverse_scaled_kernel<false>", "ns_inverse_scaled_kernel<true>",
              "ns_inverse_scaled_build_kernel", "fused_admm_kernel", "form_packed_kernel<false>",
              "form_packed_kernel<true>")
GMMA_KERNELS = {"K8/128": "ns_plain_kernel<128, 2, 4>", "K8/256": "ns_plain_kernel<256, 4, 4>",
                "K9/256": "ns_plain_kernel<256, 4, 1>", "K6/128": "ns_refine_kernel<128, 0>",
                "K6/256": "ns_refine_kernel<256, 0>", "K7/128": "ns_refine_kernel<128, 1>",
                "K7/256": "ns_refine_kernel<256, 1>", "K9/128": "ns_refine_kernel<128, 2>",
                "K3/256": "ns_refine_kernel<256, 3>", "K2/256": "ns_refine_kernel<256, 4>",
                "K2/192": "ns_refine_kernel<192, 4>"}
# their instance numbers in ns_plain.cu's qct_ns_plain_clusters
PLAIN_INSTANCES = {"K8/128": 0, "K8/256": 1, "K9/256": 2}
# ns_refine.cu's instances (npad, mode) for qct_ns_refine_units
REFINE_INSTANCES = {"K6/128": (128, 0), "K7/128": (128, 1), "K9/128": (128, 2),
                    "K6/256": (256, 0), "K7/256": (256, 1), "K3/256": (256, 3),
                    "K2/256": (256, 4), "K2/192": (192, 4)}


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)
    print(f"  ok: {what}")


def median_ms(fn, reps: int = 10) -> float:
    """Median wall time of fn() in ms, synchronized around each run, after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, n: int = 20) -> float:
    """Device ms of fn(): CUDA events around n chained calls, divided by n,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def mangled(name: str) -> str:
    """The Itanium-mangled prefix of qct::name, a function or one instance
    of a template over bools and ints (name<false>, name<256, 4, 1>)."""
    base, _, args = name.partition("<")
    if not args:
        return f"_ZN3qct{len(base)}{base}E"
    enc = "".join(f"Lb{int(a == 'true')}E" if a in ("true", "false") else f"Li{int(a)}E"
                  for a in (x.strip() for x in args.rstrip(">").split(",")))
    return f"_ZN3qct{len(base)}{base}I{enc}EE"


def check_tensor_core_sass(lib_path):
    """cuobjdump -sass of the built library: every TC_KERNELS kernel holds
    HMMA instructions (mma.sync on the tensor cores), every GMMA_KERNELS
    kernel HGMMA (wgmma); prints the count and, from the ptxas log, each
    one's registers and spill stores."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    bodies = {body.split()[0]: body for body in sass.split("Function : ")[1:]}
    ptxas = lib_path.with_suffix(".log").read_text().split("Compiling entry function '")
    for name, op in [(n, "HMMA") for n in TC_KERNELS] + [(n, "HGMMA")
                                                         for n in GMMA_KERNELS.values()]:
        found = [n for n in bodies if n.startswith(mangled(name))]
        count = bodies[found[0]].count(op) if found else 0
        entry = next((e for e in ptxas if e.startswith(mangled(name))), "")
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes spill stores", entry)
        print(f"  sass: {name}: {count if found else 'not found'} {op}, "
              f"{regs[1] if regs else '?'} registers, "
              f"{spills[1] if spills else '?'} bytes spill stores")
        check(len(found) == 1 and count > 0,
              f"{name} runs its products on the tensor cores ({op} in its SASS)")


def reset_counts():
    for fn in WRAPPERS.values():
        _launch.new_count(fn, TILES)


def counts() -> dict:
    """Launches since the last reset, keyed "K<i>/<tile>" (K5 has the 128
    tile only)."""
    return {f"{k}/{t}": fn.launches_by_tile[t] for k, fn in WRAPPERS.items() for t in TILES
            if k != "K5" or t == FA.N}


def want(**launches) -> dict:
    """The expected counts(): the given keys (K1_256=1 -> "K1/256": 1), 0 elsewhere."""
    out = dict.fromkeys(counts(), 0)
    out.update({k.replace("_", "/"): v for k, v in launches.items()})
    return out


def bound(ops_bf16: float, ops_fp32: float, nbytes: float,
          ops_tf32: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over their peak (bf16 and tf32 tensor-core passes plus fp32
    CUDA-core operations) and the bytes moved once over the memory rate."""
    t_ops = ops_bf16 / PEAK_BF16 + ops_tf32 / PEAK_TF32 + ops_fp32 / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ns_bound(b: int, npad: int, schedule, nbytes: float) -> tuple[float, str]:
    """K2/K3: per NS step two npad^3 products (2 npad^3 operations each); the
    bf16x3 steps count 3 bf16 passes, the fp32 tail 3 tf32 passes (3xTF32 on
    the tensor cores at both tiles)."""
    _, n_scaled, n_quad, n_hi = schedule
    prod = 2.0 * npad ** 3 * 2 * b
    return bound(3 * prod * (n_scaled + n_quad), 0.0, nbytes, 3 * prod * n_hi)


def form_bound(b: int, h: int, ms: int, pack: int) -> tuple[float, str]:
    """K1 per scenario, counting the work the function needs: in fp32, u =
    bfam_s smat (39 x 12 x n_c) and, for each entry of bq that can be
    nonzero (rows 13 x + q of column c with x >= step(c) = c / (3 ms)), its
    expansion (~8 operations) and its term of the gradient (2); in 3 bf16
    passes, one triangle of the symmetric Gram, G[c, d] for c <= d over the
    rows where both columns can be nonzero (13 (h - step(d))); bytes: the
    operands in, the packed H and g out."""
    n_c, rows = 3 * ms * h, 13 * h
    n_pair = pack * n_c
    depth = [13 * (h - c // (3 * ms)) for c in range(n_c)]
    gram = sum((d + 1) * depth[d] for d in range(n_c))
    fp32 = b * (2.0 * 39 * 12 * n_c + 10.0 * sum(depth))
    nbytes = 4.0 * (b * (468 + 12 * n_c + rows + h) + b // pack * (n_pair * n_pair + n_pair))
    return bound(3 * 2.0 * gram * b, fp32, nbytes)


def gram_mma(h: int, ms: int) -> tuple[int, int]:
    """(mma.sync m16n8k16 K1's Gram runs for one scenario, as the library
    counts them; those of the full Gram, ceil(n_c / 16) x ceil(n_c / 8)
    fragments over every 16-row chunk), both over bf16x3's three passes."""
    n_c = 3 * ms * h
    full = -(-n_c // 16) * -(-n_c // 8) * -(-13 * h // 16) * 3
    return FP.mma_count(_build.load(), h, FP.per_step_slots(h, ms, "cpu")), full


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def spd_batch(gen, b: int, n: int, npad: int, cond: float, dev):
    """Jacobi-scaled random SPD matrices of condition ~cond, identity-padded
    to npad (the construction of the JAX package's kernel tests)."""
    q, _ = torch.linalg.qr(torch.randn((b, n, n), generator=gen, dtype=torch.float64,
                                       device=dev))
    ev = torch.logspace(0.0, -math.log10(cond), n, dtype=torch.float64, device=dev)
    k = (q * ev[None, None, :]) @ q.transpose(1, 2)
    d = torch.diagonal(k, dim1=-2, dim2=-1).rsqrt()
    return NI.pad_to((k * d[:, :, None] * d[:, None, :]).float(), n, npad)


def identity_gap(ks, inv) -> torch.Tensor:
    """|I - ks inv| in float64, per system."""
    eye = torch.eye(ks.shape[-1], dtype=torch.float64, device=ks.device)
    return (eye - ks.double() @ inv.double()).abs()


def residuals(ks, inv):
    """(max |I - ks inv| elementwise, max row sum of |I - ks inv|), over the batch."""
    gap = identity_gap(ks, inv)
    return float(gap.max()), float(gap.sum(-1).max())


@contextlib.contextmanager
def recorded(mod, name: str):
    """Each call of mod.<name> made inside the block, as (args, keywords)
    with its tensors cloned, into the list it yields; the calls run as they
    would."""
    calls, real = [], getattr(mod, name)
    clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa: E731

    def record(*args, **kw):
        calls.append((tuple(map(clone, args)), {k: clone(v) for k, v in kw.items()}))
        return real(*args, **kw)

    setattr(mod, name, record)
    try:
        yield calls
    finally:
        setattr(mod, name, real)


def as_operands(args) -> tuple:
    """A recorded NS call's positional arguments as (tensors..., schedule)."""
    return (*(a for a in args if isinstance(a, torch.Tensor)),
            tuple(a for a in args if not isinstance(a, torch.Tensor)))


def solve_operands(cfg, inputs, name="ns_inverse_scaled_build", **solve_kw):
    """The arguments of every call one real solve makes to NI.<name>, as
    (tensors..., schedule): K2's are the cold ADMM factorization, the
    adaptive-rho refactorization and the polish rounds."""
    with recorded(NI, name) as calls:
        pipeline.solve_packed_batch(cfg, inputs, **solve_kw)
    return [as_operands(args) for args, _ in calls]


def ns_times(hp, g9, ks, sched) -> list[float]:
    """Median ms of K2, its reference, K3, its reference and
    torch.linalg.inv (the yardstick; the port never calls it) on one batch."""
    return [median_ms(lambda: NI.ns_inverse_scaled_build(hp, g9, *sched)),
            median_ms(lambda: NI.ns_inverse_scaled_build_reference(hp, g9, *sched)),
            median_ms(lambda: NI.ns_inverse_scaled(ks, *sched)),
            median_ms(lambda: NI.ns_inverse_scaled_reference(ks, *sched)),
            median_ms(lambda: torch.linalg.inv(ks))]


def ns_device_times(hp, g9, ks, sched) -> list[float]:
    """Device ms (CUDA events over 5 chained calls) of K2, K3 and
    torch.linalg.inv_ex (the yardstick) on one batch."""
    return [event_ms(lambda: NI.ns_inverse_scaled_build(hp, g9, *sched), 5),
            event_ms(lambda: NI.ns_inverse_scaled(ks, *sched), 5),
            event_ms(lambda: torch.linalg.inv_ex(ks), 5)]


def k2_key(npad: int, nblk: int) -> str:
    """The kernels line's entry of a K2 call on nblk blocks: at the 256 tile
    a system of at most 192 variables runs on the 3-CTA instance (K2/192)."""
    return "K2/192" if npad == NI.N_BIG and 3 * nblk <= 192 else f"K2/{npad}"


def ns_bounds(npad, hp, g9, sched):
    """(K2's, K3's) bound on (hp, g9) at one schedule: (ms, what bounds it).
    K2/192 is counted at the width it multiplies, 192: hp's leading 192 rows
    and columns in, the whole tile's inv out."""
    b, nblk = hp.shape[0], g9.shape[-1]
    width = 192 if k2_key(npad, nblk) == "K2/192" else npad
    mat = b * npad * npad * 4.0
    small = 4.0 * b * (9 * nblk + npad)              # g9 in, d_row out
    outs_k2 = 2 if npad == NI.N else 1               # inv (and ks at 128) out
    k2_in = b * width * width * 4.0
    return (ns_bound(b, width, sched, k2_in + mat * outs_k2 + small),
            ns_bound(b, npad, sched, 2 * mat))


def ns_device_results(results, npad, hp, g9, sched, dev, prefix):
    """K2's and K3's device ms of one schedule (ns_device_times), their share
    of the bound and inv_ex's, printed and kept in the tile's entries under
    `prefix` ("" for the ADMM schedule of solve call 0, "polish_" for solve
    call 2). K3's entry is filled only from a K2 call over the whole tile."""
    bounds = ns_bounds(npad, hp, g9, sched)
    key2 = k2_key(npad, g9.shape[-1])
    entries = [(key2, dev[0], bounds[0])]
    if key2 == f"K2/{npad}":
        entries.append((f"K3/{npad}", dev[1], bounds[1]))
    for key, ms, bd in entries:
        results[key].update({f"{prefix}device_ms": ms, f"{prefix}library_device_ms": dev[2],
                             f"{prefix}bound_ms": bd[0]})
        print(f"  {key} {prefix or 'admm_'}schedule by events: {ms:.4f} ms, bound {bd[0]:.4f} "
              f"ms ({bd[1]}), share {bd[0] / ms:.4f}; torch.linalg.inv_ex {dev[2]:.4f} ms")


def ns_results(results, npad, hp, g9, sched, times, err2, err3):
    """Fill the K2 entry of the instance that ran (hp, g9) from ns_times(),
    and the tile's K3 entry with it where K2 ran over the whole tile."""
    k2, k3 = ns_bounds(npad, hp, g9, sched)
    b = hp.shape[0]
    key2 = k2_key(npad, g9.shape[-1])
    width = 192 if key2 == "K2/192" else npad
    results[key2].update(max_abs_err=err2, ms=times[0], plain_ms=times[1],
                         library_ms=times[4], bound_ms=k2[0], bound_by=k2[1])
    entries = [(key2, times[0], k2[0], width)]
    if key2 == f"K2/{npad}":
        results[f"K3/{npad}"].update(max_abs_err=err3, ms=times[2], plain_ms=times[3],
                                     library_ms=times[4], bound_ms=k3[0], bound_by=k3[1])
        entries.append((f"K3/{npad}", times[2], k3[0], npad))
    print(f"  bounds at the {npad} tile: {key2} %.3f ms (%s), K3 %.3f ms (%s)" % (*k2, *k3))
    _, n_scaled, n_quad, _ = sched
    for key, ms, bound_ms, w in entries:
        passes = 3 * 2 * 2.0 * w ** 3 * b * (n_scaled + n_quad)    # the bf16x3 steps' passes
        print(f"  {key}: share of the bound {bound_ms / ms:.4f}; the bf16x3 products at "
              f"{passes / (ms * 1e-3) / 1e12:.1f} bf16-pass TFLOP/s over the whole call "
              "(fp32 tail not counted)")


def gait_table(kind: str, b: int, h: int, dev) -> torch.Tensor | None:
    """None for random_inputs' own trot; "midband" is the aio walking-to-trot
    band's 3-stance table of bench.py (v = 0.3)."""
    if kind == "trot":
        return None
    v_band = 0.3
    o2, o3 = math.floor(h * 1.25 * v_band), math.floor(h * (1.25 * v_band + 0.5))
    dwt = math.floor(h * (-1.25 * v_band + 1.0))
    offs = torch.tensor([0, h // 2, o2, o3], device=dev)
    steps = torch.arange(h, device=dev)[:, None]
    tbl = (((steps - offs[None, :]) % h) < dwt).float()
    check(int(tbl.sum(1).max()) <= 3 and int(tbl.sum(1).min()) >= 1,
          "midband table: 1 to 3 stance feet per step")
    return tbl.expand(b, h, 4).contiguous()


def lane_inputs(seed: int, b: int, h: int, kind: str, dev):
    inputs = pipeline.random_inputs(seed=seed, batch=b, h=h, device=dev)
    tbl = gait_table(kind, b, h, dev)
    return inputs if tbl is None else inputs.replace(gait_table=tbl)


def check_k1(cfg, dev, batch, h, ms, pack, masked, kind, results=None, timed=False):
    """K1 against its reference and the fp32 plain formation. `timed` times
    the kernel and its reference by the host clock (median of 10) and on the
    device (event_ms) and prints the mma.sync the Gram runs against the
    full Gram's; `results` also fills the K1 entry of its tile."""
    inp = lane_inputs(1, batch, h, kind, dev)
    adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag,
                                      cfg.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            cfg.mpc.gravity)
    _, _, sel = formation.stance_selectors(inp.gait_table, ms)
    mask = torch.ones((batch, h), device=dev)
    if masked:
        mask[:, -masked:] = 0.0
    ops = formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel)
    args = (*ops, h, ms, pack, float(cfg.mpc.alpha))
    hk, gk = FP.form_packed(*args)
    hr, gr = FP.form_packed_reference(*args)
    hx, gx = formation.qp_cost_packed(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel, pack,
                                      use_kernels=False)
    torch.cuda.synchronize()
    n_pair = pack * 3 * ms * h
    tag = f"K1 h={h} ms={ms} pack={pack} batch {batch}" + (f" ({masked} masked steps)"
                                                          if masked else "")
    print(f"  {tag}: rel_H {rel(hk, hr):.3e} rel_g {rel(gk, gr):.3e} vs reference; "
          f"rel_H {rel(hk, hx):.3e} rel_g {rel(gk, gx):.3e} vs the fp32 plain formation")
    check(hk.shape == (batch // pack, n_pair, n_pair) and bool(torch.isfinite(hk).all()),
          f"{tag}: shape and finite")
    check(rel(hk, hr) < 5e-5 and rel(gk, gr) < 1e-5, f"{tag} vs reference")
    check(rel(hk, hx) < 5e-5 and rel(gk, gx) < 1e-5, f"{tag} vs fp32 plain")
    if not timed:
        return
    bound_ms, bound_by = form_bound(batch, h, ms, pack)
    count, full = gram_mma(h, ms)
    t = dict(ms=median_ms(lambda: FP.form_packed(*args)),
             device_ms=event_ms(lambda: FP.form_packed(*args)),
             plain_ms=median_ms(lambda: FP.form_packed_reference(*args)),
             plain_device_ms=event_ms(lambda: FP.form_packed_reference(*args)))
    print("  %s: kernel %.4f ms host (median of 10), %.4f ms device (20 chained calls); "
          "reference %.4f / %.4f ms; bound %.4f ms (%s, one triangle of the Gram); share of the "
          "bound %.4f (device)" % (tag, t["ms"], t["device_ms"], t["plain_ms"],
                                   t["plain_device_ms"], bound_ms, bound_by,
                                   bound_ms / t["device_ms"]))
    print(f"  {tag}: the Gram runs {count} mma.sync m16n8k16 a scenario of the full Gram's "
          f"{full} (share {count / full:.4f}; zero chunks and mirrored tiles skipped)")
    if results is not None:
        results[f"K1/{FP.pair_tile(n_pair)}"].update(
            max_abs_err=float((hk - hr).abs().max()), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, mma_count=count, mma_full=full, **t)


def check_k1_slots(cfg, dev, batch, h=14, gaits=(7, 8, 9), n_slot=28):
    """K1 on stance slot lists (mpc/formation.stance_slots), as a routed
    solve forms one group: `batch` scenarios at horizon h, each on a gait of
    the reference's library (by default galloping, pacing and trotting, 84
    variables at h=14) at a segment of its own, each with its own slots'
    steps; against its reference and the fp32 plain formation, timed."""
    from quadruped_ctrl_tpu_torch.gait import gait

    inp = pipeline.random_inputs(seed=3, batch=batch, h=h, device=dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(14)
    nums = torch.tensor(gaits)[torch.randint(0, len(gaits), (batch,), generator=gen)]
    segs = torch.randint(0, h, (batch,), generator=gen, dtype=torch.int32)
    tables = torch.stack([gait.mpc_table(s, gait.params_for_gait(g), h)
                          for g, s in zip(nums, segs)]).to(dev)
    adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag,
                                      cfg.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            cfg.mpc.gravity)
    _, _, sel, steps = formation.stance_slots(tables, n_slot)
    mask = torch.ones((batch, h), device=dev)
    ops = formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel)
    args = (*ops, h, None, 1, float(cfg.mpc.alpha))
    hk, gk = FP.form_packed(*args, slot_step=steps)
    hr, gr = FP.form_packed_reference(*args, slot_step=steps)
    hx, gx = formation.qp_cost_packed(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel, 1,
                                      use_kernels=False, slot_step=steps)
    torch.cuda.synchronize()
    tag = f"K1 h={h} slot lists of {3 * n_slot} variables (gaits {list(gaits)}) batch {batch}"
    print(f"  {tag}: rel_H {rel(hk, hr):.3e} rel_g {rel(gk, gr):.3e} vs reference; "
          f"rel_H {rel(hk, hx):.3e} rel_g {rel(gk, gx):.3e} vs the fp32 plain formation")
    check(hk.shape == (batch, 3 * n_slot, 3 * n_slot) and bool(torch.isfinite(hk).all()),
          f"{tag}: shape and finite")
    check(rel(hk, hr) < 5e-5 and rel(gk, gr) < 1e-5, f"{tag} vs reference")
    check(rel(hk, hx) < 5e-5 and rel(gk, gx) < 1e-5, f"{tag} vs fp32 plain")
    t = dict(ms=median_ms(lambda: FP.form_packed(*args, slot_step=steps)),
             device_ms=event_ms(lambda: FP.form_packed(*args, slot_step=steps)))
    print("  %s: kernel %.4f ms host (median of 10), %.4f ms device (20 chained calls)"
          % (tag, t["ms"], t["device_ms"]))


def check_ns(cases, results, npad, n_sys):
    """K2 and K3 against their references on (label, hp, g9, schedule,
    residual metric (0 elementwise, 1 row sum), gate) cases. The kernel's
    residual must pass the gate and stay within 2x of the reference's. Times
    solve calls 0 and 2 and fills the tile's entries from call 0 (K2's of the
    instance that ran, k2_key)."""
    for label, hp_c, g9_c, sched, metric, gate in cases:
        key2 = k2_key(npad, g9_c.shape[-1])
        inv_k, ks_k, d_k = NI.ns_inverse_scaled_build(hp_c, g9_c, *sched)
        inv_r, ks_r, d_r = NI.ns_inverse_scaled_build_reference(hp_c, g9_c, *sched)
        if ks_r is None:          # the 256 tile returns no ks: scale K as K2 does
            d = d_r[:, 0]
            ks_r = NI._build_k(hp_c, g9_c) * d[:, :, None] * d[:, None, :]
        res_k, res_r = residuals(ks_r, inv_k)[metric], residuals(ks_r, inv_r)[metric]
        err2 = float((inv_k - inv_r).abs().max())
        ks_note = ("ks None" if ks_k is None else f"rel ks {rel(ks_k, ks_r):.3e}")
        print(f"  {key2} {label}: residual kernel {res_k:.3e} reference {res_r:.3e} "
              f"(gate {gate}); {ks_note} rel d {rel(d_k, d_r):.3e}; "
              f"max |inv_k - inv_r| {err2:.3e}")
        check(res_k < gate and res_r < gate and res_k <= 2 * res_r + 1e-5,
              f"{key2} {label}: residuals")
        check((ks_k is None) == (npad > NI.N), f"{key2} {label}: ks only at the 128 tile")
        check((ks_k is None or rel(ks_k, ks_r) <= 1e-6) and rel(d_k, d_r) <= 1e-6,
              f"{key2} {label}: ks, d_row")
        inv3_k = NI.ns_inverse_scaled(ks_r, *sched)
        inv3_r = NI.ns_inverse_scaled_reference(ks_r, *sched)
        res3_k, res3_r = residuals(ks_r, inv3_k)[metric], residuals(ks_r, inv3_r)[metric]
        err3 = float((inv3_k - inv3_r).abs().max())
        print(f"  K3/{npad} {label}: residual kernel {res3_k:.3e} reference {res3_r:.3e} "
              f"(gate {gate}); max |inv_k - inv_r| {err3:.3e}")
        check(res3_k < gate and res3_r < gate and res3_k <= 2 * res3_r + 1e-5,
              f"K3/{npad} {label}: residuals")
        if label.startswith("solve call 0") or label.startswith("solve call 2"):
            times = ns_times(hp_c, g9_c, ks_r, sched)
            print(f"  %s at {n_sys} systems: K2 kernel %.3f ms reference %.3f ms; K3 kernel "
                  "%.3f ms reference %.3f ms; torch.linalg.inv %.3f ms (median of 10)"
                  % (label, *times))
            ns_device_results(results, npad, hp_c, g9_c, sched,
                              ns_device_times(hp_c, g9_c, ks_r, sched),
                              "" if label.startswith("solve call 0") else "polish_")
        if label.startswith("solve call 0"):
            # the kernels' line reports the solve's first factorization;
            # polish-schedule inverses differ from the reference by more in
            # absolute terms (entries up to ~cond), see the lines above
            ns_results(results, npad, hp_c, g9_c, sched, times, err2, err3)


def schedules(cfg):
    s = cfg.solver
    return ((s.ns_admm_a0, s.ns_admm_scaled_iters, s.ns_quad_iters, s.ns_hi_iters),
            (s.ns_a0, s.ns_scaled_iters, s.ns_quad_iters, s.ns_hi_iters))


def solve_cases(calls, polish_sched, polish_gate=0.5):
    """check_ns cases for a real solve's K2 calls. A real solve's polish-round
    K (w_act = 1e4 on the active set) is worse conditioned than the SPD
    cases: at h=10 the reference's own row-sum residual reaches ~0.26 there
    (CPU, batch 1024) and 0.34 on the card, which the polish solves' two
    refinement passes contract as r^3; its gate is 0.5. At h=16 (the 256
    tile) the reference itself reads 0.51 on the card, so the gate there is
    1.0, the row-sum bound under which the refinement still contracts, and
    so at h=14 (the routed groups, phase 4h), where the reference reads 0.70
    at n = 120 on the card; the 2x rule of check_ns holds the kernel to the
    reference either way."""
    cases = []
    for i, (hp, g9, sched) in enumerate(calls):
        polish = sched == polish_sched
        cases.append((f"solve call {i} ({'polish' if polish else 'ADMM'} schedule)", hp, g9,
                      sched, 1 if polish else 0, polish_gate if polish else 1e-2))
    return cases


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (the allocator aligns a fresh tensor to more than 16)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_alignment(cfg, dev):
    """Every kernel wrapper on offset_view()s of its tensor operands returns
    what it returns on the operands themselves, bit for bit (the wrappers
    hand their kernels aligned copies, ops/_launch.aligned; the kernels read
    16 bytes at a time). Small batches at the main path's shapes."""
    print("phase 2b: each kernel wrapper on inputs 4 bytes past a 16-byte boundary")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    admm_sched = schedules(cfg)[0]
    s = cfg.solver
    warm_kw = dict(n_wquad=s.ns_warm_quad, n_whi=s.ns_warm_hi, guard=s.ns_warm_guard)
    inp = lane_inputs(1, B_ALIGN, H, "trot", dev)
    adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag, cfg.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            cfg.mpc.gravity)
    _, _, sel = formation.stance_selectors(inp.gait_table, MS)
    k1_ops = formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj,
                                          torch.ones((B_ALIGN, H), device=dev), sel)
    k5_args, k5_kw = fused_call(cfg, pipeline.random_inputs(seed=0, batch=B_ALIGN, h=H,
                                                            device=dev))
    cases = [("K1/128", FP.form_packed, k1_ops, (H, MS, PACK, float(cfg.mpc.alpha)), {}),
             ("K5/128", FA.fused_admm_solve, k5_args, (), k5_kw)]
    for npad, b, n in ((NI.N, B_ALIGN, N_VARS), (NI.N_BIG, B_ALIGN // 4, 192)):
        ks = spd_batch(gen, b, n, npad, 1e3, dev)
        ks_w, init, _ = spd_warm(gen, b, n, npad, dev)
        init[::3] = 17.0                      # a third of the systems trip K7's guard
        cases += [(k2_key(npad, n // 3), NI.ns_inverse_scaled_build,
                   (ks * 2.0, torch.zeros((b, 9, n // 3), device=dev)), admm_sched, {}),
                  (f"K3/{npad}", NI.ns_inverse_scaled, (ks,), admm_sched, {}),
                  (f"K6/{npad}", NI.ns_inverse_refine, (ks_w, init), (1, 1), {}),
                  (f"K7/{npad}", NI.ns_inverse_warm, (ks_w, init), admm_sched, warm_kw),
                  (f"K8/{npad}", NI.ns_inverse, (ks[0].contiguous(),), (s.ns_iters,), {}),
                  (f"K9/{npad}", NI.ns_inverse_blocked, (ks,), (s.ns_iters,), {})]
    b = B_ALIGN // 4                           # K2/256 itself: 240 variables (nblk 80)
    cases.append(("K2/256", NI.ns_inverse_scaled_build,
                  (spd_batch(gen, b, 240, NI.N_BIG, 1e3, dev) * 2.0,
                   torch.zeros((b, 9, 80), device=dev)), admm_sched, {}))
    # SEG on the second segment call (warm carry, bf16 then fp32) of a solve
    # at each tile: 128 systems of 120 variables, 256 of 192
    def seg(inv, grad, l, u, rho, x, z, y, **k):
        return AS.admm_segment(inv, grad, l, u, rho, (x, z, y), **k)

    for tile, inputs, kw in ((NI.N, pipeline.random_inputs(seed=0, batch=B_ALIGN, h=H,
                                                          device=dev), {}),
                             (NI.N_BIG, lane_inputs(1, B_ALIGN, H16, "trot", dev),
                              dict(max_stance=4, pack=1))):
        (*ops, carry), skw = segment_calls(cfg, inputs, **kw)[1]
        cases.append((f"SEG/{tile}", seg, (*ops, *carry), (), skw))
    for key, fn, ops, args, kw in cases:
        want = fn(*ops, *args, **kw)
        got = fn(*map(offset_view, ops), *args, **kw)
        torch.cuda.synchronize()
        pairs = list(zip(*(x if isinstance(x, tuple) else (x,) for x in (want, got))))
        check(all((w is None and g is None) or torch.equal(w, g) for w, g in pairs),
              f"{key}: inputs at a 4-byte offset give the aligned call's result bit for bit")


def phase_kernels(cfg, dev, results):
    print("phase 3: kernels vs references on the card (h=10, the 128 tile)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    # K1 at the main path's shape and at an odd system count with 2 masked steps
    check_k1(cfg, dev, BATCH, H, MS, PACK, 0, "trot", results, timed=True)
    check_k1(cfg, dev, BATCH - 2, H, MS, PACK, 2, "trot")
    check_k1_slots(cfg, dev, B16)

    admm_sched, polish_sched = schedules(cfg)
    g9_zero = torch.zeros((N_SYS, 9, N_VARS // 3), device=dev)
    # the JAX package's kernel-test gates for the SPD cases and for a real
    # solve's ADMM operands
    cases = [("SPD cond 2.1e3, ADMM schedule", spd_batch(gen, N_SYS, N_VARS, NI.N, 2.1e3, dev),
              g9_zero, admm_sched, 0, 1e-2),
             ("SPD cond 1e4, polish schedule", spd_batch(gen, N_SYS, N_VARS, NI.N, 1e4, dev),
              g9_zero, polish_sched, 1, 5e-3)]
    calls = solve_operands(cfg, pipeline.random_inputs(seed=2, batch=BATCH, h=H, device=dev))
    check(len(calls) == 5, "a real solve makes 5 K2 calls")
    check_ns(cases + solve_cases(calls, polish_sched), results, NI.N, N_SYS)


def schur_bound(b: int, n: int, schedule, n_small: int = 13, n_scrub: int = 1):
    """K4 (ns_inverse_schur_scaled with its defaults) on b systems of n: K3 on
    the 128 block, then in fp32 A^-1 B, the Schur complement, its n_small
    NS steps, the block assembly and n_scrub NS steps at n; bytes: ks in, the
    inverse out."""
    m = n - NI.N
    k3 = ns_bound(b, NI.N, schedule, 0.0)[0] * 1e-3
    fp32 = b * (2.0 * NI.N * NI.N * m + 2.0 * m * NI.N * m + n_small * 4.0 * m ** 3
                + 2.0 * NI.N * m * m + 2.0 * NI.N * m * NI.N + n_scrub * 4.0 * n ** 3)
    t_ops = k3 + fp32 / PEAK_FP32
    t_bytes = 2 * b * n * n * 4.0 / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_k4(label, ks, sched, gate):
    """K4 (the Schur split around K3 at the 128 tile) against its plain
    version, the same function with K3's reference in place of the kernel:
    row-sum residuals under the gate, the kernel's within 2x of the plain
    one's."""
    x_k = NI.ns_inverse_schur_scaled(ks, *sched)
    kernel = NI.ns_inverse_scaled
    NI.ns_inverse_scaled = NI.ns_inverse_scaled_reference
    try:
        x_r = NI.ns_inverse_schur_scaled(ks, *sched)
    finally:
        NI.ns_inverse_scaled = kernel
    res_k, res_r = residuals(ks, x_k)[1], residuals(ks, x_r)[1]
    print(f"  K4 {label}: row-sum residual kernel {res_k:.3e} plain {res_r:.3e} (gate {gate}); "
          f"max |x_k - x_r| {float((x_k - x_r).abs().max()):.3e}")
    check(x_k.shape == ks.shape and res_k < gate and res_r < gate
          and res_k <= 2 * res_r + 1e-5, f"K4 {label}: residuals")


def phase_kernels16(cfg, dev, results):
    print(f"phase 3b: kernels vs references on the card (h=16: K1 above 128 variables, "
          f"the 256 tile, K4)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    for lane, (ms, pack, kind) in LANES16.items():
        check_k1(cfg, dev, B16, H16, ms, pack, 0, kind,
                 results if lane == "h16_full" else None, timed=True)
    check_k1(cfg, dev, B16 - 2, H16, 4, 1, 2, "trot")
    # the largest shapes K1 takes, whose planes leave no room for the padded
    # row stride (qct_form_packed_smem_bytes); at h=36 the last tile reads
    # 16 columns past the planes' 112
    check_k1(cfg, dev, 512, 36, 1, 2, 0, "trot")
    check_k1(cfg, dev, 511, 25, 2, 1, 1, "trot")

    admm_sched, polish_sched = schedules(cfg)
    n_spd = N_SPD
    cases = []
    # 192 and 144 variables run K2/192, 240 (nblk 80) K2/256 over the whole tile
    for n in (192, 144, 240):
        g9_zero = torch.zeros((n_spd, 9, n // 3), device=dev)
        cases += [(f"SPD n={n} cond 2.1e3, ADMM schedule",
                   spd_batch(gen, n_spd, n, NI.N_BIG, 2.1e3, dev), g9_zero, admm_sched, 0, 1e-2),
                  (f"SPD n={n} cond 1e4, polish schedule",
                   spd_batch(gen, n_spd, n, NI.N_BIG, 1e4, dev), g9_zero, polish_sched, 1, 5e-3)]
    ms, pack, kind = LANES16["h16_full"]
    calls = solve_operands(cfg, lane_inputs(2, B16, H16, kind, dev), max_stance=ms, pack=pack)
    check(len(calls) == 5 and all(c[0].shape[-1] == NI.N_BIG and c[1].shape[-1] == 64
                                  for c in calls),
          "a real h16_full solve makes 5 K2 calls at the 256 tile, on 192 variables (K2/192)")
    # calls 0 and 2 again on K2/256: the same K taken as 240 variables (g9
    # zero-extended to 80 blocks adds zero blocks to hp's identity pad)
    solve = solve_cases(calls, polish_sched, polish_gate=1.0)
    wide = [(label + ", g9 zero-extended to 80 blocks", hp,
             torch.cat([g9, g9.new_zeros(g9.shape[:-1] + (16,))], -1), *rest)
            for label, hp, g9, *rest in (solve[0], solve[2])]
    check_ns(cases + solve + wide, results, NI.N_BIG, B16)
    del calls, cases, solve, wide

    # K4 on ADMM-grade SPD systems and on a real midband solve's two ADMM
    # operands (n = 144), gate 5e-3: the JAX package's Schur-split test and
    # its batch, 2G + 3 systems (the A block G-padded). Over 2048 such SPD
    # systems at cond 1e3 the largest row sum of the kernel's and of the
    # plain version's result comes near or over 5e-3, a tail the 19-system
    # gate was not set for.
    for cond in (213.0, 1e3):
        check_k4(f"SPD n=144 cond {cond:g}, ADMM schedule, {2 * NI.G + 3} systems",
                 spd_batch(gen, 2 * NI.G + 3, 144, 144, cond, dev), admm_sched, 5e-3)
    ms, pack, kind = LANES16["h16_midband"]
    k4_calls = solve_operands(cfg, lane_inputs(2, B16, H16, kind, dev),
                              "ns_inverse_schur_scaled", max_stance=ms, pack=pack)
    check(len(k4_calls) == 2 and all(c[0].shape == (B16, 144, 144) for c in k4_calls),
          "a real h16_midband solve makes 2 K4 calls at n=144")
    for i, (ks, sched) in enumerate(k4_calls):
        check_k4(f"midband solve call {i} (ADMM schedule)", ks, sched, 5e-3)
        if i == 0:
            t_k4 = median_ms(lambda: NI.ns_inverse_schur_scaled(ks, *sched))
            t_inv = median_ms(lambda: torch.linalg.inv(ks))
            b4 = schur_bound(B16, ks.shape[-1], sched)
            print(f"  K4 midband solve call 0 at {B16} systems: %.3f ms, torch.linalg.inv %.3f ms "
                  "(median of 10); bound %.4f ms (%s)" % (t_k4, t_inv, *b4))


def fused_call(cfg, inputs):
    """(args, kwargs) of the one K5 call a fused solve of `inputs` makes."""
    calls = []
    fn = FA.fused_admm_solve

    def record(*args, **kw):
        calls.append((tuple(a.clone() for a in args), kw))
        return fn(*args, **kw)

    FA.fused_admm_solve = record
    try:
        pipeline.solve_packed_batch(cfg, inputs, use_fused=True)
    finally:
        FA.fused_admm_solve = fn
    check(len(calls) == 1, "a fused solve makes 1 K5 call")
    return calls[0]


def fused_bound(b: int, kw: dict) -> tuple[float, str]:
    """K5 per system, on the units the kernel uses: 1 + polish_rounds
    factorizations (the NS schedule at the 128 tile as ns_bound counts it:
    3 bf16 passes a bf16x3 step, 3 tf32 passes a tail step) and as many
    Grams (2 M N^2, 3 tf32 passes); on the CUDA cores n_iter ADMM iterations
    (A'v and Av, 2 M N each, and the inverse matvec, 2 N^2) and per polish
    round its right-hand side, 3 inverse and 2 K matvecs and Ax; bytes: H, g,
    l, u, rho in, x out, A once."""
    n, m = FA.N, FA.M
    facs = 1 + kw["polish_rounds"]
    prod = 2.0 * n ** 3 * 2 * b * facs
    gram = 2.0 * m * n * n * b * facs
    fp32 = b * (kw["n_iter"] * (4.0 * m * n + 2.0 * n * n)
                + kw["polish_rounds"] * (4.0 * m * n + 10.0 * n * n))
    nbytes = 4.0 * (b * (n * n + 2 * n + 3 * m) + m * n)
    return bound(3 * prod * (kw["n_scaled"] + kw["n_quad"]), fp32, nbytes,
                 3 * (prod * kw["n_hi"] + gram))


def fused_phases(args, kw: dict) -> dict:
    """K5's time split by phase, each from the wrapper's median of 3 with
    some of the work cut: build (n_iter = polish_rounds = 0: the Gram and one
    factorization), iterate (the ADMM iterations alone: no polish minus
    build), polish (the whole call minus no polish), and grams (n_iter = 0
    and the NS schedule empty: the 1 + 2 polish_rounds Grams the kernel
    computes with their staging of A, the right-hand sides and the polish's
    matvecs; an upper bound of the Grams' time)."""
    def t(**cut):
        return median_ms(lambda: FA.fused_admm_solve(*args, **{**kw, **cut}), reps=3)

    full, no_polish, build = t(), t(polish_rounds=0), t(n_iter=0, polish_rounds=0)
    grams = t(n_iter=0, n_scaled=0, n_quad=0, n_hi=0)
    return dict(build=build, iterate=no_polish - build, polish=full - no_polish, grams=grams,
                full=full)


def spd_warm(gen, b: int, n: int, npad: int, dev):
    """(ks, init, r0): SPD systems of condition 1e4 and the warm start of the
    JAX package's refinement test, the exact inverse times (I + E) with
    ||E||_2 = 0.05; r0 is the start's row-sum residual."""
    ks = spd_batch(gen, b, n, npad, 1e4, dev)
    e = torch.randn((b, npad, npad), generator=gen, device=dev, dtype=torch.float64)
    e *= 0.05 / torch.linalg.matrix_norm(e.float(), ord=2).double()[:, None, None]
    eye = torch.eye(npad, dtype=torch.float64, device=dev)
    init = torch.linalg.inv(ks.double()) @ (eye + e)
    r0 = float((eye - ks.double() @ init).abs().sum(-1).max())
    return ks, init.float(), r0


def woodbury_config(cfg):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, polish_woodbury=True))


def row_sums(ks, inv) -> torch.Tensor:
    """Per system, the largest row sum of |I - ks inv|."""
    return identity_gap(ks, inv).sum(-1).amax(-1)


def check_k6_real(label, ks, init, sched, polish_gate) -> float:
    """K6 against its reference on the operands of a real Woodbury solve.
    K6 has no guard: its contract is a start whose row-sum residual is below
    1, and the Woodbury correction meets it on part of the batch only (it
    amplifies the stored inverse's fp32 error by ~w_act, the JAX package's
    config note): on the card 13-17% of the systems of round 1 and 33-45% of
    round 2 start below 1; outside, kernel and reference diverge alike. On
    the systems inside, both stop at the fp32 floor of the polish
    conditioning (row sum ~0.02 median, up to ~0.15), where the SPD cases'
    5e-3 and 0.1 r0 do not apply. Gates there: finite; the largest row sum
    under solve_cases' polish gate and within 2x of the reference's; the
    median within 1.2x of the reference's (measured 0.98-1.05x); each
    system's inverse within 5e-2 of the reference's, relative to its largest
    entry (measured <= 1.5e-2). Returns max |inv_k - inv_r| on those
    systems."""
    out_k = NI.ns_inverse_refine(ks, init, *sched)
    out_r = NI.ns_inverse_refine_reference(ks, init, *sched)
    r0, rk, rr = row_sums(ks, init), row_sums(ks, out_k), row_sums(ks, out_r)
    dom = r0 < 1.0
    n_dom = int(dom.sum())
    fin_k = torch.isfinite(out_k).all(-1).all(-1)
    fin_r = torch.isfinite(out_r).all(-1).all(-1)
    rel_sys = ((out_k - out_r).abs().amax(dim=(-2, -1))
               / out_r.abs().amax(dim=(-2, -1)))[dom]
    check(n_dom > 0, f"{label}: some systems start below 1")
    rk_d, rr_d = rk[dom], rr[dom]
    print(f"  {label}: {n_dom} of {ks.shape[0]} systems start below 1 (r0 median "
          f"{float(r0.median()):.3e}); on them row sums kernel max {float(rk_d.max()):.3e} median "
          f"{float(rk_d.median()):.3e}, reference max {float(rr_d.max()):.3e} median "
          f"{float(rr_d.median()):.3e}; per-system relative |inv_k - inv_r| max "
          f"{float(rel_sys.max()):.3e}; finite alike on {float((fin_k == fin_r).float().mean()):.4f}"
          f" of all systems")
    check(bool(fin_k[dom].all()), f"{label}: finite where the start is below 1")
    check(float(rk_d.max()) < polish_gate and float(rk_d.max()) <= 2 * float(rr_d.max()) + 1e-5,
          f"{label}: largest row sum < {polish_gate} and within 2x of the reference's")
    check(float(rk_d.median()) <= 1.2 * float(rr_d.median()) and float(rel_sys.max()) <= 5e-2,
          f"{label}: median row sum within 1.2x of the reference's, each inverse within 5e-2")
    return float((out_k - out_r)[dom].abs().max())


def phase_kernels_fused(cfg, dev, results):
    print(f"phase 3c: K5 and K6 vs references on the card (K5 at batch {B_FUSED}, h={H})")
    args, kw = fused_call(cfg, pipeline.random_inputs(seed=0, batch=B_FUSED, h=H, device=dev))
    x_k = FA.fused_admm_solve(*args, **kw)
    x_r = FA.fused_admm_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    n = 3 * MS * H
    f_scale = float(cfg.mpc.f_max)
    diff = ((x_k - x_r)[:, :n].abs() * f_scale).amax(-1)
    share = float((diff <= 0.5).float().mean())
    print(f"  K5: max |f_k - f_r| {float(diff.max()):.3e} N, median {float(diff.median()):.3e} N, "
          f"share of systems within 0.5 N {share:.4f}")
    check(bool(torch.isfinite(x_k).all()), "K5: finite")
    check(share >= 0.98 and float(diff.median()) <= 0.15,
          "K5: >= 0.98 of systems within 0.5 N of the reference, median <= 0.15 N")
    t_k = median_ms(lambda: FA.fused_admm_solve(*args, **kw), reps=3)
    t_r = median_ms(lambda: FA.fused_admm_solve_reference(*args, **kw), reps=3)
    b5 = fused_bound(B_FUSED, kw)
    phases = fused_phases(args, kw)
    results["K5/128"].update(max_abs_err=float((x_k - x_r).abs().max()), ms=t_k, plain_ms=t_r,
                             bound_ms=b5[0], bound_by=b5[1], library_ms=None, phases_ms=phases)
    print(f"  K5 at {B_FUSED} systems: kernel %.3f ms reference %.3f ms (median of 3); "
          "bound %.3f ms (%s)" % (t_k, t_r, *b5))
    print("  K5 by phase (ms, median of 3): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; grams share of the whole call <= {phases['grams'] / phases['full']:.4f}")
    del args, x_k, x_r

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    s = cfg.solver
    sched = (s.ns_wb_quad, s.ns_wb_hi)
    wb = woodbury_config(cfg)
    ms16, pack16, kind16 = LANES16["h16_full"]
    # (tile, systems, variables, the Woodbury solve whose K6 operands are held)
    for npad, n_sys, n_log, (inputs, kw) in (
            (NI.N, N_SYS, N_VARS, (pipeline.random_inputs(seed=2, batch=BATCH, h=H, device=dev),
                                   {})),
            (NI.N_BIG, B16, 3 * ms16 * pack16 * H16,
             (lane_inputs(2, B16, H16, kind16, dev), dict(max_stance=ms16, pack=pack16)))):
        ks, init, r0 = spd_warm(gen, n_sys, n_log, npad, dev)
        out_k = NI.ns_inverse_refine(ks, init, *sched)
        out_r = NI.ns_inverse_refine_reference(ks, init, *sched)
        res_k, res_r = residuals(ks, out_k)[1], residuals(ks, out_r)[1]
        print(f"  K6/{npad} ({n_sys} systems of n={n_log}, cond 1e4): row-sum residual r0 {r0:.3e}"
              f" -> kernel {res_k:.3e} reference {res_r:.3e}; max |inv_k - inv_r| "
              f"{float((out_k - out_r).abs().max()):.3e}")
        check(bool(torch.isfinite(out_k).all()) and res_k < 5e-3 and res_k < 0.1 * r0
              and res_k <= 1.1 * res_r, f"K6/{npad} SPD: residual < 5e-3, < 0.1 r0, within 10% "
              "of the reference's")
        del ks, init, out_k, out_r
        calls = solve_operands(wb, inputs, "ns_inverse_refine", **kw)
        check(len(calls) == 2 and all(c[0].shape == (n_sys, npad, npad) for c in calls),
              f"a real Woodbury solve makes 2 K6 calls on {n_sys} systems at the {npad} tile")
        for i, (ks, init, sched_c) in enumerate(calls):
            err = check_k6_real(f"K6/{npad} Woodbury solve call {i}", ks, init, sched_c,
                                polish_gate=0.5 if npad == NI.N else 1.0)
            if i == 0:
                t = [median_ms(lambda: NI.ns_inverse_refine(ks, init, *sched_c)),
                     median_ms(lambda: NI.ns_inverse_refine_reference(ks, init, *sched_c)),
                     median_ms(lambda: torch.linalg.inv(ks))]
                # device time by CUDA events over 20 chained calls, beside
                # torch.linalg.inv_ex on the same matrices (inv syncs)
                d6 = [event_ms(lambda: NI.ns_inverse_refine(ks, init, *sched_c)),
                      event_ms(lambda: torch.linalg.inv_ex(ks))]
                b6 = ns_bound(n_sys, npad, (0.0, 0) + sched_c, 3 * n_sys * npad * npad * 4.0)
                results[f"K6/{npad}"].update(max_abs_err=err, ms=t[0], plain_ms=t[1],
                                             library_ms=t[2], bound_ms=b6[0], bound_by=b6[1],
                                             device_ms=d6[0], library_device_ms=d6[1])
                print(f"  K6/{npad} Woodbury solve call 0 at {n_sys} systems: kernel %.3f ms "
                      "reference %.3f ms torch.linalg.inv %.3f ms (median of 10); by events: "
                      "kernel %.4f ms, torch.linalg.inv_ex %.4f ms; bound %.4f ms (%s)"
                      % (*t, *d6, *b6))
        del calls


def plain_ns_bound(b: int, npad: int, iters: int) -> tuple[float, str]:
    """K8/K9: `iters` fp32 NS steps of two npad^3 products per system, each
    3 tf32 passes; bytes: ks in, the inverse out."""
    return bound(0.0, 0.0, 2 * b * npad * npad * 4.0, 3 * 2.0 * npad ** 3 * 2 * b * iters)


def warm_bound(n_warm: int, n_cold: int, npad: int, schedule, warm_kw) -> tuple[float, str]:
    """K7 on this run's data: every system's guard product (one bf16x3
    product); a system that passes completes that step (one more) and runs
    n_wquad - 1 bf16x3 and n_whi fp32 steps; one that trips runs the cold
    schedule. Bytes: ks and init in, the inverse out."""
    _, n_scaled, n_quad, n_hi = schedule
    prod = 2.0 * npad ** 3
    bf16 = 3 * prod * ((n_warm + n_cold) + n_warm * (1 + 2 * (warm_kw["n_wquad"] - 1))
                       + n_cold * 2 * (n_scaled + n_quad))
    tf32 = 3 * prod * 2 * (n_warm * warm_kw["n_whi"] + n_cold * n_hi)
    return bound(bf16, 0.0, 3 * (n_warm + n_cold) * npad * npad * 4.0, tf32)


def guard_r0(ks, init) -> torch.Tensor:
    """K7's guard per system, as its reference computes it: the largest row
    sum of |I - K X0| with the bf16x3 product."""
    k_hi, k_lo = NI._split(ks)
    eye = torch.eye(ks.shape[-1], device=ks.device)
    return (eye - NI._mm3(k_hi, k_lo, init)).abs().sum(-1).amax(-1)


def scenario_admm_ks(cfg, inputs) -> torch.Tensor:
    """Per scenario, the Jacobi-scaled K of the first ADMM-phase
    factorization that the per-scenario solve (pipeline.solve ->
    admm.admm_mpc -> admm._make_solver) makes: (B, n, n), n = 12 h, taken
    from the solver objects of one solve_batch without polish."""
    real = admm._make_solver

    def one(inp):
        made = []

        def record(*args, **kw):
            made.append(real(*args, **kw))
            return made[-1]

        admm._make_solver = record
        try:
            pipeline.solve(cfg, inp, polish_rounds=0)
        finally:
            admm._make_solver = real
        return made[0].ks

    return vmap(one)(inputs)


def check_plain_ns(cfg, label, ks_log, npad, results):
    """K9 through make_ns_inverse under torch.func.vmap and K8 through its
    unbatched call, on ks_log (B, n, n) padded to npad, against their
    references and against the plain fp32 NS (`admm._ns_inverse`, what the
    per-scenario solver runs) at the logical size."""
    iters = cfg.solver.ns_iters
    b, n = ks_log.shape[0], ks_log.shape[-1]
    ksp = NI.pad_to(ks_log, n, npad).contiguous()
    f = NI.make_ns_inverse(iters)
    reset_counts()
    inv_k = torch.func.vmap(f)(ksp)
    torch.cuda.synchronize()
    c9 = counts()
    check(c9 == want(**{f"K9_{npad}": 1}), f"K9/{npad} via make_ns_inverse under vmap: launches "
          f"K9={c9[f'K9/{npad}']}, K8={c9[f'K8/{npad}']}, else 0")
    reset_counts()
    one_k = f(ksp[0])
    torch.cuda.synchronize()
    c8 = counts()
    check(c8 == want(**{f"K8_{npad}": 1}), f"K8/{npad} via make_ns_inverse on one matrix: launches "
          f"K8={c8[f'K8/{npad}']}, K9={c8[f'K9/{npad}']}, else 0")
    inv_r = NI.ns_inverse_blocked_reference(ksp, iters)
    one_r = NI.ns_inverse_reference(ksp[0], iters)
    plain = admm._ns_inverse(ks_log, iters)
    res_k, res_r = residuals(ksp, inv_k)[0], residuals(ksp, inv_r)[0]
    err9 = float((inv_k - inv_r).abs().max())
    err8 = float((one_k - one_r).abs().max())
    rel_plain = rel(inv_k[:, :n, :n], plain)
    print(f"  K9/{npad} {label} ({b} systems): max |I - K X| kernel {res_k:.3e} reference "
          f"{res_r:.3e}; max |inv_k - inv_r| {err9:.3e}; relative to the plain _ns_inverse at "
          f"n={n}: {rel_plain:.3e}; K8 on system 0: max |inv_k - inv_r| {err8:.3e}")
    # the JAX kernel tests' residual gate (5e-4 at cond 1e3) and their
    # agreement with the plain NS (1e-4 relative)
    check(bool(torch.isfinite(inv_k).all()) and res_k < 5e-4 and res_k <= 2 * res_r + 1e-5,
          f"K9/{npad} {label}: residual < 5e-4 and within 2x of the reference's")
    check(rel_plain < 1e-4 and rel(one_k, inv_k[0]) < 1e-4,
          f"K9/{npad} and K8/{npad}: within 1e-4 of the plain NS")
    t9 = [median_ms(lambda: NI.ns_inverse_blocked(ksp, iters)),
          median_ms(lambda: NI.ns_inverse_blocked_reference(ksp, iters)),
          median_ms(lambda: torch.linalg.inv(ksp))]
    k0 = ksp[0].contiguous()
    t8 = [median_ms(lambda: NI.ns_inverse(k0, iters)),
          median_ms(lambda: NI.ns_inverse_reference(k0, iters)),
          median_ms(lambda: torch.linalg.inv(k0))]
    # device time by CUDA events over chained calls: K8 (20) and K9 (3) and
    # torch.linalg.inv_ex on the same matrices (inv syncs for its error check)
    d9 = [event_ms(lambda: NI.ns_inverse_blocked(ksp, iters), 3),
          event_ms(lambda: torch.linalg.inv_ex(ksp), 3)]
    d8 = [event_ms(lambda: NI.ns_inverse(k0, iters)), event_ms(lambda: torch.linalg.inv_ex(k0))]
    b9, b8 = plain_ns_bound(b, npad, iters), plain_ns_bound(1, npad, iters)
    results[f"K9/{npad}"].update(launches=c9[f"K9/{npad}"], max_abs_err=err9, ms=t9[0],
                                 plain_ms=t9[1], library_ms=t9[2], bound_ms=b9[0], bound_by=b9[1],
                                 device_ms=d9[0], library_device_ms=d9[1],
                                 counted_in=f"make_ns_inverse under vmap, {label}")
    results[f"K8/{npad}"].update(launches=c8[f"K8/{npad}"], max_abs_err=err8, ms=t8[0],
                                 plain_ms=t8[1], library_ms=t8[2], bound_ms=b8[0], bound_by=b8[1],
                                 device_ms=d8[0], library_device_ms=d8[1],
                                 counted_in=f"make_ns_inverse on one matrix, {label}")
    print(f"  K9/{npad} at {b} systems: kernel %.3f ms reference %.3f ms torch.linalg.inv %.3f ms "
          "(host clock, median of 10); by events: kernel %.3f ms, torch.linalg.inv_ex %.3f ms; "
          "bound %.3f ms (%s)" % (*t9, *d9, *b9))
    print(f"  K8/{npad} on one system: kernel %.3f ms reference %.3f ms torch.linalg.inv %.3f ms "
          "(host clock); by events: kernel %.4f ms, torch.linalg.inv_ex %.4f ms; bound %.4f ms "
          "(%s)" % (*t8, *d8, *b8))


def warm_pairs(cfg, inputs, **solve_kw):
    """K7's real operands: the K of the K2 calls of one packed solve (at the
    logical n), paired as the JAX per-scenario solver warm-starts them:
    (label, K cold, its schedule, K warm-started from it, its schedule)."""
    calls = solve_operands(cfg, inputs, **solve_kw)
    n = 3 * calls[0][1].shape[-1]
    ks = [NI._build_k(hp, g9)[:, :n, :n] for hp, g9, _ in calls]
    return [("ADMM: cold, then the adaptive-rho refactorization", ks[0], calls[0][2], ks[1],
             calls[1][2]),
            ("polish: round 0, then round 1", ks[2], calls[2][2], ks[3], calls[3][2])]


def check_k7_pair(cfg, label, k1, sched1, k2, sched2, npad, gate, results=None, reps=10):
    """K7 on a real warm pair: the second factorization through
    _batched_solver(prev_inv=..., prev_scale=...) seeded from the first's
    _Solver.inv_padded / .scale. Against its reference: the guard's pass
    share, which systems return K3's result bit for bit (those that trip),
    and residuals (metric as solve_cases: elementwise at the ADMM schedule,
    the row sum at the polish one, under `gate` and within 2x of the
    reference's). Times K7, its reference, K3 on the same systems with the
    same schedule and torch.linalg.inv; with `results`, fills K7's entry."""
    first = admm._batched_solver(k1, cfg.solver, True, schedule=sched1)
    seen = []
    real = NI.ns_inverse_warm

    def record(ksp, init, *args, **kw):
        seen.append((ksp, init, args, kw))
        return real(ksp, init, *args, **kw)

    NI.ns_inverse_warm = record
    reset_counts()
    try:
        second = admm._batched_solver(k2, cfg.solver, True, schedule=sched2,
                                      prev_inv=first.inv_padded, prev_scale=first.scale)
        torch.cuda.synchronize()
    finally:
        NI.ns_inverse_warm = real
    c = counts()
    tag = f"K7/{npad} {label}"
    check(c == want(**{f"K7_{npad}": 1}) and len(seen) == 1,
          f"{tag}: _batched_solver(prev_inv=...) launches K7/{npad} once, nothing else")
    ksp, init, sargs, skw = seen[0]
    b = k2.shape[0]
    out_k = second.inv_padded
    out_r = NI.ns_inverse_warm_reference(ksp, init, *sargs, **skw)[:b]
    cold_k = NI.ns_inverse_scaled(ksp, *sargs)[:b]
    r0 = guard_r0(ksp, init)[:b]
    warm = r0 < skw["guard"]
    n_warm = int(warm.sum())
    as_cold = (out_k == cold_k).all(-1).all(-1)
    agree = float((as_cold == ~warm).float().mean())
    polish = sched2 == schedules(cfg)[1]
    ks_b = ksp[:b]
    res_k = row_sums(ks_b, out_k) if polish else identity_gap(ks_b, out_k).amax(dim=(-2, -1))
    res_r = row_sums(ks_b, out_r) if polish else identity_gap(ks_b, out_r).amax(dim=(-2, -1))
    err = float((out_k - out_r).abs().max())
    print(f"  {tag}: {n_warm} of {b} systems pass the guard (share {n_warm / b:.4f}; r0 median "
          f"{float(r0.median()):.3e}, min {float(r0.min()):.3e}); the kernel returns K3's result "
          f"bit for bit exactly where the reference's guard trips on {agree:.4f} of systems")
    for name, sel in (("warm", warm), ("cold", ~warm)):
        if bool(sel.any()):
            print(f"    {name} systems: {'row-sum' if polish else 'max |I - K X|'} residual kernel "
                  f"max {float(res_k[sel].max()):.3e} median {float(res_k[sel].median()):.3e}, "
                  f"reference max {float(res_r[sel].max()):.3e} median "
                  f"{float(res_r[sel].median()):.3e}")
    print(f"    max |inv_k - inv_r| {err:.3e}")
    check(bool(torch.isfinite(out_k).all()), f"{tag}: finite")
    check(agree >= 0.999, f"{tag}: the tripped systems (and only they) return K3's result")
    check(float(res_k.max()) < gate and float(res_k.max()) <= 2 * float(res_r.max()) + 1e-5,
          f"{tag}: residual < {gate} and within 2x of the reference's")
    if results is not None:
        t = [median_ms(lambda: NI.ns_inverse_warm(ksp, init, *sargs, **skw), reps=reps),
             median_ms(lambda: NI.ns_inverse_warm_reference(ksp, init, *sargs, **skw), reps=3),
             median_ms(lambda: NI.ns_inverse_scaled(ksp, *sargs), reps=reps),
             median_ms(lambda: torch.linalg.inv(ksp), reps=reps)]
        # device time by CUDA events: K7's call, each of its two launches,
        # K3 on the same systems, torch.linalg.inv_ex (inv syncs)
        guard_ms, cold_ms = k7_launch_ms(ksp, init, sargs, skw, ~warm, npad)
        d = dict(device_ms=event_ms(lambda: NI.ns_inverse_warm(ksp, init, *sargs, **skw), 5),
                 guard_ms=guard_ms, cold_ms=cold_ms,
                 k3_device_ms=event_ms(lambda: NI.ns_inverse_scaled(ksp, *sargs), 5),
                 library_device_ms=event_ms(lambda: torch.linalg.inv_ex(ksp), 5))
        b7 = warm_bound(n_warm, b - n_warm, npad, sargs, skw)
        results[f"K7/{npad}"].update(launches=c[f"K7/{npad}"], max_abs_err=err, ms=t[0],
                                     plain_ms=t[1], library_ms=t[3], bound_ms=b7[0],
                                     bound_by=b7[1], guard_share=n_warm / b, k3_ms=t[2],
                                     counted_in=f"_batched_solver(prev_inv=...), {label}", **d)
        print(f"  {tag} at {b} systems: K7 %.3f ms, reference %.3f ms, K3 on the same systems "
              "and schedule %.3f ms, torch.linalg.inv %.3f ms (median); bound %.3f ms (%s)"
              % (*t, *b7))
        print(f"  {tag} by events: K7 {d['device_ms']:.4f} ms (the guard and warm launch "
              f"{guard_ms:.4f}, K3 on the {b - n_warm} tripped systems {cold_ms:.4f}), K3 on all "
              f"{d['k3_device_ms']:.4f}, torch.linalg.inv_ex {d['library_device_ms']:.4f}; share "
              f"of the bound {b7[0] / d['device_ms']:.4f}")
    # starts that trip every system's guard, 17.0 and NaN everywhere: K3's
    # result, bit for bit
    k3 = NI.ns_inverse_scaled(ksp, *sargs)
    for start in (17.0, float("nan")):
        garbage = torch.full_like(init, start)
        out_g = NI.ns_inverse_warm(ksp, garbage, *sargs, **skw)
        trips = (guard_r0(ksp, garbage) >= skw["guard"]) | guard_r0(ksp, garbage).isnan()
        check(bool(trips.all()) and torch.equal(out_g, k3),
              f"{tag}: a start of {start} everywhere trips every guard and returns K3's result "
              "exactly")


def k7_launch_ms(ksp, init, sargs, skw, tripped, npad) -> tuple[float, float]:
    """Device ms (CUDA events over 5 chained launches) of K7's two launches
    apart, through the library's entry points: the guard and warm branch
    (qct_ns_warm_guarded), then K3 masked to the systems it flagged
    (qct_ns_inverse_scaled_masked[_256]). Checks that the flags are the
    reference guard's `tripped` on >= 0.999 of the systems."""
    lib, b = _build.load(), ksp.shape[0]
    flags = torch.empty(b, dtype=torch.int32, device=ksp.device)
    inv = torch.empty_like(ksp)
    P, stream = _launch.ptr, _launch.stream(ksp)
    masked = (lib.qct_ns_inverse_scaled_masked if npad == NI.N
              else lib.qct_ns_inverse_scaled_masked_256)

    def guarded():
        _launch.raise_on_error(lib.qct_ns_warm_guarded(
            P(ksp), P(init), P(inv), P(flags), b, skw["n_wquad"], skw["n_whi"], skw["guard"],
            npad, stream), "qct_ns_warm_guarded")

    def cold():
        _launch.raise_on_error(masked(P(ksp), P(inv), P(flags), b, NI._mus_arg(*sargs[:2]),
                                      *sargs[1:], stream), "qct_ns_inverse_scaled_masked")

    guard_ms = event_ms(guarded, 5)
    check(float((flags.bool() == tripped).float().mean()) >= 0.999,
          f"K7/{npad}: the guard launch flags the systems the reference's guard trips")
    return guard_ms, event_ms(cold, 5)


def check_k7_all_warm(cfg, gen, npad, n, dev, results):
    """K7 on spd_warm starts (B16 systems of n variables, cond 1e4): every
    system passes the guard, the warm branch alone runs; residual gates as
    check_k7_pair's at the polish schedule (the row sum under 5e-3, the SPD
    gate of K6, and within 2x of the reference's), timed by events beside
    torch.linalg.inv_ex."""
    s = cfg.solver
    skw = dict(n_wquad=s.ns_warm_quad, n_whi=s.ns_warm_hi, guard=s.ns_warm_guard)
    ks, init, r0 = spd_warm(gen, B16, n, npad, dev)
    out_k = NI.ns_inverse_warm(ks, init, **skw)
    out_r = NI.ns_inverse_warm_reference(ks, init, **skw)
    share = float((guard_r0(ks, init) < skw["guard"]).float().mean())
    res_k, res_r = residuals(ks, out_k)[1], residuals(ks, out_r)[1]
    tag = f"K7/{npad} all warm ({B16} SPD systems of n={n}, cond 1e4, r0 {r0:.3e})"
    print(f"  {tag}: guard share {share:.4f}; row-sum residual kernel {res_k:.3e} reference "
          f"{res_r:.3e}; max |inv_k - inv_r| {float((out_k - out_r).abs().max()):.3e}")
    check(share == 1.0 and bool(torch.isfinite(out_k).all()) and res_k < 5e-3
          and res_k <= 2 * res_r + 1e-5,
          f"{tag}: every guard passes; residual < 5e-3 and within 2x of the reference's")
    d = [event_ms(lambda: NI.ns_inverse_warm(ks, init, **skw), 5),
         event_ms(lambda: torch.linalg.inv_ex(ks), 5)]
    b7 = warm_bound(B16, 0, npad, (0.0, 0, 0, 0), skw)
    results[f"K7/{npad}"].update(all_warm_device_ms=d[0], all_warm_library_device_ms=d[1],
                                 all_warm_bound_ms=b7[0])
    print(f"  {tag} by events: K7 {d[0]:.4f} ms, torch.linalg.inv_ex {d[1]:.4f} ms; bound "
          f"{b7[0]:.4f} ms ({b7[1]}), share {b7[0] / d[0]:.4f}")


def phase_kernels_plain_warm(cfg, dev, results):
    print("phase 3d: K7, K8, K9 vs references on the card (128 and 256 tiles)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    # K8/K9 on the per-scenario path's own ADMM-phase K (h=10, n=120) and on
    # the JAX kernel test's SPD systems at the 256 tile (n=192, cond 1e3)
    ks120 = scenario_admm_ks(cfg, pipeline.random_inputs(seed=0, batch=N_SYS, h=H, device=dev))
    check_plain_ns(cfg, "per-scenario ADMM-phase K, h=10, n=120", ks120, NI.N, results)
    del ks120
    check_plain_ns(cfg, "SPD n=192 cond 1e3", spd_batch(gen, B16, 192, 192, 1e3, dev), NI.N_BIG,
                   results)
    # K7 on real warm pairs of the h=10 solve (2048 systems of n=120) and of
    # h16_full (2048 of n=192), gates as solve_cases'
    ms16, pack16, kind16 = LANES16["h16_full"]
    for npad, inputs, kw, polish_gate, reps in (
            (NI.N, pipeline.random_inputs(seed=2, batch=BATCH, h=H, device=dev), {}, 0.5, 10),
            (NI.N_BIG, lane_inputs(2, B16, H16, kind16, dev),
             dict(max_stance=ms16, pack=pack16), 1.0, 5)):
        for i, (label, k1, s1, k2, s2) in enumerate(warm_pairs(cfg, inputs, **kw)):
            check_k7_pair(cfg, label, k1, s1, k2, s2, npad,
                          polish_gate if i else 1e-2, results if i == 0 else None, reps)
        check_k7_all_warm(cfg, gen, npad, N_VARS if npad == NI.N else 192, dev, results)


B_SCN = 1024                    # scenarios of the per-scenario lanes (phase 4d)


def phase_scenario_path(cfg, dev, name_power):
    """The per-scenario solve (pipeline.solve_batch / solve_compressed_batch,
    torch.func.vmap over admm.admm_mpc): forces, no kernel launched, and the
    share within 1 N of solve_packed_batch on the same inputs."""
    print(f"phase 4d: the per-scenario path, solve_batch and solve_compressed_batch at batch "
          f"{B_SCN}, h={H}")
    inputs = pipeline.random_inputs(seed=0, batch=B_SCN, h=H, device=dev)
    packed = pipeline.solve_packed_batch(cfg, inputs)
    times = {}
    for label, max_stance, fn in (
            ("scenario_full", 4, lambda: pipeline.solve_batch(cfg, inputs)),
            ("scenario_compressed", MS, lambda: pipeline.solve_compressed_batch(cfg, inputs, MS))):
        reset_counts()
        forces = fn()
        torch.cuda.synchronize()
        c = counts()
        check(c == want(), f"{label}: launches no kernel (the JAX per-scenario solve runs no "
              "Pallas kernel either)")
        force_checks(cfg, inputs, forces, max_stance)
        diff = (forces - packed).abs().amax(dim=(1, 2, 3))
        share = float((diff <= 1.0).float().mean())
        print(f"  {label} vs solve_packed_batch: share of scenarios within 1 N {share:.4f}, "
              f"median {float(diff.median()):.3e} N, max {float(diff.max()):.3e} N")
        # the same comparison on the CPU (plain packed branch,
        # random_inputs(seed=0, batch=256, h=10)): 0.9922 for both paths
        check(share >= 0.9922 - 0.02, f"{label}: >= 0.9722 of scenarios within 1 N of "
              "solve_packed_batch")
        times[label] = median_ms(fn, reps=3)
        print(f"  {label}: {times[label]:.2f} ms per call (median of 3), "
              f"{B_SCN / times[label] * 1e3:.0f} solves/s at batch {B_SCN}, no kernel launched "
              f"({name_power})")
    return times


def bound_violation(cfg, inputs, forces) -> torch.Tensor:
    """Per scenario, the largest violation of the friction pyramid and the
    normal-force box (0 <= fz <= f_max on stance feet, 0 on swing feet), N."""
    gait = inputs.gait_table
    fx, fy, fz = forces[..., 0], forces[..., 1], forces[..., 2]
    mu, f_max = cfg.mpc.mu, cfg.mpc.f_max
    return torch.stack([-fz, fz - f_max * gait, fx.abs() - mu * fz, fy.abs() - mu * fz],
                       dim=-1).amax(dim=(1, 2, 3)).clamp(min=0.0)


def force_checks(cfg, inputs, forces, max_stance: int = MS, tight_min: float = 0.99):
    """Finite forces of the inputs' shape; exact zeros on the swing feet the
    stance compression drops (a swing foot kept in one of the max_stance
    slots is a variable bounded by 0 <= fz <= 0); every scenario inside the
    controller's acceptance gate (SolverConfig.fail_primal_tol) and a share
    >= tight_min inside 1e-3 N of the bounds."""
    b, h = inputs.gait_table.shape[:2]
    check(forces.shape == (b, h, 4, 3), f"forces shape ({b}, {h}, 4, 3)")
    check(bool(torch.isfinite(forces).all()), "forces finite")
    _, _, sel = formation.stance_selectors(inputs.gait_table, max_stance)
    dropped = (inputs.gait_table == 0) & (sel.sum(-2) == 0)
    check(bool((forces[dropped] == 0).all()), "forces of the dropped swing feet exactly 0")
    viol = bound_violation(cfg, inputs, forces)
    tight = float((viol <= 1e-3).float().mean())
    print(f"  max bound violation {float(viol.max()):.3e} N; share of scenarios within "
          f"1e-3 N {tight:.4f}")
    check(float(viol.max()) <= cfg.solver.fail_primal_tol,
          f"every scenario within the acceptance gate ({cfg.solver.fail_primal_tol} N)")
    check(tight >= tight_min, f">= {tight_min:.4f} of scenarios within 1e-3 N of the bounds")


def plain_gate(forces, plain, share_min: float = 0.98):
    """The kernel branch against the plain branch on the same inputs. The
    reference solve resolves a few knife-edge active sets differently under
    rounding-level changes (ROADMAP queue 3: the JAX package's own Pallas and
    XLA branches differ by > 0.5 N on 7 of 1024 scenarios at h=10), so the
    comparison gates the share of scenarios and the median, not the max."""
    diff = (forces - plain).abs().amax(dim=(1, 2, 3))
    share = float((diff <= 0.5).float().mean())
    print(f"  vs plain branch on the card: max |d| {float(diff.max()):.3e} N, median "
          f"{float(diff.median()):.3e} N, share of scenarios within 0.5 N {share:.4f}")
    check(share >= share_min and float(diff.median()) <= 0.15,
          f">= {share_min:.4f} of scenarios within 0.5 N of the plain branch, median <= 0.15 N")
    return share


SEG_SYSTEMS = 256               # systems of each segment held against the CPU reference
# shared memory of the whole card: 128 bytes a clock an SM, 132 SMs, the 1,980 MHz boost clock
PEAK_SMEM = 128 * 132 * 1.98e9


def segment_bound(b: int, n: int, iters: int) -> tuple[float, str]:
    """SEG: each iteration reads every system's n x n fp32 inverse from
    shared memory (n^2 multiply-adds); device memory moves the inverse once
    and the operands and carry (~15 n floats). The larger of the shared
    memory's time and bound()'s."""
    ms, by = bound(0.0, 2.0 * n * n * iters * b, 4.0 * b * (n * n + 15 * n))
    t_smem = 4.0 * n * n * iters * b / PEAK_SMEM * 1e3
    return (t_smem, "shared memory") if t_smem >= ms else (ms, by)


def segment_calls(cfg, inputs, **kw) -> list:
    """The (operands, keywords) of each admm_segment call that one
    solve_packed_batch makes."""
    with AS.recorded_calls() as calls:
        pipeline.solve_packed_batch(cfg, inputs, **kw)
    torch.cuda.synchronize()
    return calls


def segment_systems(args, device=None) -> tuple:
    """The first SEG_SYSTEMS systems of a segment's operands, on `device`."""
    take = lambda t: t[:SEG_SYSTEMS].contiguous().to(device or t.device)  # noqa: E731
    *ops, carry = args
    return (*map(take, ops), tuple(map(take, carry)))


def segment_rel(got, want, n: int) -> torch.Tensor:
    """Each system's largest |difference| over x, z, y's true entries, over
    the reference's largest entry in that vector."""
    out = []
    for g, w, width in zip(got, want, (n, 5 * n // 3, 5 * n // 3)):
        g, w = g[:, :width].double().cpu(), w[:, :width].double().cpu()
        out.append((g - w).abs().amax(1) / w.abs().amax(1).clamp(min=1e-30))
    return torch.stack(out).amax(0)


def check_segment(label, calls, results, key) -> dict:
    """SEG on one solve's own segment calls (segment_calls, or a routed
    group's two) against admm_segment_reference on the card
    (tests/test_torch_admm_segment_card.py's gates): the first call's
    operands run 60 fp32 iterations within 1e-4 of the reference's largest
    entry per system, the padding exact; each of the solver's segments
    (bf16, then bf16 and an fp32 tail) within three times the CPU
    reference's distance from the card's at the median, 90th percentile and
    largest system. The 1e-4 is the CPU reference's distance from the
    card's in fp32: where the CPU's own distance comes near it (the routed
    widths 72 and 84, whose worst systems amplify rounding over the 60
    iterations; the kernel there is the CPU's loop bit for bit in
    emulation), the fp32 run is held to the solver segments' rule instead. Times the solver's first segment on the whole batch by
    the host clock and by events beside the reference and the bound. Records
    the numbers under results[key]["lanes"][label], and the first lane's at
    the entry's top."""
    check(len(calls) == 2 and all(AS.fits(k["n"]) for _, k in calls),
          f"{label}: two ADMM segments, each n within the kernel's route")
    args, skw = calls[0]
    n, m, b = skw["n"], 5 * skw["n"] // 3, args[0].shape[0]
    sub = segment_systems(args)
    f32 = {**skw, "n_lo": 0, "n_hi": 60}
    got, want = AS.admm_segment(*sub, **f32), AS.admm_segment_reference(*sub, **f32)
    quantiles = lambda v: [float(torch.quantile(v, q)) for q in (0.5, 0.9, 1.0)]  # noqa: E731
    kq32 = quantiles(segment_rel(got, want, n))
    cq32 = quantiles(segment_rel(AS.admm_segment_reference(
        *segment_systems(sub, torch.device("cpu")), **f32), want, n))
    rel32 = kq32[-1]
    max_abs = max(float((g[:, :w] - r[:, :w]).abs().max())
                  for g, r, w in zip(got, want, (n, m, m)))
    pads = all(torch.equal(g[:, w:], r[:, w:]) for g, r, w in zip(got, want, (n, m, m)))
    near = rel32 <= 1e-4 or all(x <= 3.0 * c + 1e-5 for x, c in zip(kq32, cq32))
    check(near and pads,
          f"{label}: SEG, 60 fp32 iterations on {SEG_SYSTEMS} systems of n={n}: within 1e-4 of "
          f"the reference's largest entry per system ({rel32:.3e}; the CPU reference "
          f"{cq32[-1]:.3e}), or within 3x the CPU reference's distance at the median, 90th "
          f"percentile and largest ({', '.join(f'{x:.3e}' for x in kq32)} against "
          f"{', '.join(f'{x:.3e}' for x in cq32)}), the padding exact")
    bf16 = []
    for i, (a, k) in enumerate(calls):
        a = segment_systems(a)
        ref = AS.admm_segment_reference(*a, **k)
        kq = quantiles(segment_rel(AS.admm_segment(*a, **k), ref, n))
        cq = quantiles(segment_rel(AS.admm_segment_reference(
            *segment_systems(a, torch.device("cpu")), **k), ref, n))
        check(all(x <= 3.0 * c + 1e-5 for x, c in zip(kq, cq)),
              f"{label}: SEG, the solver's segment {i} (n_lo {k['n_lo']}, n_hi {k['n_hi']}): "
              f"from the card's reference {', '.join(f'{x:.3e}' for x in kq)} (median, 90th "
              f"percentile, largest) within 3x the CPU reference's "
              f"{', '.join(f'{x:.3e}' for x in cq)} + 1e-5")
        bf16.append(dict(n_lo=k["n_lo"], n_hi=k["n_hi"], kernel=kq, cpu=cq))
    iters = skw["n_lo"] + skw["n_hi"]
    kern = lambda: AS.admm_segment(*args, **skw)  # noqa: E731
    ref = lambda: AS.admm_segment_reference(*args, **skw)  # noqa: E731
    numbers = dict(n=n, systems=b, iterations=iters, ms=median_ms(kern, reps=5),
                   plain_ms=median_ms(ref, reps=5), device_ms=event_ms(kern),
                   plain_device_ms=event_ms(ref, n=5), fp32_rel=rel32, fp32_rel_cpu=cq32[-1],
                   max_abs_err=max_abs,
                   bf16_rel=bf16)
    numbers["bound_ms"], numbers["bound_by"] = segment_bound(b, n, iters)
    print(f"  {label}: SEG {numbers['device_ms']:.3f} ms a segment by events ({iters} "
          f"iterations, {b} systems of n={n}; {numbers['ms']:.3f} ms by the host clock), the "
          f"reference {numbers['plain_device_ms']:.3f} ms; bound {numbers['bound_ms']:.3f} ms "
          f"({numbers['bound_by']}), share {numbers['bound_ms'] / numbers['device_ms']:.3f}")
    entry = results[key]
    if "lanes" not in entry:
        entry.update({k: numbers[k] for k in ("n", "ms", "plain_ms", "device_ms",
                                              "plain_device_ms", "bound_ms", "bound_by",
                                              "max_abs_err", "fp32_rel")}, library_ms=None)
    entry.setdefault("lanes", {})[label] = numbers
    return numbers


@contextlib.contextmanager
def plain_kernels():
    """The kernel branch with every kernel replaced by its plain reference:
    the same solve arithmetic without the CUDA kernels."""
    swaps = ((FP, "form_packed"), (NI, "ns_inverse_scaled_build"), (NI, "ns_inverse_scaled"),
             (NI, "ns_inverse_refine"), (NI, "ns_inverse_warm"), (NI, "ns_inverse"),
             (NI, "ns_inverse_blocked"), (FA, "fused_admm_solve"), (AS, "admm_segment"))
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, f"{name}_reference"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def phase_main_path(cfg, dev, name_power, results):
    print("phase 4: main path, solve_packed_batch at batch 4096, h=10 (2048 systems, n=120)")
    inputs = pipeline.random_inputs(seed=0, batch=BATCH, h=H, device=dev)
    reset_counts()
    forces = pipeline.solve_packed_batch(cfg, inputs)
    torch.cuda.synchronize()
    main_counts = counts()
    print(f"  launches in one solve: {main_counts}")
    check(main_counts == want(K1_128=1, K2_128=5, SEG_128=2),
          "launches K1/128=1, K2/128=5, SEG/128=2, else 0")
    for k in ("K1/128", "K2/128", "SEG/128"):
        results[k].update(launches=main_counts[k], counted_in="h10 default")
    force_checks(cfg, inputs, forces)
    plain_gate(forces, pipeline.solve_packed_batch(cfg, inputs, use_kernels=False))
    check_segment("h10", segment_calls(cfg, inputs), results, "SEG/128")

    times = {}
    for label, kw in (("full", {}), ("no_polish", dict(polish_rounds=0)),
                      ("form_only", dict(form_only=True))):
        reset_counts()
        out = pipeline.solve_packed_batch(cfg, inputs, **kw)
        torch.cuda.synchronize()
        c = counts()
        expect = {"full": want(K1_128=1, K2_128=5, SEG_128=2),
                  "no_polish": want(K1_128=1, K2_128=2, SEG_128=2),
                  "form_only": want(K1_128=1)}[label]
        check(c == expect and bool(torch.isfinite(out).all()), f"{label}: launches {c}, finite")
        times[label] = median_ms(lambda: pipeline.solve_packed_batch(cfg, inputs, **kw), reps=5)
    admm._FUSED_BUILD = False
    try:
        reset_counts()
        two = pipeline.solve_packed_batch(cfg, inputs)
        torch.cuda.synchronize()
        c = counts()
        check(c == want(K1_128=1, K3_128=5, SEG_128=2), f"two-step build: launches {c}")
        results["K3/128"].update(launches=c["K3/128"], counted_in="h10 two_step_build")
        force_checks(cfg, inputs, two)
        d2 = float((two - forces).abs().amax(dim=(1, 2, 3)).le(0.25).float().mean())
        print(f"  two-step vs fused build: share of scenarios within 0.25 N {d2:.4f}")
        check(d2 >= 0.98, ">= 98% of scenarios within 0.25 N of the fused build")
        times["two_step_build"] = median_ms(lambda: pipeline.solve_packed_batch(cfg, inputs),
                                            reps=5)
    finally:
        admm._FUSED_BUILD = True
    for label, ms in times.items():
        print(f"  {label}: {ms:.2f} ms per call, {BATCH / ms * 1e3:.0f} solves/s at batch "
              f"{BATCH} ({name_power})")
    return times


def phase_lanes16(cfg, dev, name_power, results):
    """bench.py's three h=16 lanes at batch 2048 through the kernels: launch
    counts, forces, the plain branch, and ms per call with its phase split
    (no_polish, form_only), then h16_full on the two-step build (K3/256)."""
    print(f"phase 4b: the h=16 lanes, solve_packed_batch at batch {B16}")
    expect = {"h16_full": want(K1_256=1, K2_256=5, SEG_256=2),
              "h16_trot": want(K1_256=1, K2_256=5, SEG_256=2),
              "h16_midband": want(K1_256=1, K3_128=2, K2_256=3, SEG_256=2)}
    times = {}
    for lane, (ms, pack, kind) in LANES16.items():
        n = pack * 3 * ms * H16
        print(f"  {lane}: max_stance={ms} pack={pack} ({B16 // pack} systems of n={n})")
        inputs = lane_inputs(1, B16, H16, kind, dev)
        kw = dict(max_stance=ms, pack=pack)
        reset_counts()
        forces = pipeline.solve_packed_batch(cfg, inputs, **kw)
        torch.cuda.synchronize()
        c = counts()
        print(f"  launches in one solve: {c}")
        check(c == expect[lane], f"{lane}: launches as routed")
        if lane == "h16_full":
            # its systems have 192 variables: every K2 launch, which the
            # wrapper counts at the 256 tile, runs the 3-CTA instance
            results["K1/256"].update(launches=c["K1/256"], counted_in="h16_full")
            results["SEG/256"].update(launches=c["SEG/256"], counted_in="h16_full")
            results["K2/192"].update(launches=c["K2/256"],
                                     counted_in="h16_full (counted at the 256 tile)")
            results["K2/256"].update(launches=0, counted_in="h16_full (192 variables: K2/192)")
        if lane == "h16_midband":
            results["K3/128"].update(launches=c["K3/128"], counted_in="h16_midband (in K4)")
        # At h=16 the reference itself leaves 2-3% of scenarios more than
        # 1e-3 N outside the bounds (the plain branch, which matches the JAX
        # package's XLA path, printed below), so the share gate is the plain
        # branch's share on the same inputs less 0.01 instead of h=10's 0.99.
        plain = pipeline.solve_packed_batch(cfg, inputs, use_kernels=False, **kw)
        tight_plain = float((bound_violation(cfg, inputs, plain) <= 1e-3).float().mean())
        print(f"  plain branch: share of scenarios within 1e-3 N {tight_plain:.4f}")
        force_checks(cfg, inputs, forces, ms, tight_min=tight_plain - 0.01)
        # The two branches' arithmetic differs (mixed-precision NS and a bf16
        # iterate against plain fp32 NS), and at h=16 that alone moves more
        # than 2% of scenarios by > 0.5 N: the kernel branch with its kernels
        # replaced by their references, printed below, reaches only 93-96%.
        # The share gate is therefore the lower of 0.98 and that share on the
        # same inputs, less 0.01.
        with plain_kernels():
            ref_forces = pipeline.solve_packed_batch(cfg, inputs, use_kernels=True, **kw)
        ref_share = float(((ref_forces - plain).abs().amax(dim=(1, 2, 3)) <= 0.5)
                          .float().mean())
        near = float(((forces - ref_forces).abs().amax(dim=(1, 2, 3)) <= 0.5).float().mean())
        print(f"  kernel branch with the references in place: share within 0.5 N of the plain "
              f"branch {ref_share:.4f}; the kernels' share within 0.5 N of it {near:.4f}")
        share_min = min(0.98, ref_share - 0.01)
        plain_gate(forces, plain, share_min=share_min)
        check_segment(lane, segment_calls(cfg, inputs, **kw), results, "SEG/256")
        for label, extra in (("full", {}), ("no_polish", dict(polish_rounds=0)),
                             ("form_only", dict(form_only=True))):
            times[f"{lane}/{label}"] = median_ms(
                lambda: pipeline.solve_packed_batch(cfg, inputs, **kw, **extra), reps=3)
        ms_call = times[f"{lane}/full"]
        print(f"  {lane}: {ms_call:.2f} ms per call (median of 3), {B16 / ms_call * 1e3:.0f} "
              f"solves/s at batch {B16}; no_polish {times[f'{lane}/no_polish']:.2f} ms, "
              f"form_only {times[f'{lane}/form_only']:.2f} ms ({name_power})")
        if lane == "h16_full":
            full_forces, full_inputs, full_kw = forces, inputs, kw
            full_tight, full_plain, full_share_min = tight_plain - 0.01, plain, share_min
    admm._FUSED_BUILD = False
    try:
        reset_counts()
        two = pipeline.solve_packed_batch(cfg, full_inputs, **full_kw)
        torch.cuda.synchronize()
        c = counts()
        check(c == want(K1_256=1, K3_256=5, SEG_256=2),
              f"h16_full two-step build: launches {c}")
        results["K3/256"].update(launches=c["K3/256"], counted_in="h16_full two_step_build")
        force_checks(cfg, full_inputs, two, full_kw["max_stance"], tight_min=full_tight)
        # The two-step build is held to the fused build's gate against the
        # plain branch. The two builds differ by rounding only (ks built in
        # torch or in the kernel, refinement against ks or against hp + the
        # gram blocks), which at h=16 moves ~5% of scenarios by > 0.25 N, as
        # rounding moves the kernel branch against its own references: the
        # share between the builds is printed, not gated.
        plain_gate(two, full_plain, share_min=full_share_min)
        d2 = float((two - full_forces).abs().amax(dim=(1, 2, 3)).le(0.25).float().mean())
        print(f"  two-step vs fused build: share of scenarios within 0.25 N {d2:.4f}")
    finally:
        admm._FUSED_BUILD = True
    return times


def phase_fused_woodbury(cfg, dev, name_power, results):
    """The two new lanes end to end: h10_fused (K5 alone) and h10_woodbury
    (K6 for the Woodbury rounds)."""
    print(f"phase 4c: h10_fused (use_fused=True, batch {B_FUSED}) and h10_woodbury "
          f"(polish_woodbury=True, batch {BATCH})")
    times = {}
    inputs = pipeline.random_inputs(seed=0, batch=B_FUSED, h=H, device=dev)
    reset_counts()
    forces = pipeline.solve_packed_batch(cfg, inputs, use_fused=True)
    torch.cuda.synchronize()
    c = counts()
    print(f"  h10_fused launches in one solve: {c}")
    check(c == want(K5_128=1), "h10_fused: launches K5/128=1, else 0")
    results["K5/128"].update(launches=c["K5/128"], counted_in="h10_fused")
    plain = pipeline.solve_packed_batch(cfg, inputs, use_fused=True, use_kernels=False)
    tight_plain = float((bound_violation(cfg, inputs, plain) <= 1e-3).float().mean())
    print(f"  plain version: share of scenarios within 1e-3 N {tight_plain:.4f}")
    force_checks(cfg, inputs, forces, tight_min=min(0.99, tight_plain - 0.01))
    plain_gate(forces, plain)
    # The packed path at a fixed rho, with the JAX fused test's terms. The
    # reference arithmetic itself misses that test's step-0 share at this
    # batch (the plain version on the CPU at batch 256: 0.977 within 1 N), so
    # the step-0 share gate is the lower of 0.99 and the plain version's
    # share on the same inputs, less 0.01.
    cfg0 = default_config(**{"solver.rho_adapt": 0})
    packed = pipeline.solve_packed_batch(cfg0, inputs)

    def vs_packed(f):
        diff = (f - packed).abs()
        step0 = diff[:, 0].amax(dim=(1, 2))
        return (float(torch.quantile(diff.flatten(), 0.99)), float(diff.max()),
                float((step0 <= 1.0).float().mean()), float(step0.max()))

    q99, dmax, share0, max0 = vs_packed(forces)
    q99_p, dmax_p, share0_p, max0_p = vs_packed(plain)
    print(f"  vs the packed path at rho_adapt=0: q99 |d| {q99:.3e} N, max {dmax:.3e} N; step-0 "
          f"share within 1.0 N {share0:.4f}, step-0 max {max0:.3e} N (plain version: q99 "
          f"{q99_p:.3e}, max {dmax_p:.3e}, step-0 share {share0_p:.4f}, step-0 max {max0_p:.3e})")
    share0_min = min(0.99, share0_p - 0.01)
    check(q99 < 0.5 and share0 >= share0_min, f"h10_fused vs packed (rho_adapt=0): q99 < 0.5 N, "
          f">= {share0_min:.4f} of step-0 forces within 1 N")
    times["h10_fused"] = median_ms(lambda: pipeline.solve_packed_batch(cfg, inputs, use_fused=True),
                                   reps=3)
    print(f"  h10_fused: {times['h10_fused']:.2f} ms per call (median of 3), "
          f"{B_FUSED / times['h10_fused'] * 1e3:.0f} solves/s at batch {B_FUSED} ({name_power})")
    del inputs, forces, plain, packed

    wb = woodbury_config(cfg)
    inputs = pipeline.random_inputs(seed=0, batch=BATCH, h=H, device=dev)
    reset_counts()
    forces = pipeline.solve_packed_batch(wb, inputs)
    torch.cuda.synchronize()
    c = counts()
    print(f"  h10_woodbury launches in one solve: {c}")
    check(c == want(K1_128=1, K2_128=3, K6_128=2, SEG_128=2),
          "h10_woodbury: launches K1=1, K2=3, K6=2, SEG=2")
    results["K6/128"].update(launches=c["K6/128"], counted_in="h10_woodbury")
    check(bool(torch.isfinite(forces).all()), "h10_woodbury: forces finite")
    cold = pipeline.solve_packed_batch(cfg, inputs)
    guard = (forces - cold).abs().amax(dim=(1, 2, 3))
    print(f"  vs the default-config solve: median {float(guard.median()):.3e} N, max "
          f"{float(guard.max()):.3e} N, share within 0.5 N {float((guard <= 0.5).float().mean()):.4f}")
    check(float(guard.median()) < 1.0 and float(guard.max()) < 40.0,
          "h10_woodbury vs default config: median < 1 N, max < 40 N (the JAX test's guard)")
    # The Woodbury rounds amplify rounding (the JAX solve moves by up to
    # 13 N between its eager and jit runs on 8 scenarios): the kernels are
    # held to the share the same arithmetic reaches with the references in
    # place, both against the plain branch on the same inputs, less 0.02.
    plain = pipeline.solve_packed_batch(wb, inputs, use_kernels=False)
    with plain_kernels():
        ref_forces = pipeline.solve_packed_batch(wb, inputs, use_kernels=True)
    ref_share = float(((ref_forces - plain).abs().amax(dim=(1, 2, 3)) <= 0.5).float().mean())
    share = float(((forces - plain).abs().amax(dim=(1, 2, 3)) <= 0.5).float().mean())
    near = float(((forces - ref_forces).abs().amax(dim=(1, 2, 3)) <= 0.5).float().mean())
    print(f"  share of scenarios within 0.5 N of the plain branch: kernels {share:.4f}, "
          f"references in place {ref_share:.4f}; kernels within 0.5 N of the references "
          f"in place {near:.4f}")
    check(share >= ref_share - 0.02, "h10_woodbury: kernels' share vs the plain branch >= the "
          "references' share - 0.02")
    times["h10_woodbury"] = median_ms(lambda: pipeline.solve_packed_batch(wb, inputs), reps=3)
    print(f"  h10_woodbury: {times['h10_woodbury']:.2f} ms per call (median of 3), "
          f"{BATCH / times['h10_woodbury'] * 1e3:.0f} solves/s at batch {BATCH} ({name_power})")
    del inputs, forces, cold, plain, ref_forces

    # the same polish at the 256 tile, once: K2 there emits no ks, so every
    # factorization takes the two-step build (K3) and the rounds K6 at 256
    ms, pack, kind = LANES16["h16_full"]
    inputs = lane_inputs(1, B16, H16, kind, dev)
    kw = dict(max_stance=ms, pack=pack)
    reset_counts()
    forces = pipeline.solve_packed_batch(wb, inputs, **kw)
    torch.cuda.synchronize()
    c = counts()
    print(f"  h16_full with polish_woodbury, batch {B16}: launches in one solve: {c}")
    check(c == want(K1_256=1, K3_256=3, K6_256=2, SEG_256=2),
          "h16 Woodbury: launches K1=1, K3=3, K6=2, SEG=2 at the 256 tile")
    results["K6/256"].update(launches=c["K6/256"], counted_in="h16_full polish_woodbury")
    check(bool(torch.isfinite(forces).all()), "h16 Woodbury: forces finite")
    # At h=16 the Woodbury rounds cost the polish several N against the
    # default config (a first run: median 7.3 N, max 43.4 N over 2048
    # scenarios), beyond the JAX test's h=10 guard of 40 N. The kernels are
    # held to what the same arithmetic gives with the references in place;
    # phase 3c holds K6/256 itself on this lane's real operands.
    cold = pipeline.solve_packed_batch(cfg, inputs, **kw)
    with plain_kernels():
        ref_forces = pipeline.solve_packed_batch(wb, inputs, use_kernels=True, **kw)
    guard = (forces - cold).abs().amax(dim=(1, 2, 3))
    guard_r = (ref_forces - cold).abs().amax(dim=(1, 2, 3))
    print(f"  vs the default-config solve: median {float(guard.median()):.3e} N, max "
          f"{float(guard.max()):.3e} N (references in place: median "
          f"{float(guard_r.median()):.3e} N, max {float(guard_r.max()):.3e} N)")
    check(float(guard.median()) <= float(guard_r.median()) + 1.0,
          "h16 Woodbury: median distance to the default-config solve within 1 N of the "
          "references'")
    times["h16_woodbury"] = median_ms(lambda: pipeline.solve_packed_batch(wb, inputs, **kw),
                                      reps=3)
    print(f"  h16_full with polish_woodbury: {times['h16_woodbury']:.2f} ms per call (median of "
          f"3), {B16 / times['h16_woodbury'] * 1e3:.0f} solves/s at batch {B16} ({name_power})")
    return times


# the closed loop (phase 4e): `cli sweep --batch 4096 --gaits trot`'s first
# checkpoint chunk, 16 mode-1 stand macros then 25 trot sweep macros, h_sol 10
CL_BATCH, CL_STAND, CL_SWEEP, CL_H = 4096, 16, 25, 10


def closed_loop_compare(cfg, label, states, sims, cmds, terr, max_stance):
    """One MPC tick (`batch_rollout._mpc_tick_batched`) from the same state
    through the kernels and through their plain versions (use_kernels=False):
    K1/128 and K2/128 launched, and the share of scenarios whose fr_des is
    within 0.5 N of the plain branch. The gate is phase 4's 0.98, or, where
    the reference arithmetic itself falls short of it, the share of the plain
    branch against a second plain run whose rpy is scaled by (1 + 2^-23),
    less 0.02, measured here."""
    reset_counts()
    kern, _ = br._mpc_tick_batched(cfg, states, sims, cmds, terr, CL_H, None,
                                   max_stance=max_stance)
    torch.cuda.synchronize()
    c = counts()
    print(f"  {label}: launches in one MPC tick: {c}")
    check(c["K1/128"] == 1 and c["K2/128"] > 0 and c["SEG/128"] == 2
          and all(v == 0 for k, v in c.items() if k not in ("K1/128", "K2/128", "SEG/128")),
          f"{label}: the MPC tick launches K1/128 once, K2/128 ({c['K2/128']} times) and "
          "SEG/128 twice, nothing else")
    plain, _ = br._mpc_tick_batched(cfg, states, sims, cmds, terr, CL_H, None,
                                    max_stance=max_stance, use_kernels=False)
    st, ctx = ctrl.control_tick_batched(
        cfg, states, vmap(lambda s: engine.sensors_from_sim(cfg, s))(sims), cmds)
    se = ctx["se"]
    nudged = ctrl.mpc_update_batched(
        cfg, st, dict(ctx, se=se.replace(rpy=se.rpy * (1.0 + 2.0 ** -23))), h_sol=CL_H,
        iterations=cfg.solver.warm_iterations, max_stance=max_stance, use_kernels=False)
    fr_k, fr_p = kern.core.locomotion.fr_des, plain.core.locomotion.fr_des
    fr_n = nudged.core.locomotion.fr_des
    check(bool(torch.isfinite(fr_k).all()), f"{label}: fr_des finite")
    d_k = (fr_k - fr_p).abs().amax(dim=(1, 2))
    d_n = (fr_n - fr_p).abs().amax(dim=(1, 2))
    share = float((d_k <= 0.5).float().mean())
    ref_share = float((d_n <= 0.5).float().mean())
    gate = 0.98 if ref_share >= 0.98 else ref_share - 0.02
    print(f"  {label}: fr_des vs plain branch: share within 0.5 N {share:.4f} (max "
          f"{float(d_k.max()):.3e} N, median {float(d_k.median()):.3e} N); plain vs plain "
          f"with rpy x (1 + 2^-23): {ref_share:.4f} (max {float(d_n.max()):.3e} N); "
          f"gate {gate:.4f}")
    check(share >= gate, f"{label}: >= {gate:.4f} of scenarios' fr_des within 0.5 N of the "
          "plain branch")
    return dict(launches=c["K1/128"], k2_launches=c["K2/128"], share=share,
                reference_share=ref_share, gate=gate, max_abs_err=float(d_k.max()))


def phase_closed_loop(cfg, dev, name_power, results):
    """The closed loop through its entry point, `batch_rollout`, at the
    sweep users run (SWEEP_r05.json): batch 4096 on the plane, 16 mode-1
    stand macros (uncompressed, 4096 systems of n = 120), then 25 trot sweep
    macros (max_stance 2, pack 2: 2048 systems of n = 120), each MPC solve
    warm-started with warm_iterations. Kernel against plain from the same
    state at a stand tick and a warm sweep tick; launches per MPC tick;
    survival and safety; robot ticks/s, MPC and plain tick times, a profile
    of one macro."""
    print(f"phase 4e: the closed loop, batch_rollout at batch {CL_BATCH}: {CL_STAND} stand "
          f"macros (mode 1), then {CL_SWEEP} trot sweep macros (max_stance {MS}), h_sol {CL_H}")
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    terr = br.batch_terrains(CL_BATCH, gen, device=dev)
    states0, sims0 = br.batch_init(cfg, terr, CL_BATCH, device=dev)
    stand = Command(vel=torch.zeros((CL_BATCH, 3), device=dev),
                    gait_type=torch.full((CL_BATCH,), 9, dtype=torch.int32, device=dev),
                    robot_mode=torch.ones((CL_BATCH,), dtype=torch.int32, device=dev))
    sweep = br.sweep_commands(cfg, (0.0, 1.0), (-0.3, 0.3), (-0.5, 0.5), [9], CL_BATCH, gen,
                              device=dev)
    torch.cuda.synchronize()
    out = dict(batch=CL_BATCH, setup_s=time.perf_counter() - t0, card=name_power)

    # 1. the stand tick: warm-up and prologue (n_macro 0), then one MPC tick
    s, m, _ = br.batch_rollout(cfg, states0, sims0, stand, terr, 0, h_sol=CL_H)
    out["stand_tick"] = closed_loop_compare(cfg, "stand tick (uncompressed, cold triple)",
                                            s, m, stand, terr, None)

    # 2. the sweep, each path with the counts set to 0 just before it
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, m, _ = br.batch_rollout(cfg, states0, sims0, stand, terr, CL_STAND, h_sol=CL_H)
    torch.cuda.synchronize()
    t_stand = time.perf_counter() - t0
    c_stand = counts()
    reset_counts()
    t0 = time.perf_counter()
    s, m, recs = br.batch_rollout(cfg, s, m, sweep, terr, CL_SWEEP, h_sol=CL_H, cont=True,
                                  max_stance=MS)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    c_sweep = counts()
    for label, c, n in (("stand", c_stand, CL_STAND), ("sweep", c_sweep, CL_SWEEP)):
        print(f"  {label} ({n} MPC ticks): launches {c}; per MPC tick K1/128 "
              f"{c['K1/128'] / n:.2f}, K2/128 {c['K2/128'] / n:.2f}")
        check(c["K1/128"] == n and c["K2/128"] >= n and c["SEG/128"] == 2 * n
              and all(v == 0 for k, v in c.items() if k not in ("K1/128", "K2/128", "SEG/128")),
              f"{label}: K1/128 once per MPC tick, K2/128 at least once, SEG/128 twice, "
              "nothing else")
        out[f"{label}_launches"] = {k: c[k] for k in ("K1/128", "K2/128")}
    for k in ("K1/128", "K2/128"):
        results[k]["closed_loop"] = {
            "stand_per_mpc_tick": c_stand[k] / CL_STAND, "sweep_per_mpc_tick": c_sweep[k] / CL_SWEEP}
    survival = float((m.p[:, 2] > 0.12).float().mean())
    safety_rate = float(recs["safety"][-1].float().mean())
    fails = s.core.locomotion.mpc_fail_count
    fail_share = float(fails.sum()) / (CL_BATCH * (CL_STAND + CL_SWEEP))
    _, ctx = ctrl.control_tick_batched(
        cfg, s, vmap(lambda x: engine.sensors_from_sim(cfg, x))(m), sweep)
    _, outs = vmap(lambda st, c: ctrl.leg_commands(cfg, st, c))(s, ctx)
    print(f"  survival_rate {survival:.6f} (base z > 0.12), safety_rate {safety_rate:.6f}; "
          f"share of MPC solves that failed {fail_share:.6f} ({int(fails.sum())} of "
          f"{CL_BATCH * (CL_STAND + CL_SWEEP)})")
    check(survival >= 0.999 and safety_rate >= 0.999,
          "survival and safety rates >= 0.999 (at most 4 of 4096 scenarios fail)")
    check(fails.dtype == torch.int32 and int(fails.min()) >= 0
          and bool(torch.isfinite(s.core.locomotion.fr_des).all()),
          "mpc_fail_count counted, fr_des finite")
    check(bool(torch.isfinite(outs.tau).all()), "every torque of the tick after the sweep finite")

    # 1b. a warm sweep tick from the sweep's end (packed)
    out["sweep_tick"] = closed_loop_compare(cfg, "sweep tick (packed, warm triple)",
                                            s, m, sweep, terr, MS)
    for k in ("K1/128", "K2/128"):
        results[k]["closed_loop"]["max_abs_err"] = max(
            out["stand_tick"]["max_abs_err"], out["sweep_tick"]["max_abs_err"])

    # 3. times
    ticks = 13 * CL_SWEEP
    out.update(stand_s=t_stand, sweep_s=t_sweep, survival_rate=survival,
               safety_rate=safety_rate, mpc_fail_share=fail_share,
               robot_ticks_per_s_sweep=CL_BATCH * ticks / t_sweep,
               robot_ticks_per_s=CL_BATCH * 13 * (CL_STAND + CL_SWEEP) / (t_stand + t_sweep))
    out["mpc_tick_ms"] = event_ms(lambda: br._mpc_tick_batched(
        cfg, s, m, sweep, terr, CL_H, None, max_stance=MS), n=5)
    out["plain_tick_ms"] = event_ms(lambda: br._plain_tick(cfg, s, m, sweep, terr), n=10)
    print(f"  stand {t_stand:.2f} s, sweep {t_sweep:.2f} s: {out['robot_ticks_per_s_sweep']:.0f} "
          f"robot ticks/s over the sweep, {out['robot_ticks_per_s']:.0f} over stand + sweep "
          f"(host clock, synchronized); one MPC tick {out['mpc_tick_ms']:.2f} ms, one plain "
          f"tick {out['plain_tick_ms']:.2f} ms (CUDA events) ({name_power})")
    out["profile_macro"] = phase_profile(
        cfg, "closed_loop_sweep macro (one MPC tick + 12 plain ticks)", None,
        solve=lambda c, _: br.batch_rollout(c, s, m, sweep, terr, 1, h_sol=CL_H, cont=True,
                                            max_stance=MS),
        batch=CL_BATCH)
    return out


# the single-robot sessions (phase 4f): `cli sim --gait trot --vx 0.5` on the
# Mini-Cheetah's full model (h_max 16), the 200-tick stand, then trot; the
# articulated session, its 400-tick stand, then trot; and `cli sweep` at the
# batch its users run (phase 4g)
SIM_TICKS, SIM_CPU_TICKS, ART_TICKS, ART_STAND = 1000, 100, 800, 400
SWEEP_BATCH = 4096
TROT = (0.5, 0.0, 0.0)
LOOP_TICKS = 13                 # one MPC cadence


def run_cli(argv) -> tuple[int, dict, str]:
    """cli.main(argv), with what it prints echoed: (exit code, its last
    line as JSON, all it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    print("  " + text.rstrip().replace("\n", "\n  "))
    return rc, json.loads(text.strip().splitlines()[-1]), text


@contextlib.contextmanager
def kept_sessions():
    """A list that holds what each `rollout.run_session` call returns while
    the block runs (the CLI prints only its metrics)."""
    kept, original = [], rollout.run_session

    def keep(*args, **kwargs):
        kept.append(original(*args, **kwargs))
        return kept[-1]

    rollout.run_session = keep
    try:
        yield kept
    finally:
        rollout.run_session = original


def runtime_calls(fn) -> dict:
    """What fn() asks of the card, from torch.profiler's CUDA activity alone
    (host ops untraced: tracing them costs ~10x the run): kernel launches
    and host synchronizations among the CUDA runtime calls, counted as
    probes/loop_times.py counts them (the synchronize that closes the window
    is not counted), and the kernels' device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict(launches=0, syncs=-1, device_ms=0.0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out["device_ms"] += e.device_time_total / 1e3
        elif "LaunchKernel" in e.key:
            out["launches"] += e.count
        elif e.key.startswith("cu") and "Synchronize" in e.key:
            out["syncs"] += e.count
    return out


def loop_ticks(cfg, state, sim, cmd, sensors, step, n: int = LOOP_TICKS) -> dict:
    """n consecutive closed-loop ticks from (state, sim): ms a tick of
    `controller_step` and of the simulator (its sensors and its `step`) by
    CUDA events around each call; then the same n ticks under
    torch.profiler, and `controller_step` alone over them: launches and host
    syncs a tick (the simulator's are the difference), the device's busy ms
    a tick and its idle share over the tick's time by events."""
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n)]
    s, m = state, sim
    for e in ev:
        e[0].record()
        sens = sensors(m)
        e[1].record()
        s, out = ctrl.controller_step(cfg, s, sens, cmd)
        e[2].record()
        m = step(m, out)
        e[3].record()
    torch.cuda.synchronize()
    ctrl_ms = sum(e[1].elapsed_time(e[2]) for e in ev) / n
    sim_ms = sum(e[0].elapsed_time(e[1]) + e[2].elapsed_time(e[3]) for e in ev) / n

    def ticks(with_sim: bool):
        s, m = state, sim
        for _ in range(n):
            s, out = ctrl.controller_step(cfg, s, sensors(m), cmd)
            if with_sim:
                m = step(m, out)

    whole = runtime_calls(lambda: ticks(True))
    alone = runtime_calls(lambda: ticks(False))
    busy = whole["device_ms"] / n
    out = dict(ticks=n, controller_step_ms=ctrl_ms, sim_ms=sim_ms,
               launches=whole["launches"] / n, syncs=whole["syncs"] / n,
               controller_step_launches=alone["launches"] / n,
               controller_step_syncs=alone["syncs"] / n, device_busy_ms=busy,
               idle_share=1.0 - busy / (ctrl_ms + sim_ms))
    print(f"  {n} ticks from the session's end: controller_step {ctrl_ms:.2f} ms a tick, the "
          f"simulator {sim_ms:.2f} ms (CUDA events); a tick {out['launches']:.1f} kernel "
          f"launches and {out['syncs']:.2f} host syncs ({out['controller_step_launches']:.1f} "
          f"and {out['controller_step_syncs']:.2f} in controller_step); the device busy "
          f"{busy:.3f} ms a tick (torch.profiler), idle share {out['idle_share']:.4f}")
    return out


@contextlib.contextmanager
def nudged_filter():
    """`controller.init_state` with the Kalman filter's initial covariance
    scaled by (1 + 2^-23), one ulp, while the block runs."""
    original = ctrl.init_state

    def init_state(cfg, device=None):
        state = original(cfg, device=device)
        est = state.core.estimator
        est = est.replace(kf_P=est.kf_P * (1.0 + 2.0 ** -23))
        return state.replace(core=state.core.replace(estimator=est))

    ctrl.init_state = init_state
    try:
        yield
    finally:
        ctrl.init_state = original


def session_against_cpu(cfg, dev, traj, terrain, cmd) -> dict:
    """The session's first SIM_CPU_TICKS ticks on the card against the same
    ticks on the CPU: base position within 0.02 m (the gate of
    tests/test_torch_rollout.py) widened by what the card's own run moves
    when the filter's initial covariance (100 I) changes by one ulp. The
    first updates of that filter are a cancellation in float32 (in the JAX
    package too: ROADMAP queue 3), so the card's and the CPU's rounding
    part the two runs' estimates by centimetres from the warm-up on."""
    cpu = torch.device("cpu")
    n = SIM_CPU_TICKS
    _, _, ref = rollout.run_session(cfg, Terrain.plane(device=cpu), cmd.to(cpu), n_ticks=n,
                                    device=cpu)
    with nudged_filter():
        _, _, nudged = rollout.run_session(cfg, terrain, cmd, n_ticks=n, device=dev)
    gap = float((traj["p"][:n].cpu() - ref["p"]).abs().max())
    spread = float((traj["p"][:n] - nudged["p"]).abs().max())
    est_gap = float((traj["est_p"][:n].cpu() - ref["est_p"]).abs().max())
    check(gap <= 0.02 + spread,
          f"the first {n} ticks within 0.02 m + {spread:.3e} m (the card's own run with the "
          f"filter's initial covariance one ulp larger) of the CPU run: {gap:.3e} m (the "
          f"estimates {est_gap:.3e} m apart)")
    return dict(ticks=n, gap_m=gap, spread_m=spread, estimate_gap_m=est_gap)


def tick_against_cpu(cfg, state, sim, cmd) -> dict:
    """One tick without an MPC solve (control_tick, leg_commands, sim_step)
    from the same state on the card and on the CPU: torques within 1e-4 N m
    and the base position within 1e-6 m."""
    cpu = torch.device("cpu")
    outs = []
    for st, sm, c in ((state, sim, cmd), (state.to(cpu), sim.to(cpu), cmd.to(cpu))):
        st, ctx = ctrl.control_tick(cfg, st, engine.sensors_from_sim(cfg, sm), c)
        _, o = ctrl.leg_commands(cfg, st, ctx)
        outs.append((o.tau.cpu(), engine.sim_step(cfg, sm, o, Terrain.plane(device=sm.p.device)
                                                  ).p.cpu()))
    dtau = float((outs[0][0] - outs[1][0]).abs().max())
    dp = float((outs[0][1] - outs[1][1]).abs().max())
    check(dtau <= 1e-4 and dp <= 1e-6,
          f"one tick from the same state, card against CPU: tau within {dtau:.3e} N m (<= 1e-4), "
          f"base position within {dp:.3e} m (<= 1e-6)")
    return dict(tau_max_abs_err=dtau, p_max_abs_err=dp)


def phase_sessions(cfg, dev, name_power) -> dict:
    """Phase 4f: the single-robot sessions on the card, none of whose paths
    runs a kernel (as in the JAX package): `cli sim` against the trot gates
    of tests/test_closed_loop.py and its first ticks against the CPU, the
    articulated session against tests/test_articulated.py's gates, the
    depth camera at its last pose against the CPU, and the stage-wise MPC
    against the dense solve."""
    print(f"phase 4f: the single-robot sessions ({name_power})")
    dev_args = [] if dev == torch.device("cuda", 0) else ["--device", str(dev)]
    cpu = torch.device("cpu")
    out = {}

    # (a) cli sim, the counts set to 0 just before it
    reset_counts()
    with kept_sessions() as kept:
        rc, m, _ = run_cli(["sim", "--gait", "trot", "--vx", str(TROT[0]),
                            "--ticks", str(SIM_TICKS)] + dev_args)
    c = counts()
    check(all(v == 0 for v in c.values()),
          "cli sim launches no kernel (the JAX package's sim path runs no Pallas kernel)")
    state, sim, traj = kept[0]
    check(rc == 0 and traj["p"].device == dev, f"cli sim ran on {dev} and exited 0")
    tail = traj["p"][SIM_TICKS // 2:, 2]
    check(m["vx_err"] < 0.1 and 0.22 < m["height_mean"] < 0.30 and m["safety_ok"]
          and not m["fell"] and 0.22 < float(tail.min()) and float(tail.max()) < 0.30
          and all(bool(torch.isfinite(v.float()).all()) for v in traj.values()),
          f"cli sim meets the trot gates on its tail: vx_err {m['vx_err']:.4f} < 0.1, "
          f"height {float(tail.min()):.4f}..{float(tail.max()):.4f} in (0.22, 0.30), safety, "
          "finite")
    terrain = Terrain.plane(device=dev)
    cmd = Command.create(*TROT, gait_type=9, device=dev)
    out["sim_cpu"] = session_against_cpu(cfg, dev, traj, terrain, cmd)
    out["sim_tick_cpu"] = tick_against_cpu(cfg, state, sim, cmd)
    out["sim"] = dict(metrics=m, realtime_factor=m["realtime_factor"],
                      kernel_counts=c, **loop_ticks(
                          cfg, state, sim, cmd, lambda x: engine.sensors_from_sim(cfg, x),
                          lambda x, o: engine.sim_step(cfg, x, o, terrain)))

    # (b) the articulated session
    model = MiniCheetahModel(device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, sim, traj = articulated.run_articulated_session(
        cfg, terrain, cmd, n_ticks=ART_TICKS, stand_ticks=ART_STAND, model=model, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    check(all(v == 0 for v in c.values()), "the articulated session launches no kernel")
    p, v, tau = traj["p"], traj["v"], traj["tau"]
    height = float(p[-500:, 2].mean())
    check(0.22 < height < 0.30 and float(tau.abs().max()) < 30.0 and bool(traj["safety"][-1])
          and all(bool(torch.isfinite(x.float()).all()) for x in traj.values()),
          f"articulated session: height over the last 500 ticks {height:.4f} in (0.22, 0.30), "
          f"|tau| max {float(tau.abs().max()):.2f} < 30 N m, safety, finite")
    vx_800 = float(v[-800:, 0].mean())
    vx_tail = float(v[ART_TICKS // 2:, 0].mean())
    print(f"  vx (not gated: at {ART_TICKS} ticks the port's CPU run misses "
          f"tests/test_articulated.py's vx gate, whose last 800 ticks hold the stand): mean "
          f"over the last 800 ticks {vx_800:.4f}, over the trot {vx_tail:.4f}")
    rtf = ART_TICKS * cfg.dt / wall
    print(f"  {ART_TICKS} ticks in {wall:.2f} s: realtime factor {rtf:.4f} (host clock)")
    out["articulated"] = dict(height=height, tau_max=float(tau.abs().max()), vx_last_800=vx_800,
                              vx_trot=vx_tail, wall_s=wall, realtime_factor=rtf, kernel_counts=c,
                              **loop_ticks(
                                  cfg, state, sim, cmd,
                                  lambda x: articulated.sensors_from_articulated(cfg, x),
                                  lambda x, o: articulated.articulated_step(cfg, model, x, o.tau,
                                                                            terrain)))

    # (c) the depth camera at the articulated session's last pose, robot in frame
    pose = (sim.p, sim.quat)
    robot = (cfg.robot, sim.q.reshape(4, 3))
    depth, _, _, is_robot, _ = camera.render_depth(terrain, *pose, robot=robot)
    ref = camera.render_depth(Terrain.plane(device=cpu), *(x.cpu() for x in pose),
                              robot=(cfg.robot, robot[1].cpu()))
    same = float(((depth.cpu() - ref[0]).abs() <= 1e-5).float().mean())
    mask = float((is_robot.cpu() == ref[3]).float().mean())
    render_ms = event_ms(lambda: camera.render_depth(terrain, *pose, robot=robot), n=10)
    check(same >= 0.99 and mask >= 0.99,
          f"render_depth on the card against the CPU: share of pixels within 1e-5 m {same:.4f}, "
          f"robot mask {mask:.4f} (>= 0.99); {render_ms:.3f} ms a frame (CUDA events)")
    out["camera"] = dict(depth_share=same, mask_share=mask, ms=render_ms)

    # (d) the stage-wise MPC against the dense solve (tests/test_sparse_mpc.py)
    inp = pipeline.random_inputs(seed=7, batch=3, h=10, device=dev)
    worst = [0.0, 0.0]
    for b in range(3):
        one = tree_map(lambda t: t[b], inp)
        f_sparse = sparse.solve_sparse(cfg, one, weights=cfg.mpc.weights, mu=cfg.mpc.mu,
                                       iterations=250, polish_rounds=8)
        f_dense = pipeline.solve(cfg, one)
        d = (f_sparse[0] - f_dense[0]).abs()
        worst = [max(worst[0], float(d[:, 2].max())), max(worst[1], float(d.max()))]
    check(worst[0] <= 3.0 and worst[1] <= 12.0,
          f"solve_sparse against pipeline.solve, h=10, 3 scenarios: first-step fz within "
          f"{worst[0]:.3e} N (<= 3), forces within {worst[1]:.3e} N (<= 12)")
    out["sparse"] = dict(fz_max_abs_err=worst[0], max_abs_err=worst[1])
    return out


def phase_cli_sweep(cfg, dev, name_power, results) -> dict:
    """Phase 4g: `cli sweep` at batch 4096 through the port's CLI: one macro
    with a checkpoint, then --macros 2 resumed from it, against an
    uninterrupted --macros 2 run; launches per MPC tick of each run."""
    print(f"phase 4g: cli sweep --batch {SWEEP_BATCH} (trot on the plane, h_sol 10), "
          f"checkpointed and resumed ({name_power})")
    dev_args = [] if dev == torch.device("cuda", 0) else ["--device", str(dev)]
    base = ["sweep", "--batch", str(SWEEP_BATCH), "--gaits", "trot"] + dev_args
    out = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        resumed, full = f"{tmp}/resumed.npz", f"{tmp}/full.npz"
        runs = {"first": base + ["--macros", "1", "--checkpoint", resumed],
                "resumed": base + ["--macros", "2", "--checkpoint", resumed],
                "uninterrupted": base + ["--macros", "2", "--checkpoint", full]}
        for name, argv in runs.items():
            reset_counts()
            t0 = time.perf_counter()
            rc, m, text = run_cli(argv)
            c = counts()
            mpc_ticks = {"first": 17, "resumed": 1, "uninterrupted": 18}[name]
            check(rc == 0 and c["K1/128"] == mpc_ticks and c["K2/128"] >= mpc_ticks
                  and c["SEG/128"] == 2 * mpc_ticks
                  and all(v == 0 for k, v in c.items()
                          if k not in ("K1/128", "K2/128", "SEG/128")),
                  f"cli sweep ({name}): K1/128 once per MPC tick ({mpc_ticks}), K2/128 "
                  f"{c['K2/128']} times, SEG/128 twice a tick, nothing else")
            out[name] = dict(metrics=m, seconds=time.perf_counter() - t0,
                             k1_launches=c["K1/128"], k2_launches=c["K2/128"])
            if name == "resumed":
                check("resumed" in text and "at macro 1/2" in text,
                      "the second run resumed from the checkpoint at macro 1/2")
        a, b = out["resumed"]["metrics"], out["uninterrupted"]["metrics"]
        check(a["survival_rate"] == b["survival_rate"] and a["safety_rate"] == b["safety_rate"]
              and b["survival_rate"] >= 0.999 and b["safety_rate"] >= 0.999,
              f"resumed survival {a['survival_rate']:.6f} and safety {a['safety_rate']:.6f} "
              "equal the uninterrupted run's, both >= 0.999")
        with np.load(resumed) as ra, np.load(full) as fa:
            n = int(fa["n_leaves"])
            diffs = [np.abs(ra[f"leaf_{i}"].astype(np.float64)
                            - fa[f"leaf_{i}"].astype(np.float64)).max(initial=0.0)
                     for i in range(n)]
            # the payload's keys sort as done, sims, states, wall: the last
            # leaf is the wall clock, which differs from run to run
            equal = all(np.array_equal(ra[f"leaf_{i}"], fa[f"leaf_{i}"]) for i in range(n - 1))
        gap = max(diffs[:-1])
        print(f"  resumed against uninterrupted final state: largest difference {gap:.3e} over "
              f"{n - 1} leaves (the wall clock aside), bit-equal {equal}")
        out["final_state_max_abs_diff"], out["final_state_bit_equal"] = gap, equal
    for k in ("K1/128", "K2/128"):
        results[k]["cli_sweep"] = {"per_mpc_tick": out["uninterrupted"][
            "k1_launches" if k == "K1/128" else "k2_launches"] / 18}
    return out


# the routed solve (phase 4h): one batch of the benchmark cell's traffic,
# drawn as benchmark/run.py draws it
ROUTED_CELL, ROUTED_SEED = "h14_gait_mix_solve", 25_000_000_014
ROUTED_KEYS = ("K1/128", "K1/256", "K2/128", "K2/256", "SEG/128", "SEG/256")


def routed_want(widths) -> dict:
    """The launches of one routed solve whose groups have these widths (in
    variables): each group one K1, five K2 (the cold factorization, the
    adaptive-rho refactorization, three polish rounds) and two SEG, at its
    width's tile."""
    out = want()
    for n in widths:
        for k, launches in (("K1", 1), ("K2", 5), ("SEG", 2)):
            out[f"{k}/{NI.pad_sizes(n)}"] += launches
    return out


def phase_routed(dev, name_power, results) -> dict:
    """Phase 4h: solve_routed_batch on one batch of the h14_gait_mix_solve
    cell: launches by group, the forces under the cell's own check, and each
    group's own K1, K2 and SEG calls against their references."""
    from benchmark.harness import check as cell_check
    from benchmark.harness import spec

    cell = spec.load_cell(ROUTED_CELL)
    cfg = spec.program_config(cell.config)
    pool = cell.generator().make_pool(dict(cell.traffic, pool=1), int(cell.config["horizon"]),
                                      ROUTED_SEED, dev)
    inputs = pipeline.MPCInputs(**pool[0])
    b, h = inputs.gait_table.shape[:2]
    width = (-(-3 * inputs.gait_table.sum((1, 2)).long() // 12) * 12).tolist()
    sizes = {n: width.count(n) for n in sorted(set(width))}
    print(f"phase 4h: the routed solve, solve_routed_batch on one {ROUTED_CELL} batch ({b} "
          f"scenarios at h={h}; scenarios by variables {sizes})")
    check(list(sizes) == [72, 84, 120, 168], "the batch's groups: 72, 84, 120 and 168 variables")
    reset_counts()
    forces = pipeline.solve_routed_batch(cfg, inputs)
    torch.cuda.synchronize()
    c = counts()
    print(f"  launches in one solve: {c}")
    check(c == routed_want(sizes), "launches: one K1, five K2 and two SEG a group at its "
          "width's tile, else 0")
    for k in ROUTED_KEYS:
        results[k]["launches_routed"] = c[k]
    results["K2/192"]["launches_routed"] = "counted as K2/256"
    pairs = cell_check.sample(ROUTED_SEED, 1, b, int(cell.workload["check"]["scenarios"]))
    sample, f = cell_check.gather(pairs, [{k: getattr(inputs, k) for k in cell_check.FIELDS}],
                                  [forces], forces.device)
    numbers = cell_check.judge(cell.config["mpc"], sample, f)
    nonfinite = int((~torch.isfinite(forces)).flatten(1).any(1).sum())
    correct, _ = cell_check.verdict(numbers, cell.workload["check"]["limits"], nonfinite)
    print(f"  the cell's check: {numbers}; nonfinite {nonfinite}; correct {correct}")
    check(correct and nonfinite == 0, f"{ROUTED_CELL}: correct under the cell's limits")
    check(float(forces[inputs.gait_table < 0.5].abs().max()) == 0.0,
          "forces of every swing foot exactly 0")

    with recorded(FP, "form_packed") as k1, recorded(NI, "ns_inverse_scaled_build") as k2, \
            AS.recorded_calls() as seg:
        again = pipeline.solve_routed_batch(cfg, inputs)
    torch.cuda.synchronize()
    check(torch.equal(again, forces), "a second routed solve gives the same forces bit for bit")
    _, polish_sched = schedules(cfg)
    for n in sizes:
        tag, tile = f"h14 n={n}", NI.pad_sizes(n)
        (args, kw), = [call for call in k1 if call[0][1].shape[-1] == n]
        hk, gk = FP.form_packed(*args, **kw)
        hr, gr = FP.form_packed_reference(*args, **kw)
        torch.cuda.synchronize()
        print(f"  K1/{tile} {tag} (each scenario's slot list, {args[0].shape[0]} scenarios): "
              f"rel_H {rel(hk, hr):.3e} rel_g {rel(gk, gr):.3e} vs reference")
        check(rel(hk, hr) < 5e-5 and rel(gk, gr) < 1e-5, f"K1/{tile} {tag} vs reference")
        group = [as_operands(args) for args, _ in k2 if 3 * args[1].shape[-1] == n]
        check(len(group) == 5, f"{tag}: five K2 calls")
        # labelled apart from "solve call ...": held, neither timed nor kept
        cases = [(f"{tag} {label}", *rest) for label, *rest in
                 solve_cases(group, polish_sched, polish_gate=1.0)]
        check_ns(cases, results, tile, len(group[0][0]))
        check_segment(tag, [call for call in seg if call[1]["n"] == n], results, f"SEG/{tile}")
        del group, cases
    del k1, k2, seg
    ms_call = median_ms(lambda: pipeline.solve_routed_batch(cfg, inputs), reps=3)
    print(f"  routed: {ms_call:.2f} ms per call (median of 3), {b / ms_call * 1e3:.0f} solves/s "
          f"at batch {b} ({name_power})")
    return {"h14_gait_mix/routed": ms_call}


BENCH_REPS, BENCH_REPS16 = 48, 16   # bench.py's chained reps (h=10, h=16 lanes)
# bench.py's lanes: (the bench twin's JSON key that carries the lane, its
# launches per solve on the card)
BENCH_LANES = {"h10_full": ("value", dict(K1_128=1, K2_128=5, SEG_128=2)),
               "h10_nopolish": ("phases", dict(K1_128=1, K2_128=2, SEG_128=2)),
               "h10_form_fact": ("phases", dict(K1_128=1, K2_128=2, SEG_128=2)),
               "h10_form_only": ("phases", dict(K1_128=1)),
               "h10_two_step_build": ("two_step_build_solves_per_s",
                                      dict(K1_128=1, K3_128=5, SEG_128=2)),
               "h16_full": ("h16_solves_per_s", dict(K1_256=1, K2_256=5, SEG_256=2)),
               "h16_trot": ("h16_trot_solves_per_s", dict(K1_256=1, K2_256=5, SEG_256=2)),
               "h16_midband": ("h16_midband_solves_per_s",
                               dict(K1_256=1, K3_128=2, K2_256=3, SEG_256=2)),
               # the iterate timed apart: h10's two segments replayed
               "h10_iterate": ("phases", dict(SEG_128=2))}
# the one h10 solve (polish_rounds=0) whose segment calls h10_iterate records
BENCH_ITERATE_SOLVE = dict(K1_128=1, K2_128=2, SEG_128=2)
FFI_STAND, FFI_EQUAL = 300, 20          # phase 5e: stand ticks, ticks held bit-equal


def path_launches(results, path: str, c: dict):
    """Record one phase-5 path's launches by kernel in the kernels line."""
    for k, n in c.items():
        results[k].setdefault("launches_phase5", {})[path] = n


def phase_bench(cfg, dev, name_power, results, h10_ms: float) -> dict:
    """Phase 5a: `cli bench` at bench.py's sizes through the port's CLI: all
    eight lanes, no lane error, every phase within its bound, the launches
    each lane's chained reps make (a warm-up chain and three timed ones), and
    those of the iterate's timing apart."""
    print(f"phase 5a: cli bench (bench.py's lanes, sizes and reps; {name_power})")
    dev_args = [] if dev == torch.device("cuda", 0) else ["--device", str(dev)]
    reset_counts()
    t0 = time.perf_counter()
    rc, rep, _ = run_cli(["bench"] + dev_args)
    seconds = time.perf_counter() - t0
    c = counts()
    print(f"  launches: {c} ({seconds:.1f} s)")
    expect = {k: want(**BENCH_ITERATE_SOLVE)[k] for k in c}
    for lane, (_, per_solve) in BENCH_LANES.items():
        calls = 4 * (BENCH_REPS if lane.startswith("h10") else BENCH_REPS16)
        for k, n in per_solve.items():
            expect[k.replace("_", "/")] += calls * n
    check(c == expect, "the eight lanes' chained reps and the iterate's replayed segments "
                       "launched K1/K2/K3/SEG as routed, nothing else")
    path_launches(results, "bench", c)
    lanes_ok = all(rep[key] is not None for key, _ in BENCH_LANES.values())
    check(rc == 0 and lanes_ok and rep["lane_errors"] is None,
          "cli bench: all eight lanes measured, lane_errors null")
    pct = [p["attained_pct"] for p in rep["phases"]]
    check(all(p is not None and 0 < p <= 100 for p in pct),
          f"every phase within its bound: attained_pct {pct}")
    print(f"  h10: {rep['value']:.1f} solves/s (bench twin: CUDA events over 48 chained reps) "
          f"beside phase 4's {BATCH / h10_ms * 1e3:.1f} (host clock, median of 5 "
          f"synchronised calls); h16_full {rep['h16_solves_per_s']}, h16_trot "
          f"{rep['h16_trot_solves_per_s']}, h16_midband {rep['h16_midband_solves_per_s']} "
          f"solves/s ({name_power})")
    return dict(report=rep, seconds=seconds, launches=c,
                phase4_h10_solves_per_s=BATCH / h10_ms * 1e3)


def phase_latency(cfg, dev, name_power, results) -> dict:
    """Phase 5b: `cli latency` (bench_latency.py's measurements) through the
    port's CLI; the single-robot tick runs no kernel."""
    print(f"phase 5b: cli latency ({name_power})")
    dev_args = [] if dev == torch.device("cuda", 0) else ["--device", str(dev)]
    reset_counts()
    rc, rep, _ = run_cli(["latency"] + dev_args)
    c = counts()
    path_launches(results, "latency", c)
    check(rc == 0 and all(v == 0 for v in c.values()) and rep["host_roundtrip_p99_ms"] > 0
          and rep["device_per_tick_ms"] > 0 and rep["backend"] == dev.type,
          "cli latency: measured, no kernel on the single-robot tick (as in JAX)")
    return rep


def phase_kernels_smoke(cfg, dev, name_power, results) -> dict:
    """Phase 5c: `cli kernels-smoke --full`: every case at production
    batches on the card, 0 failed, each of K1-K6 launched."""
    print(f"phase 5c: cli kernels-smoke --full ({name_power})")
    dev_args = [] if dev == torch.device("cuda", 0) else ["--device", str(dev)]
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["kernels-smoke", "--full"] + dev_args)
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    print("  " + text.rstrip().replace("\n", "\n  "))
    c = counts()
    print(f"  launches: {c} ({seconds:.1f} s)")
    path_launches(results, "kernels_smoke", c)
    tail = text.strip().splitlines()[-1]
    check(rc == 0 and tail.endswith(" 0 failed") and "FAIL" not in text
          and "BAD-VALUES" not in text, f"kernels-smoke --full: {tail}")
    ran = ("K1/128", "K1/256", "K2/128", "K2/256", "K3/128", "K3/256", "K5/128", "K6/128",
           "K6/256", "SEG/128", "SEG/256")
    check(all(c[k] > 0 for k in ran) and all(c[k] == 0 for k in c if k not in ran),
          "kernels-smoke launched K1, K2, K3, K6 and SEG at both tiles, K4 (K3/128 inside) "
          "and K5; no K7, K8, K9")
    return dict(summary=tail, seconds=seconds, launches=c)


def phase_scaling(cfg, dev, name_power, results) -> dict:
    """Phase 5d: `cli scaling` on a one-rank NCCL group on the card, then
    sharded_mpc_solve at world size 1 held bit for bit to
    solve_packed_batch on the same inputs."""
    from quadruped_ctrl_tpu_torch.parallel import mesh as mesh_mod

    print(f"phase 5d: scale-out at world size 1 ({mesh_mod.backend_for(dev)} on {dev}; "
          f"{name_power})")
    dev_args = [] if dev == torch.device("cuda", 0) else ["--device", str(dev)]
    reset_counts()
    rc, rep, _ = run_cli(["scaling"] + dev_args)
    c = counts()
    path_launches(results, "scaling", c)
    check(rc == 0 and [r["devices"] for r in rep["rows"]] == [1]
          and rep["process_group_backend"] == mesh_mod.backend_for(dev)
          and rep["rows"][0]["solves_per_s"] > 0
          and c["K1/128"] > 0 and c["K2/128"] > 0,
          f"cli scaling: one row, {rep['rows'][0]['solves_per_s']} solves/s on a one-rank "
          f"{rep['process_group_backend']} group, K1/128 and K2/128 launched")
    inputs = pipeline.random_inputs(0, BATCH, H, device=dev)
    reset_counts()
    with mesh_mod.local_group(dev):
        mesh = mesh_mod.make_mesh(1, device=dev)
        forces, mean_abs = mesh_mod.sharded_mpc_solve(cfg, mesh, H)(
            mesh_mod.shard_batch(inputs, mesh))
        torch.cuda.synchronize()
    c = counts()
    path_launches(results, "sharded_solve", c)
    local = pipeline.solve_packed_batch(cfg, inputs)
    local_mean = local.abs().sum() / local.numel()
    gap = float((forces - local).abs().max())
    check(torch.equal(forces, local) and bool(mean_abs == local_mean)
          and c == want(K1_128=1, K2_128=5, SEG_128=2),
          f"sharded_mpc_solve at world size 1, batch {BATCH}: bit-equal to solve_packed_batch "
          f"(largest difference {gap:.3e}), reduced mean {float(mean_abs):.6f} equal to the "
          f"local one, launches K1/128=1, K2/128=5, SEG/128=2")
    return dict(report=rep, sharded_max_abs_diff=gap, mean_abs=float(mean_abs))


def tree_digest(path: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(path.iterdir())
            if p.is_file()}


def phase_native(cfg, dev, name_power, results) -> dict:
    """Phase 5e: NativeController on the card through the FFI
    (tests/test_native_runtime.py's closed loop): 10 pre_work ticks, 300
    stand ticks of the SRB sim, then 20 ticks held bit for bit to direct
    controller_step calls from the same state; native/ left unchanged."""
    from quadruped_ctrl_tpu_torch.core.types import ControllerOutput, Sensors
    from quadruped_ctrl_tpu_torch.runtime import native

    print(f"phase 5e: the native runtime's FFI on {dev} ({name_power})")
    native_dir = Path(native.__file__).resolve().parents[2] / "native"
    before = tree_digest(native_dir)
    reset_counts()
    nc = native.NativeController(cfg, mpc_iterations=20, device=dev)
    nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    nc.set_gait_type(4)
    terrain = Terrain.plane(device=dev)
    sim = engine.sim_init(cfg, terrain, device=dev)

    def arrays(sim):
        s = engine.sensors_from_sim(cfg, sim)
        return (torch.cat([s.accelerometer, s.quat, s.gyro]).cpu().numpy().astype(np.float64),
                torch.cat([s.q, s.qd]).cpu().numpy().astype(np.float64))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    imu, leg = arrays(sim)
    for _ in range(10):
        nc.pre_work(imu, leg)
    for _ in range(FFI_STAND):
        imu, leg = arrays(sim)
        tau = nc.torque_calculator(imu, leg)
        st = nc._state
        out = ControllerOutput(
            tau=f32(tau), p_foot_des=st.swing_p_cur, v_foot_des=st.swing_v_cur,
            fr_des=st.core.locomotion.fr_des, contact_state=torch.ones(4, device=dev),
            swing_state=torch.zeros(4, device=dev), p_body_des=torch.zeros(3, device=dev),
            v_body_des=torch.zeros(3, device=dev), estimate=None)
        sim = engine.sim_step(cfg, sim, out, terrain)
    z = float(sim.p[2])
    stats = nc.latency_summary()
    print(f"  latency summary (the library's histogram, us): {stats}")
    check(0.2 < z < 0.32 and stats["count"] >= FFI_STAND and stats["p50_us"] > 0,
          f"{FFI_STAND} stand ticks through the FFI: base height {z:.4f} in (0.2, 0.32)")
    # 20 ticks through the FFI against controller_step called directly
    state = nc._state
    cmd = Command(vel=f32([0.0, 0.0, 0.0]), gait_type=torch.tensor(4, dtype=torch.int32,
                                                                   device=dev),
                  robot_mode=torch.tensor(0, dtype=torch.int32, device=dev))
    equal = True
    for _ in range(FFI_EQUAL):
        imu, leg = arrays(sim)
        tau_ffi = nc.torque_calculator(imu, leg)
        sensors = Sensors(quat=f32(imu[3:7]), gyro=f32(imu[7:10]), accelerometer=f32(imu[0:3]),
                          q=f32(leg[:12]), qd=f32(leg[12:]))
        state, out = ctrl.controller_step(cfg, state, sensors, cmd, mpc_iterations=20)
        equal &= bool(np.array_equal(tau_ffi, out.tau.cpu().numpy().astype(np.float64)))
        sim = engine.sim_step(cfg, sim, out, terrain)
    c = counts()
    path_launches(results, "native_ffi", c)
    check(equal, f"{FFI_EQUAL} FFI ticks bit-equal to direct controller_step calls")
    check(all(v == 0 for v in c.values()), "the FFI's ticks launch no kernel (as in JAX)")
    unchanged = tree_digest(native_dir) == before
    git = subprocess.run(["git", "status", "--porcelain", "native/"], cwd=native_dir.parent,
                         capture_output=True, text=True)
    porcelain = git.stdout.strip() if git.returncode == 0 else "(no git repository here)"
    check(unchanged and (git.returncode != 0 or not porcelain),
          f"native/ unchanged (sha256 of each file; git status: {porcelain or 'clean'}); the "
          f"library built into {native.build().parent.name}/")
    return dict(stand_height=z, latency_us=stats, ffi_bit_equal=equal)


def phase_graft(cfg, dev, name_power, results) -> dict:
    """Phase 5f: graft_entry.entry()'s controller step once, and
    dryrun_multichip(1) on a one-rank NCCL group."""
    from quadruped_ctrl_tpu_torch import graft_entry

    print(f"phase 5f: the graft entry points on {dev} ({name_power})")
    fn, args = graft_entry.entry(device=dev)
    _, tau = fn(*args)
    check(tau.shape == (12,) and tau.device == dev and bool(torch.isfinite(tau).all()),
          "entry(): one controller step on the card, 12 finite torques")
    reset_counts()
    mean_tau = graft_entry.dryrun_multichip(1, device=dev)
    torch.cuda.synchronize()
    c = counts()
    path_launches(results, "graft_dryrun", c)
    check(math.isfinite(mean_tau) and c == want(K1_128=1, K2_128=5, SEG_128=2),
          f"dryrun_multichip(1): mean |tau| {mean_tau:.6f}, finite; launches K1/128=1, "
          "K2/128=5, SEG/128=2")
    return dict(mean_tau=mean_tau, launches=c)


def phase_profile(cfg, label, inputs, solve=pipeline.solve_packed_batch, batch=None,
                  **solve_kw) -> dict:
    """Device time by kernel and the device's idle share over one solve,
    from torch.profiler's CUDA activity (the profiler's own host overhead
    widens the span, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    batch = inputs.rpy.shape[0] if batch is None else batch
    print(f"phase 6: torch.profiler over one {label}{' solve' if inputs is not None else ''} "
          f"at batch {batch}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(cfg, inputs, **solve_kw)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("  no device activity traced: device time and idle share not measured")
        return {}
    by_name, busy = {}, 0.0
    cur_s, cur_e = spans[0][0], spans[0][1]
    for start, end, name in spans:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (end - start)
        if start > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {name}")
    out = dict(device_busy_ms=busy / 1e3, span_ms=span / 1e3, idle_share=1.0 - busy / span,
               launches=len(spans))
    print(f"  device busy {out['device_busy_ms']:.2f} ms of a {out['span_ms']:.2f} ms span "
          f"({len(spans)} device activities): idle share {out['idle_share']:.4f}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    name_power = smi.stdout.strip().splitlines()[0]
    print(name_power)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    print("phase 2: build")
    lib_path, seconds = _build.build()
    _build.load()
    print(f"  built {lib_path.name} in {seconds:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    check_tensor_core_sass(lib_path)

    cfg = default_config()
    results = {k: {"route": "cuda", "tile": int(k.split("/")[1]), **KERNEL_INFO[k]}
               for k in KERNEL_INFO}
    # the wrapper counts K2's launches by tile: K2/192's phase-5 launches are
    # among K2/256's
    results["K2/192"]["launches_phase5"] = "counted as K2/256"
    for key, (npad, mode) in REFINE_INSTANCES.items():
        units = ctypes.c_int(-1)
        rc = _build.load().qct_ns_refine_units(npad, mode, ctypes.byref(units))
        size = 1 if npad == NI.N else npad // 64
        what = "CTAs" if npad == NI.N else f"{size}-CTA clusters"
        check(rc == 0 and units.value > 0,
              f"{key} ({GMMA_KERNELS[key]}): {units.value} {what} active at once, each "
              "walking systems in turn")
        results[key].update(cluster=size, clusters_active=units.value)
    for key, inst in PLAIN_INSTANCES.items():
        size, active = ctypes.c_int(-1), ctypes.c_int(-1)
        rc = _build.load().qct_ns_plain_clusters(inst, ctypes.byref(size), ctypes.byref(active))
        check(rc == 0 and active.value > 0,
              f"{key} ({GMMA_KERNELS[key]}): clusters of {size.value} CTAs fit, "
              f"{active.value} active at once")
        results[key].update(cluster=size.value, clusters_active=active.value)
    t0 = time.perf_counter()
    phase_alignment(cfg, dev)
    phase_kernels(cfg, dev, results)
    phase_kernels16(cfg, dev, results)
    phase_kernels_fused(cfg, dev, results)
    t1 = time.perf_counter()
    phase_kernels_plain_warm(cfg, dev, results)
    t1d = time.perf_counter()
    times = phase_main_path(cfg, dev, name_power, results)
    times16 = phase_lanes16(cfg, dev, name_power, results)
    times.update(phase_fused_woodbury(cfg, dev, name_power, results))
    t2 = time.perf_counter()
    times.update(phase_scenario_path(cfg, dev, name_power))
    t2d = time.perf_counter()
    closed_loop = phase_closed_loop(cfg, dev, name_power, results)
    t2e = time.perf_counter()
    sessions = phase_sessions(cfg, dev, name_power)
    t2f = time.perf_counter()
    cli_sweep = phase_cli_sweep(cfg, dev, name_power, results)
    t2g = time.perf_counter()
    times.update(phase_routed(dev, name_power, results))
    t2h = time.perf_counter()
    entry_points = dict(bench=phase_bench(cfg, dev, name_power, results, times["full"]),
                        latency=phase_latency(cfg, dev, name_power, results),
                        kernels_smoke=phase_kernels_smoke(cfg, dev, name_power, results),
                        scaling=phase_scaling(cfg, dev, name_power, results),
                        native_ffi=phase_native(cfg, dev, name_power, results),
                        graft=phase_graft(cfg, dev, name_power, results))
    t5 = time.perf_counter()
    profile = phase_profile(cfg, "h10", pipeline.random_inputs(seed=0, batch=BATCH, h=H,
                                                               device=dev))
    profiles16 = {lane: phase_profile(cfg, lane, lane_inputs(1, B16, H16, kind, dev),
                                      max_stance=ms, pack=pack)
                  for lane, (ms, pack, kind) in LANES16.items()}
    profile_fused = phase_profile(cfg, "h10_fused", pipeline.random_inputs(
        seed=0, batch=B_FUSED, h=H, device=dev), use_fused=True)
    profile_wb = phase_profile(woodbury_config(cfg), "h10_woodbury", pipeline.random_inputs(
        seed=0, batch=BATCH, h=H, device=dev))
    ms16, pack16, kind16 = LANES16["h16_full"]
    profile_wb16 = phase_profile(woodbury_config(cfg), "h16_full with polish_woodbury",
                                 lane_inputs(1, B16, H16, kind16, dev), max_stance=ms16,
                                 pack=pack16)
    profile_scn = phase_profile(cfg, "scenario_full (solve_batch)", pipeline.random_inputs(
        seed=0, batch=B_SCN, h=H, device=dev), solve=pipeline.solve_batch)
    print(f"phase seconds: kernels {t1 - t0:.1f}, 3d {t1d - t1:.1f}, paths {t2 - t1d:.1f}, "
          f"4d {t2d - t2:.1f}, 4e {t2e - t2d:.1f}, 4f {t2f - t2e:.1f}, 4g {t2g - t2f:.1f}, "
          f"4h {t2h - t2g:.1f}, 5 {t5 - t2h:.1f}, profiles {time.perf_counter() - t5:.1f}")
    print(name_power)       # again, near the end: the output's head may be cut
    print(json.dumps({"phase_ms": times, "batch": BATCH, "phase_ms_h16": times16,
                      "batch_h16": B16, "batch_h10_fused": B_FUSED, "profile": profile,
                      **{f"profile_{lane}": p for lane, p in profiles16.items()},
                      "profile_h10_fused": profile_fused,
                      "profile_h10_woodbury": profile_wb,
                      "profile_h16_woodbury": profile_wb16, "batch_scenario": B_SCN,
                      "profile_scenario_full": profile_scn, "closed_loop": closed_loop,
                      "sessions": sessions, "cli_sweep": cli_sweep, "entry_points": entry_points,
                      "card": name_power}))
    kernels = [{key: results[k][key] for key in (
        "name", "route", "source", "replaces", "tile", "launches", "counted_in",
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        + (("guard_share", "k3_ms", "device_ms", "guard_ms", "cold_ms", "k3_device_ms",
            "library_device_ms", "all_warm_device_ms", "all_warm_library_device_ms",
            "all_warm_bound_ms") if k.startswith("K7") else ())
        + (("device_ms", "library_device_ms", "cluster", "clusters_active")
           if k.startswith(("K8", "K9")) else ())
        + (("device_ms", "library_device_ms") if k.startswith("K6") else ())
        + (("device_ms", "library_device_ms", "polish_device_ms", "polish_library_device_ms",
            "polish_bound_ms")
           if k.startswith(("K2", "K3")) else ())
        + (("cluster", "clusters_active")
           if k in ("K6/256", "K7/256", "K2/256", "K2/192", "K3/256") else ())
        + (("phases_ms",) if k.startswith("K5") else ())
        + (("device_ms", "plain_device_ms", "mma_count", "mma_full") if k.startswith("K1")
           else ())
        + (("device_ms", "plain_device_ms", "n", "fp32_rel", "lanes") if k.startswith("SEG")
           else ())
        + (("closed_loop", "cli_sweep") if k in ("K1/128", "K2/128") else ())
        + (("launches_routed",) if k in ROUTED_KEYS or k == "K2/192" else ())
        + ("launches_phase5",)}
        for k in KERNEL_INFO]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
