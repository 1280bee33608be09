"""Where the NS step of csrc/ns_refine.cu spends its time, on the card: the
warm refinement K6, the scaled NS K3 at the 256 tile, or its fused build K2
at the 256 tile at both widths.

    python3 quadruped_ctrl_tpu_torch/probes/refine_phases.py [--systems B] [--kernel k6|k3|k2]

Copies csrc/ns_refine.cu into quadruped_ctrl_tpu_torch/_build/refine_phases/
in several variants (by text substitution: the library's source is not
changed), builds each with nvcc into a library of its own, all at once, and
runs K6 (one bf16x3 and one fp32 step) at both tiles on B SPD warm starts
(n = 120 and 192, cond 1e4; default 2048), or K3 at 256 (`--kernel k3`:
the ADMM schedule, 8 bf16x3 and one fp32 step, on B SPD n = 192 at cond
2.1e3), or K2 at 256 (`--kernel k2`: the same schedule and systems, g9
zero, so that K2 builds K3's ks; 64 blocks, which take the 3-CTA instance
over the tile's leading 192 rows and columns (`K2/192`), and 80, the 4-CTA
one over all 256 (`K2/256`)):

* `clocks`: clock64() stamps, read for thread 0 of CTA 0: the mean clocks a
  stage of each product type spends in its barrier, the B loads issued, the
  wgmma issue, the next ks copies with the next stage's A fragments and B
  staging, the wait, and the adds; a step's two products, its T epilogue and
  barrier, its last epilogue (X, or the result's store) and barrier; and a
  system's tail (at 256 the barrier that frees T, the next init's copy into
  it, its transpose into X, the barrier; K3: the cold start, its barriers).
  The stamps perturb what they time: compare phases, not totals.
* device ms by CUDA events over 20 chained launches of the unchanged kernel
  (`full`) and of copies with one piece cut, each result wrong:
  `no_copies` (no cp.async of ks and init, no store of the result; the
  transpose of init stays),
  `no_b_loads` (B's loads replaced by zeros: no DSMEM at 256),
  `no_staging` (B's loads waited for, but not split or stored),
  `two_peers` (at 256 the rows of one of the three peers not loaded: the
  remote bytes of a product 128 KB in place of 192 KB, as a 2 x 2 quadrant
  split of K, X and T would move for B and A together); and one
  alternative that is right: `own_local` (at 256 the CTA's own rows of B
  read from its own shared memory, not over DSMEM).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from quadruped_ctrl_tpu_torch import default_config  # noqa: E402
from quadruped_ctrl_tpu_torch.ops import _build  # noqa: E402
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI  # noqa: E402

STAGE_PHASES = ("barrier", "B loads", "wgmma issue", "copies, next A and B staged", "wait",
                "adds")
STEP_PHASES = ("product 1", "T and barrier", "product 2", "X or store, and barrier")
# stamps in a stage: (anchor, text put before it)
STAGE_STAMPS = (
    ("      group_bar();  // stage s's slot", "      long long c0 = clock64();\n"),
    ("      if (s + P::kDepth < P::kStages) load(", "      long long c1 = clock64();\n"),
    ("      issue(s, (d & 1) == 0);\n", "      long long c2 = clock64();\n"),
    ("      if (next_k != nullptr) {\n        for (int c = S::kCopies * s",
     "      long long c3 = clock64();\n"),
    ("      wg_wait_all();\n#pragma unroll\n      for (int kg = 0; kg < P::kKG; ++kg)",
     "      long long c4 = clock64();\n"),
)
STAGE_END = ("          for (int i = 0; i < S::kAcc; ++i) acc[i] += p[i];\n        }\n      }\n")
STAGE_RECORD = (
    "      long long c6 = clock64();\n"
    "      if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
    "        unsigned long long* k = qct_clocks + (kBf16 ? 0 : 8);\n"
    "        k[0] += c1 - c0; k[1] += c2 - c1; k[2] += c3 - c2;\n"
    "        k[3] += c4 - c3; k[4] += c5 - c4; k[5] += c6 - c5; k[6] += 1;\n"
    "      }\n")
# (the first product is rf_step's, the second rf_finish's: the first two
# stamps cross over in qct_clocks[38], [39])
STEP_STAMPS = (
    ("  rf_product<kN, kBf16, true>(K, X, ring, acc, q, nullptr, nullptr);\n",
     "  long long u0 = clock64();\n",
     "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
     "    qct_clocks[38] = u0; qct_clocks[39] = clock64();\n  }\n"),
    ("  rf_sync<kN>();  // T complete", "", ""),
    ("  rf_product<kN, kBf16, false>(X, T, ring, acc, q, next_k, K);\n",
     "  long long u2 = clock64();\n", ""),
    ("  __syncthreads();  // this CTA's reads of X are done\n", "",
     "  long long u3 = clock64();\n"),
)
STEP_RECORD = (
    "  if (threadIdx.x == 0 && blockIdx.x == 0) {{\n"
    "    long long u4 = clock64(), u0 = qct_clocks[38], u1 = qct_clocks[39];\n"
    "    unsigned long long* k = qct_clocks + (kBf16 ? 16 : 24);\n"
    "    k[0] += u1 - u0; k[1] += u2 - u1; k[2] += u3 - u2; k[3] += u4 - u3; k[4] += 1;\n"
    "  }}\n")
CUTS = {
    "no_copies": (("  cp_async16(tile + (kKsw ? ksw<kN>(r, c) : r * kN + c), "
                   "src + r * RefineShape<kN>::kLd + c);",
                   "  (void)src; (void)r; (void)c;"),
                  ("      *reinterpret_cast<float2*>(out + (S::kRows * q + r) * S::kLd + c) =\n"
                   "          make_float2(mu * acc[i], mu * acc[i + 1]);",
                   "      (void)r; (void)c;")),
    "no_b_loads": (("        v[l] = *reinterpret_cast<const float4*>(b_tile + src(s, l));",
                    "        v[l] = make_float4(0.f, 0.f, 0.f, 0.f);"),
                   ("        v[l] = ld_cluster(map_rank(b_own, owner) + 4 * src(s, l));",
                    "        v[l] = make_float4(0.f, 0.f, 0.f, 0.f);")),
    "no_staging": (("    float* slot = ring + (s & 1) * S::kSlot;\n",
                    "    if (v[0].x != 12345.f) return;\n    float* slot = ring + (s & 1) * "
                    "S::kSlot;\n"),),
    "two_peers": (("        v[l] = ld_cluster(map_rank(b_own, owner) + 4 * src(s, l));",
                   "        v[l] = owner == (q + 2) % S::kCtas ? make_float4(0.f, 0.f, 0.f, 0.f)\n"
                   "                                      : ld_cluster(map_rank(b_own, owner) + "
                   "4 * src(s, l));"),),
    "own_local": (("#pragma unroll\n    for (int l = 0; l < P::kLoads; ++l) {\n"
                   "      if constexpr (S::kCtas == 1) {",
                   "#pragma unroll\n    for (int l = 0; l < P::kLoads; ++l) {\n"
                   "      if (S::kCtas == 1 || owner == q) {"),),
}


def replace_once(src: str, anchor: str, new: str) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"refine_phases: anchor not found once in ns_refine.cu: {anchor!r}")
    return src.replace(anchor, new)


def clocked_source(src: str) -> str:
    src = src.replace("namespace qct {\n", "__device__ unsigned long long qct_clocks[40];\n\n"
                      "namespace qct {\n", 1)
    for anchor, stamp in STAGE_STAMPS:
        src = replace_once(src, anchor, stamp + anchor)
    wait = "      wg_wait_all();\n#pragma unroll\n      for (int kg = 0; kg < P::kKG; ++kg)"
    src = src.replace(wait, wait.replace("wg_wait_all();\n", "wg_wait_all();\n"
                                         "      long long c5 = clock64();\n"), 1)
    src = replace_once(src, STAGE_END, STAGE_END + STAGE_RECORD)
    for anchor, before, after in STEP_STAMPS:
        src = replace_once(src, anchor, before + anchor + after)
    record = STEP_RECORD.format()
    x_store = ("    return;\n  }\n#pragma unroll\n  for (int i = 0; i < S::kAcc; ++i) {\n"
               "    int r, c;\n    rf_place<kN>(i, r, c);\n    X[")
    src = replace_once(src, x_store, record + x_store)
    src = replace_once(src, "  rf_sync<kN>();  // X complete in every CTA; every read of T done\n",
                       "  rf_sync<kN>();  // X complete in every CTA; every read of T done\n"
                       + record)
    tail0 = "    if (next < b) {\n      if constexpr (kCold) {"
    src = replace_once(src, tail0, "    long long v0 = clock64();\n" + tail0)
    tail1 = "    rf_sync<kN>();  // the next K and X complete in every CTA\n"
    src = replace_once(src, tail1, tail1 + "    if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
                       "      qct_clocks[32] += clock64() - v0; qct_clocks[33] += 1;\n    }\n")
    return src + ('\nextern "C" void qct_clocks_read(unsigned long long* out) {\n'
                  "  cudaMemcpyFromSymbol(out, qct_clocks, sizeof(qct_clocks));\n}\n"
                  'extern "C" void qct_clocks_reset() {\n'
                  "  unsigned long long zero[40] = {};\n"
                  "  cudaMemcpyToSymbol(qct_clocks, zero, sizeof(zero));\n}\n")


def variants() -> dict:
    src = (_build.CSRC / "ns_refine.cu").read_text()
    out = {"full": src, "clocks": clocked_source(src)}
    for name, reps in CUTS.items():
        cut = src
        for anchor, new in reps:
            cut = replace_once(cut, anchor, new)
        out[name] = cut
    return out


def build() -> dict:
    """Every variant built at once: {name: its library}; a variant nvcc
    fails on is reported and left out."""
    root = _build.BUILD_DIR / "refine_phases"
    procs = {}
    for name, src in variants().items():
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "ns_refine.cu").write_text(src)
        for other in ("mma.cuh", "ns_core.cuh", "ns_inverse.cu"):
            (out / other).write_text((_build.CSRC / other).read_text())
        # ns_refine.cu's K7/128 entry point calls ns_inverse.cu's masked K3
        procs[name] = (out / "lib.so", subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"),
             *(str(out / f) for f in ("ns_refine.cu", "ns_inverse.cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            if name in ("full", "clocks"):
                raise SystemExit(f"refine_phases: nvcc failed for {name}:\n{log[-4000:]}")
            print(f"refine_phases: nvcc failed for {name}, left out:\n{log[-2000:]}")
            continue
        lib = ctypes.CDLL(str(path))
        for entry, (argtypes, restype) in _build._SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = list(argtypes)
                getattr(lib, entry).restype = restype
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--systems", type=int, default=2048)
    parser.add_argument("--kernel", choices=("k6", "k3", "k2"), default="k6")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("refine_phases: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    b = args.systems
    admm = CS.schedules(default_config())[0]
    cases = {"k6": ((128, 120), (256, 192)), "k3": ((256, 192),), "k2": ((192, 64), (256, 80))}
    for npad, n in cases[args.kernel]:
        if args.kernel == "k6":
            ks, init, _ = CS.spd_warm(gen, b, n, npad, dev)
        else:
            ks = CS.spd_batch(gen, b, 192, NI.N_BIG, 2.1e3, dev)
        inv = torch.empty_like(ks)
        g9 = torch.zeros((b, 9, n), device=dev)  # K2: n blocks
        d_row = torch.empty((b, 1, NI.N_BIG), device=dev)

        def run(lib):
            if args.kernel == "k3":
                rc = lib.qct_ns_inverse_scaled_256(ptr(ks), ptr(inv), b,
                                                   NI._mus_arg(*admm[:2]), *admm[1:], stream)
            elif args.kernel == "k2":
                rc = lib.qct_ns_inverse_scaled_build_256(ptr(ks), ptr(g9), n, ptr(inv),
                                                         ptr(d_row), b, NI._mus_arg(*admm[:2]),
                                                         *admm[1:], stream)
            else:
                entry = (lib.qct_ns_inverse_refine if npad == 128
                         else lib.qct_ns_inverse_refine_256)
                rc = entry(ptr(ks), ptr(init), ptr(inv), b, 1, 1, stream)
            if rc:
                raise SystemExit(f"refine_phases: {args.kernel}/{npad} launch failed with "
                                 f"cudaError {rc}")

        times = {name: CS.event_ms(lambda: run(lib)) for name, lib in libs.items()
                 if name != "clocks"}
        print(f"{args.kernel.upper()}/{npad} at {b} systems, device ms (events, 20 launches): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items()))
        lib = libs["clocks"]
        lib.qct_clocks_reset()
        run(lib)
        torch.cuda.synchronize()
        clocks = (ctypes.c_ulonglong * 40)()
        lib.qct_clocks_read(clocks)
        for kind, base, sbase in (("bf16x3", 0, 16), ("3xTF32", 8, 24)):
            stages = max(clocks[base + 6], 1)
            mean = [clocks[base + i] / stages for i in range(6)]
            steps = max(clocks[sbase + 4], 1)
            smean = [clocks[sbase + i] / steps for i in range(4)]
            print(f"  {kind}: {stages} stages, clocks a stage: " + ", ".join(
                f"{p} {m:.0f}" for p, m in zip(STAGE_PHASES, mean)) + f" (total {sum(mean):.0f});"
                f" a step ({steps}): " + ", ".join(f"{p} {m:.0f}" for p, m in
                                                      zip(STEP_PHASES, smean)))
        tails = max(clocks[33], 1)
        print(f"  a system's tail (the next system's start: init copied and transposed, or the "
              f"cold start; barriers): {clocks[32] / tails:.0f} clocks ({tails} systems on CTA 0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
