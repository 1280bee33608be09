"""Where a stage of the plain NS product (csrc/ns_plain.cu) spends its clocks,
on the card.

    python3 quadruped_ctrl_tpu_torch/probes/plain_phases.py [--iters N]

Copies csrc/ns_plain.cu into quadruped_ctrl_tpu_torch/_build/plain_phases/
with clock64() stamps put around the phases of plain_product's stage loop
(by text substitution: the library's source is not changed), builds it with
nvcc into a library of its own, runs K8 at both tiles (one SPD system of
n = 120 and 192, cond 1e3) and K9 at the 256 tile (2048 of them), and prints,
for thread 0 of CTA 0, the mean clocks a stage spends in each phase: its
warpgroup's barrier, the loads issued after it (B, and X's gathered row block at K8),
the wgmma issue (per wgmma too), the next stage's A fragments and B staging,
the wait for the wgmmas, and the fp32 adds. The stamps perturb what they
time; compare phases, not totals.
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
from quadruped_ctrl_tpu_torch.ops import _build  # noqa: E402

PHASES = ("barrier", "loads", "wgmma issue", "next A and B staged", "wait", "adds")
# (anchor in ns_plain.cu, text put before it)
STAMPS = (
    ("      wg_bar(wg);\n      if (s + S::kDepth < S::kStages)", "      long long c0 = clock64();\n"),
    ("      if (s + S::kDepth < S::kStages) load(", "      long long c1 = clock64();\n"),
    ("      issue(s);\n", "      long long c2 = clock64();\n"),
    ("      if (s + 1 < S::kStages) {\n        load_a(s + 1);",
     "      long long c3 = clock64();\n"),
    ("      wg_wait_all();\n", "      long long c4 = clock64();\n"),
)
RECORD = ("      long long c6 = clock64();\n"
          "      if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
          "        qct_clocks[0] += c1 - c0; qct_clocks[1] += c2 - c1; qct_clocks[2] += c3 - c2;\n"
          "        qct_clocks[3] += c4 - c3; qct_clocks[4] += c5 - c4; qct_clocks[5] += c6 - c5;\n"
          "        qct_clocks[6] += 1;\n"
          "      }\n")


def instrumented_source() -> str:
    src = (_build.CSRC / "ns_plain.cu").read_text()
    src = src.replace("namespace qct {\n", "__device__ unsigned long long qct_clocks[8];\n\n"
                      "namespace qct {\n", 1)
    for anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"plain_phases: anchor not found once in ns_plain.cu: {anchor!r}")
        src = src.replace(anchor, stamp + anchor)
    # c5 after the wait; c6 after the adds, at the end of the stage's body
    wait = "      wg_wait_all();\n"
    src = src.replace(wait, wait + "      long long c5 = clock64();\n", 1)
    tail = "          acc[i] += p[ru][i];\n        }\n"
    if src.count(tail) != 1:
        raise SystemExit("plain_phases: the stage's adds not found once in ns_plain.cu")
    src = src.replace(tail, tail + RECORD, 1)
    return src + ('\nextern "C" void qct_clocks_read(unsigned long long* out) {\n'
                  "  cudaMemcpyFromSymbol(out, qct_clocks, sizeof(qct_clocks));\n}\n"
                  'extern "C" void qct_clocks_reset() {\n'
                  "  unsigned long long zero[8] = {};\n"
                  "  cudaMemcpyToSymbol(qct_clocks, zero, sizeof(zero));\n}\n")


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "plain_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ns_plain.cu").write_text(instrumented_source())
    (out / "mma.cuh").write_text((_build.CSRC / "mma.cuh").read_text())
    lib_path = out / "libplain_phases.so"
    run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                          str(out / "ns_plain.cu")], capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"plain_phases: nvcc failed:\n{run.stdout[-4000:]}{run.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for name in ("qct_ns_inverse_plain_one", "qct_ns_inverse_plain_256"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("plain_phases: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    lib = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    # (label, npad, systems, n, wgmmas a stage: 3 passes x k-groups)
    for label, npad, b, n, wgmmas in (("K8/128", 128, 1, 120, 12), ("K8/256", 256, 1, 192, 12),
                                      ("K9/256", 256, 2048, 192, 6)):
        ks = CS.spd_batch(gen, b, n, npad, 1e3, dev).contiguous()
        inv = torch.empty_like(ks)
        for _ in range(2):  # the second run is the one read
            lib.qct_clocks_reset()
            if b == 1:
                rc = lib.qct_ns_inverse_plain_one(ptr(ks), ptr(inv), npad, args.iters, stream)
            else:
                rc = lib.qct_ns_inverse_plain_256(ptr(ks), ptr(inv), b, args.iters, stream)
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"plain_phases: {label} launch failed with cudaError {rc}")
        clocks = (ctypes.c_ulonglong * 8)()
        lib.qct_clocks_read(clocks)
        stages = clocks[6]
        mean = [clocks[i] / stages for i in range(6)]
        print(f"{label}: {stages} stages; " + ", ".join(
            f"{name} {m:.0f}" for name, m in zip(PHASES, mean))
            + f" (clocks a stage; {mean[2] / wgmmas:.0f} a wgmma issued); total {sum(mean):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
