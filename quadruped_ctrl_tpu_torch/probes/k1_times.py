"""Time the packed formation K1 of one checkout on the card, at the four
lanes' shapes, against its plain version.

    python3 quadruped_ctrl_tpu_torch/probes/k1_times.py [--root DIR] [--phases]

`--root` is the root of the checkout whose `quadruped_ctrl_tpu_torch` is
imported, built and timed (default: this one); run it on two checkouts in
one call, in turns (A, B, B, A), to compare two versions of the kernel on
one card. The timers and the inputs are this checkout's `chip_smoke.py`
(`median_ms`, `event_ms`, `lane_inputs`). For each shape (h10: batch 4096,
h=10, max_stance 2, pack 2; h16_full, h16_trot, h16_midband: batch 2048,
h=16, max_stance 4 / 2 / 3, pack 1 / 2 / 1, the midband on bench.py's
3-stance table) it prints rel_H and rel_g against form_packed_reference and
the times of the kernel and of the plain version: the host median of 10
synchronized calls of the wrapper, and the device time, CUDA events around
20 chained calls divided by 20 (of the wrapper, and of the library's C entry
point with the outputs allocated once, which leaves out the wrapper's
checks). With `--phases` it also times, on the device, copies of the kernel
with a part cut out (CUTS, built by nvcc beside the library) and
`hess.zero_()` on the same output, what writing H alone takes. The last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]
SHAPES = {"h10": (4096, 10, 2, 2, "trot"), "h16_full": (2048, 16, 4, 1, "trot"),
          "h16_trot": (2048, 16, 2, 2, "trot"), "h16_midband": (2048, 16, 3, 1, "midband")}


# The kernel with a part cut out, for --phases: (anchor in
# csrc/formation_pack.cu, its replacement). no_gram empties the k loop (H
# gets 2 alpha I); no_store keeps the Gram but stores a tile only if the sum
# of its accumulators is an impossible value (so no mma is dead code);
# build_only returns before the Gram (the loads, the zero blocks, bq and g).
CUTS = {
    "no_gram": ("int kc = kc0; kc < chunks;", "int kc = chunks; kc < chunks;"),
    "no_store": ("fp_store_tile(acc, st,",
                 "if ([&] { float z = 0.f; for (auto& a : acc) for (auto& b : a) for (float e : b) "
                 "z += e; return z == -1.2345e-30f; }()) fp_store_tile(acc, st,"),
    "build_only": ("  // The Gram's warp tiles", "  return;\n  // The Gram's warp tiles"),
}


def cut_libraries(build) -> dict:
    """{cut: ctypes library} of formation_pack.cu with each CUTS entry
    applied, compiled by nvcc in parallel into the build directory."""
    src = (build.CSRC / "formation_pack.cu").read_text()
    procs = {}
    for cut, (anchor, repl) in CUTS.items():
        if src.count(anchor) != 1:
            raise SystemExit(f"k1_times: the {cut} anchor is not in formation_pack.cu once")
        cu = build.BUILD_DIR / f"k1_{cut}.cu"
        cu.write_text(src.replace(anchor, repl))
        procs[cut] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared", "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for cut, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k1_times: nvcc failed for {cut}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(build.BUILD_DIR / f"k1_{cut}.so"))
        lib.qct_form_packed.argtypes, lib.qct_form_packed.restype = \
            build._SIGNATURES["qct_form_packed"]
        libs[cut] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE_ROOT))
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from quadruped_ctrl_tpu_torch import default_config
    from quadruped_ctrl_tpu_torch.mpc import formation
    from quadruped_ctrl_tpu_torch.ops import _build
    from quadruped_ctrl_tpu_torch.ops import formation_pack as FP

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE_ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        raise SystemExit("k1_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lib_path, seconds = _build.build()
    lib = _build.load()
    print(f"{args.root}: {FP.__file__}; built {lib_path.name} in {seconds:.1f} s; {card}")
    cfg = default_config()
    alpha = float(cfg.mpc.alpha)
    cuts = cut_libraries(_build) if args.phases else {}
    out = {"root": args.root, "card": card}
    for name, (b, h, ms, pack, kind) in SHAPES.items():
        inp = cs.lane_inputs(1, b, h, kind, dev)
        adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag,
                                          cfg.dt_mpc)
        x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                                cfg.mpc.gravity)
        _, _, sel = formation.stance_selectors(inp.gait_table, ms)
        ops = formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj,
                                           torch.ones((b, h), device=dev), sel)
        a = (*ops, h, ms, pack, alpha)
        hk, gk = FP.form_packed(*a)
        hr, gr = FP.form_packed_reference(*a)
        torch.cuda.synchronize()
        rel_h, rel_g = cs.rel(hk, hr), cs.rel(gk, gr)
        hess, grad = torch.empty_like(hk), torch.empty_like(gk)
        steps = FP.per_step_slots(h, ms, dev)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*ops[:2], steps)] + [0] + [
            ctypes.c_void_p(t.data_ptr()) for t in (*ops[2:], hess, grad)]
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        raw = lambda: lib.qct_form_packed(*ptrs, b, h, ms * h, pack, alpha, stream)  # noqa: E731
        row = dict(rel_H=rel_h, rel_g=rel_g,
                   kernel_host_ms=cs.median_ms(lambda: FP.form_packed(*a)),
                   kernel_device_ms=cs.event_ms(lambda: FP.form_packed(*a)),
                   kernel_raw_device_ms=cs.event_ms(raw),
                   plain_host_ms=cs.median_ms(lambda: FP.form_packed_reference(*a)),
                   plain_device_ms=cs.event_ms(lambda: FP.form_packed_reference(*a)))
        out[name] = row
        print(f"  {name} (batch {b}, h={h}, max_stance {ms}, pack {pack}): rel_H {rel_h:.3e} "
              f"rel_g {rel_g:.3e}; kernel host {row['kernel_host_ms']:.4f} ms, device "
              f"{row['kernel_device_ms']:.4f} ms (raw {row['kernel_raw_device_ms']:.4f}); plain "
              f"host {row['plain_host_ms']:.4f} ms, device {row['plain_device_ms']:.4f} ms")
        if cuts:
            row["zero_fill_ms"] = cs.event_ms(lambda: hess.zero_())
            for cut, cut_lib in cuts.items():
                row[f"{cut}_ms"] = cs.event_ms(
                    lambda: cut_lib.qct_form_packed(*ptrs, b, h, ms * h, pack, alpha, stream))
            print("    phases (device ms): " + ", ".join(
                f"{k[:-3]} {row[k]:.4f}" for k in ("zero_fill_ms", *(f"{c}_ms" for c in cuts))))
        del inp, ops, hk, gk, hr, gr, hess, grad
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
