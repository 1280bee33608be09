"""Time the guarded warm NS K7 at both tiles, the plain NS K9 at the 128
tile and the scaled NS K2 and K3 at the 256 tile of one checkout on the
card, beside torch.linalg.inv_ex, and check them against their references.

    python3 quadruped_ctrl_tpu_torch/probes/warm_times.py [--root DIR] [--label NAME]

`--root` is the root of the checkout whose `quadruped_ctrl_tpu_torch` and
`chip_smoke.py` helpers are imported, built and timed (default: this one);
run it on two checkouts in one call, in turns (A, B, B, A), to compare them
on one card. Device times are CUDA events around chained calls divided by
their count (chip_smoke.event_ms). Cases, each at 2048 systems:

- K9/128 on the per-scenario path's ADMM-phase K (h=10, n=120), through
  `ns_inverse_blocked`: max |I - K X| against the reference's;
- K7 on the real warm pairs' first pair (the ADMM refactorization of the
  h=10 solve at 128, of h16_full at 256; chip_smoke.warm_pairs), through
  `_batched_solver(prev_inv=...)`'s own call of `ns_inverse_warm`: the guard
  share (the reference's r0), whether the tripped systems equal K3's result
  bit for bit, and where the library has them (`qct_ns_warm_guarded`,
  `qct_ns_inverse_scaled_masked[_256]`), the time of each of K7's two
  launches;
- K7 on `spd_warm` starts (cond 1e4, n = 120 / 192; every system warm): the
  largest row sum of |I - K X| against the reference's; K6
  (`ns_inverse_refine`, one bf16x3 and one fp32 step) on the same starts;
- K2 (`ns_inverse_scaled_build`) and K3 (`ns_inverse_scaled`) at the 256
  tile at both schedules: on SPD n = 192 (cond 2.1e3 on the ADMM schedule,
  1e4 on the polish one; g9 zero, so K2 builds K3's ks) and on a real
  h16_full solve's K2 calls 0 (ADMM) and 2 (polish; chip_smoke
  .solve_operands), K3 on the ks K2 builds: residual (max |I - ks X| on the
  ADMM schedule, the largest row sum on the polish one) against the
  reference's.

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs
    from quadruped_ctrl_tpu_torch import default_config
    from quadruped_ctrl_tpu_torch.mpc import pipeline
    from quadruped_ctrl_tpu_torch.ops import _build
    from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
    from quadruped_ctrl_tpu_torch.solver import admm

    if not torch.cuda.is_available():
        raise SystemExit("warm_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lib = _build.load()
    print(f"{args.label}: {cs.__file__}; {card}")
    cfg = default_config()
    out = {"label": args.label, "card": card}

    ks = NI.pad_to(cs.scenario_admm_ks(cfg, pipeline.random_inputs(
        seed=0, batch=cs.N_SYS, h=cs.H, device=dev)), 120, NI.N).contiguous()
    iters = cfg.solver.ns_iters
    inv = NI.ns_inverse_blocked(ks, iters)
    res = [cs.residuals(ks, inv)[0], cs.residuals(ks, NI.ns_inverse_blocked_reference(ks, iters))[0]]
    out["K9/128"] = dict(residual=res[0], reference=res[1],
                         device_ms=cs.event_ms(lambda: NI.ns_inverse_blocked(ks, iters), 5),
                         inv_ex_ms=cs.event_ms(lambda: torch.linalg.inv_ex(ks), 5))
    print(f"  K9/128: {out['K9/128']}")
    del ks, inv

    ms16, pack16, kind16 = cs.LANES16["h16_full"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for npad, inputs, kw, n_log in (
            (NI.N, pipeline.random_inputs(seed=2, batch=cs.BATCH, h=cs.H, device=dev), {}, 120),
            (NI.N_BIG, cs.lane_inputs(2, cs.B16, cs.H16, kind16, dev),
             dict(max_stance=ms16, pack=pack16), 192)):
        _, k1, s1, k2, s2 = cs.warm_pairs(cfg, inputs, **kw)[0]
        first = admm._batched_solver(k1, cfg.solver, True, schedule=s1)
        seen, real = [], NI.ns_inverse_warm
        NI.ns_inverse_warm = lambda *a, **k: seen.append((a, k)) or real(*a, **k)
        try:
            admm._batched_solver(k2, cfg.solver, True, schedule=s2, prev_inv=first.inv_padded,
                                 prev_scale=first.scale)
        finally:
            NI.ns_inverse_warm = real
        (ksp, init, *sargs), skw = seen[0]
        r0 = cs.guard_r0(ksp, init)
        tripped = r0 >= skw["guard"]
        got = NI.ns_inverse_warm(ksp, init, *sargs, **skw)
        cold = NI.ns_inverse_scaled(ksp, *sargs)
        pair = dict(systems=ksp.shape[0], guard_share=float((~tripped).float().mean()),
                    tripped_are_k3=bool(torch.equal(got[tripped], cold[tripped])),
                    device_ms=cs.event_ms(lambda: NI.ns_inverse_warm(ksp, init, *sargs, **skw), 5),
                    k3_ms=cs.event_ms(lambda: NI.ns_inverse_scaled(ksp, *sargs), 5),
                    inv_ex_ms=cs.event_ms(lambda: torch.linalg.inv_ex(ksp), 5))
        if hasattr(lib, "qct_ns_warm_guarded"):
            b = ksp.shape[0]
            flags = torch.empty(b, dtype=torch.int32, device=dev)
            inv = torch.empty_like(ksp)
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            P = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
            masked = (lib.qct_ns_inverse_scaled_masked if npad == NI.N
                      else lib.qct_ns_inverse_scaled_masked_256)
            guarded = lambda: lib.qct_ns_warm_guarded(  # noqa: E731
                P(ksp), P(init), P(inv), P(flags), b, skw["n_wquad"], skw["n_whi"],
                skw["guard"], npad, stream)
            pair["guard_pass_ms"] = cs.event_ms(guarded, 5)
            pair["flags_match_reference"] = bool(torch.equal(flags.bool(), tripped))
            pair["cold_launch_ms"] = cs.event_ms(lambda: masked(
                P(ksp), P(inv), P(flags), b, NI._mus_arg(*sargs[:2]), *sargs[1:], stream), 5)
        out[f"K7/{npad} ADMM pair"] = pair
        print(f"  K7/{npad} ADMM pair: {pair}")
        del ksp, init, got, cold, first, k1, k2

        ks, init, r0w = cs.spd_warm(gen, cs.B16, n_log, npad, dev)
        got = NI.ns_inverse_warm(ks, init, **skw)
        ref = NI.ns_inverse_warm_reference(ks, init, **skw)
        warm = dict(r0=r0w, guard_share=float((cs.guard_r0(ks, init) < skw["guard"]).float().mean()),
                    residual=cs.residuals(ks, got)[1], reference=cs.residuals(ks, ref)[1],
                    device_ms=cs.event_ms(lambda: NI.ns_inverse_warm(ks, init, **skw), 5),
                    inv_ex_ms=cs.event_ms(lambda: torch.linalg.inv_ex(ks), 5),
                    k6_residual=cs.residuals(ks, NI.ns_inverse_refine(ks, init, 1, 1))[1],
                    k6_ms=cs.event_ms(lambda: NI.ns_inverse_refine(ks, init, 1, 1), 5))
        out[f"K7/{npad} all warm"] = warm
        print(f"  K7/{npad} all warm: {warm}")
        del ks, init, got, ref

    admm_s, polish_s = cs.schedules(cfg)
    gen.manual_seed(16)
    calls = cs.solve_operands(cfg, cs.lane_inputs(2, cs.B16, cs.H16, kind16, dev),
                              max_stance=ms16, pack=pack16)
    for label, sched, cond, call in (("ADMM", admm_s, 2.1e3, 0), ("polish", polish_s, 1e4, 2)):
        metric = 0 if sched == admm_s else 1
        spd = cs.spd_batch(gen, cs.B16, 192, NI.N_BIG, cond, dev)
        for case, (hp, g9) in ((f"SPD n=192 cond {cond:g}", (spd, torch.zeros(
                (cs.B16, 9, 64), device=dev))), (f"h16_full call {call}", calls[call][:2])):
            inv, _, d = NI.ns_inverse_scaled_build(hp, g9, *sched)
            ks = NI._build_k(hp, g9) * d[:, 0, :, None] * d
            inv_r = NI.ns_inverse_scaled_build_reference(hp, g9, *sched)[0]
            k3 = NI.ns_inverse_scaled(ks, *sched)
            r = dict(k2_residual=cs.residuals(ks, inv)[metric],
                     k3_residual=cs.residuals(ks, k3)[metric],
                     reference=cs.residuals(ks, inv_r)[metric],
                     k2_ms=cs.event_ms(lambda: NI.ns_inverse_scaled_build(hp, g9, *sched), 5),
                     k3_ms=cs.event_ms(lambda: NI.ns_inverse_scaled(ks, *sched), 5),
                     inv_ex_ms=cs.event_ms(lambda: torch.linalg.inv_ex(ks), 5))
            out[f"K2/K3 256 {label}, {case}"] = r
            print(f"  K2/K3 256 {label}, {case}: {r}")
            del inv, ks, inv_r, k3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
