#!/usr/bin/env python3
"""Drive the PyTorch port's batched packed MPC solve once on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds the CUDA kernels from quadruped_ctrl_tpu_torch/csrc;
3. holds each kernel (K1 form_packed, K2 ns_inverse_scaled_build, K3
   ns_inverse_scaled) against its plain PyTorch reference on the card, at the
   main path's shapes, and times both;
4. drives `solve_packed_batch` at batch 4096, h=10 (2048 packed systems of
   120 variables) through the kernels, counts their launches, checks the
   forces and compares them with the plain branch on the same inputs, then
   runs the polish_rounds=0, form_only and two-step-build variants;
5. profiles one solve (device time by kernel, device idle share);
6. prints a JSON line with the kernels, then the result line.

Exits non-zero when no CUDA device is present, when a kernel fails to build
or launch, or when any check fails. Needs no JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import formation, pipeline
from quadruped_ctrl_tpu_torch.ops import _build
from quadruped_ctrl_tpu_torch.ops import formation_pack as FP
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from quadruped_ctrl_tpu_torch.solver import admm

BATCH, H, MS, PACK = 4096, 10, 2, 2
N_SYS, N_VARS = BATCH // PACK, PACK * 3 * MS * H      # 2048 systems of n=120
WRAPPERS = {"K1": FP.form_packed, "K2": NI.ns_inverse_scaled_build,
            "K3": NI.ns_inverse_scaled}
KERNEL_INFO = {
    "K1": dict(name="form_packed", source="quadruped_ctrl_tpu_torch/csrc/formation_pack.cu",
               replaces="quadruped_ctrl_tpu/ops/formation_pack.py:135"),
    "K2": dict(name="ns_inverse_scaled_build",
               source="quadruped_ctrl_tpu_torch/csrc/ns_inverse.cu",
               replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:615"),
    "K3": dict(name="ns_inverse_scaled", source="quadruped_ctrl_tpu_torch/csrc/ns_inverse.cu",
               replaces="quadruped_ctrl_tpu/ops/ns_inverse.py:259"),
}


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


def reset_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {k: fn.launches for k, fn in WRAPPERS.items()}


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


def residuals(ks, inv):
    """(max |I - ks inv| elementwise, max row sum of |I - ks inv|), in float64."""
    r = torch.eye(ks.shape[-1], dtype=torch.float64, device=ks.device) - ks.double() @ inv.double()
    return float(r.abs().max()), float(r.abs().sum(-1).max())


def solve_operands(cfg, inputs):
    """The (hp, g9, schedule) of every K2 call one real solve makes: the cold
    ADMM factorization, the adaptive-rho refactorization and the polish
    rounds."""
    calls = []
    kernel = NI.ns_inverse_scaled_build

    def record(hp, g9, *schedule):
        calls.append((hp, g9.clone(), schedule))
        return kernel(hp, g9, *schedule)

    NI.ns_inverse_scaled_build = record
    try:
        pipeline.solve_packed_batch(cfg, inputs)
    finally:
        NI.ns_inverse_scaled_build = kernel
    return calls


def phase_kernels(cfg, dev, results):
    print("phase 3: kernels vs references on the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    # K1 at the main path's shape and at an odd system count with 2 masked steps
    for batch, masked in ((BATCH, 0), (BATCH - 2, 2)):
        inp = pipeline.random_inputs(seed=1, batch=batch, h=H, device=dev)
        adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag,
                                          cfg.dt_mpc)
        x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                                cfg.mpc.gravity)
        _, _, sel = formation.stance_selectors(inp.gait_table, MS)
        mask = torch.ones((batch, H), device=dev)
        if masked:
            mask[:, -masked:] = 0.0
        ops = formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel)
        args = (*ops, H, MS, PACK, float(cfg.mpc.alpha))
        hk, gk = FP.form_packed(*args)
        hr, gr = FP.form_packed_reference(*args)
        hx, gx = formation.qp_cost_packed(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel, PACK,
                                          use_kernels=False)
        torch.cuda.synchronize()
        print(f"  K1 batch {batch}: rel_H {rel(hk, hr):.3e} rel_g {rel(gk, gr):.3e} vs "
              f"reference; rel_H {rel(hk, hx):.3e} rel_g {rel(gk, gx):.3e} vs the fp32 "
              "plain formation")
        check(hk.shape == (batch // PACK, N_VARS, N_VARS) and bool(torch.isfinite(hk).all()),
              f"K1 batch {batch}: shape and finite")
        check(rel(hk, hr) < 5e-5 and rel(gk, gr) < 1e-5, f"K1 batch {batch} vs reference")
        check(rel(hk, hx) < 5e-5 and rel(gk, gx) < 1e-5, f"K1 batch {batch} vs fp32 plain")
        if batch == BATCH:
            results["K1"].update(max_abs_err=float((hk - hr).abs().max()),
                                 ms=median_ms(lambda: FP.form_packed(*args)),
                                 plain_ms=median_ms(lambda: FP.form_packed_reference(*args)))
            print("  K1 at batch %d: kernel %.3f ms reference %.3f ms (median of 10)"
                  % (batch, results["K1"]["ms"], results["K1"]["plain_ms"]))

    s = cfg.solver
    admm_sched = (s.ns_admm_a0, s.ns_admm_scaled_iters, s.ns_quad_iters, s.ns_hi_iters)
    polish_sched = (s.ns_a0, s.ns_scaled_iters, s.ns_quad_iters, s.ns_hi_iters)
    g9_zero = torch.zeros((N_SYS, 9, N_VARS // 3), device=dev)
    # (label, hp, g9, schedule, residual metric (0 elementwise, 1 row sum), gate):
    # the JAX package's kernel-test gates for the SPD cases and for a real
    # solve's ADMM operands. A real solve's polish-round K (w_act = 1e4 on the
    # active set) is worse conditioned than the SPD cases: the reference's own
    # row-sum residual reaches ~0.26 there (CPU, batch 1024), which the
    # polish solves' two refinement passes contract as r^3. Its gate is 0.5,
    # inside the refinement's convergence region. Everywhere the kernel's
    # residual must also stay within 2x of the reference's.
    cases = [("SPD cond 2.1e3, ADMM schedule", spd_batch(gen, N_SYS, N_VARS, NI.N, 2.1e3, dev),
              g9_zero, admm_sched, 0, 1e-2),
             ("SPD cond 1e4, polish schedule", spd_batch(gen, N_SYS, N_VARS, NI.N, 1e4, dev),
              g9_zero, polish_sched, 1, 5e-3)]
    calls = solve_operands(cfg, pipeline.random_inputs(seed=2, batch=BATCH, h=H, device=dev))
    check(len(calls) == 5, "a real solve makes 5 K2 calls")
    for i, (hp, g9, sched) in enumerate(calls):
        polish = sched == polish_sched
        cases.append((f"solve call {i} ({'polish' if polish else 'ADMM'} schedule)", hp, g9,
                      sched, 1 if polish else 0, 0.5 if polish else 1e-2))
    for label, hp_c, g9_c, sched, metric, gate in cases:
        inv_k, ks_k, d_k = NI.ns_inverse_scaled_build(hp_c, g9_c, *sched)
        inv_r, ks_r, d_r = NI.ns_inverse_scaled_build_reference(hp_c, g9_c, *sched)
        res_k, res_r = residuals(ks_r, inv_k)[metric], residuals(ks_r, inv_r)[metric]
        err2 = float((inv_k - inv_r).abs().max())
        print(f"  K2 {label}: residual kernel {res_k:.3e} reference {res_r:.3e} (gate {gate}); "
              f"rel ks {rel(ks_k, ks_r):.3e} rel d {rel(d_k, d_r):.3e}; "
              f"max |inv_k - inv_r| {err2:.3e}")
        check(res_k < gate and res_r < gate and res_k <= 2 * res_r + 1e-5,
              f"K2 {label}: residuals")
        check(rel(ks_k, ks_r) <= 1e-6 and rel(d_k, d_r) <= 1e-6, f"K2 {label}: ks, d_row")
        inv3_k = NI.ns_inverse_scaled(ks_r, *sched)
        inv3_r = NI.ns_inverse_scaled_reference(ks_r, *sched)
        res3_k, res3_r = residuals(ks_r, inv3_k)[metric], residuals(ks_r, inv3_r)[metric]
        err3 = float((inv3_k - inv3_r).abs().max())
        print(f"  K3 {label}: residual kernel {res3_k:.3e} reference {res3_r:.3e} "
              f"(gate {gate}); max |inv_k - inv_r| {err3:.3e}")
        check(res3_k < gate and res3_r < gate and res3_k <= 2 * res3_r + 1e-5,
              f"K3 {label}: residuals")
        if label.startswith("solve call 0") or label.startswith("solve call 2"):
            times = [median_ms(lambda: NI.ns_inverse_scaled_build(hp_c, g9_c, *sched)),
                     median_ms(lambda: NI.ns_inverse_scaled_build_reference(hp_c, g9_c, *sched)),
                     median_ms(lambda: NI.ns_inverse_scaled(ks_r, *sched)),
                     median_ms(lambda: NI.ns_inverse_scaled_reference(ks_r, *sched))]
            print(f"  %s at {N_SYS} systems: K2 kernel %.3f ms reference %.3f ms; K3 kernel "
                  "%.3f ms reference %.3f ms (median of 10)" % (label, *times))
        if label.startswith("solve call 0"):
            # the kernels' line reports the solve's first factorization;
            # polish-schedule inverses differ from the reference by more in
            # absolute terms (entries up to ~cond), see the lines above
            results["K2"].update(max_abs_err=err2, ms=times[0], plain_ms=times[1])
            results["K3"].update(max_abs_err=err3, ms=times[2], plain_ms=times[3])


def force_checks(cfg, inputs, forces):
    """Finite forces, exact zeros on swing feet, and the friction pyramid and
    normal-force box: every scenario inside the controller's acceptance gate
    (SolverConfig.fail_primal_tol) and >= 99% inside 1e-3 N."""
    check(forces.shape == (BATCH, H, 4, 3), "forces shape (4096, 10, 4, 3)")
    check(bool(torch.isfinite(forces).all()), "forces finite")
    swing = inputs.gait_table == 0
    check(bool((forces[swing] == 0).all()), "swing-foot forces exactly 0")
    fx, fy, fz = forces[..., 0], forces[..., 1], forces[..., 2]
    mu, f_max = cfg.mpc.mu, cfg.mpc.f_max
    viol = torch.stack([-fz, fz - f_max, fx.abs() - mu * fz, fy.abs() - mu * fz],
                       dim=-1).amax(dim=(1, 2, 3)).clamp(min=0.0)
    tight = float((viol <= 1e-3).float().mean())
    print(f"  max bound violation {float(viol.max()):.3e} N; share of scenarios within "
          f"1e-3 N {tight:.4f}")
    check(float(viol.max()) <= cfg.solver.fail_primal_tol,
          f"every scenario within the acceptance gate ({cfg.solver.fail_primal_tol} N)")
    check(tight >= 0.99, ">= 99% of scenarios within 1e-3 N of the bounds")


def phase_main_path(cfg, dev, name_power, results):
    print("phase 4: main path, solve_packed_batch at batch 4096, h=10 (2048 systems, n=120)")
    inputs = pipeline.random_inputs(seed=0, batch=BATCH, h=H, device=dev)
    reset_counts()
    forces = pipeline.solve_packed_batch(cfg, inputs)
    torch.cuda.synchronize()
    main_counts = counts()
    print(f"  launches in one solve: {main_counts}")
    check(main_counts == {"K1": 1, "K2": 5, "K3": 0}, "launches K1=1, K2=5, K3=0")
    for k in ("K1", "K2"):
        results[k].update(launches=main_counts[k], counted_in="default")
    force_checks(cfg, inputs, forces)
    # The reference solve resolves a few knife-edge active sets differently
    # under rounding-level changes (ROADMAP queue 3: the JAX package's own
    # Pallas and XLA branches differ by > 0.5 N on 7 of 1024 scenarios), so
    # the comparison gates the share of scenarios and the median, not the max.
    plain = pipeline.solve_packed_batch(cfg, inputs, use_kernels=False)
    diff = (forces - plain).abs().amax(dim=(1, 2, 3))
    share = float((diff <= 0.5).float().mean())
    print(f"  vs plain branch on the card: max |d| {float(diff.max()):.3e} N, median "
          f"{float(diff.median()):.3e} N, share of scenarios within 0.5 N {share:.4f}")
    check(share >= 0.98 and float(diff.median()) <= 0.15,
          ">= 98% of scenarios within 0.5 N of the plain branch, median <= 0.15 N")

    times = {}
    for label, kw in (("full", {}), ("no_polish", dict(polish_rounds=0)),
                      ("form_only", dict(form_only=True))):
        reset_counts()
        out = pipeline.solve_packed_batch(cfg, inputs, **kw)
        torch.cuda.synchronize()
        c = counts()
        want = {"full": {"K1": 1, "K2": 5, "K3": 0}, "no_polish": {"K1": 1, "K2": 2, "K3": 0},
                "form_only": {"K1": 1, "K2": 0, "K3": 0}}[label]
        check(c == want and bool(torch.isfinite(out).all()), f"{label}: launches {c}, finite")
        times[label] = median_ms(lambda: pipeline.solve_packed_batch(cfg, inputs, **kw), reps=5)
    admm._FUSED_BUILD = False
    try:
        reset_counts()
        two = pipeline.solve_packed_batch(cfg, inputs)
        torch.cuda.synchronize()
        c = counts()
        check(c == {"K1": 1, "K2": 0, "K3": 5}, f"two-step build: launches {c}")
        results["K3"].update(launches=c["K3"], counted_in="two_step_build")
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


def phase_profile(cfg, dev) -> dict:
    """Device time by kernel and the device's idle share over one solve,
    from torch.profiler's CUDA activity (the profiler's own host overhead
    widens the span, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    print(f"phase 5: torch.profiler over one solve at batch {BATCH}")
    inputs = pipeline.random_inputs(seed=0, batch=BATCH, h=H, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline.solve_packed_batch(cfg, inputs)
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

    cfg = default_config()
    results = {k: dict(KERNEL_INFO[k], route="cuda") for k in WRAPPERS}
    phase_kernels(cfg, dev, results)
    times = phase_main_path(cfg, dev, name_power, results)
    profile = phase_profile(cfg, dev)
    print(json.dumps({"phase_ms": times, "profile": profile, "batch": BATCH,
                      "card": name_power}))
    kernels = [{key: results[k][key] for key in (
        "name", "route", "source", "replaces", "launches", "counted_in", "max_abs_err",
        "ms", "plain_ms")} for k in ("K1", "K2", "K3")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
