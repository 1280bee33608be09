"""Benchmark: batched MPC solves/s on one card (10-step horizon), with
per-phase speed-of-light accounting.

The counterpart of the repo root's `bench.py`, run as

    python -m quadruped_ctrl_tpu_torch.bench
    python -m quadruped_ctrl_tpu_torch.cli bench [--device cpu] [--out FILE]

on cuda:0 unless told otherwise. Prints one JSON line with `bench.py`'s
keys: {"metric", "value", "unit", "vs_baseline", ..., "phases",
"lane_errors"}; writes it to a file only when given one (`out`). Baseline
target: 10,000 solves/s/chip (BASELINE.md).

Each "solve" is the full MPC pipeline for one scenario (SRB linearization,
exact discretization, condensed stacking, stance-compressed H/g, pair-packed
KKT systems, ADMM iterations + polish rounds), as `bench.py` counts it. The
lanes, shapes, seeds and rep counts are `bench.py`'s: five h=10 lanes at
batch 4096 and 48 reps, three h=16 lanes at batch 2048 and 16 reps. On the
card the h=10 lanes run kernels K1/128 and K2/128 (`h10_two_step_build`:
K3/128 in K2's place), `h16_full` K1/256 and K2/256 (n = 192), `h16_trot`
K1/128 and K2/128 (n = 96), and `h16_midband` K1/256, the Schur split K4
(K3/128 inside) for its ADMM-phase factorizations (n = 144: 128 < n <= 160)
and K2/256 for its polish.

Phase accounting: the pipeline is timed at four nested configurations and
differenced into formation / factorize / polish phases, each against
`bench.py`'s analytic FLOP/byte model and the bound it names: the "mxu-f32"
phases over the bf16 tensor-core peak / 3 (the port's fp32 products run as
bf16x3, three bf16 passes), the "hbm" phases over the device-memory rate
(NVIDIA H100 SXM data sheet, dense). The iterate is timed apart (`_iterate`):
its segments run as one kernel each (`ops/admm_segment.py`), whose device
time overlaps the host's dispatch of the other phases, so the difference of
two lanes no longer isolates it; its bytes are that kernel's (each system's
inverse read once a segment), in place of `bench.py`'s stream of the inverse
every iteration. Its timing runs as the lane `h10_iterate`; on the plain
branch (the CPU's), which has no segment to replay, the iterate is
differenced as the other phases are. On the CPU no share of a device bound is computed.

Timing: the repetitions are chained (each rep's v_world moves by 1e-9 x the
mean of the previous rep's forces, so no rep can be skipped), timed on the
device by CUDA events around the chain, least of 3 after one warm-up,
divided by the rep count; the host clock only on the CPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import default_config
from quadruped_ctrl_tpu_torch.mpc import pipeline
from quadruped_ctrl_tpu_torch.ops import admm_segment as AS

# One H100 SXM's peaks (NVIDIA data sheet, dense); used only for
# %-of-bound reporting
PEAK_BF16_TFLOPS = 989.0                   # bf16 tensor cores
PEAK_F32_TFLOPS = PEAK_BF16_TFLOPS / 3.0   # fp32 products as bf16x3 = 3 bf16 passes
PEAK_HBM_GBS = 3350.0                      # HBM3
PEAKS = {"mxu-f32": f"{PEAK_F32_TFLOPS:.2f} TFLOP/s: NVIDIA H100 SXM bf16 tensor cores "
                    f"{PEAK_BF16_TFLOPS:.0f} / 3 (bf16x3)",
         "hbm": f"{PEAK_HBM_GBS:.0f} GB/s: NVIDIA H100 SXM HBM3"}


def timed(fn, inputs, n_reps):
    """Seconds per rep of fn(inputs) over a chain of n_reps reps: least of
    3 chains after one warm-up chain, by CUDA events around the chain on the
    card (by the host clock on the CPU)."""
    dev = inputs.v_world.device

    def chained(inp):
        for _ in range(n_reps):
            forces = fn(inp)
            inp = inp.replace(v_world=inp.v_world + 1e-9 * forces.mean(dim=(1, 2)))
        return inp.v_world.sum()

    return _seconds(lambda: chained(inputs), dev) / n_reps


def _seconds(run, dev) -> float:
    """Seconds of run() (which returns a tensor): least of 3 runs after one
    warm-up, by CUDA events around it on the card (by the host clock on the
    CPU)."""
    float(run())  # warm up
    times = []
    for _ in range(3):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            float(run())
            times.append(time.perf_counter() - t0)
    return min(times)


def _iterate(cfg, inputs, n_reps) -> tuple[float, float] | None:
    """The ADMM iterate of one call, timed apart: (seconds, bytes). The
    segment calls that one `solve_packed_batch(polish_rounds=0)` makes are
    recorded and replayed n_reps times in a chain. Bytes: each system's
    n x n inverse read once a segment (twice in the one that switches from
    bf16 to fp32 products), its vectors in and the carry out. None where the
    solve makes no segment call (the plain branch, the CPU's)."""
    with AS.recorded_calls() as calls:
        pipeline.solve_packed_batch(cfg, inputs, polish_rounds=0)
    if not calls:
        return None

    def chain():
        for _ in range(n_reps):
            x = [AS.admm_segment(*args, **kw)[0] for args, kw in calls]
        return x[-1].sum()

    nbytes = 0
    for (inv, grad, l, *_), kw in calls:
        loads = 1 + (kw["n_lo"] > 0 and kw["n_hi"] > 0)
        nbytes += 4 * grad.shape[0] * (loads * kw["n"] ** 2 + 3 * grad.shape[1]
                                       + 7 * l.shape[1])
    return _seconds(chain, inputs.v_world.device) / n_reps, nbytes


def _phase_models(cfg, batch: int, h: int) -> dict:
    """`bench.py`'s analytic per-phase (FLOP, byte) models for one full
    batch of the h=10 flagship shape, number for number."""
    s = cfg.solver
    ms, pack = 2, 2                     # stance compression + pair packing
    n_c = 3 * ms * h                    # 60 compressed vars / scenario
    npad = 128                          # packed KKT tile (2 x 60 -> 128)
    mp_ = 256                           # padded constraint rows
    sys_n = batch // pack               # packed systems
    ns_admm = s.ns_admm_scaled_iters + s.ns_quad_iters + s.ns_hi_iters
    ns_pol = s.ns_scaled_iters + s.ns_quad_iters + s.ns_hi_iters
    iters, polish = s.iterations, s.polish_rounds

    # formation: dominated by bq.T @ (S bq) — (13h x n_c)^T (13h x n_c)
    flops_form = batch * 2 * (13 * h) * n_c * n_c * 2
    bytes_form = batch * (13 * h * n_c * 2 + n_c * n_c) * 4
    # factorize: 2 ADMM-phase factorizations (cold + adaptive-rho), two
    # products per NS step, K in and X out
    flops_fact = 2 * sys_n * ns_admm * 2 * 2 * npad**3
    bytes_fact = 2 * sys_n * 2 * npad * npad * 4
    # iterate: the inverse matvec streams the inverse (2 bytes, the f32
    # tail 4)
    n_lo = iters - min(s.f32_tail_iters, iters)
    n_hi_i = iters - n_lo
    flops_iter = iters * sys_n * 2 * (npad**2 + 2 * npad * mp_)
    bytes_iter = sys_n * npad * npad * (2 * n_lo + 4 * n_hi_i)
    # polish: per round one full-schedule factorization + one f32 refine
    # solve (3 matvecs) + bound algebra
    flops_pol_fact = polish * sys_n * ns_pol * 2 * 2 * npad**3
    bytes_pol_fact = polish * sys_n * 2 * npad * npad * 4
    flops_pol = polish * sys_n * 2 * 3 * npad**2
    bytes_pol = polish * sys_n * 3 * npad * npad * 4
    return {"formation": (flops_form, bytes_form),
            "factorize(NS)": (flops_fact, bytes_fact),
            "iterate(ADMM)": (flops_iter, bytes_iter),
            "polish+fact": (flops_pol + flops_pol_fact, bytes_pol + bytes_pol_fact)}


def _midband_table(h16: int) -> np.ndarray:
    """The aio walking->trot morph band's 3-stance gait table at v = 0.3
    (ConvexMPCLocomotion.cpp:174-233), as `bench.py` builds it."""
    v_band = 0.3
    o2 = int(np.floor(h16 * 1.25 * v_band))
    o3 = int(np.floor(h16 * (1.25 * v_band + 0.5)))
    dwt = int(np.floor(h16 * (-1.25 * v_band + 1.0)))
    offs = np.array([0, h16 // 2, o2, o3])
    steps = np.arange(h16)[:, None]
    tbl = (((steps - offs[None, :]) % h16) < dwt).astype(np.float32)
    # every step must have <= 3 stance feet (the ms=3 compression is only
    # exact then) and >= 1 (a zero-stance step has no variables)
    if not (tbl.sum(axis=1).max() <= 3 and (tbl.sum(1) >= 1).all()):
        raise ValueError("midband gait table: a step outside 1-3 stance feet")
    return tbl


def main(batch: int = 4096, batch16: int = 2048, n_reps: int = 48, n_reps16: int = 16,
         device=None, out: str | None = None) -> dict:
    """Run the eight lanes, print the JSON line (and write it to `out` when
    given) and return it as a dict. The sizes default to `bench.py`'s;
    `device` to cuda:0."""
    dev = _device.resolve(device)
    on_card = dev.type == "cuda"
    print(f"# device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}",
          file=sys.stderr, flush=True)
    # Every lane runs in its own try/except; per-lane progress goes to
    # stderr as it lands, and the final single JSON line on stdout is ALWAYS
    # printed, carrying nulls + error strings for any lane that failed.
    lane_errors = {}

    def lane(name, fn):
        try:
            out_ = fn()
            print(f"# lane {name}: ok", file=sys.stderr, flush=True)
            return out_
        except Exception as e:  # noqa: BLE001 — record and keep going
            lane_errors[name] = f"{type(e).__name__}: {str(e)[:400]}"
            print(f"# lane {name}: FAIL {lane_errors[name]}", file=sys.stderr, flush=True)
            return None

    cfg = default_config()
    h = 10
    inputs = pipeline.random_inputs(0, batch, h, device=dev)

    t_full = lane("h10_full", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i), inputs, n_reps))
    t_nopol = lane("h10_nopolish", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, polish_rounds=0), inputs, n_reps))
    iter_min = 2 * (cfg.solver.rho_adapt + 1)
    t_form_fact = lane("h10_form_fact", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, iterations=iter_min, polish_rounds=0),
        inputs, n_reps))
    t_form_meas = lane("h10_form_only", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, form_only=True), inputs, n_reps))
    iterate = lane("h10_iterate", lambda: _iterate(cfg, inputs, n_reps))

    # A/B: the fused K-build+NS factorization kernel (K2) vs the two-step
    # (plain-torch assemble -> NS kernel K3) path, via the _FUSED_BUILD hatch
    def ab_two_step():
        from quadruped_ctrl_tpu_torch.solver import admm
        admm._FUSED_BUILD = False
        try:
            return timed(lambda i: pipeline.solve_packed_batch(cfg, i), inputs, n_reps)
        finally:
            admm._FUSED_BUILD = True

    t_two_step = lane("h10_two_step_build", ab_two_step)

    def phase(name, t, flops, bts, bound):
        if on_card:
            attained = (flops / 1e12 / t / PEAK_F32_TFLOPS if bound == "mxu-f32"
                        else bts / 1e9 / t / PEAK_HBM_GBS)
            attained_pct, peak = round(100 * attained, 1), PEAKS[bound]
        else:
            attained_pct, peak = None, f"not measured: ran on {dev.type}"
        return {
            "name": name,
            "ms": round(t * 1e3, 2),
            "gflops": round(flops / 1e9, 1),
            "gbytes": round(bts / 1e9, 3),
            "bound": bound,
            "attained_pct": attained_pct,
            "peak": peak,
        }

    phases = None
    if None not in (t_full, t_nopol, t_form_fact, t_form_meas):
        models = _phase_models(cfg, batch, h)
        if iterate is None:
            t_iter = max(t_nopol - t_form_fact, 1e-9)
        else:
            t_iter, bytes_iter = iterate
            models["iterate(ADMM)"] = (models["iterate(ADMM)"][0], bytes_iter)
        # formation is measured directly (form_only); factorize is the
        # remainder of the measured formation+factorize bucket
        t_form = t_form_meas
        t_fact = max(t_form_fact - t_form, 1e-9)
        t_pol = max(t_full - t_nopol, 1e-9)
        phases = [
            phase("formation", t_form, *models["formation"], "mxu-f32"),
            phase("factorize(NS)", t_fact, *models["factorize(NS)"], "mxu-f32"),
            phase("iterate(ADMM)", t_iter, *models["iterate(ADMM)"], "hbm"),
            phase("polish+fact", t_pol, *models["polish+fact"], "hbm"),
        ]

    # h=16 lanes: the aio mode-1 horizon cap (ConvexMPCLocomotion.cpp:174-233).
    # The worst case (3-4 stance feet -> no swing elimination, 192-var
    # systems on the 256 tile) and the fast-trot band (2-stance, compressed
    # 96-var, pair-packed to 192)
    h16, b16 = 16, batch16
    inputs16 = pipeline.random_inputs(1, b16, h16, device=dev)
    t16 = lane("h16_full", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=4, pack=1),
        inputs16, n_reps16))
    t16t = lane("h16_trot", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=2, pack=2),
        inputs16, n_reps16))
    # mid-band lane: the aio walking->trot morph band is a 3-STANCE h=16
    # gait, so it compresses to ms=3 (144-var systems) instead of running
    # uncompressed 192-var
    tbl = torch.as_tensor(_midband_table(h16), device=dev)
    inputs16m = inputs16.replace(gait_table=tbl.expand(b16, h16, 4).contiguous())
    t16m = lane("h16_midband", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=3, pack=1),
        inputs16m, n_reps16))

    def rate(total, t):
        return round(total / t, 1) if t else None

    solves_per_s = (batch / t_full) if t_full else None
    report = {
        "metric": "mpc_solves_per_s_per_chip",
        "value": round(solves_per_s, 1) if solves_per_s else None,
        "unit": f"solves/s (h=10, batch={batch}, full pipeline)",
        "vs_baseline": (round(solves_per_s / 10000.0, 3) if solves_per_s else None),
        "h16_solves_per_s": rate(b16, t16),
        "h16_unit": f"solves/s (h=16, batch={b16}, 192-var/256-tile)",
        "h16_trot_solves_per_s": rate(b16, t16t),
        "h16_trot_unit": "solves/s (h=16 fast-trot band, 2-stance "
                         "compressed + pair-packed)",
        "h16_midband_solves_per_s": rate(b16, t16m),
        "h16_midband_unit": "solves/s (h=16 aio walking band, "
                            "3-stance compressed, 144-var systems)",
        "h16_midband_note": "ms=3 compression (192->144 vars): the ADMM-phase "
                            "factorizations take the Schur split K4 (K3 at the "
                            "128 tile inside; routed for 128 < n <= 160), the "
                            "polish factorizations keep the 256 tile (K2/256)",
        "fused_build_solves_per_s": rate(batch, t_full),
        "two_step_build_solves_per_s": rate(batch, t_two_step),
        "fused_build_note": "A/B of the fused K-build+NS kernel K2 vs plain-torch "
                            "assemble + NS kernel K3 (admm._FUSED_BUILD hatch), "
                            "h=10 flagship shape",
        "phases": phases,
        "lane_errors": lane_errors or None,
    }
    line = json.dumps(report)
    print(line)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
