#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`quadruped_ctrl_tpu_torch`).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. Everything a
cell needs is found by name from `BENCHMARK.json` (see `harness/spec.py`).

Set-up (counted in `setup_s`, from the first statement of this file to the
start of the window): import torch and the port, create the CUDA context,
build or load the port's kernel library (`quadruped_ctrl_tpu_torch/_build/`,
inside the checkout), draw the cell's pool of inputs on the card from the
seed, and one warm-up call on the cell's shape. The window then runs the
cell's entry for `--seconds`:

* `loop: batched`: calls back to back, each on the next batch of the pool,
  no host sync inside the window; the window ends with a synchronize after
  the last call it started;
* `loop: closed`: one client; each request's forces are copied to the host
  before the next request is sent, and its latency is the host time from
  the call to the forces on the host.

With `--trace 1` a stretch of the window (the cell file's `trace.calls`
calls, after `trace.skip`) runs under torch.profiler, the window is held
open for as long as the stretch took, and the per-layer metrics are read
from it once the window has closed. After the window a sample of what the timed
calls returned, drawn from the seed, is judged against the plain reference
(`harness/check.py`). The last line of standard output is the result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "quadruped_ctrl_tpu")
CACHE = ROOT / ".bench_cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that this benchmark must not load,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run(args, *, device=None, entry_wrap=None, traffic_over=None, workload_over=None,
        min_calls=0):
    """One run; returns (result, notes, check lines, every number the check
    computed) or raises SystemExit.

    `device=None` is the real run: it needs CUDA cards, as many as the
    cell asks for. The keyword arguments are for tests and for the
    calibration: another device, a wrapper around the entry's call (the
    control or a planted fault), overrides of the traffic's and the cell
    file's values, and a least number of calls that holds the window open
    past `--seconds` (so that a slow control is judged on a full sample)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    import torch

    from benchmark.harness import check, spec
    from benchmark.harness.trace import profiled, read_profile

    cell = spec.load_cell(args.workload)
    cell.traffic.update(traffic_over or {})
    cell.workload.update(workload_over or {})
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("benchmark: torch.cuda.is_available() is False: a CUDA card is needed")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"benchmark: {cell.name} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        from quadruped_ctrl_tpu_torch.ops import _build
        _build.load()
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    cfg = spec.program_config(cell.config)
    h = int(cell.config["horizon"])
    pool = cell.generator().make_pool(cell.traffic, h, args.seed, device)
    prepare, call = cell.entry_module().make(cfg, cell.workload.get("params", {}))
    if entry_wrap is not None:
        call = entry_wrap(call)
    prepared = [prepare(b) for b in pool]
    closed = cell.traffic["loop"] == "closed"
    batch = int(cell.traffic["batch"])
    n_pool = len(pool)

    # warm-up: the cell's one shape
    out = call(prepared[0])
    if closed:
        out.cpu()
    sync()
    del out
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    tr = cell.workload["trace"]
    trace_at = int(tr["skip"]) if args.trace else -1
    stretch_slots, traced = [], {}
    kept = {}                    # batched: slot -> forces; closed: request -> forces
    slots_of = {}                # closed: request -> slot
    latencies = []

    def one(k):
        slot = k % n_pool
        if closed:
            t = time.perf_counter()
            f = call(prepared[slot]).cpu()
            latencies.append((time.perf_counter() - t) * 1e3)
            kept[k], slots_of[k] = f, slot
        else:
            kept[slot] = call(prepared[slot])
        return slot

    t_start = time.perf_counter()
    setup_s = t_start - T0
    deadline = t_start + args.seconds
    k = 0
    while True:
        if k == trace_at:
            # the profiler's start and stop take seconds: the window is held
            # open that much longer, so a traced run checks as many outputs
            # as an untraced one
            sync()
            t_traced = time.perf_counter()
            with profiled(sync, traced):
                for _ in range(int(tr["calls"])):
                    stretch_slots.append(one(k))
                    k += 1
            deadline += time.perf_counter() - t_traced
        else:
            one(k)
            k += 1
        if time.perf_counter() >= deadline and (trace_at < 0 or k > trace_at) \
                and k >= min_calls:
            break
    sync()
    t_end = time.perf_counter()
    window_s = t_end - t_start
    found = banned_modules()
    if found:
        raise SystemExit(f"benchmark: the run loaded {found}")
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    trace = (read_profile(traced["profile"], tempfile.gettempdir(), int(tr["calls"]))
             if "profile" in traced else None)

    # the check, after the window, on what the timed calls returned
    if closed:
        items = [(pool[slots_of[r]], kept[r]) for r in sorted(kept)]
    else:
        items = [(pool[s], kept[s]) for s in sorted(kept)]
    del prepared
    chk = cell.workload["check"]
    nonfinite = sum(int((~torch.isfinite(f)).flatten(1).any(1).sum()) for _, f in items)
    pairs = check.sample(args.seed, len(items), batch, int(chk["scenarios"]))
    inp, forces = check.gather(pairs, [i for i, _ in items], [f for _, f in items], device)
    del kept, items
    numbers = check.judge(cell.config["mpc"], inp, forces)
    correct, checks = check.verdict(numbers, chk["limits"], nonfinite)

    ctx = SimpleNamespace(
        setup_s=setup_s, trace=trace, cell=cell,
        window=dict(calls=k, scenarios=k * batch, seconds=window_s, latencies_ms=latencies),
        stretch=[pool[s] for s in stretch_slots],
        peaks=spec.peaks(torch.cuda.get_device_name(device)) if on_card else None)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": k * batch, "failed": nonfinite,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = checks
    notes = [f"# {cell.name}: {k} calls ({k * batch} scenarios) in {window_s:.3f} s, "
             f"set-up {setup_s:.3f} s; checked {len(pairs)} scenarios",
             "# not compared: " + ", ".join(f"{n} {v:.3g}" for n, v in numbers.items()
                                            if n not in checks)]
    if latencies:
        xs = sorted(latencies)
        notes.append(f"# requests {len(xs)}, median {xs[len(xs) // 2]:.3f} ms")
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return result, notes, lines, numbers


def main(argv=None) -> int:
    args = parse(argv)
    result, notes, lines, _ = run(args)
    for line in notes + lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
