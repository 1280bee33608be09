"""On-device smoke for every kernel of the port at production shapes.

The counterpart of `quadruped_ctrl_tpu/utils/kernels_smoke.py`, with the
same cases in the same order: it runs each kernel at the exact (batch, tile)
shapes the bench and closed-loop paths use, both the 128 and 256 tiles,
checks finiteness plus an NS residual where meaningful, and reports one
line per case. On the card the cases launch the port's CUDA kernels through
their wrappers: K3 (`ns_inverse_scaled`), K2 (`ns_inverse_scaled_build`),
K4 (`ns_inverse_schur_scaled`, K3/128 inside), K6 (`ns_inverse_refine`), K1
(`form_packed`, through `formation.qp_cost_packed`) and, with `full`, K5
(`solve_packed_batch(use_fused=True)`) and the four bench lanes. On the CPU
the wrappers run their plain PyTorch versions at reduced batch, so the lane
is still exercised by the default suite.

Run via `python -m quadruped_ctrl_tpu_torch.cli kernels-smoke [--out FILE]`.
Exit code is non-zero if any case fails.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _spd_batch(seed: int, b: int, n: int, npad: int, cond: float = 1e3, device=None):
    """Jacobi-prescaled SPD batch embedded in the kernel tile (the
    construction of tests/test_pallas_kernels.py, tiled from G distinct
    systems for speed at production batch), on `device` (cuda:0 unless
    named)."""
    from quadruped_ctrl_tpu_torch import device as _device
    from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI

    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    ks = []
    for _ in range(NI.G):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)).astype(np.float64))
        ev = np.logspace(0.0, -np.log10(cond), n)
        k = (q * ev[None, :]) @ q.T
        d = 1.0 / np.sqrt(np.diagonal(k))
        ks.append((k * d[:, None] * d[None, :]).astype(np.float32))
    base = NI.pad_to(torch.as_tensor(np.stack(ks), device=dev), n, npad)
    reps = -(-b // NI.G)
    return base.repeat(reps, 1, 1)[:b].contiguous()


def _sync(out):
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def _timed(fn, *args):
    """Run + synchronise; returns (result, best-of-2 ms) after one warm-up
    run: wall clock around a call that ends in a synchronisation."""
    out = fn(*args)
    _sync(out)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    return out, min(times) * 1e3


def run_smoke(full: bool | None = None, device=None):
    """Returns (lines, n_failed). `full=None` auto-selects: production
    batches on the card, small batches on the CPU. `device` defaults to
    cuda:0."""
    from quadruped_ctrl_tpu_torch import device as _device
    from quadruped_ctrl_tpu_torch.config import default_config
    from quadruped_ctrl_tpu_torch.core.types import tree_flatten
    from quadruped_ctrl_tpu_torch.mpc import formation, pipeline
    from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI

    dev = _device.resolve(device)
    if full is None:
        full = dev.type == "cuda"
    cfg = default_config()
    cs = cfg.solver
    sched = (cs.ns_a0, cs.ns_scaled_iters, cs.ns_quad_iters, cs.ns_hi_iters)
    asched = (cs.ns_admm_a0, cs.ns_admm_scaled_iters, cs.ns_quad_iters,
              cs.ns_hi_iters)
    B = 2048 if full else NI.G
    lines = []
    failed = 0

    def case(name, fn, *args, check=None):
        nonlocal failed
        try:
            out, ms = _timed(fn, *args)
            arrs = tree_flatten(out)[0]
            ok = all(bool(torch.isfinite(a).all()) for a in arrs)
            extra = ""
            if ok and check is not None:
                ok, extra = check(out)
            status = "ok" if ok else "BAD-VALUES"
            if not ok:
                failed += 1
            lines.append(f"{name:<58} {status:>10}  {ms:9.2f} ms{extra}")
        except Exception as e:  # noqa: BLE001 — the whole point is recording
            failed += 1
            lines.append(
                f"{name:<58} {'FAIL':>10}  {type(e).__name__}: "
                f"{str(e)[:200]}")
        print(lines[-1], flush=True)

    def ns_resid_check(ks):
        # host f64 check on the first group, so the check's own rounding
        # stays far below the kernel's ~1e-5 residual
        ks8 = ks[:NI.G].double().cpu().numpy()

        def chk(inv):
            if isinstance(inv, tuple):
                inv = inv[0]
            eye = np.eye(ks8.shape[-1])
            r = float(np.abs(ks8 @ inv[:NI.G].double().cpu().numpy() - eye).max())
            return r < 0.05, f"  resid={r:.2e}"
        return chk

    # ---- NS inversion kernel K3, both tiles, production batch ----
    for n, npad in ((120, 128), (192, 256)):
        ks = _spd_batch(0, B, n, npad, device=dev)
        case(f"ns_inverse_scaled (K3)          B={B} tile={npad}",
             lambda ks: NI.ns_inverse_scaled(ks, *sched),
             ks, check=ns_resid_check(ks))
        case(f"ns_inverse_scaled[admm] (K3)    B={B} tile={npad}",
             lambda ks: NI.ns_inverse_scaled(ks, *asched),
             ks, check=ns_resid_check(ks))

    # ---- fused K-build + NS (K2), production (n, nblk) per tile ----
    # 128: the h=10 pair-packed bench shape (n=120, nblk=40);
    # 256: h=16 uncompressed (n=192, nblk=64) and the ms=3 walking band
    # (n=144, nblk=48)
    for n, npad in ((120, 128), (144, 256), (192, 256)):
        nblk = n // 3
        rng = np.random.default_rng(n)
        m0 = rng.standard_normal((NI.G, n, n)).astype(np.float32)
        h8 = np.einsum("bij,bkj->bik", m0, m0) * 0.02 \
            + 3.0 * np.eye(n, dtype=np.float32)
        hp8 = NI.pad_to(torch.as_tensor(h8, device=dev), n, npad)
        reps = -(-B // NI.G)
        hp = hp8.repeat(reps, 1, 1)[:B].contiguous()
        g9 = torch.as_tensor(
            np.abs(rng.standard_normal((B, 9, nblk))).astype(np.float32) * 0.05,
            device=dev)
        case(f"ns_inverse_scaled_build (K2)    B={B} tile={npad} n={n}",
             lambda hp, g9: NI.ns_inverse_scaled_build(hp, g9, *sched)[0],
             hp, g9)

    # ---- Schur-split inverse K4 (K3/128 inside): n=144 is the routed
    # production size (admm routes 128 < n <= 160 there); n=192 is run as
    # the JAX lane runs it, outside the routing ----
    for n in (144, 192):
        ks8 = _spd_batch(5, NI.G, n, n, cond=213.0, device=dev)
        ks = ks8.repeat(-(-B // NI.G), 1, 1)[:B].contiguous()
        routed = "routed" if n <= 160 else "not routed"
        case(f"ns_inverse_schur_scaled (K4)    B={B} n={n} ({routed})",
             lambda ks: NI.ns_inverse_schur_scaled(
                 ks, cs.ns_admm_a0, cs.ns_admm_scaled_iters,
                 cs.ns_quad_iters, cs.ns_hi_iters),
             ks, check=ns_resid_check(ks))

    # ---- warm refine kernel K6, both tiles ----
    for n, npad in ((120, 128), (192, 256)):
        ks = _spd_batch(1, B, n, npad, device=dev)
        exact8 = np.linalg.inv(ks[:NI.G].double().cpu().numpy())
        e = np.random.default_rng(2).standard_normal(exact8.shape)
        e *= 0.05 / np.linalg.norm(e, ord=2, axis=(-2, -1), keepdims=True)
        init8 = torch.as_tensor((exact8 @ (np.eye(npad) + e)).astype(np.float32),
                                device=dev)
        init = init8.repeat(-(-B // NI.G), 1, 1)[:B].contiguous()
        case(f"ns_inverse_refine (K6)          B={B} tile={npad}",
             lambda ks, init: NI.ns_inverse_refine(ks, init, cs.ns_wb_quad, cs.ns_wb_hi),
             ks, init, check=ns_resid_check(ks))

    # ---- packed formation kernel K1, every bench lane shape ----
    bform = (4096 if full else 4, 2048 if full else 4)
    for h, ms, pack, b in ((10, 2, 2, bform[0]), (16, 2, 2, bform[1]),
                           (16, 3, 1, bform[1]), (16, 4, 1, bform[1])):
        inputs = pipeline.random_inputs(h + ms, b, h, device=dev)
        if ms < 4:
            # build an exactly-ms-stance gait table so the compression and
            # the kernel's selector contraction run their production shape
            offs = np.arange(4) * (h // 4)
            steps = np.arange(h)[:, None]
            dur = max(int(h * ms / 4), 1)
            tbl = (((steps - offs[None, :]) % h) < dur).astype(np.float32)
            tbl[tbl.sum(1) < 1, 0] = 1.0
            for x in range(h):
                on = np.flatnonzero(tbl[x])
                tbl[x, on[ms:]] = 0.0
            inputs = inputs.replace(gait_table=torch.as_tensor(tbl, device=dev)
                                    .expand(b, h, 4).contiguous())

        def run_form(inputs, ms=ms, pack=pack):
            adt, bdt = formation.srb_discrete(
                cfg.mpc, inputs.r_feet, inputs.rpy[:, 2], inputs.x_drag,
                cfg.dt_mpc)
            x0 = formation.build_x0(inputs.rpy, inputs.position,
                                    inputs.omega_world, inputs.v_world,
                                    cfg.mpc.gravity)
            _, _, sel = formation.stance_selectors(inputs.gait_table, ms)
            smask = torch.ones(inputs.traj.shape[:2], dtype=torch.float32, device=dev)
            return formation.qp_cost_packed(
                cfg.mpc, adt, bdt, x0, inputs.traj, smask, sel, pack)

        case(f"formation_pack.form_packed (K1) B={b} h={h} ms={ms} "
             f"pack={pack}", run_form, inputs)

    # ---- fused single-kernel ADMM solver K5 (the opt-in use_fused path) ----
    if full:
        bfa = 2048
        inputs_fa = pipeline.random_inputs(9, bfa, 10, device=dev)
        case(f"fused_admm (solve_packed use_fused, K5) B={bfa} h=10",
             lambda i: pipeline.solve_packed_batch(cfg, i, use_fused=True),
             inputs_fa)
    else:
        lines.append(
            "fused_admm.admm_mpc_fused (K5)  (skipped at small batch: covered by "
            "tests/test_torch_fused_admm.py)")

    # ---- the production pipeline entries the bench lanes call ----
    if full:
        inp10 = pipeline.random_inputs(0, 4096, 10, device=dev)
        case("pipeline.solve_packed_batch     B=4096 h=10 (flagship)",
             lambda i: pipeline.solve_packed_batch(cfg, i), inp10)
        inp16 = pipeline.random_inputs(1, 2048, 16, device=dev)
        case("pipeline.solve_packed_batch     B=2048 h=16 ms=4 (256 tile)",
             lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=4,
                                                   pack=1), inp16)
        case("pipeline.solve_packed_batch     B=2048 h=16 ms=2 pack=2",
             lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=2,
                                                   pack=2), inp16)
        case("pipeline.solve_packed_batch     B=2048 h=16 ms=3 (midband)",
             lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=3,
                                                   pack=1), inp16)
    return lines, failed
