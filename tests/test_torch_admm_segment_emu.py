"""The batched ADMM segment's CUDA source (csrc/admm_segment.cu) compiled by
g++ against the emulation headers of quadruped_ctrl_tpu_torch/probes/cpu_emu
and run on the CPU by `emulate.run_admm_segment` against
`ops/admm_segment.admm_segment_reference`, the iterate as plain ops, on the
operands that `solve_packed_batch` hands the segment: n = 120 (two scenarios
a system, the zero carry, bf16 products only), 144 (a warm carry, bf16
iterations and then fp32 ones, the inverse loaded twice) and 192 (a warm
carry, n_lo = 0), and at the widths a routed solve adds, 72 (the zero carry,
bf16), 84 (warm, fp32) and 168 (warm, both), two systems each, and on random
operands at n = 234, the largest n that fits, whose rows end in a part
float4.

Gates. x, z and y within 1e-4 of the reference's largest entry: the same
arithmetic but for the two matrix products' order of summation (measured
0 at n = 120, 72 and 84, whose products the kernel holds bit for bit;
1.1e-6, 1.5e-6 and 1.2e-6 at 192, 144 and 168; 8.2e-6 at n = 234, the
duals', where rho = 30 scales the rounding of z). At least 1e-3 from the reference at the other precision
(all fp32 products where the segment has bf16 ones, all bf16 where it has
none; measured 4.9e-3 to 9.9e-3), so a kernel that rounds the wrong
iterations fails. The padding of x, z and y exactly the reference's, and the
threads of a block as the library shapes it for each n. The route by n is
the library's own rule (`admm_segment.fits` asks it).

One case holds the kernel against the JAX package's own iterate: its
`admm_mpc_batched` (the `mk_body` scan) on the n = 192 QP, with the
factorization replaced by the inverse the segment received, a warm carry,
3 bf16 and 2 fp32 iterations (measured within 9.2e-7). This file is apart
from the other kernel tests so that it runs on a worker of its own.
"""

import dataclasses
import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu import default_config as jax_default_config
from quadruped_ctrl_tpu.solver import admm as JA
from quadruped_ctrl_tpu_torch.ops import admm_segment as AS
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """emulate.py as a module, and the segment's emulated library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    path = Path(AS.__file__).parents[1] / "probes" / "cpu_emu" / "emulate.py"
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("cpu_emu")
    mod.prepare(mod.PKG / "csrc", out)
    return mod, mod.compile_segment(out)


@pytest.fixture(scope="module")
def emulated(emu):
    mod, lib = emu
    return mod.run_admm_segment(lib)


@pytest.mark.parametrize("case,threads", [("n120_bf16", 256), ("n144_switch", 320),
                                          ("n192_fp32", 768), ("n234_ragged", 768),
                                          ("n72_bf16", 96), ("n84_fp32", 96),
                                          ("n168_switch", 768)])
def test_segment_source_runs_in_cpu_emulation(emulated, case, threads):
    r = emulated[case]
    assert r["finite"] and r["pad_exact"], r
    assert r["rel"] <= 1e-4 and r["rel_other"] >= 1e-3, r
    assert r["threads"] == threads, r


def test_route_follows_n(emu, monkeypatch):
    """`fits`, asking the (emulated) library: every n the solver forms today
    fits; 237 variables and more do not; n must be a multiple of 3."""
    monkeypatch.setattr(AS._build, "load", lambda: emu[1])
    assert all(AS.fits(n) for n in (72, 84, 120, 144, 168, 192, 234))
    assert not AS.fits(237) and not AS.fits(256) and not AS.fits(121)


def test_segment_holds_the_jax_iterate(emu, monkeypatch):
    """The emulated kernel against the JAX package's `admm_mpc_batched`
    iterate (pallas branch, one segment, no polish) on the same QP, inverse
    and warm carry: within 1e-4 of its largest entry, as against the port's
    reference."""
    mod, lib = emu
    ops = mod.segment_operands(16, 4, 1, 2)
    (inv, grad, l, u, rho, _), kw = ops["calls"][0]
    carry = ops["calls"][1][0][5]
    hess, grad_qp, gait = ops["qp"]
    n, m, bsz = kw["n"], 5 * kw["n"] // 3, grad.shape[0]
    kw = {**kw, "n_lo": 3, "n_hi": 2}
    got = mod.segment(lib, (inv, grad, l, u, rho, carry), kw)

    @dataclasses.dataclass
    class Given:
        inv_padded: object
        scale: object

    def given(*args, **kwargs):
        return Given(inv_padded=jnp.asarray(inv.numpy()), scale=jnp.ones((bsz, n), jnp.float32))

    monkeypatch.setattr(JA, "_batched_solver_fused", given)
    jcfg = jax_default_config()
    solver = dataclasses.replace(jcfg.solver, rho_adapt=0, f32_tail_iters=kw["n_hi"])
    _, want = JA.admm_mpc_batched(
        solver, jcfg.mpc, jnp.asarray(hess.numpy()), jnp.asarray(grad_qp.numpy()),
        jnp.asarray(gait.numpy()), iterations=kw["n_lo"] + kw["n_hi"], polish_rounds=0,
        use_pallas=True, warm=tuple(jnp.asarray(c[:, :w].numpy()) for c, w in
                                    zip(carry, (n, m, m))), return_warm=True)
    for g, w, width in zip(got, want, (n, m, m)):
        w = np.asarray(w)
        assert np.abs(g[:, :width].numpy() - w).max() <= 1e-4 * np.abs(w).max()
