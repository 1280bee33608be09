"""PyTorch port vs JAX package: the factorization kernels' references (K2
`ns_inverse_scaled_build`, K3 `ns_inverse_scaled`, K6 `ns_inverse_refine`)
at the 128 and 256 tiles, the Schur split K4 (`ns_inverse_schur_scaled`) and
their wrappers, on the CPU; the kernels' order of summation on the tensor
cores, and their CUDA source itself under a CPU emulation.

Residual gates are the JAX kernel tests' (test_pallas_kernels.py): ADMM
schedule at cond 2.1e3 max |I - KX| < 1e-2; polish schedule row-sum residual
< 5e-3 at cond 1e4 and < 5e-2 at cond 1e5; the Schur split row-sum residual
< 5e-3 and error against the f64 inverse < 1e-2.
"""

import functools
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.mpc import formation as JF
from quadruped_ctrl_tpu.ops import ns_inverse as JNI
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


SCFG = default_config().solver
ADMM = (SCFG.ns_admm_a0, SCFG.ns_admm_scaled_iters, SCFG.ns_quad_iters, SCFG.ns_hi_iters)
POLISH = (SCFG.ns_a0, SCFG.ns_scaled_iters, SCFG.ns_quad_iters, SCFG.ns_hi_iters)


def _spd_batch(seed, b, n, npad, cond):
    """Jacobi-scaled random SPD matrices of condition ~cond, identity-padded
    (numpy; the construction of test_pallas_kernels._spd_batch)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, npad, npad), np.float32)
    for i in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = np.logspace(0.0, -np.log10(cond), n)
        k = (q * ev[None, :]) @ q.T
        d = 1.0 / np.sqrt(np.diagonal(k))
        out[i, :n, :n] = k * d[:, None] * d[None, :]
        out[i, n:, n:] = np.eye(npad - n)
    return out


def _resid(ks, inv):
    r = np.eye(ks.shape[-1]) - ks.astype(np.float64) @ inv.astype(np.float64)
    return np.abs(r).max(), np.abs(r).sum(-1).max()


def test_tiles_padding_and_schedule_match_jax():
    assert (NI.N, NI.N_BIG, NI.G) == (JNI.N, JNI.N_BIG, JNI.G)
    for n in (1, 100, 128, 129, 256):
        assert NI.pad_sizes(n) == JNI.pad_sizes(n)
    with pytest.raises(ValueError):
        NI.pad_sizes(257)
    k = np.random.default_rng(0).normal(size=(2, 10, 10)).astype(np.float32)
    np.testing.assert_array_equal(NI.pad_to(torch.from_numpy(k), 10).numpy(),
                                  np.asarray(JNI.pad_to(jnp.asarray(k), 10)))
    for a0, n in ((SCFG.ns_a0, SCFG.ns_scaled_iters), (SCFG.ns_admm_a0, 6), (0.3, 3)):
        assert NI.mu_schedule(a0, n) == JNI.mu_schedule(a0, n)


@pytest.mark.parametrize("cond,sched,metric,gate", [
    (2.1e3, ADMM, 0, 1e-2),      # the ADMM schedule, 10x the worst ADMM cond
    (1e4, POLISH, 1, 5e-3),      # the polish schedule at polish conditioning
    (1e5, POLISH, 1, 5e-2),
])
def test_scaled_reference_residual(cond, sched, metric, gate):
    ks = _spd_batch(3, 8, 120, 128, cond)
    inv = NI.ns_inverse_scaled(torch.from_numpy(ks), *sched).numpy()
    assert _resid(ks, inv)[metric] < gate


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value, ties away from zero (cvt.rna.tf32.f32)."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tc_mm(a: torch.Tensor, b: torch.Tensor, bf16x3: bool, slab: int | None = None,
           run: int = 16) -> torch.Tensor:
    """a @ b (B, npad, npad) summed as the kernels sum it. The rows fall in
    slabs of `slab` rows, and each slab takes k in runs of `run`, starting at
    its own rows of k and walking the others in turn. By default the K3
    kernels' order: at the 256 tile csrc/ns_refine.cu's rf_product (slabs of
    64, one a CTA, runs of 16: a bf16x3 stage, two 3xTF32 stages of 8), at
    the 128 tile csrc/ns_core.cuh's mm_tile (one slab of 128). The plain NS
    of csrc/ns_plain.cu (K8, K9/256) sums its blocks' rows
    in slabs of 64 at both tiles (a cluster row of CTAs shares its rows'
    order), runs of 16. bf16x3: per 16 k the three bf16 passes hi*hi, hi*lo,
    lo*hi, each a 16-term sum added in turn to one fp32 accumulator (an
    m16n8k16 mma). Otherwise (fp32) 3xTF32: per 8 k the passes of tf32 parts
    (m16n8k8 mma.sync, or wgmma k8) into a run's fresh sum, which one fp32
    add takes into the accumulator."""
    if bf16x3:
        (ah, al), (bh, bl) = ([t.float() for t in NI._split(x)] for x in (a, b))
    else:
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
    passes = ((ah, bh), (ah, bl), (al, bh))
    step = 16 if bf16x3 else 8
    npad = a.shape[-1]
    if slab is None:
        slab = 64 if npad == NI.N_BIG else npad
    out = torch.empty_like(a)
    for q in range(npad // slab):
        rows = slice(slab * q, slab * q + slab)
        acc = torch.zeros_like(a[:, rows])
        for c in range(npad // run):
            k0 = (slab * q + run * c) % npad
            part = acc if bf16x3 else torch.zeros_like(acc)
            for kc in range(k0, k0 + run, step):
                for pa, pb in passes:
                    part = part + pa[:, rows, kc:kc + step] @ pb[:, kc:kc + step]
            acc = part if bf16x3 else acc + part
        out[:, rows] = acc
    return out


def _tc_schedule(ks, a0, n_scaled, n_quad, n_hi, slab=None, run=16):
    """The NS schedule of ns_inverse_scaled_reference with _tc_mm's sums
    (the fp32 steps' in slabs of `slab` rows, runs of `run`)."""
    eye = torch.eye(ks.shape[-1])
    x = (1.0 / ks.abs().sum(-1).amax(-1))[:, None, None] * eye
    for mu in NI.mu_schedule(a0, n_scaled) + [1.0] * n_quad:
        x = mu * _tc_mm(x, 2.0 * eye - mu * _tc_mm(ks, x, True), True)
    for _ in range(n_hi):
        x = _tc_mm(x, 2.0 * eye - _tc_mm(ks, x, False, slab, run), False, slab, run)
    return x


@pytest.mark.parametrize("n", [192, 144, 120])
@pytest.mark.parametrize("cond,sched,metric,gate", [
    (2.1e3, ADMM, 0, 1e-2),
    (1e4, POLISH, 1, 5e-3),
])
def test_tensor_core_summation_order_holds_the_gates(cond, sched, metric, gate, n):
    """The kernels' order of summation on the tensor cores (bf16x3 mmas over
    k-chunks of 16, the tail in 3xTF32 with one fp32 add per chunk) on SPD
    n = 192 and 144 at the 256 tile and n = 120 at the 128 tile, b = 8: the
    residual gates of test_scaled_reference_residual and within 2x of the
    reference's (chip_smoke.py's rule)."""
    ks = _spd_batch(3, 8, n, NI.pad_sizes(n), cond)
    ref = NI.ns_inverse_scaled_reference(torch.from_numpy(ks), *sched).numpy()
    tc = _tc_schedule(torch.from_numpy(ks), *sched).numpy()
    r_tc, r_ref = _resid(ks, tc)[metric], _resid(ks, ref)[metric]
    assert r_tc < gate and r_ref < gate and r_tc <= 2 * r_ref + 1e-5, (r_tc, r_ref)


@pytest.mark.parametrize("n", [192, 120])
@pytest.mark.parametrize("order", ["k3_tail", "ns_plain"])
def test_tensor_core_plain_schedule_holds_the_gate(order, n):
    """K8/K9's schedule (X0 = I / ||K||_inf, 25 fp32 steps) summed as the
    kernels sum it, on SPD n = 192 (256 tile) and n = 120 (128 tile) at cond
    1e3, b = 8: as K3's kernels sum their 3xTF32 tail (K9 at 128), and as
    csrc/ns_plain.cu's wgmma product does (K8 at both tiles, K9 at 256:
    slabs of 64 rows walking k from their own rows, runs of 16 k a fresh
    accumulator; at 256 the same order as K3's): chip_smoke.py's K9 gate
    (max |I - K X| < 5e-4) and within 2x of the reference's."""
    ks = _spd_batch(9, 8, n, NI.pad_sizes(n), 1e3)
    ref = NI.ns_inverse_blocked_reference(torch.from_numpy(ks), 25).numpy()
    slab = 64 if order == "ns_plain" else None
    tc = _tc_schedule(torch.from_numpy(ks), 0.0, 0, 0, 25, slab, 16).numpy()
    r_tc, r_ref = _resid(ks, tc)[0], _resid(ks, ref)[0]
    assert r_tc < 5e-4 and r_ref < 5e-4 and r_tc <= 2 * r_ref + 1e-5, (r_tc, r_ref)


def test_kernel_sources_run_in_cpu_emulation(tmp_path):
    """The 128-tile kernels' CUDA source (csrc/ns_inverse.cu on ns_core.cuh
    and mma.cuh; K7's guard and warm branch in csrc/ns_refine.cu, built into
    one library with them) compiled by g++
    against the emulation headers of quadruped_ctrl_tpu_torch/probes/cpu_emu
    (each CUDA thread a fiber on the calling thread; mma.sync, ldmatrix and
    wgmma on their PTX fragment layouts) and run on b = 2 systems against
    the references: every csrc/*.cu belongs to an emulated library that a
    test builds (a new source with none raises); K3's and K2's residuals
    under the gates above and within 2x of the reference's, their inverses
    within 1e-3 relative (measured <= 7.6e-5); K2's ks and d_row within 1e-6
    (measured 0); K7's tripped system equal to K3 bit for bit; ldmatrix free
    of bank conflicts (1 wavefront a matrix). K6 and K9 at this tile are
    test_torch_refine_emu.py's and test_torch_warm_plain_emu.py's, under the
    same gates."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    path = Path(NI.__file__).parents[1] / "probes" / "cpu_emu" / "emulate.py"
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", path)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    emu.prepare(emu.PKG / "csrc", tmp_path)
    emu.check_sources(tmp_path)
    stray = tmp_path / "stray"
    stray.mkdir()
    (stray / "new_kernel.cu").touch()
    with pytest.raises(RuntimeError, match="new_kernel.cu"):
        emu.check_sources(stray)
    out = emu.run(emu.compile_ns(tmp_path))
    assert all(v["rc"] == 0 for k, v in out.items() if isinstance(v, dict)), out
    for name, gate in (("k3_admm", 1e-2), ("k3_polish", 5e-3), ("k2", 1e-2)):
        r = out[name]
        assert r["residual"] < gate and r["residual"] <= 2 * r["reference"] + 1e-5, (name, r)
        assert r.get("rel", 0.0) < 1e-3, (name, r)
    assert out["k2"]["rel_ks"] <= 1e-6 and out["k2"]["rel_d"] <= 1e-6, out["k2"]
    assert out["k7"]["tripped_is_k3"] and out["k7"]["rel_warm"] < 1e-3, out["k7"]
    assert out["ldmatrix_wavefronts"] == 1.0, out


def _build_operands(seed, b, hv, nf, npad):
    """(hp, g9, k, n): a random SPD hess_n + sigma I padded to npad, the gram
    blocks of random pyramid weights from JAX's pyramid_gram, and the
    assembled K = hess_n + sigma I + blockdiag3(gram) at the logical n (the
    construction of test_pallas_kernels.test_fused_kbuild_matches_xla_assembly)."""
    jcfg = jax_default_config()
    n = 3 * nf * hv
    rng = np.random.default_rng(seed)
    m0 = rng.uniform(-1, 1, (b, n, n)).astype(np.float32)
    hess_n = (np.einsum("bij,bkj->bik", m0, m0) * 0.05 + 3.0 * np.eye(n)).astype(np.float32)
    w = (np.abs(rng.normal(size=(b, hv * nf * 5))) * 30.0).astype(np.float32)
    gram = np.asarray(JF.pyramid_gram(jcfg.mpc, w.reshape(b, hv, nf, 5)))
    g9 = np.ascontiguousarray(gram.reshape(b, hv * nf, 9).transpose(0, 2, 1))
    hs = hess_n + SCFG.sigma * np.eye(n, dtype=np.float32)
    hp = np.asarray(JNI.pad_to(jnp.asarray(hs), n, npad))
    g4 = gram.reshape(b, hv * nf, 3, 3)
    delta = np.zeros((b, n, n), np.float32)
    for blk in range(hv * nf):
        delta[:, 3 * blk:3 * blk + 3, 3 * blk:3 * blk + 3] = g4[:, blk]
    return hp, g9, hs + delta, n


def test_build_reference_matches_jax_kernel():
    """K2's reference vs the JAX Pallas kernel in interpret mode, on gram
    blocks from pyramid_gram: the K build and Jacobi scale (ks, d_row) to
    1e-6 relative, the inverse to 1e-3 relative (measured 2.8e-7)."""
    hp, g9, _, _ = _build_operands(5, 8, 20, 2, 128)
    kernel = jax.jit(functools.partial(JNI.ns_inverse_pallas_scaled_build, interpret=True),
                     static_argnums=(2, 3, 4, 5))
    inv_j, ks_j, d_j = (np.asarray(a) for a in kernel(hp, g9, *POLISH))
    inv_t, ks_t, d_t = (a.numpy() for a in NI.ns_inverse_scaled_build(
        torch.from_numpy(hp.copy()), torch.from_numpy(g9), *POLISH))

    def rel(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    assert rel(ks_t, ks_j) <= 1e-6 and rel(d_t, d_j) <= 1e-6, (rel(ks_t, ks_j), rel(d_t, d_j))
    assert rel(inv_t, inv_j) < 1e-3, rel(inv_t, inv_j)
    # the build is K3 on the built ks, exactly
    inv3 = NI.ns_inverse_scaled(torch.from_numpy(ks_t), *POLISH).numpy()
    np.testing.assert_array_equal(inv3, inv_t)


@pytest.mark.parametrize("hv,nf", [(24, 2), (32, 2)])     # n = 144, 192
def test_references_at_256_tile_match_jax_kernels(hv, nf):
    """K2's and K3's references at the 256 tile (b = 8) against the JAX
    Pallas kernels in interpret mode, ADMM schedule. Within the port, as
    test_pallas_kernels.test_fused_kbuild_matches_xla_assembly holds the JAX
    kernels: K2's d_row equals the two-step Jacobi scale exactly, K2's
    inverse is within 1e-6 of K3 on the two-step ks, and ks is None at 256.
    Against JAX: d_row to 1e-6 relative (measured 1.5e-8), the inverses to
    1e-3 relative as at the 128 tile (measured <= 6.0e-7)."""
    hp, g9, k, n = _build_operands(7, NI.G, hv, nf, 256)
    inv_t, ks_t, d_t = (None if a is None else a.numpy() for a in NI.ns_inverse_scaled_build(
        torch.from_numpy(hp.copy()), torch.from_numpy(g9), *ADMM))
    assert ks_t is None and inv_t.shape == (NI.G, 256, 256) and d_t.shape == (NI.G, 1, 256)
    kt = torch.from_numpy(k)
    d2 = torch.rsqrt(torch.clamp(torch.diagonal(kt, dim1=-2, dim2=-1), min=1e-30))
    ks2 = NI.pad_to(kt * d2[:, :, None] * d2[:, None, :], n, 256)
    inv2 = NI.ns_inverse_scaled(ks2, *ADMM).numpy()
    np.testing.assert_array_equal(d_t[:, 0, :n], d2.numpy())
    assert np.abs(inv_t - inv2).max() < 1e-6

    build = jax.jit(functools.partial(JNI.ns_inverse_pallas_scaled_build, interpret=True),
                    static_argnums=(2, 3, 4, 5))
    inv_j, ks_j, d_j = build(hp, g9, *ADMM)
    scaled = jax.jit(functools.partial(JNI.ns_inverse_pallas_scaled, interpret=True),
                     static_argnums=(1, 2, 3, 4))
    inv3_j = np.asarray(scaled(ks2.numpy(), *ADMM))

    def rel(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    assert ks_j is None
    assert rel(d_t, np.asarray(d_j)) <= 1e-6, rel(d_t, np.asarray(d_j))
    assert rel(inv_t, np.asarray(inv_j)) < 1e-3, rel(inv_t, np.asarray(inv_j))
    assert rel(inv2, inv3_j) < 1e-3, rel(inv2, inv3_j)


@pytest.mark.parametrize("n,cond", [(144, 213.0), (192, 1e3)])
def test_schur_split_matches_jax(n, cond):
    """K4 at the ADMM schedule of the JAX test (5e-4, 6, 2, 1) on
    b = 2G + 3 systems (the A block G-padded), against the JAX function with
    its K3 in interpret mode: the JAX test's residual and f64 gates
    (measured 6.3e-5 / 4.9e-6 at n=144, 1.8e-3 / 1.0e-5 at n=192), and
    agreement with the JAX output to 1e-4 relative (measured <= 1.6e-5)."""
    b = 2 * NI.G + 3
    ks = _spd_batch(11, b, n, n, cond)
    x_t = NI.ns_inverse_schur_scaled(torch.from_numpy(ks), 5e-4, 6, 2, 1).numpy()
    x_j = np.asarray(JNI.ns_inverse_schur_scaled(jnp.asarray(ks), 5e-4, 6, 2, 1,
                                                 interpret=True))
    x64 = x_t.astype(np.float64)
    ks64 = ks.astype(np.float64)
    assert x_t.shape == (b, n, n)
    assert np.abs(np.eye(n) - ks64 @ x64).sum(-1).max() < 5e-3
    assert np.abs(x64 - np.linalg.inv(ks64)).max() / np.abs(x64).max() < 1e-2
    agree = np.abs(x_t - x_j).max() / np.abs(x_j).max()
    assert agree < 1e-4, agree
    with pytest.raises(ValueError):
        NI.ns_inverse_schur_scaled(torch.from_numpy(ks[:, :128, :128].copy()))


def test_build_reference_at_256_tile_skips_ks():
    hp = torch.from_numpy(_spd_batch(4, 2, 150, 256, 10.0))
    g9 = torch.zeros((2, 9, 50))
    inv, ks, d = NI.ns_inverse_scaled_build(hp, g9, *ADMM)
    assert ks is None and inv.shape == (2, 256, 256) and d.shape == (2, 1, 256)
    assert _resid(hp.numpy(), inv.numpy())[0] < 1e-2


def test_wrappers_route_cpu_to_reference_and_check_inputs():
    ks = torch.from_numpy(_spd_batch(6, 3, 120, 128, 100.0))
    NI.ns_inverse_scaled.launches = 0
    NI.ns_inverse_scaled_build.launches = 0
    assert torch.equal(NI.ns_inverse_scaled(ks, *ADMM),
                       NI.ns_inverse_scaled_reference(ks, *ADMM))
    g9 = torch.zeros((3, 9, 40))
    for a, r in zip(NI.ns_inverse_scaled_build(ks, g9, *ADMM),
                    NI.ns_inverse_scaled_build_reference(ks, g9, *ADMM)):
        assert torch.equal(a, r)
    assert NI.ns_inverse_scaled.launches == 0
    assert NI.ns_inverse_scaled_build.launches == 0
    with pytest.raises(TypeError):
        NI.ns_inverse_scaled(ks.double())
    with pytest.raises(ValueError):
        NI.ns_inverse_scaled(ks[:, :120, :120].contiguous())     # not a tile
    with pytest.raises(ValueError):
        NI.ns_inverse_scaled(ks[:, :, :64])                      # not square
    with pytest.raises(ValueError):
        NI.ns_inverse_scaled(ks.transpose(1, 2))                 # not contiguous
    with pytest.raises(ValueError):
        NI.ns_inverse_scaled_build(ks, torch.zeros((2, 9, 40)))   # batch mismatch
    with pytest.raises(ValueError):
        NI.ns_inverse_scaled_build(ks, torch.zeros((3, 9, 50)))   # too many blocks
    with pytest.raises(ValueError):
        NI.ns_inverse_scaled(ks, n_scaled=17)                    # mu table length


def _warm_init(ks, seed=1, size=0.05):
    """test_pallas_kernels.test_refine_kernel_from_warm_init's start: the
    exact inverse right-multiplied by (I + E), ||E||_2 = size, so that the NS
    residual ||I - ks init|| is ~size by construction."""
    ks64 = ks.astype(np.float64)
    b, npad = ks.shape[0], ks.shape[-1]
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((b, npad, npad))
    e *= size / np.linalg.norm(e, ord=2, axis=(-2, -1), keepdims=True)
    init = np.linalg.inv(ks64) @ (np.eye(npad) + e)
    r0 = np.abs(ks64 @ init - np.eye(npad)).sum(-1).max()
    return init.astype(np.float32), r0


@pytest.mark.parametrize("n,npad", [(96, 128), (192, 256)])
def test_refine_reference_matches_jax_kernel(n, npad):
    """K6's reference at both tiles (b = G) against the JAX kernel in
    interpret mode, on the JAX test's construction (cond 1e4, ||E||_2 =
    0.05; row-sum r0 0.28 at 128, 0.38 at 256), n_quad = n_hi = 1: the JAX
    test's gates (row-sum residual < 5e-3 and < 0.1 r0; measured 1.4e-3 and
    2.3e-3, JAX 1.4e-3 and 2.4e-3) and agreement with the JAX output to 1e-3
    relative (measured 8.9e-5 and 6.7e-5)."""
    ks = _spd_batch(7, NI.G, n, npad, 1e4)
    init, r0 = _warm_init(ks)
    assert 0.01 < r0 < 0.5, r0
    out_t = NI.ns_inverse_refine(torch.from_numpy(ks), torch.from_numpy(init), 1, 1).numpy()
    out_j = np.asarray(JNI.ns_inverse_pallas_refine(jnp.asarray(ks), jnp.asarray(init), 1, 1,
                                                    interpret=True))
    resid = _resid(ks, out_t)[1]
    assert resid < 5e-3 and resid < 0.1 * r0, (resid, r0)
    agree = np.abs(out_t - out_j).max() / np.abs(out_j).max()
    assert agree < 1e-3, agree
    # the reference is the quadratic steps of K3's schedule from init
    np.testing.assert_array_equal(
        out_t, NI._ns_steps(torch.from_numpy(ks), torch.from_numpy(init), [], 1, 1).numpy())


def test_refine_wrapper_routes_cpu_to_reference_and_checks_inputs():
    ks = torch.from_numpy(_spd_batch(6, 3, 120, 128, 100.0))
    init = torch.eye(128).expand(3, 128, 128).contiguous()
    NI.ns_inverse_refine.launches = 0
    assert torch.equal(NI.ns_inverse_refine(ks, init, 2, 1),
                       NI.ns_inverse_refine_reference(ks, init, 2, 1))
    assert NI.ns_inverse_refine.launches == 0
    with pytest.raises(TypeError):
        NI.ns_inverse_refine(ks, init.double())
    with pytest.raises(ValueError):
        NI.ns_inverse_refine(ks, init[:2].contiguous())                  # batch mismatch
    with pytest.raises(ValueError):
        NI.ns_inverse_refine(ks[:, :120, :120].contiguous(),
                             init[:, :120, :120].contiguous())           # not a tile
    with pytest.raises(ValueError):
        NI.ns_inverse_refine(ks, init.transpose(1, 2))                   # not contiguous
