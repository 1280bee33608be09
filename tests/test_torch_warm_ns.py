"""PyTorch port vs JAX package: the guarded warm NS K7 (`ns_inverse_warm`),
the plain NS K8 / K9 (`ns_inverse`, `ns_inverse_blocked`), their dispatcher
`make_ns_inverse` and the warm batched factorization
`_batched_solver(prev_inv=...)`, on the CPU, where the wrappers run their
`_reference` versions. The JAX kernels run in Pallas interpret mode.

Gates are the JAX kernel tests' (test_pallas_kernels.py): K8 / K9 max
|I - K X| < 5e-4; K7 row-sum residual < 5e-3. Agreement with the JAX output:
1e-4 of max |inv| for the fp32 K8 / K9, 1e-3 for the bf16x3 K7 (K6's test's
tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.ops import ns_inverse as JNI
from quadruped_ctrl_tpu.solver import admm as JA
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import formation as TF
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from quadruped_ctrl_tpu_torch.solver import admm as TA
from tests.test_torch_admm import _problem
from tests.test_torch_ns_inverse import _resid, _spd_batch
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)

JCFG = jax_default_config()
CFG = default_config()
SCFG = CFG.solver
ADMM = (SCFG.ns_admm_a0, SCFG.ns_admm_scaled_iters, SCFG.ns_quad_iters, SCFG.ns_hi_iters)
POLISH = (SCFG.ns_a0, SCFG.ns_scaled_iters, SCFG.ns_quad_iters, SCFG.ns_hi_iters)
WARM = dict(n_wquad=SCFG.ns_warm_quad, n_whi=SCFG.ns_warm_hi, guard=SCFG.ns_warm_guard)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's NS kernels in Pallas interpret mode."""
    for name in ("ns_inverse_pallas", "ns_inverse_pallas_blocked", "ns_inverse_pallas_scaled",
                 "ns_inverse_pallas_warm"):
        monkeypatch.setattr(JNI, name, functools.partial(getattr(JNI, name), interpret=True))


@pytest.mark.parametrize("kernel,n,npad", [("K8", 100, 128), ("K9", 96, 128), ("K9", 192, 256)])
def test_plain_references_match_jax_kernels(jax_interpret, kernel, n, npad):
    """K8 on one system (test_single_instance_kernel's n = 100), K9 on G
    systems (test_blocked_kernel_inverts' cases), 25 fp32 steps at cond 1e3:
    the JAX tests' residual gate (measured 1.6e-5 to 2.7e-5) and agreement
    with the JAX kernel (measured 0, 7.5e-6, 1.1e-5)."""
    ks = _spd_batch(2, NI.G, n, npad, 1e3)
    if kernel == "K8":
        ks = ks[0]
        out_t = NI.ns_inverse(torch.from_numpy(ks), 25).numpy()
        out_j = np.asarray(JNI.ns_inverse_pallas(jnp.asarray(ks), 25))
    else:
        out_t = NI.ns_inverse_blocked(torch.from_numpy(ks), 25).numpy()
        out_j = np.asarray(JNI.ns_inverse_pallas_blocked(jnp.asarray(ks), 25))
    assert out_t.shape == ks.shape
    assert _resid(ks, out_t)[0] < 5e-4
    assert _rel(out_t, out_j) < 1e-4, _rel(out_t, out_j)
    # the plain reference is K3's step loop with no scaled or bf16x3 steps
    x = NI._ns_schedule(torch.from_numpy(ks).reshape(-1, npad, npad), [], 0, 25)
    np.testing.assert_array_equal(out_t, x.reshape(ks.shape).numpy())


def _record_routes(monkeypatch):
    routes = []
    for name in ("ns_inverse", "ns_inverse_blocked"):
        real = getattr(NI, name)

        def record(ks, iters=25, _name=name, _real=real):
            routes.append((_name, tuple(ks.shape)))
            return _real(ks, iters)

        monkeypatch.setattr(NI, name, record)
    return routes


def test_make_ns_inverse_matches_jax_and_routes(jax_interpret, monkeypatch):
    """Under vmap the port's make_ns_inverse equals the JAX custom_vmap on 5
    systems, and the routes are the JAX ones: one matrix reaches ns_inverse
    (K8); torch.func.vmap over 5 reaches ns_inverse_blocked (K9) once with 8
    systems (G-padded with identities) and returns 5; a plain (5, 128, 128)
    call takes the same route."""
    ks = _spd_batch(3, 5, 100, 128, 1e3)
    out_j = np.asarray(jax.vmap(JNI.make_ns_inverse(25))(jnp.asarray(ks)))
    routes = _record_routes(monkeypatch)
    f = NI.make_ns_inverse(25)
    kt = torch.from_numpy(ks)
    out_t = torch.func.vmap(f)(kt).numpy()
    assert routes == [("ns_inverse_blocked", (8, 128, 128))]
    assert out_t.shape == (5, 128, 128) and _rel(out_t, out_j) < 1e-4, _rel(out_t, out_j)
    routes.clear()
    np.testing.assert_array_equal(f(kt).numpy(), out_t)
    assert routes == [("ns_inverse_blocked", (8, 128, 128))]
    routes.clear()
    one = f(kt[0]).numpy()
    assert routes == [("ns_inverse", (128, 128))]
    assert _rel(one, out_j[0]) < 1e-4


def _warm_case(kind: str, npad: int, n: int):
    """test_pallas_kernels.test_warm_kernel_quality_and_guard's systems (cond
    1e4, a few diagonal bumps) with the cold inverse of the unbumped systems
    as the start ("warm"), 17.0 everywhere ("garbage"), or the first half
    warm and the second garbage ("mixed"). The bumps are up to 3e-5 here
    where the JAX test has 0.3: at cond 1e4 its starts have guard residuals
    of 380-800, so every system there takes the cold branch; these have
    0.04-0.09 and pass."""
    ks = torch.from_numpy(_spd_batch(8, NI.G, n, npad, 1e4))
    cold = NI.ns_inverse_scaled_reference(ks, *POLISH)
    rng = np.random.default_rng(9)
    bump = (rng.uniform(0, 3e-5, (NI.G, npad)) * (rng.uniform(0, 1, (NI.G, npad)) < 0.05)
            * (np.arange(npad) < n)).astype(np.float32)
    ks2 = ks + torch.diag_embed(torch.from_numpy(bump))
    garbage = torch.full_like(cold, 17.0)
    init = {"warm": cold, "garbage": garbage,
            "mixed": torch.cat([cold[:NI.G // 2], garbage[NI.G // 2:]])}[kind]
    passes = {"warm": [True] * NI.G, "garbage": [False] * NI.G,
              "mixed": [True] * (NI.G // 2) + [False] * (NI.G // 2)}[kind]
    return ks2, init.contiguous(), passes


def _guard_r0(ks, init):
    """The K7 guard per system: max row sum of |I - K X0|, X0 = init, with
    the bf16x3 product."""
    k_hi, k_lo = NI._split(ks)
    eye = torch.eye(ks.shape[-1])
    return (eye - NI._mm3(k_hi, k_lo, init)).abs().sum(-1).amax(-1)


@pytest.mark.parametrize("kind", ["warm", "garbage", "mixed"])
def test_warm_reference_matches_jax_kernel(jax_interpret, kind):
    """K7's reference at the 128 tile (b = G, n = 120) against the JAX kernel
    in interpret mode, on warm starts (every system passes the guard),
    garbage (every system trips it) and half of each, a batch the JAX test
    does not cover: the JAX test's row-sum gate (measured 1.4e-3 to 1.5e-3),
    agreement to 1e-3 of max |inv| (measured 6.5e-5 warm, 1.1e-4 with
    tripped systems), and the tripped systems equal to K3's reference bit
    for bit."""
    ks, init, passes = _warm_case(kind, 128, 120)
    assert (_guard_r0(ks, init) < SCFG.ns_warm_guard).tolist() == passes
    out_t = NI.ns_inverse_warm(ks, init, *POLISH, **WARM).numpy()
    out_j = np.asarray(JNI.ns_inverse_pallas_warm(jnp.asarray(ks.numpy()),
                                                  jnp.asarray(init.numpy()), *POLISH, **WARM))
    assert _resid(ks.numpy(), out_t)[1] < 5e-3
    assert _rel(out_t, out_j) < 1e-3, _rel(out_t, out_j)
    cold = NI.ns_inverse_scaled_reference(ks, *POLISH).numpy()
    tripped = ~np.array(passes)
    np.testing.assert_array_equal(out_t[tripped], cold[tripped])
    assert tripped.all() or not np.array_equal(out_t[~tripped], cold[~tripped])


def test_warm_reference_at_256_tile():
    """K7's reference at the 256 tile (n = 192) on the mixed batch: the JAX
    test's row-sum gate, the guard pattern, and the tripped half equal to
    K3's reference bit for bit (no JAX run at 256: interpret mode there
    costs minutes)."""
    ks, init, passes = _warm_case("mixed", 256, 192)
    assert (_guard_r0(ks, init) < SCFG.ns_warm_guard).tolist() == passes
    out = NI.ns_inverse_warm(ks, init, *POLISH, **WARM).numpy()
    assert _resid(ks.numpy(), out)[1] < 5e-3
    cold = NI.ns_inverse_scaled_reference(ks, *POLISH).numpy()
    half = NI.G // 2
    np.testing.assert_array_equal(out[half:], cold[half:])
    assert not np.array_equal(out[:half], cold[:half])


def _admm_k(hess, gait, scale):
    """admm_mpc_batched's ADMM-phase K = hess_n + sigma I + blockdiag3(gram)
    at rho x scale, for the packed problem (hess, gait)."""
    b, n = hess.shape[0], hess.shape[-1]
    h, nf = gait.shape[1:]
    f = float(CFG.mpc.f_max)
    u = torch.cat([torch.full((b, h, nf, 4), CFG.mpc.big_number), (gait * 1.0)[..., None]],
                  dim=-1).reshape(b, -1)
    rho = TA.constraint_rho(SCFG, torch.zeros_like(u), u) * scale
    gram = TF.pyramid_gram(CFG.mpc, rho.reshape(b, h, nf, 5)).reshape(b, h * nf, 3, 3)
    sel = torch.eye(h * nf)
    delta = (gram[:, :, :, None, :] * sel[None, :, None, :, None]).reshape(b, n, n)
    return (hess * (f * f) + SCFG.sigma * torch.eye(n)[None] + delta).numpy()


@pytest.mark.parametrize("scale,warm", [(1.2, True), (3.0, False)])
def test_warm_batched_solver_matches_jax(jax_interpret, monkeypatch, scale, warm):
    """_batched_solver(prev_inv=...) on the kernel branch (K7's reference)
    against the JAX Pallas branch in interpret mode: the ADMM-phase K of an
    h=4 packed problem (b = 6 systems, so the batch and the start are
    G-padded with identities) at rho, factorized cold, then at `scale` rho
    seeded from it, as an adaptive-rho refactorization would be. Both
    packages get the same K and the same previous inverse and scale (the
    JAX cold solver's). At 1.2 rho every start passes the guard (residuals
    0.25-0.27), at 3 rho every one trips it (2.5-2.7) and the cold schedule
    runs. The solves agree to 1e-4 relative (measured 2.1e-7 and 1.7e-7);
    the port routes the warm factorization to ns_inverse_warm."""
    hess, _, gait, _ = (np.array(a) for a in _problem(4, 12, 2, 6))
    k1, k3 = (_admm_k(torch.from_numpy(hess), torch.from_numpy(gait), s) for s in (1.0, scale))
    s1 = JA._batched_solver(jnp.asarray(k1), JCFG.solver, True, schedule=ADMM)
    s3_j = JA._batched_solver(jnp.asarray(k3), JCFG.solver, True, schedule=ADMM,
                              prev_inv=s1.inv_padded, prev_scale=s1.scale)
    calls = []
    real = NI.ns_inverse_warm

    def record(ksp, init, *args, **kw):
        calls.append((tuple(ksp.shape), bool((_guard_r0(ksp, init) < kw["guard"]).all())))
        return real(ksp, init, *args, **kw)

    monkeypatch.setattr(NI, "ns_inverse_warm", record)
    s3_t = TA._batched_solver(torch.from_numpy(k3), SCFG, True, schedule=ADMM,
                              prev_inv=torch.tensor(np.asarray(s1.inv_padded)),
                              prev_scale=torch.tensor(np.asarray(s1.scale)))
    assert calls == [((8, 128, 128), warm)]
    rhs = np.random.default_rng(1).normal(size=(6, 48)).astype(np.float32)
    x_j = np.asarray(s3_j(jnp.asarray(rhs)))
    x_t = s3_t(torch.from_numpy(rhs)).numpy()
    assert _rel(x_t, x_j) < 1e-4, _rel(x_t, x_j)
    assert s3_t.inv_padded.shape == (6, 128, 128)


def test_wrappers_route_cpu_to_reference_and_check_inputs():
    ks = torch.from_numpy(_spd_batch(6, 3, 120, 128, 100.0))
    for fn in (NI.ns_inverse, NI.ns_inverse_blocked, NI.ns_inverse_warm):
        fn.launches = 0
    assert torch.equal(NI.ns_inverse(ks[0]), NI.ns_inverse_reference(ks[0]))
    assert torch.equal(NI.ns_inverse_blocked(ks, 10), NI.ns_inverse_blocked_reference(ks, 10))
    assert torch.equal(NI.ns_inverse_warm(ks, ks, *ADMM), NI.ns_inverse_warm_reference(ks, ks,
                                                                                       *ADMM))
    assert NI.ns_inverse.launches == NI.ns_inverse_blocked.launches == 0
    assert NI.ns_inverse_warm.launches == 0
    with pytest.raises(ValueError):
        NI.ns_inverse(ks)                                                # one system only
    with pytest.raises(ValueError):
        NI.ns_inverse(ks[0, :120, :120].contiguous())                    # not a tile
    with pytest.raises(TypeError):
        NI.ns_inverse_blocked(ks.double())
    with pytest.raises(ValueError):
        NI.ns_inverse_blocked(ks[0])                                     # not a batch
    with pytest.raises(ValueError):
        NI.ns_inverse_warm(ks, ks[:2].contiguous())                      # batch mismatch
    with pytest.raises(ValueError):
        NI.ns_inverse_warm(ks, ks.transpose(1, 2))                       # not contiguous
    with pytest.raises(ValueError):
        NI.ns_inverse_warm(ks, ks, n_scaled=17)                          # mu table length
