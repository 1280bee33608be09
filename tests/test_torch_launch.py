"""The kernel wrappers' 16-byte alignment (`ops/_launch.aligned`).

The kernels read their inputs 16 bytes at a time (float4 loads, 16-byte
cp.async), so a contiguous float32 view that starts 4 bytes into its storage
would fault on the card. Every wrapper hands its kernel `aligned(t)`: t
itself when it starts on a 16-byte boundary, else a contiguous copy, which
the allocator aligns. The JAX functions take any array, and so does the
port: K1 and K5 used to raise a ValueError there. On the CPU the wrappers
run their references; chip_smoke.py holds each wrapper's offset call to its
aligned call on the card, bit for bit.
"""

import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import formation, pipeline
from quadruped_ctrl_tpu_torch.ops import _launch
from quadruped_ctrl_tpu_torch.ops import formation_pack as FP
from quadruped_ctrl_tpu_torch.ops import fused_admm as FA
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts 4 bytes into its storage."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _spd(seed: int, b: int, n: int, npad: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    out = np.zeros((b, npad, npad), np.float32)
    for i in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        k = (q * np.logspace(0, -2, n)[None]) @ q.T
        d = 1 / np.sqrt(np.diagonal(k))
        out[i, :n, :n] = k * d[:, None] * d[None]
        out[i, n:, n:] = np.eye(npad - n)
    return torch.from_numpy(out)


def test_aligned_copies_an_offset_view():
    t = offset_view(torch.randn(2, 128, 128, generator=torch.Generator().manual_seed(0)))
    a = _launch.aligned(t)
    assert a is not t and a.data_ptr() % 16 == 0 and a.is_contiguous()
    assert a.shape == t.shape and torch.equal(a, t)


def test_aligned_returns_an_aligned_tensor_itself():
    t = torch.randn(2, 128, 128)
    assert t.data_ptr() % 16 == 0 and _launch.aligned(t) is t


def _warm_start(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    ks = _spd(seed, 2, 60, 128)
    return ks, torch.linalg.inv(ks).contiguous()


def _k1_operands():
    cfg = default_config()
    h, ms, b = 4, 2, 2
    inp = pipeline.random_inputs(0, b, h, device="cpu")
    adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag, cfg.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            cfg.mpc.gravity)
    _, _, sel = formation.stance_selectors(inp.gait_table, ms)
    ops = formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj, torch.ones((b, h)), sel)
    return ops, (h, ms, 2, float(cfg.mpc.alpha))


def _k5_operands():
    rng = np.random.default_rng(3)
    b = 2
    a = np.zeros((FA.M, FA.N), np.float32)
    a[:40, :20] = rng.standard_normal((40, 20))
    hess = np.tile(np.eye(FA.N, dtype=np.float32), (b, 1, 1))
    hess[:, :20, :20] += 0.1 * np.eye(20, dtype=np.float32)
    grad = np.zeros((b, FA.N), np.float32)
    grad[:, :20] = rng.standard_normal((b, 20))
    lo = np.zeros((b, FA.M), np.float32)
    lo[:, :40] = -1.0
    hi = -lo
    rho = np.ones((b, FA.M), np.float32)
    return tuple(map(torch.from_numpy, (a, hess, grad, lo, hi, rho)))


# (wrapper, operands, other arguments): each call at 128 on small batches
CASES = {
    "K1": lambda: (FP.form_packed, *_k1_operands()),
    "K2": lambda: (NI.ns_inverse_scaled_build, (_spd(1, 2, 60, 128) * 2.0,
                                                torch.zeros((2, 9, 20))), (5e-4, 2, 1, 1)),
    "K3": lambda: (NI.ns_inverse_scaled, (_spd(2, 2, 60, 128),), (5e-4, 2, 1, 1)),
    "K5": lambda: (lambda *t: FA.fused_admm_solve(*t, n_iter=3, polish_rounds=1),
                   _k5_operands(), ()),
    "K6": lambda: (NI.ns_inverse_refine, _warm_start(3), (1, 1)),
    "K7": lambda: (NI.ns_inverse_warm, _warm_start(4), (5e-4, 1, 1, 1, 2, 1)),
    "K8": lambda: (NI.ns_inverse, (_spd(5, 1, 60, 128)[0],), (5,)),
    "K9": lambda: (NI.ns_inverse_blocked, (_spd(6, 2, 60, 128),), (5,)),
}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_wrapper_takes_an_offset_view(kernel):
    """Each wrapper on offset views of its tensor operands returns what it
    returns on the aligned operands (K1 and K5 no longer raise)."""
    fn, ops, args = CASES[kernel]()
    want = fn(*ops, *args)
    got = fn(*map(offset_view, ops), *args)
    for w, g in zip(*(x if isinstance(x, tuple) else (x,) for x in (want, got))):
        assert (w is None and g is None) or torch.equal(w, g), kernel
