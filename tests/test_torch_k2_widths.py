"""K2 at the 256 tile on the card at both widths (`csrc/ns_refine.cu`): a
system of at most 192 variables runs on `ns_refine_kernel<192, 4>`, 3-CTA
clusters over the tile's leading 192 rows and columns, which write the
tile's pad themselves; a larger one on `ns_refine_kernel<256, 4>`, 4-CTA
clusters over all 256. On 2048 systems, through the wrapper
(`ops/ns_inverse.ns_inverse_scaled_build`) and the solver's fused
factorization (`solver/admm._batched_solver_fused`), the 3-CTA instance's
inv and d_row equal bit for bit, over the whole tile, the 4-CTA instance's
on the same K (g9 zero-extended to 80 blocks, which adds zero blocks to
hp's identity pad). The `card` tests skip without a card. This file
imports no JAX, so they run where JAX is absent:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_k2_widths.py

The 3-CTA instance reads only hp's diagonal beyond 3 nblk: hp has to be
diagonal there, a rule of the wrapper's callers that nothing checks on the
card. The CPU tests hold the reference to it (on such an hp its inverse is
the same scalar on the pad's diagonal and zero elsewhere in the pad's rows
and columns, which is what the instance writes) and the solver's calls to it
(every hp it hands K2 is diagonal beyond its 3 nblk variables).
"""

import pytest
import torch

from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import pipeline
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from quadruped_ctrl_tpu_torch.solver import admm

CFG = default_config().solver
ADMM = (CFG.ns_admm_a0, CFG.ns_admm_scaled_iters, CFG.ns_quad_iters, CFG.ns_hi_iters)
POLISH = (CFG.ns_a0, CFG.ns_scaled_iters, CFG.ns_quad_iters, CFG.ns_hi_iters)
B, WIDE = 2048, 80


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """`tests/test_torch_package.py`'s fixture of the same name (torch's CPU
    ops on one thread), defined here: where another installed top-level
    `tests` package hides this directory from an import, the card's tests
    still run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on one")
    return torch.device("cuda", 0)


def operands(nblk: int, dev, seed: int = 22, b: int = B):
    """(hp, g9) of b systems of n = 3 nblk variables as the solver forms
    them: hp = 3 x SPD (cond 1e3), the identity beyond n; g9 (b, 9, nblk)
    symmetric positive 3 x 3 blocks, component-major."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = 3 * nblk
    q, _ = torch.linalg.qr(torch.randn(b, n, n, generator=gen, device=dev))
    hp = torch.eye(NI.N_BIG, device=dev).repeat(b, 1, 1)
    hp[:, :n, :n] = 3.0 * (q * torch.logspace(0, -3, n, device=dev)) @ q.transpose(1, 2)
    a = 0.5 * torch.rand(b, nblk, 3, 3, generator=gen, device=dev)
    g9 = (a @ a.transpose(-1, -2) + torch.eye(3, device=dev)).reshape(b, nblk, 9)
    return hp, g9.transpose(1, 2).contiguous()


def widened(g9):
    wide = torch.zeros((g9.shape[0], 9, WIDE), device=g9.device)
    wide[..., :g9.shape[-1]] = g9
    return wide


def coupled(hp):
    """hp with pad rows 200 and 201 coupled (0.25 off the diagonal): the
    3-CTA instance takes the pad beyond its 192 as diagonal, the 4-CTA one
    takes it whole, so an inverse's entry (200, 201) says which ran."""
    out = hp.clone()
    out[:, 200, 201] = out[:, 201, 200] = 0.25
    return out


def bits(t):
    return t.contiguous().view(torch.int32)


def off_diagonal_beyond(t, n: int):
    """t's entries in rows or columns from n on, their diagonal left out."""
    out = t.clone()
    out[:, :n, :n] = 0
    out.diagonal(dim1=-2, dim2=-1).zero_()
    return out


@pytest.mark.parametrize("nblk,sched,pad", [(64, ADMM, 1.0), (48, POLISH, 1.0), (64, POLISH, 3.0)])
def test_reference_inverse_is_diagonal_beyond_a_diagonal_pad(nblk, sched, pad):
    """On the CPU, the wrapper's reference on an hp diagonal beyond its 3
    nblk variables (the identity, or 3 I) returns an inverse whose rows and
    columns from 3 nblk on are zero off the diagonal, with one value on it
    in each system (the NS steps on 1 from the system's alpha): the pad the
    3-CTA instance writes without reading it."""
    hp, g9 = operands(nblk, torch.device("cpu"), seed=25, b=2)
    n = 3 * nblk
    hp[:, n:, n:] *= pad
    inv, ks, d = NI.ns_inverse_scaled_build(hp, g9, *sched)
    assert ks is None and bool(inv.isfinite().all())
    assert not off_diagonal_beyond(inv, n).any()
    diag = inv.diagonal(dim1=-2, dim2=-1)[:, n:]
    assert torch.equal(diag, diag[:, :1].expand_as(diag))
    assert torch.allclose(d[:, 0, n:], torch.full_like(d[:, 0, n:], pad ** -0.5))


@pytest.mark.parametrize("max_stance", [4, 3])
def test_solver_hands_k2_an_hp_diagonal_beyond_its_variables(monkeypatch, max_stance):
    """A kernel-branch solve at h=16 on the CPU (192 variables at
    max_stance=4, h16_full's systems; 144 at 3, whose polish runs K2):
    every hp it hands the wrapper at the 256 tile is diagonal from row and
    column 3 nblk on, the rule the 3-CTA instance relies on."""
    calls = []
    real = NI.ns_inverse_scaled_build

    def record(hp, g9, *args):
        calls.append((hp.clone(), g9.shape[-1]))
        return real(hp, g9, *args)

    monkeypatch.setattr(NI, "ns_inverse_scaled_build", record)
    inputs = pipeline.random_inputs(3, 2, 16, device="cpu")
    forces = pipeline.solve_packed_batch(default_config(), inputs, use_kernels=True,
                                         max_stance=max_stance, pack=1)
    assert bool(forces.isfinite().all())
    assert len(calls) == (5 if max_stance == 4 else 3)
    for hp, nblk in calls:
        assert hp.shape[-1] == NI.N_BIG and 3 * nblk == 48 * max_stance
        assert not off_diagonal_beyond(hp, 3 * nblk).any()


@pytest.mark.card
@pytest.mark.parametrize("nblk,sched", [(64, ADMM), (64, POLISH), (48, POLISH)])
def test_3_cta_instance_is_bit_equal_to_the_4_cta_one(card, nblk, sched):
    """The wrapper at 192 and 144 variables (h16_full's systems on both
    schedules, h16_midband's polish) on the 3-CTA instance, and on the
    4-CTA one with g9 zero-extended (`coupled` tells which ran): inv and
    d_row the same bits over the whole tile, the result finite."""
    hp, g9 = operands(nblk, card)
    wide = widened(g9)
    assert not NI.ns_inverse_scaled_build(coupled(hp), g9, *sched)[0][:, 200, 201].any()
    assert NI.ns_inverse_scaled_build(coupled(hp), wide, *sched)[0][:, 200, 201].all()
    inv, ks, d = NI.ns_inverse_scaled_build(hp, g9, *sched)
    inv_w, ks_w, d_w = NI.ns_inverse_scaled_build(hp, wide, *sched)
    assert ks is None and ks_w is None
    assert bool(inv.isfinite().all())
    assert torch.equal(bits(inv), bits(inv_w))
    assert torch.equal(bits(d), bits(d_w))


@pytest.mark.card
@pytest.mark.parametrize("nblk", [64, 48])
def test_fused_factorization_is_bit_equal_at_both_widths(card, nblk):
    """`_batched_solver_fused` (the solver's cold factorization, ADMM
    schedule) on n = 3 nblk and on the same K taken as 240 variables: the
    padded inverse the iterate streams, the inverse and the Jacobi scale of
    the n variables, the same bits."""
    hp, g9 = operands(nblk, card, seed=23)
    n = 3 * nblk
    got = admm._batched_solver_fused(hp, g9, n, B, CFG, schedule=ADMM)
    want = admm._batched_solver_fused(hp, widened(g9), 3 * WIDE, B, CFG, schedule=ADMM)
    assert torch.equal(bits(got.inv_padded), bits(want.inv_padded))
    assert torch.equal(bits(got.inv), bits(want.inv[:, :n, :n]))
    assert torch.equal(bits(got.scale), bits(want.scale[:, :n]))


@pytest.mark.card
def test_more_than_192_variables_keep_the_4_cta_instance(card):
    """240 variables (nblk 80) run on 4-CTA clusters, and their inverse
    holds: max |I - ks X| of the ADMM schedule's result under 1e-2 (the
    3-CTA instance would keep only the diagonal of rows 192 to 239)."""
    hp, g9 = operands(WIDE, card, seed=24)
    assert NI.ns_inverse_scaled_build(coupled(hp), g9, *ADMM)[0][:, 200, 201].all()
    inv, _, d = NI.ns_inverse_scaled_build(hp, g9, *ADMM)
    ks = NI._build_k(hp, g9) * d[:, 0, :, None] * d
    gap = torch.eye(NI.N_BIG, device=card) - ks.double() @ inv.double()
    assert float(gap.abs().max()) < 1e-2
