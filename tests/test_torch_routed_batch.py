"""The port's routed batched solve, `mpc/pipeline.solve_routed_batch`, and
the stance slot lists it forms (`formation.stance_slots`, read by K1's
plain branch through `slot_step`), on the CPU at h = 14 on the reference
controller's mode-0 gaits (ConvexMPCLocomotion.cpp:23-41, 149-172; the
tables of `gait/gait.py`, rolled as Gait.cpp:142-166):

- each gait's stance variables, whatever its segment, and the router's
  groups;
- the slot lists against a plain enumeration of each table;
- two scenarios of every gait, seeded, against the benchmark's float64
  reference (`benchmark/reference/mpc_qp.py`), at tolerances whose reasons
  each test gives;
- a permuted batch gives the forces permuted, bit for bit;
- a trot-only batch gives `solve_packed_batch(max_stance=2, pack=1)` bit
  for bit, on both branches: its slot lists are the per-step layout's
  columns;
- K1's plain branch (`qp_cost_compressed_nil_sel`, `packed_qp_operands`,
  `form_packed_reference`) given the per-step layout as a slot list, one
  for all scenarios or one a scenario, gives the per-step layout's bits.

No JAX: the routed solve has no JAX counterpart. Its pieces do, and are
held to JAX where they are the JAX functions' (`test_torch_formation.py`).
"""

import dataclasses

import pytest
import torch

from benchmark.harness import check
from benchmark.reference.mpc_qp import Reference, violation
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.gait import gait
from quadruped_ctrl_tpu_torch.mpc import formation, pipeline
from quadruped_ctrl_tpu_torch.ops import formation_pack as FP
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)

CFG = default_config()
H = 14
# the gaits mode 0 reaches and each one's stance variables at h = 14: the
# horizon is the gait's period, so every foot is in stance for its
# duration whatever the segment, and n = 3 x the durations' sum
WIDTH = {1: 72, 2: 72, 4: 168, 5: 72, 7: 84, 8: 84, 9: 84, 10: 120, 11: 120}
MPC = dict(dt=1.0 / CFG.sim.freq, iterations_between_mpc=CFG.mpc.iterations_between_mpc,
           mass=CFG.mpc.mass, inertia=list(CFG.mpc.inertia), weights=list(CFG.mpc.weights),
           alpha=CFG.mpc.alpha, mu=CFG.mpc.mu, f_max=CFG.mpc.f_max, gravity=CFG.mpc.gravity)


def table(number: int, segment: int, h: int = H) -> torch.Tensor:
    return gait.mpc_table(torch.tensor(segment, dtype=torch.int32),
                          gait.params_for_gait(torch.tensor(number)), h)


def gait_batch(seed: int, gaits, per: int, h: int = H):
    """`per` scenarios of each gait number, each at a seeded segment, on
    random_inputs of the seed: (inputs, gait number a scenario)."""
    gen = torch.Generator().manual_seed(seed)
    numbers = [g for g in gaits for _ in range(per)]
    tables = torch.stack([table(g, int(torch.randint(0, h, (), generator=gen)), h)
                          for g in numbers])
    inp = pipeline.random_inputs(seed, len(numbers), h, device="cpu")
    return dataclasses.replace(inp, gait_table=tables), numbers


def permuted(inp, perm):
    return pipeline.MPCInputs(**{f.name: getattr(inp, f.name)[perm]
                                 for f in dataclasses.fields(inp)})


@pytest.fixture(scope="module")
def mixed():
    """Two scenarios of every mode-0 gait, solved by the routed solve."""
    torch.set_num_threads(1)
    inp, numbers = gait_batch(25, tuple(WIDTH), 2)
    return inp, numbers, pipeline.solve_routed_batch(CFG, inp)


@pytest.mark.parametrize("number", list(WIDTH))
def test_each_gaits_stance_variables_at_every_segment(number):
    assert {int(3 * table(number, s).sum()) for s in range(H)} == {WIDTH[number]}


def test_stance_slots_enumerate_each_table():
    """Slot k of a scenario is its k-th stance pair in (step, foot) order;
    slots past its count select no foot, have gait 0, point at the spare
    row 4 h and lie on the last step; no list's steps decrease."""
    inp, _ = gait_batch(3, (1, 4, 9, 10), 1)
    tables = inp.gait_table.clone()
    tables[0, 3, 1] = 1.0                                     # 25 stance pairs
    flat, gait_red, sel, steps = formation.stance_slots(tables, 60)
    for s in range(tables.shape[0]):
        pairs = torch.nonzero(tables[s].flatten() > 0.5).flatten()
        k = pairs.numel()
        assert torch.equal(flat[s, :k], pairs) and bool((flat[s, k:] == 4 * H).all())
        assert torch.equal(steps[s, :k], (pairs // 4).int())
        assert bool((steps[s, k:] == H - 1).all()) and bool((steps[s].diff() >= 0).all())
        assert torch.equal(sel[s, :k].argmax(-1), pairs % 4)
        assert float(sel[s, k:].abs().sum()) == 0.0 and float(sel[s, :k].sum()) == k
        assert float(gait_red[s].sum()) == k and bool((gait_red[s, :k] == 1).all())


def test_route_groups_by_width_in_input_order(mixed):
    """The groups' widths are each gait's n (12-variable multiples here);
    a scenario of 5 stance slots rounds up to 8 (24 variables); one with no
    stance foot is in no group."""
    inp, numbers, _ = mixed
    groups = pipeline._route_groups(inp.gait_table)
    got = {3 * n_slot: idx.tolist() for n_slot, idx in groups}
    want = {}
    for i, g in enumerate(numbers):
        want.setdefault(WIDTH[g], []).append(i)
    assert got == want
    odd = torch.zeros((3, H, 4))
    odd[0, :5, 0] = 1.0
    odd[2] = 1.0
    assert [(3 * n, idx.tolist()) for n, idx in pipeline._route_groups(odd)] == \
        [(24, [0]), (168, [2])]


def test_routed_solve_agrees_with_the_reference(mixed):
    """Against the float64 interior point on the same QPs:
    - the median scenario's cost gap |J - J*| / J* under 1e-6, the limit
      `h16_full_solve`'s check sets: a float32 solve sits at ~1e-8 there
      (measured at most 1.2e-8 over eight seeds);
    - every gap under 1e-2: the port's knife-edge scenarios (1-2% of them,
      ROADMAP queue 3) settle on a nearby active set at up to ~1e-2 of J*
      (`benchmark/harness/check.py`; the unrouted solve on 576 scenarios of
      the gait mix has them as often as the routed one); measured at most
      6.5e-4;
    - the constraints violated by at most 0.5 N (measured at most 0.023 N;
      the batched cells' checks read up to 0.67 N at 2048 scenarios);
    - every swing foot's force exactly 0: the router scatters only stance
      slots."""
    inp, _, forces = mixed
    raw = {k: getattr(inp, k) for k in check.FIELDS}
    ref = Reference(MPC)
    f_opt, _ = ref.solve(raw)
    j_opt = ref.cost(raw, f_opt)
    gap = (ref.cost(raw, forces.double()) - j_opt).abs() / j_opt
    assert forces.shape == (18, H, 4, 3) and bool(torch.isfinite(forces).all())
    assert check.quantile(gap, 0.5) < 1e-6, gap
    assert float(gap.max()) < 1e-2, gap
    assert float(violation(MPC, forces, inp.gait_table).max()) < 0.5
    assert float(forces[inp.gait_table < 0.5].abs().max()) == 0.0


def test_permuted_batch_gives_permuted_forces(mixed):
    """Each scenario is one system of its group, solved by batched ops that
    treat every system alike: a permutation of the batch permutes the
    forces bit for bit."""
    inp, _, forces = mixed
    perm = torch.randperm(18, generator=torch.Generator().manual_seed(4))
    assert torch.equal(pipeline.solve_routed_batch(CFG, permuted(inp, perm)), forces[perm])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_trot_only_batch_is_the_packed_solve_bit_for_bit(use_kernels):
    """Every step of a trot has two feet in stance, so each scenario's slot
    list holds the per-step layout's columns at max_stance 2 (stance feet
    first, in foot order): the routed solve is `solve_packed_batch`'s at
    pack 1, bit for bit, on the plain branch and on the kernel branch (the
    kernels' plain references on the CPU; K1's with the slots' steps a
    scenario)."""
    inp, _ = gait_batch(6, (9,), 6)
    want = pipeline.solve_packed_batch(CFG, inp, max_stance=2, pack=1, use_kernels=use_kernels)
    got = pipeline.solve_routed_batch(CFG, inp, use_kernels=use_kernels)
    assert torch.equal(got, want)


def test_slots_past_a_scenarios_count_and_no_stance():
    """A table whose stance count is no multiple of four gets slots past its
    count, pinned to zero and dropped; a scenario with no foot in stance
    gets zero forces. The others are solved as in a batch of their own."""
    inp, _ = gait_batch(8, (9, 10), 1)
    tables = inp.gait_table.clone()
    tables[0, 0, 1] = 1.0                                     # 29 slots -> 32
    tables[1] = 0.0
    inp = dataclasses.replace(inp, gait_table=tables)
    forces = pipeline.solve_routed_batch(CFG, inp)
    assert float(forces[1].abs().max()) == 0.0
    assert float(forces[tables < 0.5].abs().max()) == 0.0
    alone = pipeline.solve_routed_batch(CFG, permuted(inp, torch.tensor([0])))
    assert torch.equal(forces[0], alone[0])
    raw = {k: getattr(inp, k)[:1] for k in check.FIELDS}
    ref = Reference(MPC)
    f_opt, _ = ref.solve(raw)
    j_opt = ref.cost(raw, f_opt)
    assert float((ref.cost(raw, forces[:1].double()) - j_opt).abs() / j_opt) < 1e-6


@pytest.mark.parametrize("h,ms,pack,masked", [(10, 2, 2, 0), (14, 3, 1, 2), (16, 4, 1, 0)])
def test_k1_plain_branch_slot_steps_equal_the_per_step_layout(h, ms, pack, masked):
    """The per-step layout (sel (B, h, ms, 4)) and the same columns as a
    slot list (sel (B, h ms, 4) with each slot's step, one list for all or
    one a scenario) give the same operands, Hessian and gradient bit for
    bit: in `qp_cost_compressed_nil_sel`, `packed_qp_operands` and
    `form_packed_reference` (K1's plain version, as `qp_cost_packed`'s
    kernel branch reaches it on the CPU)."""
    b = 4
    inp = pipeline.random_inputs(h, b, h, trot=False, device="cpu")
    gen = torch.Generator().manual_seed(h)
    tables = (torch.rand((b, h, 4), generator=gen) < 0.5).float()
    adt, bdt = formation.srb_discrete(CFG.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag,
                                      CFG.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            CFG.mpc.gravity)
    mask = torch.ones((b, h))
    if masked:
        mask[:, -masked:] = 0.0
    _, _, sel = formation.stance_selectors(tables, ms)
    flat_sel = sel.reshape(b, h * ms, 4)
    one = torch.arange(h, dtype=torch.int32).repeat_interleave(ms)
    args = (CFG.mpc, adt, bdt, x0, inp.traj, mask)
    want = formation.qp_cost_compressed_nil_sel(*args, sel)
    ops = formation.packed_qp_operands(*args, sel)
    k1 = FP.form_packed_reference(*ops, h, ms, pack, CFG.mpc.alpha)
    packed = formation.qp_cost_packed(*args, sel, pack, use_kernels=True)
    for steps in (one, one.expand(b, -1).contiguous()):
        got = formation.qp_cost_compressed_nil_sel(*args, flat_sel, steps)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got_ops = formation.packed_qp_operands(*args, flat_sel)
        assert all(torch.equal(g, w) for g, w in zip(got_ops, ops))
        got_k1 = FP.form_packed_reference(*ops, h, None, pack, CFG.mpc.alpha, slot_step=steps)
        assert all(torch.equal(g, w) for g, w in zip(got_k1, k1))
        got_packed = formation.qp_cost_packed(*args, flat_sel, pack, use_kernels=True,
                                              slot_step=steps)
        assert all(torch.equal(g, w) for g, w in zip(got_packed, packed))
