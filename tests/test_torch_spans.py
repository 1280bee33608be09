"""The port's `qct.*` spans (`utils/timer.span`) on the CPU: the names and
counts one solve records under torch.profiler, their nesting, the forces
unchanged under vmap with the profiler on, nothing constructed with it off,
and the controller tick's spans."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.control import controller as ctrl
from quadruped_ctrl_tpu_torch.core.types import Command
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from quadruped_ctrl_tpu_torch.sim import batch_rollout as BR
from quadruped_ctrl_tpu_torch.sim import engine
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
from quadruped_ctrl_tpu_torch.utils import timer
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)

CFG = default_config()
H = 10


@pytest.fixture(scope="module")
def inputs():
    return TP.random_inputs(7, 4, H, device="cpu")


def _spans(fn):
    """(result, [(name, start_us, end_us)] of the `qct.*` ranges) of fn()
    run under a CPU torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("qct.")]
    return out, sorted(spans, key=lambda s: s[1])


def _count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def _inside(span, spans, names):
    _, s0, s1 = span
    return any(n in names and a <= s0 and s1 <= b for n, a, b in spans)


def _one_scenario(inputs):
    return TP.MPCInputs(**{f.name: getattr(inputs, f.name)[0]
                           for f in dataclasses.fields(TP.MPCInputs)})


@pytest.mark.parametrize("path", ["solve", "packed_plain", "packed_kernels"])
def test_one_solve_records_its_phases(inputs, path):
    """One solve: 1 `qct.solve` holding 1 `qct.formation`; rho_adapt + 1
    ADMM segments, polish_rounds polish rounds and a factorization for each
    segment and round, every one after the first inside a rho_adapt step or
    a polish round; on the kernel branch (the kernels' references on the
    CPU) the wrappers' `qct.ops.*` spans."""
    if path == "solve":
        fn = lambda: TP.solve(CFG, _one_scenario(inputs))               # noqa: E731
    else:
        fn = lambda: TP.solve_packed_batch(                             # noqa: E731
            CFG, inputs, max_stance=2, pack=2, use_kernels=path == "packed_kernels")
    _, spans = _spans(fn)
    segs = CFG.solver.rho_adapt + 1
    rounds = CFG.solver.polish_rounds
    assert _count(spans, "qct.solve") == 1 and _count(spans, "qct.formation") == 1
    assert _inside([s for s in spans if s[0] == "qct.formation"][0], spans, {"qct.solve"})
    assert _count(spans, "qct.admm.iterate") == segs
    assert _count(spans, "qct.admm.rho_adapt") == segs - 1
    assert _count(spans, "qct.admm.polish") == rounds
    fact = [s for s in spans if s[0] == "qct.factorize"]
    assert len(fact) == segs + rounds
    assert all(_inside(f, spans, {"qct.admm.rho_adapt", "qct.admm.polish"}) for f in fact[1:])
    assert not _inside(fact[0], spans, {"qct.admm.rho_adapt", "qct.admm.polish"})
    for s in spans:
        assert s == spans[0] or _inside(s, spans, {"qct.solve"})
    ops = {n for n, _, _ in spans if n.startswith("qct.ops.")}
    if path == "packed_kernels":
        assert _count(spans, "qct.ops.form_packed") == 1
        assert _count(spans, "qct.ops.ns_inverse_scaled_build") == segs + rounds
        assert ops == {"qct.ops.form_packed", "qct.ops.ns_inverse_scaled_build"}
    else:
        assert not ops


def test_spans_under_vmap_leave_the_forces(inputs):
    """`solve_batch` runs `solve` under torch.func.vmap: with the profiler on
    it records its spans once for the batch and returns the forces it
    returns with the profiler off."""
    off = TP.solve_batch(CFG, inputs)
    on, spans = _spans(lambda: TP.solve_batch(CFG, inputs))
    assert torch.equal(on, off)
    assert _count(spans, "qct.solve") == 1
    assert _count(spans, "qct.admm.iterate") == CFG.solver.rho_adapt + 1


def test_nothing_is_constructed_without_a_profiler(inputs, monkeypatch):
    """With no profiler on, a solve constructs no `record_function`: every
    span is the one shared no-op context."""
    made = []

    class Counting:
        def __init__(self, *a, **kw):
            made.append(a)

    monkeypatch.setattr(timer, "record_function", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    TP.solve(CFG, _one_scenario(inputs))
    TP.solve_packed_batch(CFG, inputs, max_stance=2, pack=2, use_kernels=True)
    assert made == []
    assert timer.span("qct.x") is timer.span("qct.y")


def test_controller_tick_records_its_stages():
    """One `controller_step` tick on which the MPC fires records
    `qct.controller_step` with its three stages inside, in order."""
    terrain = Terrain.plane(device="cpu")
    sim = engine.sim_init(CFG, terrain, device="cpu")
    state = ctrl.init_state(CFG, device="cpu")
    loco = state.core.locomotion
    due = torch.full_like(loco.iteration_counter, CFG.mpc.iterations_between_mpc - 1)
    state = state.replace(core=state.core.replace(
        locomotion=loco.replace(iteration_counter=due)))
    cmd = Command.create(0.3, 0.0, 0.0, device="cpu")
    _, spans = _spans(lambda: ctrl.controller_step(
        CFG, state, engine.sensors_from_sim(CFG, sim), cmd, mpc_iterations=10))
    stages = ["qct.control_tick", "qct.mpc_update", "qct.leg_commands"]
    assert _count(spans, "qct.controller_step") == 1
    got = [s for s in spans if s[0] in stages]
    assert [n for n, _, _ in got] == stages
    assert all(_inside(s, spans, {"qct.controller_step"}) for s in got)
    assert _count(spans, "qct.admm.iterate") == CFG.solver.rho_adapt + 1


def test_batched_ticks_record_one_span_each():
    """`batch_rollout`'s two tick kinds: one `qct.mpc_tick` or
    `qct.plain_tick` span a tick."""
    terrains = BR.batch_terrains(2, torch.Generator(), kinds=("plane",), device="cpu")
    states, sims = BR.batch_init(CFG, terrains, 2, device="cpu")
    cmds = BR.sweep_commands(CFG, (0.2, 0.3), (0.0, 0.0), (0.0, 0.0), [9], 2,
                             torch.Generator().manual_seed(1), device="cpu")
    _, spans = _spans(lambda: BR._plain_tick(CFG, states, sims, cmds, terrains))
    assert _count(spans, "qct.plain_tick") == 1 and _count(spans, "qct.mpc_tick") == 0
    _, spans = _spans(lambda: BR._mpc_tick_batched(
        CFG, states, sims, cmds, terrains, H, 10, max_stance=4, use_kernels=False))
    assert _count(spans, "qct.mpc_tick") == 1
    assert _count(spans, "qct.admm.iterate") == CFG.solver.rho_adapt + 1
