"""The warm refinement K6's CUDA source (csrc/ns_refine.cu on mma.cuh)
compiled by g++ against the emulation headers of
quadruped_ctrl_tpu_torch/probes/cpu_emu and run on the CPU by
`emulate.run_refine`: one bf16x3 and one fp32 step on three SPD systems of
cond 1e4 (n = 96 at the 128 tile, 192 at 256) from the JAX package's warm
start (the exact inverse times I + E, ||E||_2 = 0.05), against
ns_inverse_refine_reference. The emulated card holds two blocks at 128 and
two 4-CTA clusters at 256 (a cluster's CTAs together; DSMEM loads reach
the peer's shared memory; wgmma bf16 and tf32 on their fragment and
descriptor layouts; cp.async copies at once), so one block (cluster) walks
two systems: the next system's ks streamed into K during the last product,
the result stored from the accumulators.

Gates, chip_smoke.py's K6 gates on SPD starts: the largest row sum of
|I - K X| < 5e-3, within 2x of the reference's and < 0.1 of the start's;
the inverses within 1e-3 relative (measured ~8e-5 at both tiles). Two more
schedules the wrapper takes: two bf16x3 steps and no fp32 step (the last
step's product and store are bf16x3's), held to the reference by the last
two gates, and no step at all, which returns init itself. This file is
apart from test_torch_ns_inverse.py so that it runs on a worker of its own.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest

from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """The emulate module and the NS kernels' emulated library (ns_refine.cu
    with ns_inverse.cu)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    path = Path(NI.__file__).parents[1] / "probes" / "cpu_emu" / "emulate.py"
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", path)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    out = tmp_path_factory.mktemp("cpu_emu")
    emu.prepare(emu.PKG / "csrc", out)
    return emu, emu.compile_ns(out)


@pytest.fixture(scope="module")
def refine(emu_lib):
    """emulate.run_refine's numbers at both tiles on the Woodbury schedule."""
    emu, lib = emu_lib
    return emu.run_refine(lib, (NI.N, NI.N_BIG), 3)


@pytest.mark.parametrize("npad", [NI.N, NI.N_BIG])
def test_refine_source_runs_in_cpu_emulation(refine, npad):
    r = refine[f"k6_{npad}"]
    assert r["rc"] == 0 and r["finite"], r
    assert r["residual"] < 5e-3 and r["residual"] <= 2 * r["reference"] + 1e-5, r
    assert r["residual"] < 0.1 * r["start"], r
    assert r["rel"] < 1e-3, r


@pytest.mark.parametrize("npad,sched", [(NI.N, (2, 0)), (NI.N_BIG, (0, 0))])
def test_refine_source_other_schedules(emu_lib, npad, sched):
    emu, lib = emu_lib
    r = emu.run_refine(lib, (npad,), 3, sched)[f"k6_{npad}"]
    assert r["rc"] == 0 and r["finite"], r
    if sched == (0, 0):
        assert r["equal"], r
    else:
        assert r["residual"] <= 2 * r["reference"] + 1e-5 and r["rel"] < 1e-3, r
