"""The plain NS kernels' CUDA source (csrc/ns_plain.cu on mma.cuh) compiled by
g++ against the emulation headers of quadruped_ctrl_tpu_torch/probes/cpu_emu
and run on the CPU by `emulate.run_plain`: K8 on one system at the 128 tile
(a cluster of 2 x 4 CTAs), K9 on two systems at the 256 tile (a cluster of
4 x 1 CTAs each) and K8 at the 256 tile (4 x 4 CTAs), the CTAs of a cluster
concurrently (cluster.sync() one barrier over all their threads; DSMEM loads
and map_shared_rank reach the peer's shared memory; wgmma on its fragment
and descriptor layouts), against ns_inverse_reference /
ns_inverse_blocked_reference at emulate.PLAIN_ITERS steps on SPD systems of
cond 2 (n = 120 and 192), where that many steps reach fp32 rounding: the
indexing is the same for any number of steps.

Gates: chip_smoke.py's K9 gate, max |I - K X| < 5e-4 and within 2x of the
reference's (+1e-5; measured 5.5e-7 against 1.1e-6 at 128, 7.9e-7 against
1.8e-6 at 256), and the inverses within 1e-3 relative (measured <= 1.6e-6).
K8 and K9 sum in the same order at the 256 tile, so K8 there equals K9's
system 0 exactly. This file is apart from test_torch_ns_inverse.py so that it
runs on a worker of its own.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    path = Path(NI.__file__).parents[1] / "probes" / "cpu_emu" / "emulate.py"
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def plain(emu, tmp_path_factory):
    """emulate.run_plain's numbers and inverses for the three cases, from
    ns_plain.cu's emulated library."""
    out = tmp_path_factory.mktemp("cpu_emu")
    emu.prepare(emu.PKG / "csrc", out)
    inverses = {}
    numbers = emu.run_plain(emu.compile_plain(out), ("k8_128", "k9_256", "k8_256"), inverses)
    return numbers, inverses


@pytest.mark.parametrize("case", ["k8_128", "k9_256", "k8_256"])
def test_plain_ns_source_runs_in_cpu_emulation(plain, case):
    r = plain[0][case]
    assert r["rc"] == 0 and r["finite"], r
    assert r["residual"] < 5e-4 and r["residual"] <= 2 * r["reference"] + 1e-5, r
    assert r["rel"] < 1e-3, r


def test_plain_ns_k8_equals_k9_system_0_at_256(plain):
    """One system through K8 (4 x 4 blocks of 64 x 64) and two through K9 (row
    slabs of 64), system 0 the same matrix: the same sums in the same order,
    so the same bits."""
    k8, k9 = plain[1]["k8_256"], plain[1]["k9_256"]
    assert torch.equal(k8[0], k9[0])
    assert not torch.equal(k9[0], k9[1])
