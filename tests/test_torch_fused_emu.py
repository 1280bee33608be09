"""K5's CUDA source (csrc/fused_admm.cu on ns_core.cuh and mma.cuh) compiled
by g++ against the emulation headers of quadruped_ctrl_tpu_torch/probes/cpu_emu
(each CUDA thread a fiber on the calling thread; mma.sync, ldmatrix and
the shuffles on their PTX fragment layouts) and run on the CPU against
`fused_admm_solve_reference` by `emulate.run_k5`, on the first b = 2 systems
of the operands that `solve_packed_batch(use_fused=True)` builds at h=10 (60
variables and 100 rows in the 128 x 256 tile).

Tolerances. The whole solve (n_iter=60, polish_rounds=2): forces (x f_max)
within 0.5 N, the JAX kernel test's own (measured 1.7e-3 N), and the padded
variables exactly 0. The ADMM phase alone (n_iter=30, polish_rounds=0): the
same arithmetic but for the NS products' and the matvecs' order of
summation, within 1e-4 of max |x| (measured 1.2e-5). ldmatrix free of bank
conflicts (1 wavefront a matrix). This file is apart from
test_torch_fused_admm.py so that it runs on a worker of its own.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest

from quadruped_ctrl_tpu_torch.ops import fused_admm as FA
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def k5_emulated(tmp_path_factory):
    """emulate.run_k5's numbers from K5's emulated library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    path = Path(FA.__file__).parents[1] / "probes" / "cpu_emu" / "emulate.py"
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", path)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    out = tmp_path_factory.mktemp("cpu_emu")
    emu.prepare(emu.PKG / "csrc", out)
    return emu.run_k5(emu.compile_fused(out))


def test_k5_source_runs_in_cpu_emulation(k5_emulated):
    r = k5_emulated["k5"]
    assert r["finite"] and r["pad_zero"] and r["max_force_diff"] <= 0.5, r
    assert k5_emulated["ldmatrix_wavefronts"] == 1.0, k5_emulated


def test_k5_admm_phase_in_cpu_emulation(k5_emulated):
    r = k5_emulated["k5_admm"]
    assert r["finite"] and r["pad_zero"] and r["rel"] <= 1e-4, r
