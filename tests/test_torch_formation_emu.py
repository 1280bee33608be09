"""K1's CUDA source (csrc/formation_pack.cu on mma.cuh) compiled by g++
against the emulation headers of quadruped_ctrl_tpu_torch/probes/cpu_emu
(one std::thread per CUDA thread; mma.sync and ldmatrix on their PTX
fragment layouts) and run on the CPU against `form_packed_reference` by
`emulate.run_k1`: the four lanes' shapes (h=10 at max_stance 2 and pack 2,
two scenarios; h=16 at max_stance 4 / pack 1, 2 / pack 2 and 3 / pack 1, one
system each), h=10 with 2 masked steps, h=5 at max_stance 1 (n_c = 15,
no multiple of 4: the scalar stores), and h=36 at max_stance 1, h=25 at 2,
whose planes leave no room in 227 KB for the padded row stride.

Tolerances: K1's own gates on the card (chip_smoke.check_k1), rel_H < 5e-5
(the bf16x3 Gram in another order of summation; measured <= 4e-7) and rel_g
< 1e-5 (fp32 in another order; measured <= 7e-7); H finite, every entry off
the scenario blocks exactly 0 (the output starts as NaN, so an entry the
kernel does not write fails); the mma.sync run equal to the library's
`qct_form_packed_mma_count` (the zero chunks and the mirrored tiles
skipped, no more); ldmatrix free of bank conflicts (1 wavefront a matrix)
wherever the row stride is padded, and 2 and 4 wavefronts at the two shapes
where it is not (rows of 14 and 20 16-byte groups). This file is apart from
test_torch_formation.py so that it runs on a worker of its own.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest

from quadruped_ctrl_tpu_torch.ops import formation_pack as FP
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


def _emulate():
    path = Path(FP.__file__).parents[1] / "probes" / "cpu_emu" / "emulate.py"
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", path)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    return emu


@pytest.fixture(scope="module")
def k1_lib(tmp_path_factory):
    """(emulate, K1's emulated library)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    emu = _emulate()
    out = tmp_path_factory.mktemp("cpu_emu")
    emu.prepare(emu.PKG / "csrc", out)
    return emu, emu.compile_formation(out)


@pytest.fixture(scope="module")
def k1_emulated(k1_lib):
    """emulate.run_k1's numbers from K1's emulated library."""
    emu, lib = k1_lib
    return emu.run_k1(lib)


# ldmatrix wavefronts a matrix where the planes' rows are not padded
_UNPADDED_WAVEFRONTS = {"h36_ms1": 2.0, "h25_ms2": 4.0}


@pytest.mark.parametrize("case", ["h10", "h16_full", "h16_trot", "h16_midband", "h10_masked",
                                  "h5_ms1", "h36_ms1", "h25_ms2"])
def test_k1_source_runs_in_cpu_emulation(k1_emulated, case):
    r = k1_emulated[case]
    assert r["rc"] == 0 and r["finite"] and r["zeros_exact"], r
    assert r["rel_H"] < 5e-5 and r["rel_g"] < 1e-5, r
    assert r["mma_count"] == r["mma_expected"], r
    assert r["ldmatrix_wavefronts"] == _UNPADDED_WAVEFRONTS.get(case, 1.0), r
    assert r["smem"] <= 227 * 1024, r


def test_k1_shared_memory_sets_the_blocks_per_sm(k1_emulated):
    # an SM has 228 KB of shared memory, 1 KB of it reserved a block: four
    # blocks at h=10, one at h16_full; a block may use 227 KB
    assert 4 * (k1_emulated["h10"]["smem"] + 1024) <= 228 * 1024, k1_emulated["h10"]
    assert k1_emulated["h16_full"]["smem"] <= 227 * 1024, k1_emulated["h16_full"]


def test_gram_mma_counts_skip_zeros_and_the_mirror(k1_lib):
    # h16_full: 21 of the 36 warp tiles, 135 (tile, chunk) pairs of their
    # 21 x 13; h10: 1 tile from chunk 0 (9 chunks), 2 from chunk 4 (5 each)
    lib = k1_lib[1]
    assert lib.qct_form_packed_mma_count(16, 4) == 135 * 24
    assert lib.qct_form_packed_mma_count(10, 2) == (9 + 2 * 5) * 24


def test_k1_takes_every_shape_the_first_design_took(k1_lib):
    # Every (h, max_stance) that qp_cost_packed routes to K1 (3 ms h <= 256)
    # and whose fp32 bq, u, smat, r and mask fit in 227 KB (the kernel's
    # first design) fits the bf16 planes' layout too.
    lib = k1_lib[1]
    took = [(h, ms) for ms in range(1, 5) for h in range(1, 86) if 3 * ms * h <= 256
            and 4 * (468 + 51 * 3 * ms * h + 13 * h * 3 * ms * h + 13 * h + h) <= 227 * 1024]
    assert max(h for h, ms in took if ms == 1) == 36 and (25, 2) in took
    over = {(h, ms): lib.qct_form_packed_smem_bytes(h, ms) for h, ms in took
            if lib.qct_form_packed_smem_bytes(h, ms) > 227 * 1024}
    assert not over, over
