"""The guarded warm NS K7 at both tiles, the plain NS K9 at the 128 tile and
the scaled NS K3 and its fused build K2 at the 256 tile, as
csrc/ns_refine.cu runs them (its wgmma step), compiled by g++ against the
emulation headers of quadruped_ctrl_tpu_torch/probes/cpu_emu together with
csrc/ns_inverse.cu, whose K3 kernel K7's second launch runs at the 128 tile
on the systems whose guard tripped (at 256 it is ns_refine.cu's own
RF_SCALED, masked). One emulated run, shared by the file's tests
(`emulate.run_warm`, `emulate.run_plain128`, `emulate.run_k23_256`,
`emulate.run_k2_widths`, `emulate.run_masked_walk`); the emulated card holds
two blocks at 128 and two clusters (of 3 or 4 CTAs) at 256, so each unit
walks two systems.

K9/128: 25 fp32 steps on three SPD systems of cond 1e3 (n = 120), against
ns_inverse_blocked_reference. Gates, chip_smoke.py's K9 gates: max |I - K X|
< 5e-4 and within 2x of the reference's (+1e-5; measured 8.1e-6 against
1.7e-5), the inverses within 1e-3 relative (measured 1.0e-5).

K7: four SPD systems of cond 1e3 (n = 120 at 128, 192 at 256) started at
17.0 everywhere (the guard trips), at the exact inverse twice (warm) and at
NaN (a NaN row sum trips), with the config's warm schedule (3 bf16x3 steps,
1 fp32, guard 0.5). Gates: the flags the guard set are those of the starts;
the warm systems within 1e-3 relative of ns_inverse_warm_reference (measured
7.9e-6 at 128, 1.2e-5 at 256) and their max |I - K X| within 2x of the
reference's; the tripped and the NaN system equal bit for bit to the
emulated K3 on the same cold schedule. The cold schedule is one scaled, one
bf16x3 and one fp32 step: the equality holds for any schedule, and the
ADMM schedule's nine steps would triple the emulated K3's time at 256
(test_torch_ns_inverse.py runs K7/128 on the ADMM schedule).

K3/256 and K2/256 (RF_SCALED, RF_BUILD) on the ADMM schedule, two systems
each: K3 on SPD n = 192 at cond 2.1e3, K2 on 3 x SPD n = 192 at cond 50
plus 64 random g9 blocks (blocks 21 and 42 cross the CTAs' rows at 64 and
128; 192 variables, so K2's 3-CTA instance over the tile's leading 192
rows and columns, with 3 I on the pad). Gates, chip_smoke.py's: max |I -
ks X| < 1e-2 and within 2x of the reference's (+1e-5; measured 3.17e-3
against 3.16e-3, and 1.6e-6 against 2.0e-6 for K2), the inverses within
1e-3 relative (measured 2.7e-5 and 1.3e-6), K2's d_row within 1e-6
(measured 0). The masked K3/256 with an
empty schedule on 600 systems, a third flagged at random and none of 100 to
399 (the walk's scans cross chunks of 256 flags): exactly the flagged
systems stored, each its start alpha I within 1e-5 relative of the
reference's (the 256-term row sums in another order; measured 5.8e-7).

K2/256 at both widths (`emulate.run_k2_widths`): a system of at most 192
variables (3 nblk) runs on the 3-CTA instance, which writes the tile's pad
itself, a larger one on 4-CTA clusters. The 3-CTA instance's inv and d_row
equal bit for bit, over the whole 256 tile, the 4-CTA instance's on the same
K (g9 zero-extended to 80 blocks): nblk 64 on the ADMM schedule (3 I on the
pad), nblk 48 with the identity on the pad and one step of each kind (the
pad's diagonal 0.868, not yet 1). nblk 80 (240 variables) still runs on
4-CTA clusters: K2's gates above against the reference (measured 2.1e-6
against 2.5e-6, rel 1.2e-6); the 3-CTA instance would have dropped its
rows from 192 on.
This file is apart from the other emulation tests so that it runs on a
worker of its own.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest

from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)

COLD = (5e-4, 1, 1, 1)  # a0, n_scaled, n_quad, n_hi of the tripped systems


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """emulate.run_warm's numbers at both tiles, run_plain128's,
    run_k23_256's, run_k2_widths' and run_masked_walk's, from one library of
    the NS kernels."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    path = Path(NI.__file__).parents[1] / "probes" / "cpu_emu" / "emulate.py"
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", path)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    out = tmp_path_factory.mktemp("cpu_emu")
    emu.prepare(emu.PKG / "csrc", out)
    lib = emu.compile_ns(out)
    return {**emu.run_warm(lib, (NI.N, NI.N_BIG), COLD), **emu.run_plain128(lib, 3, 25),
            **emu.run_k23_256(lib, 2), **emu.run_k2_widths(lib, 2),
            **emu.run_masked_walk(lib, 600)}


def test_blocked_128_source_runs_in_cpu_emulation(emulated):
    r = emulated["k9_128"]
    assert r["rc"] == 0 and r["finite"], r
    assert r["residual"] < 5e-4 and r["residual"] <= 2 * r["reference"] + 1e-5, r
    assert r["rel"] < 1e-3, r


@pytest.mark.parametrize("npad", [NI.N, NI.N_BIG])
def test_warm_source_runs_in_cpu_emulation(emulated, npad):
    r = emulated[f"k7_{npad}"]
    assert r["rc"] == 0 and r["rc_k3"] == 0 and r["finite"], r
    assert r["tripped"] == [1, 0, 0, 1], r
    assert r["rel_warm"] < 1e-3 and r["residual"] <= 2 * r["reference"] + 1e-5, r
    assert r["cold_is_k3"], r


@pytest.mark.parametrize("name", ["k3_256", "k2_256"])
def test_scaled_256_sources_run_in_cpu_emulation(emulated, name):
    r = emulated[name]
    assert r["rc"] == 0 and r["finite"], r
    assert r["residual"] < 1e-2 and r["residual"] <= 2 * r["reference"] + 1e-5, r
    assert r["rel"] < 1e-3, r
    assert r.get("rel_d", 0.0) <= 1e-6, r


def test_scaled_256_masked_walk_in_cpu_emulation(emulated):
    r = emulated["masked_walk"]
    assert r["rc"] == 0 and r["flagged"] > 0 and r["stored_is_flagged"], r
    assert r["rel"] < 1e-5, r


@pytest.mark.parametrize("n", [192, 144, 240])
def test_k2_256_widths_in_cpu_emulation(emulated, n):
    r = emulated[f"k2_width_{n}"]
    assert r["rc"] == 0 and r["finite"], r
    if n <= 192:
        assert r["rc_wide"] == 0 and r["inv_equal"] and r["d_equal"], r
    else:
        assert r["residual"] < 1e-2 and r["residual"] <= 2 * r["reference"] + 1e-5, r
        assert r["rel"] < 1e-3 and r["rel_d"] <= 1e-6, r
