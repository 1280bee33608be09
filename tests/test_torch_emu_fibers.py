"""The CPU emulator of quadruped_ctrl_tpu_torch/probes/cpu_emu itself, on
tiny kernels written here: each is rewritten by `emulate.prepare` and built
by g++ with `emulate.FLAGS`, as the kernels of csrc/ are.

- A barrier that half the block never reaches is a deadlock: the launch is
  abandoned and reported, the entry point's cudaGetLastError() returns an
  error at once (the call runs in a child process bounded at 10 s), and the
  next launch on the same library runs correctly.
- The fibers resume in a fixed order: when thread t writes s[t] and reads
  s[t ^ 1] with no barrier between, the even threads read their partner's
  slot before it is written (the arena's fill), the same lanes on every run;
  with __syncthreads() between, every lane reads its partner's value.
- Every emulated thread runs on the OS thread that called the entry point,
  and the emulator's headers include neither <thread> nor <barrier>.
"""

import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI

CPU_EMU = Path(NI.__file__).parents[1] / "probes" / "cpu_emu"

SOURCE = r"""
#include <cuda_runtime.h>
#include <sys/syscall.h>
#include <unistd.h>

__global__ void diverge(float* out) {
  if (threadIdx.x < 128) __syncthreads();
  out[threadIdx.x] = 1.f;
}

__global__ void swap_pairs(const float* in, float* out, int sync) {
  extern __shared__ float s[];
  const int t = threadIdx.x;
  s[t] = in[t];
  if (sync) __syncthreads();
  out[t] = s[t ^ 1];
}

__global__ void thread_ids(long* out) {
  const long tid = syscall(SYS_gettid);
  __syncthreads();
  out[blockIdx.x * 128 + threadIdx.x] = tid;
}

extern "C" int run_diverge(float* out) {
  diverge<<<1, 256, 0, nullptr>>>(out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_swap_pairs(const float* in, float* out, int sync) {
  swap_pairs<<<1, 256, 256 * sizeof(float), nullptr>>>(in, out, sync);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_thread_ids(long* out) {
  thread_ids<<<2, 128, 0, nullptr>>>(out);
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.fixture(scope="module")
def lib_path(tmp_path_factory):
    """The tiny kernels' emulated library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    spec = importlib.util.spec_from_file_location("cpu_emu_emulate", CPU_EMU / "emulate.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    root = tmp_path_factory.mktemp("emu_fibers")
    (root / "src").mkdir()
    (root / "src" / "tiny.cu").write_text(SOURCE)
    emu.prepare(root / "src", root / "emu")
    path = root / "emu" / "libtiny_emu.so"
    subprocess.run([*emu.FLAGS, "-O2", "-shared", "-fPIC", "-o", str(path),
                    str(root / "emu" / "tiny.cu")], check=True)
    return path


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _swap_pairs(lib: ctypes.CDLL, sync: int) -> tuple[int, np.ndarray, np.ndarray]:
    x = np.arange(1, 257, dtype=np.float32)
    out = np.zeros(256, np.float32)
    rc = lib.run_swap_pairs(_ptr(x), _ptr(out), sync)
    return rc, out, x[np.arange(256) ^ 1]


DIVERGE = """
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
out = np.zeros(256, np.float32)
rc = lib.run_diverge(ctypes.c_void_p(out.ctypes.data))
x = np.arange(1, 257, dtype=np.float32)
swapped = np.zeros(256, np.float32)
rc2 = lib.run_swap_pairs(ctypes.c_void_p(x.ctypes.data), ctypes.c_void_p(swapped.ctypes.data), 1)
print(rc, rc2, int((swapped == x[np.arange(256) ^ 1]).all()))
"""


def test_divergent_barrier_is_an_error_not_a_hang(lib_path):
    done = subprocess.run([sys.executable, "-c", DIVERGE, str(lib_path)], capture_output=True,
                          text=True, timeout=10)
    assert done.returncode == 0, done.stderr
    rc, rc_next, next_exact = map(int, done.stdout.split())
    assert rc != 0, done.stdout
    assert rc_next == 0 and next_exact == 1, done.stdout
    assert "__syncthreads of block 0: 128 of 256 threads arrived" in done.stderr, done.stderr


def test_unsynchronised_exchange_is_wrong_the_same_way_every_run(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    wrong = []
    for _ in range(3):
        rc, out, want = _swap_pairs(lib, 0)
        assert rc == 0
        wrong.append(np.flatnonzero(out != want))
    assert len(wrong[0]) > 0, wrong[0]
    assert all(np.array_equal(w, wrong[0]) for w in wrong), wrong
    np.testing.assert_array_equal(wrong[0], np.arange(0, 256, 2))
    rc, out, want = _swap_pairs(lib, 1)
    assert rc == 0
    np.testing.assert_array_equal(out, want)


def test_emulated_threads_run_on_the_calling_thread(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    out = np.zeros(256, np.int64)
    assert lib.run_thread_ids(_ptr(out)) == 0
    assert (out == threading.get_native_id()).all(), np.unique(out)
    for header in CPU_EMU.glob("*.h"):
        assert not re.search(r"#include <(thread|barrier)>", header.read_text()), header.name
