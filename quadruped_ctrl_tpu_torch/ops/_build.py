"""Build and load the port's CUDA kernels.

The sources under `quadruped_ctrl_tpu_torch/csrc/` have a plain C interface
and include no PyTorch header: one `nvcc` per `.cu` file, all started
together, compiles them to objects in seconds, and one more links the shared
library. The library is named by a hash of the sources and lives in
`quadruped_ctrl_tpu_torch/_build/` (listed in `.gitignore`): an edited source
gets a new library at its first use, an unchanged one is loaded as it is.
Pointers and the stream cross as `ctypes.c_void_p`.

Importing this module builds nothing and needs no `nvcc`; `load()` builds on
first use and raises if the build fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "qct_form_packed": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P), _I),
    "qct_form_packed_smem_bytes": ((_I, _I), ctypes.c_int64),
    "qct_form_packed_mma_count": ((_I, _I), ctypes.c_int64),
    "qct_ns_inverse_scaled": ((_P, _P, _I, _P, _I, _I, _I, _P), _I),
    "qct_ns_inverse_scaled_build": (
        (_P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P), _I),
    "qct_ns_inverse_scaled_256": ((_P, _P, _I, _P, _I, _I, _I, _P), _I),
    "qct_ns_inverse_scaled_build_256": (
        (_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P), _I),
    "qct_ns_inverse_refine": ((_P, _P, _P, _I, _I, _I, _P), _I),
    "qct_ns_inverse_refine_256": ((_P, _P, _P, _I, _I, _I, _P), _I),
    "qct_ns_inverse_plain": ((_P, _P, _I, _I, _P), _I),
    "qct_ns_inverse_plain_256": ((_P, _P, _I, _I, _P), _I),
    "qct_ns_inverse_plain_one": ((_P, _P, _I, _I, _P), _I),
    "qct_ns_plain_clusters": ((_I, _P, _P), _I),
    "qct_ns_inverse_warm": ((_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _F, _P), _I),
    "qct_ns_inverse_warm_256": ((_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _F, _P), _I),
    "qct_ns_warm_guarded": ((_P, _P, _P, _P, _I, _I, _I, _F, _I, _P), _I),
    "qct_ns_inverse_scaled_masked": ((_P, _P, _P, _I, _P, _I, _I, _I, _P), _I),
    "qct_ns_inverse_scaled_masked_256": ((_P, _P, _P, _I, _P, _I, _I, _I, _P), _I),
    "qct_fused_admm_solve": (
        (_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P), _I),
    "qct_ns_refine_units": ((_I, _I, _P), _I),
}


def source_files() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    digest = hashlib.sha256()
    for path in source_files():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels can only be built where the CUDA toolkit is")


def library_path() -> Path:
    return BUILD_DIR / f"libqct_kernels_{source_hash()}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless a library of the same hash exists: one
    nvcc per .cu file in parallel, then a link. Returns (library path,
    seconds spent compiling and linking; 0.0 when it existed)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    sources = [p for p in source_files() if p.suffix == ".cu"]
    objects = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs = [f"{src.name}:\n{proc.communicate()[0]}" for src, proc in zip(sources, procs)]
    failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objects)], capture_output=True, text=True)
        logs.append(f"link:\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs)[-8000:])
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib
