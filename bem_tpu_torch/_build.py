"""Build and load the package's Hopper kernels.

All of ``csrc/*.cu`` is compiled by one ``nvcc`` call into a shared library
with a plain C interface (``build/libbem_kernels_<hash>.so``) at first use,
and loaded with ctypes. The file name carries a hash of the sources and
flags, so an edited source rebuilds. A failed build raises: nothing runs
without the kernels. ``build/nvcc.log`` keeps the compiler's ``-Xptxas -v``
report (registers, shared memory and spills of every kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (name, argtypes). Pointers and the stream are c_void_p so
# ctypes passes them at full width.
_SIGNATURES = {
    "bem_stem_fused": [_P] * 8 + [_I] * 6 + [_P],
    "bem_gdmlp_fused": [_P] * 10 + [_I] * 8 + [_P],
    "bem_ss2d_seq_dir": [_P] * 8 + [_I] * 7 + [_P],
    "bem_ss2d_tail": [_P] * 8 + [_I] * 5 + [_P],
}

_LIB = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libbem_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{r.stderr[-8000:]}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bem_error_string.argtypes = [ctypes.c_int]
        lib.bem_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def call(name: str, *args) -> None:
    """Launch ``name`` on the current CUDA stream; raise on a CUDA error."""
    import torch

    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.bem_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
