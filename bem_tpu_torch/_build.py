"""Build and load the package's Hopper kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface (``build/libbem_kernels_<hash>.so``) at first use, loaded with
ctypes. The file name carries a hash of the sources and flags, so an
edited source rebuilds. A failed build raises: nothing runs without the
kernels. ``build/nvcc_<source>.log`` keeps the compiler's ``-Xptxas -v``
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# C entry points: (name, argtypes). Pointers and the stream are c_void_p so
# ctypes passes them at full width.
_SIGNATURES = {
    "bem_stem_fused": [_P] * 8 + [_I] * 6 + [_P],
    "bem_gdmlp_fused": [_P] * 11 + [_I] * 8 + [_P],
    "bem_ss2d_seq_sum": [_P] * 13 + [_I] * 6 + [_P],
    "bem_ss2d_seq_full": [_P] * 13 + [_I] * 6 + [_P],
    "bem_ss2d_tail": [_P] * 8 + [_I] * 5 + [_P],
    "bem_ss2d_tail_tc_with": [_P] * 8 + [_I] * 7 + [_P, _P],
    "bem_ss2d_col_sum": [_P] * 13 + [_I] * 8 + [_P],
    "bem_ss2d_col_full": [_P] * 14 + [_I] * 8 + [_P],
    "bem_linear_scan": [_P] * 5 + [_I] * 9 + [_P],
    "bem_ss2d_fused_project": [_P] * 3 + [_I] * 5 + [_P],
    "bem_ss2d_fused_fwd_sum": [_P] * 7 + [_I] * 8 + [_P],
    "bem_ss2d_fused_fwd": [_P] * 9 + [_I] * 8 + [_P],
    "bem_ss2d_fused_bwd_sum": [_P] * 9 + [_I] * 5 + [_P],
    "bem_ss2d_fused_bwd": [_P] * 21 + [_I] * 5 + [_P],
    "bem_selective_scan_sum": [_P] * 7 + [_I] * 8 + [_P],
    "bem_selective_scan_fused": [_P] * 9 + [_I] * 8 + [_P],
    "bem_vpu_scan_step": [_P] * 2 + [_L] + [_I] * 2 + [_P],
    "bem_vpu_op_rounds": [_P] * 2 + [_L] + [_I] * 2 + [_P],
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


def _run_all(cmds, logs):
    """Run the commands concurrently, each writing to its log file; returns
    [(cmd, returncode, output)]."""
    procs = []
    for c, log in zip(cmds, logs):
        with open(log, "w") as fh:
            fh.write(" ".join(c) + "\n")
            fh.flush()
            procs.append(subprocess.Popen(c, stdout=fh, stderr=subprocess.STDOUT))
    return [(c, p.wait(), Path(log).read_text()) for c, p, log in zip(cmds, procs, logs)]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    cu, _ = _sources()
    nvcc = _nvcc()
    tmpdir = BUILD_DIR / f"obj_{so.stem}_{os.getpid()}"
    tmpdir.mkdir(parents=True, exist_ok=True)
    objs = [tmpdir / (f.stem + ".o") for f in cu]
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(f), "-o", str(o)]
                        for f, o in zip(cu, objs)],
                       [BUILD_DIR / f"nvcc_{f.stem}.log" for f in cu])
    failed = [(cmd, rc, out) for cmd, rc, out in results if rc != 0]
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {cmd[-3]}:\n{out[-8000:]}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    (cmd, rc, out), = _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                                 "-o", str(tmp), *map(str, objs)]],
                               [BUILD_DIR / "nvcc_link.log"])
    if rc != 0:
        raise RuntimeError(f"nvcc link failed ({rc}):\n{out[-8000:]}")
    os.replace(tmp, so)
    shutil.rmtree(tmpdir, ignore_errors=True)
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
        lib.bem_ss2d_seq_chunk.argtypes = [_I] * 3
        lib.bem_ss2d_seq_chunk.restype = ctypes.c_int
        lib.bem_ss2d_col_chunk.argtypes = [_I] * 4
        lib.bem_ss2d_col_chunk.restype = ctypes.c_int
        lib.bem_ss2d_fused_chunk.argtypes = [_I] * 4
        lib.bem_ss2d_fused_chunk.restype = ctypes.c_int
        lib.bem_selective_scan_chunk.argtypes = [_I] * 4
        lib.bem_selective_scan_chunk.restype = ctypes.c_int
        lib.bem_ss2d_fused_bwd_cb.argtypes = [_I]
        lib.bem_ss2d_fused_bwd_cb.restype = ctypes.c_int
        lib.bem_gdmlp_form.argtypes = [_I] * 7
        lib.bem_gdmlp_form.restype = ctypes.c_int
        lib.bem_gdmlp_ws.argtypes = [_I] * 7
        lib.bem_gdmlp_ws.restype = ctypes.c_long
        lib.bem_stem_form.argtypes = [_I] * 6
        lib.bem_stem_form.restype = ctypes.c_int
        lib.bem_linear_scan_ws.argtypes = [_I] * 6
        lib.bem_linear_scan_ws.restype = ctypes.c_long
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
