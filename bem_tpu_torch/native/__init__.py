"""ctypes bindings for the native host-pipeline library (counterpart of
bem_tpu/native/__init__.py).

``histogram.cpp`` (this package's own copy of bem_tpu's) is compiled with
``g++ -O3 -shared -fPIC -pthread`` at first use into
``bem_tpu_torch/build/libbem_native_<hash>.so`` (the hash of the source and
flags, so an edited source rebuilds; written to a temporary file and moved
into place, so concurrent first uses do not clash). Without a compiler,
or where the build fails, :func:`available` is False and each entry point
returns None; their callers then take the numpy route
(``utils.histogram.compute_histograms``). Host code: the device path never
calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "histogram.cpp"
BUILD_DIR = _DIR.parent / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_lib = None
_F = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libbem_native_{h}.so"


def _build() -> Path | None:
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    try:
        lib = ctypes.CDLL(str(so)) if so is not None else None
    except OSError:
        lib = None
    if lib is not None:
        lib.kde_histograms.argtypes = [_F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _F, ctypes.c_int]
        lib.kde_histograms.restype = None
        lib.paired_crop_augment.argtypes = [_F, _F] + [ctypes.c_int] * 6 + [_F, _F]
        lib.paired_crop_augment.restype = None
    _lib = lib or False
    return _lib


def available() -> bool:
    return bool(_load())


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def kde_histograms(image: np.ndarray, patch: int, bins: int,
                   n_threads: int = 2) -> np.ndarray | None:
    """(H, W, 3) float32 [0,1] -> (3, nH, nW, bins); native or None."""
    lib = _load()
    if not lib:
        return None
    image = _f32(image)
    H, W, C = image.shape
    if C != 3:
        raise ValueError(f"kde_histograms: the image must have 3 channels, has {C}")
    out = np.empty((3, -(-H // patch), -(-W // patch), bins), np.float32)
    lib.kde_histograms(image.ctypes.data_as(_F), H, W, patch, bins, out.ctypes.data_as(_F),
                       max(1, n_threads))
    return out


def paired_crop_augment(lq: np.ndarray, gt: np.ndarray, top: int, left: int,
                        patch: int, mode: int):
    """Fused crop + geometric-augment; returns (gt_out, lq_out) or None."""
    lib = _load()
    if not lib:
        return None
    lq, gt = _f32(lq), _f32(gt)
    H, W, _ = lq.shape
    if gt.shape != lq.shape or not (0 <= top <= H - patch and 0 <= left <= W - patch):
        raise ValueError(f"paired_crop_augment: a {patch}-crop at ({top}, {left}) of "
                         f"{lq.shape} / {gt.shape}")
    if not 0 <= mode <= 7:
        raise ValueError("Invalid choice of image transformation")
    out_lq = np.empty((patch, patch, 3), np.float32)
    out_gt = np.empty((patch, patch, 3), np.float32)
    lib.paired_crop_augment(lq.ctypes.data_as(_F), gt.ctypes.data_as(_F), H, W, top, left,
                            patch, mode, out_lq.ctypes.data_as(_F), out_gt.ctypes.data_as(_F))
    return out_gt, out_lq
