"""ctypes binding of the permutohedral-lattice dense CRF (``native/crf``).

The port's copy of ``depthg_tpu/native_crf.py``: the host-side algorithm of
the reference's pydensecrf path (lattice-approximated Gaussian + bilateral
mean field), the yardstick of the fidelity study's "label agreement vs
lattice" column. It loads the committed ``native/crf/libpermutocrf.so``; if
that file is missing or does not load on this host (another glibc, say), it
builds ``native/crf/permutohedral_crf.cpp`` with ``g++`` into
``build/native_crf/`` at the repository root and loads that. It never
writes under ``native/``, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_ROOT, "native", "crf")
_LIB_PATH = os.path.join(_SRC_DIR, "libpermutocrf.so")
BUILD_DIR = os.path.join(_ROOT, "build", "native_crf")
_lib = None


def _build() -> str:
    """Compile the lattice into ``BUILD_DIR``; returns the library's path."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("native CRF: the committed library does not load and no "
                           "g++ is on PATH to build native/crf/permutohedral_crf.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "libpermutocrf.so")
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, "-O3", "-std=c++17", "-shared", "-fPIC",
                           os.path.join(_SRC_DIR, "permutohedral_crf.cpp"), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native CRF: g++ failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        lib = ctypes.CDLL(_build())
    lib.dense_crf_inference.restype = ctypes.c_int
    lib.dense_crf_inference.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float,
    ]
    _lib = lib
    return lib


def dense_crf_native(image: np.ndarray, probs: np.ndarray, n_iters: int = 10,
                     pos_w: float = 3.0, pos_xy_std: float = 1.0,
                     bi_w: float = 4.0, bi_xy_std: float = 67.0,
                     bi_rgb_std: float = 3.0) -> np.ndarray:
    """image: [3, H, W] raw 0..255; probs: [C, H, W] softmax unary.
    Returns refined Q [C, H, W]."""
    lib = _load()
    c, h, w = probs.shape
    q = np.ascontiguousarray(probs.transpose(1, 2, 0).reshape(-1, c),
                             dtype=np.float32)
    img = np.ascontiguousarray(image.transpose(1, 2, 0).reshape(-1, 3),
                               dtype=np.float32)
    ret = lib.dense_crf_inference(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, c, n_iters, pos_w, pos_xy_std, bi_w, bi_xy_std, bi_rgb_std)
    if ret != 0:
        raise RuntimeError(f"dense_crf_inference failed: {ret}")
    return q.reshape(h, w, c).transpose(2, 0, 1)
