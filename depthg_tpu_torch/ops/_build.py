"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``depthg_tpu_torch/csrc/`` is compiled at first use into
``build/depthg_tpu_torch/`` at the repository root (listed in .gitignore),
with a plain C interface and no PyTorch headers, so a build takes seconds.
The library's file name carries a hash of the source and the flags: an edit
to the source builds a new library, an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "depthg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# seconds each library took to compile in this process (0.0 when reused)
BUILD_SECONDS: dict[str, float] = {}
# ptxas report (registers, shared memory, spills) of each compiled library
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels of depthg_tpu_torch are built at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(CSRC / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = proc.stderr
    else:
        BUILD_SECONDS.setdefault(name, 0.0)
    return ctypes.CDLL(str(so))
