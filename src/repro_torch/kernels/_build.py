"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface. It is compiled at first
use with ``nvcc`` for ``sm_90a`` into a shared library under the
repository's ``build/kernels/`` and loaded with ``ctypes``. The library's
file name carries a digest of the source and the flags, so an edited source
builds anew and an unchanged one is reused. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "load_gustavson"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (no CUDA_HOME/bin/nvcc and none on PATH): the "
            "CUDA kernels are built from source at first use"
        )
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (once per source digest) and return the
    shared library's path. The compiler's output, register and shared
    memory use included, is kept beside it as ``<library>.log``."""
    source = _CSRC / f"{name}.cu"
    digest = hashlib.blake2b(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode(), digest_size=8
    ).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    with _BUILD_LOCK:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib)
    return lib


@functools.cache
def load_gustavson() -> ctypes.CDLL:
    """The block-Gustavson kernel library, built on first call."""
    lib = ctypes.CDLL(str(build("gustavson_spgemm")))
    fn = lib.gustavson_spgemm_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    fn.restype = i32
    return lib
