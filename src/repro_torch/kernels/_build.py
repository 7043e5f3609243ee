"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface. It is compiled at first
use with ``nvcc`` for ``sm_90a`` into a shared library under the
repository's ``build/kernels/`` and loaded with ``ctypes``. The library's
file name carries a digest of the source, the shared headers (``*.cuh``)
and the flags, so an edited source or header builds anew and an unchanged
one is reused. A failed build raises. No library is linked against the
CUDA library libcuda: the bfloat16 paths of the grouped matmul and the
block-sparse SpMM take ``cuTensorMapEncodeTiled`` through
``cudaGetDriverEntryPoint`` at run time.
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

__all__ = [
    "BUILD_DIR",
    "SOURCES",
    "build",
    "load_bsr_spmm",
    "load_flash_attention",
    "load_gustavson",
    "load_moe_gmm",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Every kernel source under csrc/.
SOURCES = ("gustavson_spgemm", "flash_attention", "bsr_spmm", "moe_gmm")
# One lock per library: two sources build side by side, one source once.
_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


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
    h = hashlib.blake2b(source.read_bytes(), digest_size=8)
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
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
    for name in ("gustavson_spgemm_smem_bytes", "gustavson_spgemm_blocks_per_sm",
                 "gustavson_spgemm_threads"):
        getattr(lib, name).argtypes = [i32] * 4
        getattr(lib, name).restype = i32
    return lib


@functools.cache
def load_flash_attention() -> ctypes.CDLL:
    """The flash-attention kernel library, built on first call."""
    lib = ctypes.CDLL(str(build("flash_attention")))
    fn = lib.flash_attention_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 4 + [i32] * 5 + [ctypes.c_float] + [i32] * 4 + [ptr]
    fn.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32, i32]
    lib.flash_attention_smem_bytes.restype = i32
    return lib


@functools.cache
def load_bsr_spmm() -> ctypes.CDLL:
    """The block-sparse SpMM kernel library, built on first call."""
    lib = ctypes.CDLL(str(build("bsr_spmm")))
    fn = lib.bsr_spmm_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    fn.restype = i32
    for name in ("bsr_spmm_smem_bytes", "bsr_spmm_blocks_per_sm"):
        getattr(lib, name).argtypes = [i32] * 2
        getattr(lib, name).restype = i32
    return lib


@functools.cache
def load_moe_gmm() -> ctypes.CDLL:
    """The grouped-matmul kernel library, built on first call."""
    lib = ctypes.CDLL(str(build("moe_gmm")))
    fn = lib.moe_gmm_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    fn.restype = i32
    enc = lib.moe_gmm_encode_maps
    enc.argtypes = [ptr] * 2 + [i32] * 6
    enc.restype = i32
    lib.moe_gmm_smem_bytes.argtypes = [i32, i32]
    lib.moe_gmm_smem_bytes.restype = i32
    return lib
