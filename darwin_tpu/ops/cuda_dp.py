"""GACT tile DP as a CUDA kernel for Hopper, called through jax.ffi.

The kernel (cuda/tile_dp.cu) computes what align_tiles_jax followed by
pack_dir_words6 computes, bit for bit, in one pass: packed6 traceback
words straight from registers, no byte direction matrix in between.
It has no CPU or interpret mode; the CPU tests cover the wrapper's
shapes and the build's failure path, and the chip check
(chip_smoke.py) compares it with align_tiles_jax.

The shared library is compiled from the tracked source with nvcc on
first use (or by ``python -m darwin_tpu.ops.cuda_dp``) into
``darwin_tpu/ops/cuda/build/``, named by a hash of the source and
flags, so a stale build is never loaded.  A failed build raises: the
GPU path never falls back to another kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_DIR = Path(__file__).resolve().parent / "cuda"
SOURCE = _DIR / "tile_dp.cu"
BUILD_DIR = _DIR / "build"
TARGET = "darwin_tile_dp"
MAX_TILE = 1023  # 32 lanes x 32 columns per lane, minus column 0
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """nvcc from $NVCC, $PATH or the default CUDA install."""
    return (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdarwin_tile_dp-{key}.so"


def build() -> Path:
    """Compile the kernel library unless this source's build exists.

    Raises RuntimeError when nvcc is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)  # one build at a time per checkout
        if so.exists():
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(),
               "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"CUDA tile-DP build failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError("CUDA tile-DP build failed:\n"
                               + proc.stderr[-4000:])
        os.replace(tmp, so)
    return so


def load() -> None:
    """Build if needed, load the library and register the FFI target."""
    global _lib
    with _lock:
        if _lib is not None:
            return
        lib = ctypes.CDLL(str(build()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.DarwinTileDp), platform="CUDA")
        _lib = lib


@functools.partial(
    jax.jit, static_argnames=("match", "mismatch", "gap_open",
                              "gap_extend"))
def align_tiles_cuda(ref: jnp.ndarray, query: jnp.ndarray,
                     ref_len: jnp.ndarray, query_len: jnp.ndarray, *,
                     match: int, mismatch: int, gap_open: int,
                     gap_extend: int):
    """Tile DP on the GPU.

    ref, query: [B, T] uint8 tiles (padded with PAD_REF/PAD_QUERY);
    ref_len, query_len: [B] true lengths.  Returns dict(dir_words=
    [B, T, T+1] int32 packed6 words, max_score, max_i, max_j,
    pos_score: [B] int32) — exactly align_tiles_jax's stats and
    pack_dir_words6 of its direction matrix.  The FFI target must be
    registered first: load(), or resolve_backend("cuda").
    """
    B, T = ref.shape
    if T > MAX_TILE:
        raise ValueError(f"tile_size {T} > {MAX_TILE} is not supported "
                         f"by the CUDA kernel")
    words, stats = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((B, T, T + 1), jnp.int32),
         jax.ShapeDtypeStruct((B, 4), jnp.int32)),
    )(ref.astype(jnp.uint8), query.astype(jnp.uint8),
      ref_len.astype(jnp.int32), query_len.astype(jnp.int32),
      match=np.int32(match), mismatch=np.int32(mismatch),
      gap_open=np.int32(gap_open), gap_extend=np.int32(gap_extend))
    return dict(dir_words=words, max_score=stats[:, 0],
                max_i=stats[:, 1], max_j=stats[:, 2], pos_score=stats[:, 3])


if __name__ == "__main__":
    print(build())
