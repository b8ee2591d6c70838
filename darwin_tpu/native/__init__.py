"""ctypes bindings for the native host runtime (src/dtnative.cpp).

The shared library is compiled on first use with the system g++ (no
pip-installable toolchain dependencies); every entry point has a pure
NumPy/Python fallback in the rest of the package, so the framework
works — just slower on the host side — when no compiler is available.
Set ``DARWIN_TPU_NATIVE=0`` to force the fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "src" / "dtnative.cpp"
_SO = _DIR / "libdtnative.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

# -march=native is safe here: the .so is compiled on this machine at
# first import (and rebuilt whenever the source is newer), never
# shipped; it lets the compiler vectorize the hash/window-min kernels.
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
              "-funroll-loops", "-march=native", "-Wall"]


def _build() -> bool:
    cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS,
           str(_SRC), "-o", str(_SO)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        import sys
        print(f"darwin_tpu.native build failed:\n{proc.stderr}",
              file=sys.stderr)
        return False
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("DARWIN_TPU_NATIVE", "1") in ("0", "off"):
            return None
        fresh = (_SO.exists()
                 and _SO.stat().st_mtime >= _SRC.stat().st_mtime)
        if not fresh and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        _declare(lib)
        if lib.dt_version() != 1:
            return None
        _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p, i64p, u32p, u64p = (c.POINTER(c.c_uint8), c.POINTER(c.c_int64),
                             c.POINTER(c.c_uint32), c.POINTER(c.c_uint64))
    lib.dt_version.restype = c.c_int
    lib.dt_buf_size.argtypes = [c.c_void_p]
    lib.dt_buf_size.restype = c.c_int64
    lib.dt_buf_fill.argtypes = [c.c_void_p, u64p]
    lib.dt_buf_free.argtypes = [c.c_void_p]
    lib.dt_scan_minimizers.argtypes = [u8p, c.c_int64, c.c_int, c.c_int,
                                       c.c_int]
    lib.dt_scan_minimizers.restype = c.c_void_p
    lib.dt_build_table.argtypes = [u8p, c.c_int64, c.c_int, c.c_int,
                                   c.c_int]
    lib.dt_build_table.restype = c.c_void_p
    lib.dt_dsoft_batch.argtypes = [
        u32p, u32p, c.c_int64, c.c_int, c.c_int64, c.c_int64, c.c_int64,
        c.c_int, u8p, i64p, i64p, i64p, c.c_int64, c.c_int64, c.c_int64,
        c.c_int64, c.c_int]
    lib.dt_dsoft_batch.restype = c.c_void_p
    lib.dt_dsoft_total.argtypes = [c.c_void_p]
    lib.dt_dsoft_total.restype = c.c_int64
    lib.dt_dsoft_fill.argtypes = [c.c_void_p, i64p, i64p, i64p]
    lib.dt_dsoft_free.argtypes = [c.c_void_p]
    lib.dt_fasta_parse.argtypes = [c.c_char_p]
    lib.dt_fasta_parse.restype = c.c_void_p
    for name in ("dt_fasta_ok",):
        getattr(lib, name).argtypes = [c.c_void_p]
        getattr(lib, name).restype = c.c_int
    for name in ("dt_fasta_nrecords", "dt_fasta_seq_total",
                 "dt_fasta_desc_total"):
        getattr(lib, name).argtypes = [c.c_void_p]
        getattr(lib, name).restype = c.c_int64
    lib.dt_fasta_fill.argtypes = [c.c_void_p, u8p, i64p, u8p, i64p]
    lib.dt_fasta_free.argtypes = [c.c_void_p]


def available() -> bool:
    return _load() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _take_buf(lib, handle) -> np.ndarray:
    n = lib.dt_buf_size(handle)
    out = np.empty(n, dtype=np.uint64)
    if n:
        lib.dt_buf_fill(handle, _ptr(out, ctypes.c_uint64))
    lib.dt_buf_free(handle)
    return out


def scan_minimizers(seq: np.ndarray, k: int, w: int, query_conv: bool
                    ) -> np.ndarray:
    """(hash << 32) | pos minimizers in scan order (native)."""
    lib = _load()
    assert lib is not None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    h = lib.dt_scan_minimizers(_u8ptr(seq), len(seq), k, w,
                               int(query_conv))
    return _take_buf(lib, h)


def build_table_keys(ref: np.ndarray, k: int, w: int,
                     num_threads: int | None = None) -> np.ndarray:
    """Sorted (hash << 32) | pos seed-table keys (native parallel scan
    + parallel sort)."""
    lib = _load()
    assert lib is not None
    if num_threads is None:
        num_threads = os.cpu_count() or 1
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    h = lib.dt_build_table(_u8ptr(ref), len(ref), k, w, num_threads)
    return _take_buf(lib, h)


def dsoft_batch(hashes: np.ndarray, pos: np.ndarray, k: int, w: int,
                bin_size: int, ref_size: int, kmer_max_occ: int,
                flat: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                read_ids: np.ndarray, num_seeds_cap: int, threshold: int,
                max_candidates: int, num_threads: int | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multithreaded D-SOFT over a batch of reads.

    Returns (counts, hits, offsets): per-read candidate counts (aligned
    with read_ids) and the candidates concatenated in read order, each
    read's candidates in emission order.
    """
    lib = _load()
    assert lib is not None
    if num_threads is None:
        num_threads = os.cpu_count() or 1
    hashes = np.ascontiguousarray(hashes, dtype=np.uint32)
    pos = np.ascontiguousarray(pos, dtype=np.uint32)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int64)
    n = len(read_ids)
    h = lib.dt_dsoft_batch(
        _ptr(hashes, ctypes.c_uint32), _ptr(pos, ctypes.c_uint32),
        len(hashes), k, bin_size, ref_size, kmer_max_occ, w,
        _u8ptr(flat), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), _ptr(read_ids, ctypes.c_int64),
        n, num_seeds_cap, threshold, max_candidates, num_threads)
    total = lib.dt_dsoft_total(h)
    counts = np.empty(n, dtype=np.int64)
    hits = np.empty(total, dtype=np.int64)
    offsets = np.empty(total, dtype=np.int64)
    lib.dt_dsoft_fill(h, _ptr(counts, ctypes.c_int64),
                      _ptr(hits, ctypes.c_int64),
                      _ptr(offsets, ctypes.c_int64))
    lib.dt_dsoft_free(h)
    return counts, hits, offsets


def parse_fasta(path) -> list | None:
    """Native FASTA load; None when unavailable or on parse error (the
    caller falls back to the pure parser, which raises the detailed
    error)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.dt_fasta_parse(str(path).encode())
    if not h:
        return None
    try:
        if not lib.dt_fasta_ok(h):
            return None
        n = lib.dt_fasta_nrecords(h)
        seq_blob = np.empty(lib.dt_fasta_seq_total(h), dtype=np.uint8)
        desc_blob = np.empty(lib.dt_fasta_desc_total(h), dtype=np.uint8)
        seq_off = np.empty(n + 1, dtype=np.int64)
        desc_off = np.empty(n + 1, dtype=np.int64)
        lib.dt_fasta_fill(h, _u8ptr(seq_blob),
                          _ptr(seq_off, ctypes.c_int64), _u8ptr(desc_blob),
                          _ptr(desc_off, ctypes.c_int64))
    finally:
        lib.dt_fasta_free(h)

    from darwin_tpu.io.fasta import FastaRecord, split_fields
    seq_bytes = seq_blob.tobytes()
    desc_bytes = desc_blob.tobytes()
    records = []
    for i in range(n):
        desc = desc_bytes[desc_off[i]:desc_off[i + 1]].decode("ascii")
        seq = seq_bytes[seq_off[i]:seq_off[i + 1]].decode("ascii")
        records.append(FastaRecord(split_fields(desc), seq))
    return records
