"""Tile-batch aligner frontends: one call = DP + traceback on device.

Backend dispatch by platform: the CUDA kernel (ops/cuda_dp.py) on the
GPU, the portable lax formulation (ops/reference_dp.py) on the CPU;
both feed the same packed6 traceback.  Equivalent of the reference's
Align_Batch_GPU host wrapper (cuda_host.cu:23-190), minus the
per-batch marshaling: tiles arrive as fixed-shape arrays and results
come back as NumPy.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import (pack_dir_words6,
                                      traceback_packed6_jax)

BACKENDS = ("cuda", "lax")
_PLATFORM_BACKEND = {"gpu": "cuda", "cpu": "lax"}


def backend_for(platform: str) -> str:
    """The tile-DP backend for a JAX platform name."""
    try:
        return _PLATFORM_BACKEND[platform]
    except KeyError:
        raise RuntimeError(
            f"no tile-DP backend for platform {platform!r} "
            f"(supported: {sorted(_PLATFORM_BACKEND)})") from None


def resolve_backend(backend: str = "auto") -> str:
    """Validate a backend name ("auto" = by the default platform) and
    make it usable: "cuda" builds and registers the kernel, raising if
    it cannot."""
    if backend == "auto":
        backend = backend_for(jax.default_backend())
    if backend not in BACKENDS:
        raise ValueError(f"unknown tile-DP backend {backend!r}")
    if backend == "cuda":
        from darwin_tpu.ops import cuda_dp
        cuda_dp.load()
    return backend


def tile_dp_words(backend: str, ref, query, rlen, qlen, *, match: int,
                  mismatch: int, gap_open: int, gap_extend: int):
    """Tile DP returning (stats dict, packed6 traceback words)."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if backend == "cuda":
        from darwin_tpu.ops.cuda_dp import align_tiles_cuda
        out = align_tiles_cuda(ref, query, rlen, qlen, **kw)
        return out, out["dir_words"]
    out = align_tiles_jax(ref, query, rlen, qlen, **kw)
    return out, pack_dir_words6(out["dir"])


@dataclasses.dataclass
class TileResult:
    ops: np.ndarray        # [B, S] uint8, arrival order, 0 = none
    ref_steps: np.ndarray  # [B] int32 (kernel i_steps)
    query_steps: np.ndarray  # [B] int32 (kernel j_steps)
    score: np.ndarray      # [B] int32: max score (first) / corner score
    max_i: np.ndarray      # [B] int32 (1-indexed, first tiles only)
    max_j: np.ndarray      # [B] int32


class JaxTileAligner:
    def __init__(self, *, tile_size: int, early_terminate: int,
                 match: int, mismatch: int, gap_open: int,
                 gap_extend: int, backend: str = "auto"):
        backend = resolve_backend(backend)
        self.backend = backend
        self.tile_size = tile_size
        self.early_terminate = early_terminate

        def step(ref, query, rlen, qlen, first):
            # packed6: 2-4 walk steps per gather (the op stream carries
            # in-group holes, which the scoring lookback skips).
            out, words = tile_dp_words(
                backend, ref, query, rlen, qlen, match=match,
                mismatch=mismatch, gap_open=gap_open,
                gap_extend=gap_extend)
            ops, _mb, i_steps, j_steps = traceback_packed6_jax(
                words, rlen, qlen, first, out["max_i"],
                out["max_j"], early_terminate=early_terminate)
            score = jax.numpy.where(first, out["max_score"],
                                    out["pos_score"])
            return (ops.T, i_steps, j_steps, score, out["max_i"],
                    out["max_j"])

        self._step = jax.jit(step)

    def __call__(self, ref_tiles: np.ndarray, query_tiles: np.ndarray,
                 ref_lens: np.ndarray, query_lens: np.ndarray,
                 firsts: np.ndarray) -> TileResult:
        ops, i_s, j_s, score, mi, mj = jax.device_get(self._step(
            ref_tiles, query_tiles, ref_lens.astype(np.int32),
            query_lens.astype(np.int32), firsts.astype(bool)))
        return TileResult(
            ops=np.asarray(ops), ref_steps=np.asarray(i_s),
            query_steps=np.asarray(j_s), score=np.asarray(score),
            max_i=np.asarray(mi), max_j=np.asarray(mj))
