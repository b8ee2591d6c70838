"""Score-only batched local Smith-Waterman (affine gaps), any length.

The NPBSS score evaluator (reference .measure_sensitivity_NPBSS.py:136)
shells out to an external exact aligner (`ksw` from sw_sse2) to score
"perfect" overlaps.  The in-repo equivalent is this op: the same row
wavefront as ops/reference_dp.py with no direction matrix and no
traceback — O(B * LR * LQ) compute, O(B * LQ) memory — so full-length
read pairs (tens of kb) score exactly in one call, on CPU or on chip.

Gap convention matches the engine (align.cpp:129-141): a gap of length
g costs gap_open + (g-1)*gap_extend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from darwin_tpu.ops.common import NEG_INF


def _shift_right(x: jnp.ndarray, fill) -> jnp.ndarray:
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]],
        axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("match", "mismatch", "gap_open", "gap_extend"))
def local_score_batch(ref: jnp.ndarray, query: jnp.ndarray,
                      ref_len: jnp.ndarray, query_len: jnp.ndarray, *,
                      match: int, mismatch: int, gap_open: int,
                      gap_extend: int) -> jnp.ndarray:
    """Max local alignment score per batch item.

    ref: [B, LR] uint8, query: [B, LQ] uint8 (zero-padded);
    ref_len/query_len: [B] true lengths.  Returns [B] int32.
    """
    B, LR = ref.shape
    LQ = query.shape[1]
    TJ = LQ + 1
    dt = jnp.int32

    qs = jnp.pad(query, ((0, 0), (1, 0)))
    ref_len = ref_len.astype(dt)
    query_len = query_len.astype(dt)
    jlane = jax.lax.broadcasted_iota(dt, (B, TJ), 1)
    jvalid = (jlane >= 1) & (jlane <= query_len[:, None])
    lge = jlane * gap_extend

    def row(i, carry):
        m_prev, i_prev, d_prev, best = carry
        r = jax.lax.dynamic_slice_in_dim(ref, i - 1, 1, axis=1)
        match_s = jnp.where(qs == r, match, mismatch).astype(dt)

        prev3 = jnp.maximum(jnp.maximum(m_prev, i_prev), d_prev)
        m_new = jnp.maximum(_shift_right(prev3, 0) + match_s, 0)
        m_new = m_new.at[:, 0].set(0)

        i_new = jnp.maximum(m_prev + gap_open, i_prev + gap_extend)
        i_new = i_new.at[:, 0].set(-NEG_INF)

        u = m_new + gap_open - lge
        c = jax.lax.cummax(u, axis=1)
        d_new = _shift_right(c, -NEG_INF) + (lge - gap_extend)
        d_new = d_new.at[:, 0].set(-NEG_INF)

        h = jnp.maximum(jnp.maximum(m_new, i_new),
                        jnp.maximum(d_new, 0))
        hv = jnp.where(jvalid & (i <= ref_len)[:, None], h, 0)
        best = jnp.maximum(best, jnp.max(hv, axis=1))
        return (m_new, i_new, d_new, best)

    m0 = jnp.zeros((B, TJ), dt)
    ninf = jnp.full((B, TJ), -NEG_INF, dt)
    zero = jnp.zeros((B,), dt)
    _, _, _, best = jax.lax.fori_loop(1, LR + 1, row,
                                      (m0, ninf, ninf, zero))
    return best
