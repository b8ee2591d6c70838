"""Batched GACT tile DP as a pure-JAX row wavefront.

This is the portable formulation of the tile aligner: it runs on any
JAX backend (CPU tests, multi-device dryruns) and is the plain
reference for the CUDA kernel in cuda_dp.py.  Both compute, for a batch
of tiles, exactly what AlignWithBT's DP loop computes (reference
align.cpp:114-183): the direction matrix, the row-major-last max cell,
and the anchor-corner score.

Vectorization: one DP row per step (the query axis and the batch are
array axes).  Two sequential recurrences are broken:

* the query-gap (D) in-row recurrence d[j] = max(m[j-1]+go, d[j-1]+ge)
  has the max-plus closed form
      d[j] = (j-1)*ge + cummax_{l<=j-1}( m[l] + go - l*ge )
  i.e. one cumulative max per row;
* the max-cell tie rule ("last row-major cell wins at >=",
  align.cpp:173-177) becomes per-row [row max, largest j attaining it]
  then a >= merge across rows.

Scores use int32; the reference's -INF becomes NEG_INF with headroom.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from darwin_tpu.ops.common import (GAP_OPEN_FLAG_D, GAP_OPEN_FLAG_I,
                                   MATCH_BIT, NEG_INF)


def _shift_right(x: jnp.ndarray, fill) -> jnp.ndarray:
    """Lane shift: out[..., j] = x[..., j-1], out[..., 0] = fill."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]],
        axis=-1)


@functools.partial(
    jax.jit, static_argnames=("match", "mismatch", "gap_open", "gap_extend"))
def align_tiles_jax(ref: jnp.ndarray, query: jnp.ndarray,
                    ref_len: jnp.ndarray, query_len: jnp.ndarray,
                    *, match: int, mismatch: int, gap_open: int,
                    gap_extend: int):
    """DP over a batch of tiles.

    Args:
      ref, query: [B, T] uint8 tile bytes, already oriented (the engine
        reverses right-extension tiles, mirroring the CUDA marshaling,
        cuda_host.cu:113-142); padded with PAD_REF/PAD_QUERY.
      ref_len, query_len: [B] int32 true lengths (0 allowed for idle).

    Returns dict with:
      dir: [B, T, T+1] uint8 direction bytes; row r holds DP row r+1
        (DP row 0 / column 0 are implicitly ZERO — the traceback masks
        them, so no materialized zero row is needed).
      max_score, max_i, max_j: [B] int32, 1-indexed max cell.
      pos_score: [B] int32, H at the anchor corner (ref_len, query_len).
    """
    B, T = ref.shape
    TJ = T + 1
    dt = jnp.int32

    qs = jnp.pad(query, ((0, 0), (1, 0)))  # qs[:, j] = query[:, j-1]
    ref_len = ref_len.astype(dt)
    query_len = query_len.astype(dt)

    jlane = jax.lax.broadcasted_iota(dt, (B, TJ), 1)
    jvalid = (jlane >= 1) & (jlane <= query_len[:, None])

    m0 = jnp.zeros((B, TJ), dt)
    i0 = jnp.full((B, TJ), -NEG_INF, dt)
    d0 = jnp.full((B, TJ), -NEG_INF, dt)
    dirm0 = jnp.zeros((B, T, TJ), jnp.uint8)
    # l*ge offsets for the cummax closed form.
    lge = jlane * gap_extend

    def row(i, carry):
        m_prev, i_prev, d_prev, dirm, max_s, max_i, max_j, pos_s = carry
        r = jax.lax.dynamic_slice_in_dim(ref, i - 1, 1, axis=1)  # [B,1]
        is_eq = qs == r
        match_s = jnp.where(is_eq, match, mismatch).astype(dt)

        prev3 = jnp.maximum(jnp.maximum(m_prev, i_prev), d_prev)
        m_new = jnp.maximum(_shift_right(prev3, 0) + match_s, 0)
        # index 0 stays 0 (never written by the reference loop).
        m_new = m_new.at[:, 0].set(0)

        ins_open = m_prev + gap_open
        ins_ext = i_prev + gap_extend
        i_new = jnp.maximum(ins_open, ins_ext)
        i_new = i_new.at[:, 0].set(-NEG_INF)

        u = m_new + gap_open - lge
        c = jax.lax.cummax(u, axis=1)
        d_new = _shift_right(c, -NEG_INF) + (lge - gap_extend)
        d_new = d_new.at[:, 0].set(-NEG_INF)

        h_new = jnp.maximum(jnp.maximum(m_new, i_new),
                            jnp.maximum(d_new, 0))

        del_open = _shift_right(m_new, 0) + gap_open
        del_ext = _shift_right(d_new, -NEG_INF) + gap_extend

        op = jnp.where(
            m_new >= i_new,
            jnp.where(m_new >= d_new, 3, 1),
            jnp.where(i_new >= d_new, 2, 1)).astype(jnp.uint8)
        op = jnp.where((m_new <= 0) & (i_new <= 0) & (d_new <= 0),
                       jnp.uint8(0), op)
        op = op + jnp.where(ins_open >= ins_ext,
                            jnp.uint8(GAP_OPEN_FLAG_I), jnp.uint8(0))
        op = op + jnp.where(del_open >= del_ext,
                            jnp.uint8(GAP_OPEN_FLAG_D), jnp.uint8(0))
        op = op + jnp.where(is_eq, jnp.uint8(MATCH_BIT), jnp.uint8(0))

        rvalid = (i <= ref_len)[:, None]
        op = jnp.where(jvalid & rvalid, op, jnp.uint8(0))
        dirm = jax.lax.dynamic_update_slice_in_dim(
            dirm, op[:, None, :], i - 1, axis=1)

        hv = jnp.where(jvalid, h_new, -1)
        row_max = jnp.max(hv, axis=1)
        row_j = jnp.max(jnp.where(hv == row_max[:, None], jlane, -1),
                        axis=1)
        upd = (row_max >= max_s) & (i <= ref_len)
        max_s = jnp.where(upd, row_max, max_s)
        max_i = jnp.where(upd, i, max_i)
        max_j = jnp.where(upd, row_j, max_j)

        corner = jnp.sum(
            jnp.where(jlane == query_len[:, None], h_new, 0), axis=1)
        pos_s = jnp.where(i == ref_len, corner, pos_s)

        return (m_new, i_new, d_new, dirm, max_s, max_i, max_j, pos_s)

    zero = jnp.zeros((B,), dt)
    init = (m0, i0, d0, dirm0, zero, zero, zero, zero)
    (_, _, _, dirm, max_s, max_i, max_j, pos_s) = jax.lax.fori_loop(
        1, T + 1, row, init)
    return dict(dir=dirm, max_score=max_s, max_i=max_i, max_j=max_j,
                pos_score=pos_s)
