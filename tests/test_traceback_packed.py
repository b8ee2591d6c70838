"""Packed-word traceback must be bit-identical to the byte walk.

traceback_packed_jax advances two steps per gather from the packed
word matrix (pack_dir_words);
every output (ops stream, match bits, step counts) must equal
traceback_jax's on the same tiles.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from darwin_tpu.ops.reference_dp import align_tiles_jax  # noqa: E402
from darwin_tpu.ops.traceback import (pack_dir_words,  # noqa: E402
                                      traceback_jax,
                                      traceback_packed_jax)

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_tiles(rng, B, T, div, ragged=False):
    refs = ALPHA[rng.integers(0, 4, size=(B, T))]
    queries = refs.copy()
    mut = rng.random((B, T)) < div
    queries[mut] = ALPHA[rng.integers(0, 4, size=int(mut.sum()))]
    if ragged:
        rlen = rng.integers(1, T + 1, size=B).astype(np.int32)
        qlen = rng.integers(1, T + 1, size=B).astype(np.int32)
    else:
        rlen = np.full(B, T, np.int32)
        qlen = np.full(B, T, np.int32)
    return refs, queries, rlen, qlen


@pytest.mark.parametrize("T,div,ragged,et", [
    (40, 0.1, False, 24),
    (40, 0.5, True, 24),
    (64, 0.02, True, 40),
    (32, 0.9, False, 200),   # mostly-zero dir matrices, short walks
])
def test_packed_walk_matches_byte_walk(T, div, ragged, et):
    rng = np.random.default_rng(T * 1000 + int(div * 100))
    B = 32
    refs, queries, rlen, qlen = _random_tiles(rng, B, T, div, ragged)
    firsts = np.zeros(B, bool)
    firsts[::2] = True
    out = align_tiles_jax(refs, queries, rlen, qlen, match=1,
                          mismatch=-1, gap_open=-1, gap_extend=-1)
    a = traceback_jax(out["dir"], rlen, qlen, firsts, out["max_i"],
                      out["max_j"], early_terminate=et)
    words = pack_dir_words(out["dir"])
    b = traceback_packed_jax(words, rlen, qlen, firsts, out["max_i"],
                             out["max_j"], early_terminate=et)
    for x, y, name in zip(a, b, ("ops", "mbits", "i_steps", "j_steps")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def test_packed_walk_degenerate_starts():
    """first tiles with max at (0,0) (all-mismatch) and zero-length
    walks must stay silent, like the byte walk."""
    B, T = 8, 24
    refs = np.full((B, T), ord("A"), np.uint8)
    queries = np.full((B, T), ord("C"), np.uint8)
    rlen = np.full(B, T, np.int32)
    qlen = np.full(B, T, np.int32)
    firsts = np.ones(B, bool)
    out = align_tiles_jax(refs, queries, rlen, qlen, match=1,
                          mismatch=-1, gap_open=-1, gap_extend=-1)
    a = traceback_jax(out["dir"], rlen, qlen, firsts, out["max_i"],
                      out["max_j"], early_terminate=16)
    b = traceback_packed_jax(pack_dir_words(out["dir"]), rlen, qlen,
                             firsts, out["max_i"], out["max_j"],
                             early_terminate=16)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("T,div,ragged,et,unroll", [
    (40, 0.1, False, 24, 2),
    (64, 0.02, True, 40, 4),
])
def test_packed_walk_unrolled_bit_identical(T, div, ragged, et, unroll):
    """unroll=U amortizes the loop trip over 2U steps; outputs must
    stay bit-identical (uniform advance, same slots)."""
    rng = np.random.default_rng(T + unroll)
    B = 32
    refs, queries, rlen, qlen = _random_tiles(rng, B, T, div, ragged)
    firsts = np.zeros(B, bool)
    firsts[::2] = True
    out = align_tiles_jax(refs, queries, rlen, qlen, match=1,
                          mismatch=-1, gap_open=-1, gap_extend=-1)
    words = pack_dir_words(out["dir"])
    a = traceback_packed_jax(words, rlen, qlen, firsts, out["max_i"],
                             out["max_j"], early_terminate=et)
    b = traceback_packed_jax(words, rlen, qlen, firsts, out["max_i"],
                             out["max_j"], early_terminate=et,
                             unroll=unroll)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("T,div,ragged,et", [
    (40, 0.05, False, 24),
    (40, 0.5, True, 24),
    (64, 0.02, True, 40),
    (32, 0.9, False, 200),
])
def test_packed6_walk_semantics(T, div, ragged, et):
    """The 5-bit-field walker advances 2-4 steps/gather, leaving holes
    inside its 4-slot groups — the (ops != 0) subsequence, its match
    bits, and the step counts must equal the byte walk's, and holes
    must only be trailing slots of each group."""
    from darwin_tpu.ops.traceback import (pack_dir_words6,
                                          traceback_packed6_jax)

    rng = np.random.default_rng(T * 7 + int(div * 100))
    B = 32
    refs, queries, rlen, qlen = _random_tiles(rng, B, T, div, ragged)
    firsts = np.zeros(B, bool)
    firsts[::2] = True
    out = align_tiles_jax(refs, queries, rlen, qlen, match=1,
                          mismatch=-1, gap_open=-1, gap_extend=-1)
    a_ops, a_mb, a_is, a_js = (np.asarray(x) for x in traceback_jax(
        out["dir"], rlen, qlen, firsts, out["max_i"], out["max_j"],
        early_terminate=et))
    w6 = pack_dir_words6(out["dir"])
    b_ops, b_mb, b_is, b_js = (np.asarray(x) for x in
                               traceback_packed6_jax(
        w6, rlen, qlen, firsts, out["max_i"], out["max_j"],
        early_terminate=et))
    np.testing.assert_array_equal(a_is, b_is)
    np.testing.assert_array_equal(a_js, b_js)
    for b in range(B):
        sel_a = a_ops[:, b] != 0
        sel_b = b_ops[:, b] != 0
        np.testing.assert_array_equal(a_ops[sel_a, b],
                                      b_ops[sel_b, b], err_msg=str(b))
        np.testing.assert_array_equal(a_mb[sel_a, b], b_mb[sel_b, b])
        # Hole structure: within each 4-slot group, ops are a prefix.
        g = b_ops[: 4 * (len(b_ops) // 4), b].reshape(-1, 4) != 0
        prefix_ok = (np.cumprod(g, axis=1) >= g).all()
        assert prefix_ok


@pytest.mark.parametrize("T,div,ragged,et,kb", [
    (40, 0.05, False, 24, 4),
    (40, 0.5, True, 24, 8),
    (64, 0.02, True, 40, 1),
    (32, 0.9, False, 200, 16),
    (48, 0.3, True, 30, 31),   # compact_b almost B: phase 2 from go
])
def test_packed6_compact_matches_full(T, div, ragged, et, kb):
    """compact_b lane compaction is bit-identical to the full-width
    walk: same op values in the same slots, same step counts."""
    from darwin_tpu.ops.traceback import (pack_dir_words6,
                                          traceback_packed6_jax)

    rng = np.random.default_rng(T * 13 + int(div * 100) + kb)
    B = 32
    refs, queries, rlen, qlen = _random_tiles(rng, B, T, div, ragged)
    firsts = np.zeros(B, bool)
    firsts[::2] = True
    out = align_tiles_jax(refs, queries, rlen, qlen, match=1,
                          mismatch=-1, gap_open=-1, gap_extend=-1)
    w6 = pack_dir_words6(out["dir"])
    a = [np.asarray(x) for x in traceback_packed6_jax(
        w6, rlen, qlen, firsts, out["max_i"], out["max_j"],
        early_terminate=et)]
    b = [np.asarray(x) for x in traceback_packed6_jax(
        w6, rlen, qlen, firsts, out["max_i"], out["max_j"],
        early_terminate=et, compact_b=kb)]
    # The compact variant's buffer has one spare group; beyond the
    # shared height it must be empty.
    assert b[0].shape[0] == a[0].shape[0] + 4
    assert (b[0][a[0].shape[0]:] == 0).all()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y[: len(x)] if y.ndim == 2
                                      else y)


def test_pack_dir_words6_layout():
    from darwin_tpu.ops.traceback import pack_dir_words6

    d = (np.arange(2 * 5 * 6, dtype=np.uint8).reshape(2, 5, 6) * 7) % 32
    w = np.asarray(pack_dir_words6(jnp.asarray(d)))
    for b in range(2):
        for r in range(5):
            for c in range(6):
                want = int(d[b, r, c])
                if c + 1 < 6:
                    want |= int(d[b, r, c + 1]) << 5
                if r >= 1:
                    want |= int(d[b, r - 1, c]) << 10
                    if c + 1 < 6:
                        want |= int(d[b, r - 1, c + 1]) << 15
                if r >= 2 and c >= 1:
                    want |= int(d[b, r - 2, c - 1]) << 20
                if r >= 3 and c >= 2:
                    want |= int(d[b, r - 3, c - 2]) << 25
                assert w[b, r, c] == want, (b, r, c)


def test_pack_dir_words_layout():
    d = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4) % 32
    w = np.asarray(pack_dir_words(jnp.asarray(d)))
    for b in range(2):
        for r in range(3):
            for c in range(4):
                want = int(d[b, r, c])
                want |= int(d[b, r, c + 1]) << 8 if c + 1 < 4 else 0
                want |= int(d[b, r - 1, c]) << 16 if r >= 1 else 0
                if r >= 1 and c + 1 < 4:
                    want |= int(d[b, r - 1, c + 1]) << 24
                assert w[b, r, c] == want, (b, r, c)
