"""Tile fetch from the combined banks with split (row, byte) addressing."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from darwin_tpu.ops.tile_fetch import (ROW, build_combined_bank,
                                       fetch_tiles, tile_indices)


@pytest.mark.parametrize("T", [64, 320])
def test_fetch_tiles_matches_slices(T):
    rng = np.random.default_rng(T)
    flat = rng.integers(65, 91, size=10_000).astype(np.uint8)
    bank, GP = build_combined_bank(flat, pad_byte=0)
    assert GP % ROW == 0 and bank.shape == (2 * GP // ROW, ROW)
    fwd = np.full(GP, 0, np.uint8)
    fwd[: len(flat)] = flat

    B = 64
    starts = rng.integers(0, GP - T, size=B).astype(np.int32)
    rev = rng.random(B) < 0.5  # mixed: forward spans + reversed reads

    # Forward spans address the first copy; reversed reads (tile read
    # back-to-front) address the reversed copy at 2*GP - start - T.
    eff = np.where(rev, starts, 2 * GP - starts - T).astype(np.int64)
    out = np.asarray(fetch_tiles(
        (eff // ROW).astype(np.int32), (eff % ROW).astype(np.int32),
        jnp.asarray(bank), T=T))
    assert out.shape == (B, T) and out.dtype == np.uint8
    for b in range(B):
        span = fwd[starts[b]: starts[b] + T]
        want = span if rev[b] else span[::-1]
        np.testing.assert_array_equal(out[b], want, err_msg=str(b))


def test_fetch_tiles_clips_padding_slots():
    """Padding slots carry arbitrary starts; they must read in-bank
    bytes (masked later by the caller), never fault or wrap."""
    rng = np.random.default_rng(1)
    flat = rng.integers(65, 91, size=2048).astype(np.uint8)
    bank, GP = build_combined_bank(flat, pad_byte=0)
    row = np.array([0, -3, 10 ** 9, bank.shape[0] - 1], np.int32)
    rem = np.array([0, -50, 7, ROW + 9], np.int32)
    out = np.asarray(fetch_tiles(row, rem, jnp.asarray(bank), T=64))
    assert out.shape == (4, 64)
    np.testing.assert_array_equal(out[0], bank.reshape(-1)[:64])
    # Negative starts clip to the first byte; starts past the end clip
    # to the last row.
    np.testing.assert_array_equal(out[1], bank.reshape(-1)[:64])
    last = bank[-1]
    np.testing.assert_array_equal(out[2], last[7:71])
    assert out[3][0] == last[-1]


def test_tile_indices_beyond_int32():
    """A 4 GiB combined bank (past 2^31 bytes) is addressed exactly in
    int32 (row, byte) pairs; nothing is allocated."""
    n_rows = 2 ** 32 // ROW
    row = np.array([n_rows - 5, 2 ** 22 + 17, 0], np.int32)
    rem = np.array([300, ROW - 1, 0], np.int32)
    r, c = jax.device_get(tile_indices(row, rem, n_rows, 320))
    assert r.dtype == np.int32 and c.dtype == np.int32
    got = r.astype(np.int64) * ROW + c
    want = (row.astype(np.int64) * ROW + rem)[:, None] + np.arange(320)
    np.testing.assert_array_equal(got, want)
    assert want.max() >= 2 ** 31


def test_engine_traces_bank_beyond_int32():
    """The device engine (lax backend) takes a combined genome bank past
    2^31 bytes: the whole-batch loop traces with every index int32."""
    from darwin_tpu.engine.device_batch import _make_engine_fn, _Static

    st = _Static(B=8, T=64, ET=40, Ncap=16, match=1, mismatch=-1,
                 gap_open=-1, gap_extend=-1, threshold=35,
                 same_file=False, compute_score=True, backend="lax")
    fn = _make_engine_fn(st)
    i32 = jax.ShapeDtypeStruct((st.Ncap,), jnp.int32)
    out = jax.eval_shape(
        fn, jax.ShapeDtypeStruct((), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32),
        jax.ShapeDtypeStruct((2 ** 32 // ROW, ROW), jnp.uint8),
        jax.ShapeDtypeStruct((64, ROW), jnp.uint8),
        *([i32] * 13), jax.ShapeDtypeStruct((st.Ncap, 16), jnp.int32))
    records = out[0]
    assert records.shape == (st.Ncap, 10) and records.dtype == jnp.int32


def test_split_offsets_beyond_int32():
    """Split addressing must agree with int64 math for banks past
    2^31 bytes (human-scale combined banks are ~6 GB)."""
    from darwin_tpu.engine.device_batch import DeviceGactEngine

    rng = np.random.default_rng(3)
    GP = 3_200_000_000  # 3.2 GB padded forward copy
    starts = np.sort(rng.integers(0, GP - 10 ** 6, size=64)).astype(
        np.int64)
    row, rem, rv_row, rv_rem = DeviceGactEngine._split_offsets(
        starts, GP)
    np.testing.assert_array_equal(row * ROW + rem, starts)
    np.testing.assert_array_equal(rv_row * ROW + rv_rem,
                                  2 * GP - starts)
    assert rv_row.max() < 2 ** 31  # rows fit int32 (bytes/ROW)
    assert (rem >= 0).all() and (rem < ROW).all()
    assert (rv_rem >= 0).all() and (rv_rem < ROW).all()
    # Device-side recombination: (base_row + s // ROW, s % ROW) for a
    # local span start must reproduce the absolute int64 address.
    p_r = rng.integers(0, 2 ** 31 - 10 ** 6, size=64)
    rl = rng.integers(0, 320, size=64)
    # forward-copy read [start + p - rl, ...)
    s = rem + p_r - rl
    np.testing.assert_array_equal((row + s // ROW) * ROW + s % ROW,
                                  starts + p_r - rl)
    # reverse-copy read at 2*GP - start - p - rl
    s2 = rv_rem - p_r - rl
    np.testing.assert_array_equal(
        (rv_row + s2 // ROW) * ROW + np.mod(s2, ROW),
        2 * GP - starts - p_r - rl)
