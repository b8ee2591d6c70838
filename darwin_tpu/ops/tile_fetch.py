"""Tile fetch from the combined sequence banks, in plain JAX.

The GACT engine reads, every iteration, one [B, T] tile per slot out of
the sequence banks.  Every tile is a contiguous span:

* reverse-extension tiles read [pos-len, pos) forward;
* forward-extension tiles read [pos, pos+len) back to front
  (align.cpp:130), which is a forward span of a reversed copy of the
  bank.  The combined bank holds the padded forward copy followed by
  its reverse, so both orientations are forward spans of one array.

Banks of 2^31 bytes or more (a 3.1 Gb reference's combined bank is
~6.4 GB) cannot be indexed with int32 offsets, so the bank is viewed as
[rows, ROW] and a span start travels as (row, byte-in-row): every index
the device computes stays int32.  The fetch is one XLA gather over that
2-D view; masking beyond each tile's length stays with the caller.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from darwin_tpu.utils import round_up

ROW = 512


def build_combined_bank(flat: np.ndarray, pad_byte: int
                        ) -> tuple[np.ndarray, int]:
    """[rows, ROW] uint8 bank: the padded forward copy, then its
    reverse.  Returns (bank2d, GP), GP being the padded forward length
    (the reverse copy starts at GP)."""
    GP = round_up(max(1, len(flat)), ROW)
    bank = np.full(2 * GP, pad_byte, dtype=np.uint8)
    bank[: len(flat)] = flat
    bank[GP:] = bank[:GP][::-1]
    return bank.reshape(-1, ROW), GP


def tile_indices(row: jnp.ndarray, rem: jnp.ndarray, n_rows: int,
                 T: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[B, T] (bank row, byte-in-row) int32 indices of the spans that
    start at (row, rem).  Starts are clipped into the bank, so padding
    slots with arbitrary starts read valid memory (their bytes are
    masked by the caller)."""
    rem = jnp.clip(rem.astype(jnp.int32), 0, ROW - 1)
    off = rem[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]
    r = jnp.clip(row.astype(jnp.int32)[:, None] + off // ROW, 0,
                 n_rows - 1)
    return r, off % ROW


def fetch_tiles(row: jnp.ndarray, rem: jnp.ndarray, bank2d: jnp.ndarray,
                *, T: int) -> jnp.ndarray:
    """row/rem: [B] int32 span starts as (bank row, byte within row).
    Returns [B, T] uint8: out[b, k] = bank byte row*ROW + rem + k."""
    r, c = tile_indices(row, rem, bank2d.shape[0], T)
    return bank2d[r, c]
