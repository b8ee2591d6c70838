"""Production seed-position index.

Re-design of SeedPosTable (reference seed_pos_table.cpp:46-98) for this
pipeline.  Differences from the reference that preserve semantics:

* The reference materializes a dense 4^k+1 CSR index table (1 GiB at
  k=14); we keep the hash-sorted minimizer arrays and use binary search
  (searchsorted) for range lookups — identical (start, end) ranges, two
  orders of magnitude less memory, and directly usable as device arrays
  for the on-device D-SOFT path.
* Build is fully vectorized NumPy; sort order (hash, then position)
  matches the reference's uint64 sort of (hash << 32) | pos.

The table is persistable (reference rebuilds it every run; BASELINE.md
asks for restart amortization).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from darwin_tpu.coding import ref_minimizers

_FORMAT_VERSION = 1


class SeedTable:
    def __init__(self, hashes: np.ndarray, pos: np.ndarray, *,
                 kmer_size: int, window_size: int, bin_size: int,
                 ref_size: int, kmer_max_occurence: int):
        self.hashes = hashes            # uint32, sorted
        self.pos = pos                  # uint32, grouped by hash, ascending
        self.k = kmer_size
        self.w = window_size
        self.bin_size = bin_size
        self.ref_size = ref_size
        self.kmer_max_occurence = kmer_max_occurence

    @classmethod
    def build(cls, ref_seq: str | np.ndarray, kmer_size: int,
              seed_occurence_multiple: int, bin_size: int,
              window_size: int) -> "SeedTable":
        assert 3 < kmer_size <= 15, "3 < k <= 15 (seed_pos_table.cpp:48)"
        assert kmer_size > window_size, "k > w (seed_pos_table.cpp:50)"
        ref_size = len(ref_seq)
        kmer_max_occurence = seed_occurence_multiple * (
            1 + (ref_size >> (2 * kmer_size)))
        from darwin_tpu import native
        if native.available():
            from darwin_tpu.coding import seq_to_bytes
            b = (seq_to_bytes(ref_seq) if isinstance(ref_seq, str)
                 else ref_seq)
            minimizers = native.build_table_keys(b, kmer_size, window_size)
        else:
            minimizers = np.sort(
                ref_minimizers(ref_seq, kmer_size, window_size))
        # For k + w < 16 the reference-convention scan range
        # 16*(1 + len//16) - k - w extends past the reference end, so
        # padding positions enter the table; the reference then indexes
        # its bin->chromosome map out of bounds on such hits
        # (darwin.cpp:216-223, UB).  Sane semantics: drop them (no
        # observable difference for the default k=14, w=4).
        minimizers = minimizers[
            (minimizers & np.uint64(0xFFFFFFFF)) < ref_size]
        return cls(
            (minimizers >> np.uint64(32)).astype(np.uint32),
            (minimizers & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            kmer_size=kmer_size, window_size=window_size,
            bin_size=bin_size, ref_size=ref_size,
            kmer_max_occurence=kmer_max_occurence)

    def lookup(self, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized (start, end) pos-table ranges for hash values."""
        start = np.searchsorted(self.hashes, h, side="left")
        end = np.searchsorted(self.hashes, h, side="right")
        return start, end

    # -- persistence ---------------------------------------------------
    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path, version=_FORMAT_VERSION, hashes=self.hashes,
            pos=self.pos, k=self.k, w=self.w, bin_size=self.bin_size,
            ref_size=self.ref_size,
            kmer_max_occurence=self.kmer_max_occurence)

    @classmethod
    def load(cls, path: str | Path) -> "SeedTable":
        z = np.load(path)
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported seed table version {z['version']}")
        return cls(z["hashes"], z["pos"], kmer_size=int(z["k"]),
                   window_size=int(z["w"]), bin_size=int(z["bin_size"]),
                   ref_size=int(z["ref_size"]),
                   kmer_max_occurence=int(z["kmer_max_occurence"]))
