"""On-device D-SOFT: jittable, fixed-shape, mesh-shardable seeding.

Re-expresses the D-SOFT filtration (reference seed_pos_table.cpp:100-167;
executable spec darwin_tpu/golden/dsoft.py) as a fixed-shape XLA
program so that seeding runs on the accelerator next to the GACT
engine:

* the minimizer scan's sequential emit rule becomes the change-point /
  run-anchor formulation (see darwin_tpu/coding/ntcoding.py) built from
  cumsum + one masked scatter;
* tuple expansion (minimizer -> its pos-table range) uses a fixed
  TUP_MAX tuple budget per read and a searchsorted-over-cumsum
  assignment of tuple slots to minimizers;
* the order-dependent per-bin counting becomes a stable sort by bin
  followed by a segmented prefix sum and first-threshold-crossing
  detection (same derivation as darwin_tpu/dsoft/filter.py);
* results come back as fixed [R, CAND_MAX] candidate arrays plus
  per-read counts, with an overflow flag when the tuple budget was
  exceeded (callers fall back to the host engine for those reads —
  never silently truncate).

The seed table (sorted hash + pos arrays) lives on device, replicated
across the mesh; reads shard data-parallel over the 'data' axis via
shard_map, so a multi-card mesh seeds its read batch in one dispatch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INT32_MAX = np.iinfo(np.int32).max
UINT32_FILL = np.uint32(0xFFFFFFFF)  # hits padding (-1 in int32 view)

_TWOBIT_LUT = np.zeros(256, dtype=np.uint32)
for _c, _v in (("a", 0), ("A", 0), ("c", 1), ("C", 1),
               ("g", 2), ("G", 2), ("t", 3), ("T", 3)):
    _TWOBIT_LUT[ord(_c)] = _v


def _hash32(key, k: int):
    """Thomas Wang hash masked to 2k bits (ntcoding.cpp:74-85)."""
    m = jnp.uint32((1 << (2 * k)) - 1)
    key = (~key + (key << jnp.uint32(21))) & m
    key = key ^ (key >> jnp.uint32(24))
    key = ((key + (key << jnp.uint32(3))) + (key << jnp.uint32(8))) & m
    key = key ^ (key >> jnp.uint32(14))
    key = ((key + (key << jnp.uint32(2))) + (key << jnp.uint32(4))) & m
    key = key ^ (key >> jnp.uint32(28))
    key = (key + (key << jnp.uint32(31))) & m
    return key


def _query_minimizers_fixed(codes, qlen, k: int, w: int, LP: int):
    """Minimizer scan of one read as fixed-shape masked arrays.

    codes: [LP] uint32 2-bit codes, zero beyond the read (the query
      word-count convention scans into zero padding, ntcoding.cpp:155).
    Returns (emit[LP] bool, pos[LP] int32, mhash[LP] uint32) where
    emit marks emitted minimizers at scan position p = index.
    """
    pos = jax.lax.broadcasted_iota(jnp.int32, (LP, 1), 0)[:, 0]
    # k-mer code at every position: sum of k shifted 2-bit codes.
    seed = jnp.zeros((LP,), jnp.uint32)
    for t in range(k):
        seed = seed | (jnp.roll(codes, -t) << jnp.uint32(2 * t))
    h = _hash32(seed, k)

    # Window minimum over [p-w+1, p].
    m = h
    for s in range(1, w):
        m = jnp.minimum(m, jnp.roll(h, s))

    # Scan range: lo = w-1, hi = 16*ceil(len/16) - k - w
    # (QTwoBitToMinimizers convention, ntcoding.cpp:155-182).
    s_len = (qlen + 15) // 16
    hi = 16 * s_len - k - w
    lo = w - 1
    in_range = (pos >= lo) & (pos < hi)

    prev_m = jnp.roll(m, 1)
    prev_m = jnp.where(pos == lo, 0, prev_m)  # initial last_m = 0
    change = (m != prev_m) & in_range

    # Run anchors: each change point starts a run anchored at its
    # position; the initial run is anchored at the virtual p = 0.
    run_id = jnp.cumsum(change.astype(jnp.int32))
    anchors = jnp.zeros((LP + 1,), jnp.int32)
    scatter_idx = jnp.where(change, run_id, LP + 1)  # OOB = dropped
    anchors = anchors.at[scatter_idx].set(jnp.where(change, pos, 0),
                                          mode="drop")
    offset = pos - anchors[run_id]
    emit = (change | ((offset % w == 0) & (offset > 0))) & in_range
    return emit, pos, m


def _dsoft_one(codes, qlen, table_lookup, table_pos, *, k: int, w: int,
               bin_size: int, kmer_max_occ: int, num_seeds_cap: int,
               threshold: int, max_candidates: int, LP: int,
               tup_max: int, cand_max: int, index: str,
               tl_steps: int = 0):
    """D-SOFT for one read; all shapes fixed, masked."""
    emit, pos, mhash = _query_minimizers_fixed(codes, qlen, k, w, LP)

    if index == "dense":
        # Direct CSR lookup (the reference's own index_table_ design,
        # seed_pos_table.cpp:73-94): two gathers per minimizer instead
        # of two ~23-step binary searches.
        h = mhash.astype(jnp.int32)
        start = table_lookup[h]
        end = table_lookup[h + 1]
    elif index == "twolevel":
        # Distinct-hash two-level probe (make_twolevel_index): a
        # handful of gathers per minimizer, no 4^k array.
        hd, crs, bkt, hbase, hshift = table_lookup
        start, end = twolevel_lookup(mhash, hd, crs, bkt, hbase[0],
                                     hshift[0], steps=tl_steps)
    else:
        start = jnp.searchsorted(table_lookup, mhash, side="left")
        end = jnp.searchsorted(table_lookup, mhash, side="right")
    occ = (end - start).astype(jnp.int32)

    passing = emit & (occ <= kmer_max_occ)
    rank = jnp.cumsum(passing.astype(jnp.int32))
    # First num_seeds_cap+1 passing minimizers are processed
    # (check-before-increment, seed_pos_table.cpp:128-131).
    keep = passing & (rank <= num_seeds_cap + 1)

    counts = jnp.where(keep, occ, 0)
    cum = jnp.cumsum(counts)
    total = cum[-1]
    overflow = total > tup_max

    # Assign tuple slots to minimizers: slot t belongs to the (unique)
    # kept minimizer m with cum[m]-counts[m] <= t < cum[m].  Scatter
    # each contributing minimizer's index at its first slot and
    # forward-fill — O(LP + tup_max) instead of tup_max binary
    # searches over cum.
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (tup_max, 1), 0)[:, 0]
    m_iota = jax.lax.broadcasted_iota(jnp.int32, (LP, 1), 0)[:, 0]
    first_slot = jnp.where(counts > 0, cum - counts, tup_max)  # OOB=drop
    mz = jnp.full((tup_max,), -1, jnp.int32).at[first_slot].set(
        m_iota, mode="drop")
    mz = jax.lax.associative_scan(jnp.maximum, mz)
    mz = jnp.clip(mz, 0, LP - 1)
    within = t_idx - (cum[mz] - counts[mz])
    tup_valid = t_idx < jnp.minimum(total, tup_max)

    gather_idx = jnp.where(tup_valid, start[mz] + within, 0)
    # Positions stay uint32 end to end (the reference's own pos width,
    # seed_pos_table.cpp uint64 = (hash << 32) | pos): an int32 lane
    # would cap references at 2^31 while uint32 carries the full
    # 4.29 Gb — covers GRCh38-scale concats with no wider traffic.
    hit = table_pos[gather_idx]            # uint32
    toff = pos[mz]                         # int32 (read offset, small)
    toff_u = toff.astype(jnp.uint32)
    tup_valid &= hit >= toff_u  # seed_pos_table.cpp:135

    bins = jnp.where(tup_valid,
                     ((hit - toff_u) // bin_size).astype(jnp.int32),
                     INT32_MAX)
    # Stable sort by bin; padding (INT32_MAX bins) sorts last.  The
    # payloads do NOT ride the sort: a 2-operand (key, iota) sort
    # yields the permutation and the payloads are gathered by it —
    # bit-identical to a stable multi-operand sort (t_idx IS the
    # iota), and the vmapped 5-operand sort compiles far slower than
    # a 2-operand sort plus gathers.
    b_s, t_s = jax.lax.sort((bins, t_idx), num_keys=1, is_stable=True)
    h_s = hit[t_s]
    o_s = toff[t_s]
    v_s = tup_valid[t_s]

    seg_start = jnp.concatenate(
        [jnp.ones((1,), bool), b_s[1:] != b_s[:-1]]) & v_s
    delta = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                             o_s[1:] - o_s[:-1]])
    inc = jnp.where(v_s,
                    jnp.where(seg_start, k, jnp.minimum(delta, k)), 0)
    cum2 = jnp.cumsum(inc)
    # Segment base = cum2 - inc at the segment start, forward-filled;
    # cum2 - inc is non-decreasing so a running max fills correctly.
    base_at = jnp.where(seg_start, cum2 - inc, jnp.int32(-1))
    seg_base = jax.lax.associative_scan(jnp.maximum, base_at)
    count = cum2 - seg_base

    crossing = (count >= threshold) & v_s
    prev_cross = jnp.concatenate([jnp.zeros((1,), bool), crossing[:-1]])
    first_cross = crossing & ~(prev_cross & ~seg_start)

    # Back to emission (original tuple) order; take the first cand_max.
    # Same (key, iota)-then-gather shape as the bin sort above.
    emit_key = jnp.where(first_cross, t_s, INT32_MAX)
    _, e_perm = jax.lax.sort((emit_key, t_idx), num_keys=1,
                             is_stable=True)
    e_h = h_s[e_perm]
    e_o = o_s[e_perm]
    if tup_max < cand_max:  # tiny tuple budgets: pad to the slice size
        pad = ((0, cand_max - tup_max),)
        e_h = jnp.pad(e_h, pad, constant_values=UINT32_FILL)
        e_o = jnp.pad(e_o, pad, constant_values=-1)
    n_emit = jnp.sum(first_cross.astype(jnp.int32))
    n = jnp.minimum(jnp.minimum(n_emit, max_candidates), cand_max)
    # Overflow only when the fixed budget truncates below the semantic
    # cap (truncation at max_candidates itself is correct behavior).
    overflow |= jnp.minimum(n_emit, max_candidates) > cand_max
    c_idx = jax.lax.broadcasted_iota(jnp.int32, (cand_max, 1), 0)[:, 0]
    cand_valid = c_idx < n
    return (jnp.where(cand_valid, e_h[:cand_max],
                      jnp.uint32(UINT32_FILL)),
            jnp.where(cand_valid, e_o[:cand_max], -1),
            n, overflow)


def bucket_directory(rel_b: np.ndarray, NB: int) -> np.ndarray:
    """[NB+1] int32 directory: bkt[i] = #entries with bucket id < i.

    Equivalent to np.searchsorted(rel_b, np.arange(NB + 1)) for sorted
    rel_b in [0, NB), but built by bincount + cumsum — O(n + NB)
    instead of O(NB log n), which matters at E.coli scale (measured
    ~8 s -> ~30 ms for nd=1M, NB=4.2M on this host)."""
    # Cast before cumsum: a mixed-dtype `out=` sends numpy down a
    # buffered casting loop (~100x slower at NB=4M on this host).
    counts = np.bincount(rel_b, minlength=NB).astype(np.int32)
    out = np.empty(NB + 1, np.int32)
    out[0] = 0
    np.cumsum(counts, out=out[1:])
    return out


def make_twolevel_index(hashes: np.ndarray, bucket_factor: int = 8):
    """Two-level index over ONE sorted hash array (the replicated
    device table): (hd, crs, bkt, base, shift, steps).  Same structure
    as the per-shard build in dsoft/sharded_table.py
    (make_sharded_dense_index), host-built in two passes; see that
    docstring for why a flat 4^k CSR is not used.

    bucket_factor=8 trades refine gathers against the bucket
    directory's size; it was tuned on another accelerator and is not
    yet re-tuned on the GPU."""
    n = len(hashes)
    if n == 0:
        return (np.full(1, 0xFFFFFFFF, np.uint32),
                np.zeros(2, np.int32), np.zeros(2, np.int32),
                np.zeros(1, np.int32), np.zeros(1, np.int32), 1)
    vals, starts = np.unique(hashes, return_index=True)
    crs = np.concatenate([starts, [n]]).astype(np.int32)
    base = int(vals[0])
    span = int(vals[-1]) - base + 1
    nd = len(vals)
    NB = max(1, bucket_factor * nd)
    shift = 0
    while ((span - 1) >> shift) >= NB:
        shift += 1
    rel_b = (vals.astype(np.int64) - base) >> shift
    bkt = bucket_directory(rel_b, NB)
    max_width = max(1, int(np.diff(bkt).max()))
    steps = max(1, int(np.ceil(np.log2(max_width + 1))))
    # base/shift ride as [1] arrays so sharding specs stay rank-1.
    return (vals.astype(np.uint32), crs, bkt,
            np.array([base], np.int32), np.array([shift], np.int32),
            steps)


def twolevel_lookup(hv, hd, crs, bkt, base, shift, *, steps: int):
    """Resolve (start, end) pos-table ranges for uint32 hashes `hv`
    via a two-level index (make_twolevel_index): bucket-directory
    gathers narrow the search to <= 2^steps distinct hashes, a
    fixed-step binary refine + one verify gather finish it.  Absent
    hashes resolve to (0, 0).  All shapes follow hv."""
    ND = hd.shape[0]
    NB = bkt.shape[0] - 1
    rel = hv.astype(jnp.int32) - base
    b = jax.lax.shift_right_logical(jnp.maximum(rel, 0), shift)
    bvalid = (rel >= 0) & (b < NB)
    bc = jnp.minimum(b, NB - 1)
    lo = jnp.take(bkt, bc)
    hi = jnp.take(bkt, bc + 1)
    for _ in range(steps):
        act = lo < hi
        mid = (lo + hi) >> 1
        v = jnp.take(hd, jnp.clip(mid, 0, ND - 1))
        less = v < hv
        lo = jnp.where(act & less, mid + 1, lo)
        hi = jnp.where(act & ~less, mid, hi)
    d = jnp.minimum(lo, ND - 1)
    found = bvalid & (lo < ND) & (jnp.take(hd, d) == hv)
    return (jnp.where(found, jnp.take(crs, d), 0),
            jnp.where(found, jnp.take(crs, d + 1), 0))


@functools.partial(jax.jit, static_argnames=("k",))
def dense_hash_index(table_hashes, k: int):
    """CSR index over the full 4^k hash space: csr[h] = number of
    table entries with hash < h (so start=csr[h], end=csr[h+1]).
    Built on device by scatter-add + cumsum — the reference's
    index_table_ (seed_pos_table.cpp:73-94).

    Deliberately its OWN jit, kept out of the vmapped D-SOFT program so
    the 4^k-element scatter/cumsum compiles once; callers cache the
    result per table."""
    n = 1 << (2 * k)
    counts = jnp.zeros((n + 1,), jnp.int32).at[
        table_hashes.astype(jnp.int32) + 1].add(1, mode="drop")
    return jnp.cumsum(counts)


def default_index_mode(k: int) -> str:
    """Default hash-lookup strategy for the device D-SOFT.

    "twolevel" (bucket directory over distinct hashes + a short fixed
    binary refine) replaces the two ~23-step binary searches per
    minimizer with a handful of gathers, without the 4^k dense array
    ("dense" stays opt-in).  The choice among the three modes was
    measured on another accelerator; on the GPU it is not yet measured
    (ROADMAP D5).  All three paths are golden-parity tested
    (tests/test_dsoft_device.py).
    """
    del k
    return "twolevel"


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "bin_size", "kmer_max_occ",
                     "num_seeds_cap", "threshold", "max_candidates",
                     "tup_max", "cand_max", "index", "tl_steps"))
def dsoft_device_batch(queries, qlens, table_hashes, table_pos, *,
                       k: int, w: int, bin_size: int, kmer_max_occ: int,
                       num_seeds_cap: int, threshold: int,
                       max_candidates: int, tup_max: int = 8192,
                       cand_max: int = 512, index: str = "searchsorted",
                       tl_steps: int = 0):
    """Batched on-device D-SOFT.

    queries: [R, L] uint8 ASCII (zero-padded), qlens: [R] int32.
    Returns (hits[R, cand_max], offsets[R, cand_max], counts[R],
    overflow[R]); hits are uint32 (full 4.29 Gb reference range,
    0xFFFFFFFF beyond counts), offsets int32 (-1 beyond counts).
    index: "dense" = direct CSR gathers over the 4^k hash space
    (table_hashes must then BE the dense_hash_index array),
    "twolevel" = two-level probe (table_hashes = the first five
    make_twolevel_index arrays, tl_steps = its steps),
    "searchsorted" = binary search over the sorted hash array.
    """
    R, L = queries.shape
    LP = L + 16  # headroom so k-mer reads past the scan range see zeros
    lut = jnp.asarray(_TWOBIT_LUT)
    codes = lut[queries]
    codes = jnp.pad(codes, ((0, 0), (0, LP - L)))
    lookup = table_hashes

    fn = functools.partial(
        _dsoft_one, k=k, w=w, bin_size=bin_size,
        kmer_max_occ=kmer_max_occ, num_seeds_cap=num_seeds_cap,
        threshold=threshold, max_candidates=max_candidates, LP=LP,
        tup_max=tup_max, cand_max=cand_max, index=index,
        tl_steps=tl_steps)
    table_axes = (None,) * 5 if index == "twolevel" else None
    return jax.vmap(fn, in_axes=(0, 0, table_axes, None))(
        codes, qlens.astype(jnp.int32), lookup, table_pos)


def sharded_dsoft_fn(mesh, *, k: int, w: int, bin_size: int,
                     kmer_max_occ: int, num_seeds_cap: int,
                     threshold: int, max_candidates: int,
                     tup_max: int = 8192, cand_max: int = 512,
                     index: str = "searchsorted", tl_steps: int = 0):
    """shard_map'd D-SOFT: reads sharded over the mesh's data axis,
    seed table replicated; one dispatch seeds the whole batch."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def local(queries, qlens, th, tp):
        return dsoft_device_batch(
            queries, qlens, th, tp, k=k, w=w, bin_size=bin_size,
            kmer_max_occ=kmer_max_occ, num_seeds_cap=num_seeds_cap,
            threshold=threshold, max_candidates=max_candidates,
            tup_max=tup_max, cand_max=cand_max, index=index,
            tl_steps=tl_steps)

    th_spec = ((P(None),) * 5 if index == "twolevel" else P(None))
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis), th_spec, P(None)),
        out_specs=(P(axis, None), P(axis, None), P(axis), P(axis)),
        check_vma=False)
    return jax.jit(fn)


def pad_reads(bank, read_ids, L: int | None = None):
    """[R, L] zero-padded query matrix + lengths from a SeqBank."""
    ids = np.asarray(list(read_ids), dtype=np.int64)
    lens = bank.lengths[ids]
    L = int(lens.max()) if L is None else L
    out = np.zeros((len(ids), L), dtype=np.uint8)
    for r, rid in enumerate(ids):
        s = bank.starts[rid]
        out[r, : lens[r]] = bank.flat[s: s + lens[r]]
    return out, lens.astype(np.int32)
