"""D-SOFT with the seed table SHARDED across the mesh.

For references too large to replicate (human-scale genomes), the seed
table shards by hash range across devices and candidate hits are
exchanged over the interconnect — the component BASELINE.md calls
"sharded seed table with cross-host candidate-hit exchange", with no
reference counterpart (the reference is single-GPU, cuda_host.cu:195).

Design (one shard_map'd XLA program; all shapes fixed):

1. queries are replicated; every device computes every read's
   minimizers locally (recompute beats communicating the scan), and
   looks them up in its OWN table shard only.  Shards are aligned to
   hash boundaries (``make_sharded_table``), so one minimizer's whole
   pos-range lives on exactly one device.
2. occurrence counts are summed with one ``psum`` so the
   kmer-max-occurrence filter and the num_seeds cap see global counts
   (a minimizer with zero hits still consumes num_seeds budget,
   matching seed_pos_table.cpp:128-131).
3. each device expands its shard's (hit, offset) tuples under a fixed
   budget and tags them (read, minimizer-position, hit) — the tag pair
   (m_pos, hit) totally orders tuples within a read exactly like the
   reference's scan order (minimizer order, then pos-table order).
4. the hit exchange routes tuples to their read-owner device
   (contiguous read blocks): either a simple ``all_gather`` (every
   device sees every tuple, P x traffic) or, with ``a2a_cap`` set, an
   ``all_to_all`` with per-destination budgets — each tuple crosses
   the interconnect once; budget overruns flag the affected reads.
5. per-(read, bin) counting = multi-key stable sort + segmented prefix
   sum + first-threshold-crossing, the same derivation as
   dsoft/filter.py and dsoft/device.py, then per-read compaction into
   fixed [R_local, cand_max] outputs.

Budget overflows (tuple budget, candidate slots) are flagged per read;
callers fall back to the exact host path for flagged reads.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from darwin_tpu.dsoft.device import (_query_minimizers_fixed,
                                     bucket_directory)

INT32_MAX = np.iinfo(np.int32).max
_SENTINEL_HASH = np.uint32(0xFFFFFFFF)  # > any 2k-bit hash (k <= 15)

_TWOBIT_LUT = np.zeros(256, dtype=np.uint32)
for _c, _v in (("a", 0), ("A", 0), ("c", 1), ("C", 1),
               ("g", 2), ("G", 2), ("t", 3), ("T", 3)):
    _TWOBIT_LUT[ord(_c)] = _v


def shard_bounds(hashes: np.ndarray, n_shards: int) -> list[int]:
    """Entry-count-balanced split points into a sorted hash array,
    advanced so no hash value spans two shards ([n_shards+1] list)."""
    n = len(hashes)
    bounds = [0]
    for s in range(1, n_shards):
        t = s * n // n_shards
        # advance to the end of the run of equal hashes
        while t < n and t > 0 and hashes[t] == hashes[t - 1]:
            t += 1
        t = max(t, bounds[-1])
        bounds.append(t)
    bounds.append(n)
    return bounds


def make_sharded_table(hashes: np.ndarray, pos: np.ndarray,
                       n_shards: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Split a (hash, pos)-sorted table into hash-aligned shards.

    Returns ([P, Nm] hashes, [P, Nm] pos) padded with a sentinel hash
    that sorts after every real hash, so in-shard searchsorted lookups
    see exactly the shard's ranges.  Split points never bisect a hash
    value: a minimizer resolves on exactly one shard.
    """
    n = len(hashes)
    bounds = shard_bounds(hashes, n_shards)
    nm = max(bounds[i + 1] - bounds[i] for i in range(n_shards))
    nm = max(nm, 1)
    h_out = np.full((n_shards, nm), _SENTINEL_HASH, dtype=np.uint32)
    p_out = np.zeros((n_shards, nm), dtype=np.uint32)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        h_out[s, : hi - lo] = hashes[lo:hi]
        p_out[s, : hi - lo] = pos[lo:hi]
    return h_out, p_out


import dataclasses


@dataclasses.dataclass
class DenseShardIndex:
    """Two-level per-shard hash index (make_sharded_dense_index).

    A direct per-shard CSR over the raw hash sub-range — the obvious
    port of the reference's index_table_ (seed_pos_table.cpp:73-94) —
    blows up on minimizer tables: minimizer hashes are window MINIMA,
    so their density falls with h and the count-aligned tail shard
    spans ~3/4 of the whole 4^k space (measured: SPAN 155M of 268M at
    k=14, 5 GB once padded across shards).  Instead each shard gets:

    * hd [P, ND] uint32 — its DISTINCT hashes (runs of equal hashes
      collapse, so repeat-heavy tables don't widen buckets);
    * crs [P, ND+1] int32 — CSR of each distinct hash's pos-range;
    * bkt [P, NB+1] int32 — bucket directory: first distinct-hash
      index with (h - base) >> shift >= b, with a per-shard shift
      sized so every shard fits the uniform NB buckets;
    * base/shift [P] int32, and `steps` = the static number of
      binary-refine iterations (= ceil log2 of the widest bucket).

    Lookup = 2 directory gathers + `steps` refine gathers + 1 verify
    gather, against ~2 x log2(Nm) searchsorted steps.  Memory is
    O(entries), not O(hash-space).
    """
    hd: np.ndarray
    crs: np.ndarray
    bkt: np.ndarray
    base: np.ndarray
    shift: np.ndarray
    steps: int


def make_sharded_dense_index(h_shards: np.ndarray,
                             bucket_factor: int = 4) -> DenseShardIndex:
    """Build the two-level index for hash-aligned shards (host-side,
    two passes, no device compile cost).  bucket_factor ~= buckets per
    distinct hash; larger = fewer refine steps, more memory."""
    P, _ = h_shards.shape
    hds, crss, nds = [], [], []
    bases = np.zeros(P, np.int64)
    spans = np.ones(P, np.int64)
    for s in range(P):
        hs = h_shards[s]
        n = int((hs != _SENTINEL_HASH).sum())
        if n:
            vals, starts = np.unique(hs[:n], return_index=True)
            crs = np.concatenate([starts, [n]]).astype(np.int32)
            bases[s] = int(vals[0])
            spans[s] = int(vals[-1]) - bases[s] + 1
        else:
            vals = np.zeros(0, np.uint32)
            crs = np.zeros(1, np.int32)
        hds.append(vals)
        crss.append(crs)
        nds.append(len(vals))
    ND = max(max(nds), 1)
    NB = max(1, bucket_factor * ND)
    hd = np.full((P, ND), _SENTINEL_HASH, dtype=np.uint32)
    crs_out = np.zeros((P, ND + 1), np.int32)
    bkt = np.zeros((P, NB + 1), np.int32)
    shifts = np.zeros(P, np.int64)
    max_width = 1
    for s in range(P):
        nd = nds[s]
        hd[s, :nd] = hds[s]
        crs_out[s, : nd + 1] = crss[s]
        crs_out[s, nd + 1:] = crss[s][-1] if nd else 0
        shift = 0
        while ((spans[s] - 1) >> shift) >= NB:  # max bucket id <= NB-1
            shift += 1
        shifts[s] = shift
        rel_b = (hds[s].astype(np.int64) - bases[s]) >> shift
        bkt[s] = bucket_directory(rel_b, NB)
        if nd:
            max_width = max(max_width, int(np.diff(bkt[s]).max()))
    steps = max(1, int(np.ceil(np.log2(max_width + 1))))
    return DenseShardIndex(hd, crs_out, bkt, bases.astype(np.int32),
                           shifts.astype(np.int32), steps)


@dataclasses.dataclass
class ShardedBudgets:
    """Workload-derived budgets for dsoft_table_sharded_fn, plus the
    measurements they were derived from (the reference's own fixed
    nz_bins budget, seed_pos_table.h:33, is the precedent for sizing
    these from data instead of guessing)."""
    tup_max: int        # per-device tuple-expansion budget (whole batch)
    cand_max: int       # per-read candidate slots
    a2a_cap: int        # per-(src,dst) all_to_all routing budget
    stats: dict         # observed maxima/means behind the sizing


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def derive_budgets(table, reads, n_shards: int, *, num_seeds_cap: int,
                   threshold: int, max_candidates: int,
                   safety: float = 2.0) -> ShardedBudgets:
    """Derive (tup_max, cand_max, a2a_cap) from the actual workload.

    Replays the D-SOFT gates on the host for each read (minimizer scan
    + table occurrence lookup — the cheap part of seeding) and sizes
    each fixed budget at safety x the observed per-slot maximum,
    rounded up to a power of two:

    * tup_max: per-device tuple expansion is budgeted over the WHOLE
      batch (sum over reads of that shard's occurrences, pre
      hit>=offset filtering — exactly what the kernel's cumsum-budget
      sees, sharded_table.py counts_l);
    * a2a_cap: per-(source shard, read-owner destination) tuple count
      (pre-filter, a conservative superset of the routed tuples);
    * cand_max: per-read candidate count from the host filtration
      (dsoft/filter.py, bit-exact vs the golden spec).

    Budget overflow at runtime is still flagged per read, never
    silent; safety covers workload drift from the derivation set.
    """
    from darwin_tpu.coding import query_minimizers
    from darwin_tpu.dsoft.filter import dsoft as host_dsoft

    bounds = np.asarray(shard_bounds(table.hashes, n_shards))
    R = len(reads)
    r_local = -(-R // n_shards)
    per_shard = np.zeros(n_shards, np.int64)            # tuples by src
    sd = np.zeros((n_shards, n_shards), np.int64)       # src x dst
    per_read = np.zeros(R, np.int64)
    cand = np.zeros(R, np.int64)
    for r, read in enumerate(reads):
        offs, hashes = query_minimizers(read, table.k, table.w)
        start, end = table.lookup(hashes)
        occ = end - start
        passing = occ <= table.kmer_max_occurence
        # zero-occurrence minimizers consume num_seeds budget (hence
        # the cumsum over `passing`) but expand to no tuples — and
        # their start index sits past the last shard bound.
        keep = (passing & (np.cumsum(passing) <= num_seeds_cap + 1)
                & (occ > 0))
        src = np.searchsorted(bounds, start[keep], side="right") - 1
        occk = occ[keep]
        np.add.at(per_shard, src, occk)
        np.add.at(sd, (src, np.full(len(src), r // r_local)), occk)
        per_read[r] = occk.sum()
        cand[r] = len(host_dsoft(table, read, num_seeds_cap, threshold,
                                 max_candidates)[0])
    stats = {
        "tuples_per_read_mean": float(per_read.mean()),
        "tuples_per_read_max": int(per_read.max()),
        "tuples_per_shard_max": int(per_shard.max()),
        "tuples_src_dst_max": int(sd.max()),
        "cand_per_read_mean": float(cand.mean()),
        "cand_per_read_max": int(cand.max()),
        "n_reads": R, "n_shards": n_shards,
    }
    return ShardedBudgets(
        tup_max=_next_pow2(int(safety * max(1, per_shard.max()))),
        cand_max=_next_pow2(int(safety * max(1, cand.max()))),
        a2a_cap=_next_pow2(int(safety * max(1, sd.max()))),
        stats=stats)


def _forward_fill_max(x):
    return jax.lax.associative_scan(jnp.maximum, x)


def _dsoft_table_sharded_local(queries, qlens, th, tp, *, axis: str,
                               k: int, w: int, bin_size: int,
                               kmer_max_occ: int, num_seeds_cap: int,
                               threshold: int, max_candidates: int,
                               tup_max: int, cand_max: int,
                               n_shards: int,
                               a2a_cap: int | None = None,
                               dindex=None, dsteps: int = 0):
    """Per-device body (inside shard_map).  queries [R, L] replicated;
    th/tp [1, Nm] = this device's table shard; dindex (optional) =
    this device's (hd, crs, bkt, base, shift) two-level index slices
    (make_sharded_dense_index) with dsteps refine iterations."""
    R, L = queries.shape
    LP = L + 16
    R_local = R // n_shards
    d = jax.lax.axis_index(axis)
    base = d * R_local

    th = th[0]
    tp = tp[0]

    lut = jnp.asarray(_TWOBIT_LUT)
    codes = jnp.pad(lut[queries.astype(jnp.int32)],
                    ((0, 0), (0, LP - L)))

    scan = jax.vmap(functools.partial(_query_minimizers_fixed,
                                      k=k, w=w, LP=LP),
                    in_axes=(0, 0))
    emit, mpos, mhash = scan(codes, qlens.astype(jnp.int32))  # [R, LP]

    if dindex is not None:
        # Two-level lookup (see DenseShardIndex): bucket directory
        # gathers narrow the search to <= 2^dsteps distinct hashes,
        # then a fixed-step binary refine + one verify gather resolve
        # the exact pos-range — a handful of gathers per minimizer
        # instead of two ~log2(Nm)-step binary searches (the dominant
        # lookup cost in the stage measurements).  Hashes absent from
        # this shard resolve to occ 0.
        from darwin_tpu.dsoft.device import twolevel_lookup
        hd1, crs1, bkt1, hbase, hshift = (a[0] for a in dindex)
        s0, e0 = twolevel_lookup(mhash.reshape(-1), hd1, crs1, bkt1,
                                 hbase, hshift, steps=dsteps)
        start_l = s0.reshape(R, LP)
        end_l = e0.reshape(R, LP)
    else:
        start_l = jnp.searchsorted(th, mhash.reshape(-1),
                                   side="left").reshape(R, LP)
        end_l = jnp.searchsorted(th, mhash.reshape(-1),
                                 side="right").reshape(R, LP)
    occ_l = (end_l - start_l).astype(jnp.int32)
    occ_g = jax.lax.psum(jnp.where(emit, occ_l, 0), axis)

    passing = emit & (occ_g <= kmer_max_occ)
    rank = jnp.cumsum(passing.astype(jnp.int32), axis=1)
    keep = passing & (rank <= num_seeds_cap + 1)

    # --- local tuple expansion under the fixed budget ----------------
    counts_l = jnp.where(keep, occ_l, 0).reshape(-1)        # [R*LP]
    cum = jnp.cumsum(counts_l)
    total_l = cum[-1]
    # A read overflowed locally iff its tuple range [begin, end) has
    # tuples (end > begin) and extends past the budget (end > tup_max).
    read_end = cum.reshape(R, LP)[:, -1]
    read_begin = jnp.concatenate([jnp.zeros((1,), cum.dtype),
                                  read_end[:-1]])
    overflow_read = (read_end > tup_max) & (read_end > read_begin)

    t_idx = jax.lax.broadcasted_iota(jnp.int32, (tup_max, 1), 0)[:, 0]
    f = jnp.searchsorted(cum, t_idx, side="right")
    f = jnp.minimum(f, R * LP - 1)
    within = t_idx - (cum[f] - counts_l[f])
    tvalid = t_idx < jnp.minimum(total_l, tup_max)

    g_idx = jnp.where(tvalid, start_l.reshape(-1)[f] + within, 0)
    # Positions stay uint32 through the exchange (the reference's own
    # pos width): int32 lanes would cap references at 2^31 while
    # uint32 carries the full 4.29 Gb at identical traffic.
    hit = tp[g_idx]                                # uint32
    t_read = (f // LP).astype(jnp.int32)
    t_mpos = (f % LP).astype(jnp.int32)
    tvalid &= hit >= t_mpos.astype(jnp.uint32)  # seed_pos_table.cpp:135

    # --- hit exchange -------------------------------------------------
    if a2a_cap is None:
        # all-gather: every device sees every tuple (P x traffic).
        def gather(x):
            return jax.lax.all_gather(x, axis, axis=0, tiled=True)

        a_read = gather(jnp.where(tvalid, t_read, INT32_MAX))
        a_mpos = gather(t_mpos)
        a_hit = gather(hit)
    else:
        # all_to_all: tuples routed to their read-owner device only —
        # each tuple crosses the interconnect once.  Per-destination budget a2a_cap;
        # overruns flag the affected reads (host fallback), never drop
        # silently.
        owner = jnp.where(tvalid, t_read // R_local, n_shards)
        o_s, r2, m2, h2 = jax.lax.sort(
            (owner, jnp.where(tvalid, t_read, INT32_MAX), t_mpos, hit),
            num_keys=1, is_stable=True)
        v2 = o_s != n_shards
        idx2 = jax.lax.broadcasted_iota(jnp.int32,
                                        (o_s.shape[0], 1), 0)[:, 0]
        onew = jnp.concatenate([jnp.ones((1,), bool),
                                o_s[1:] != o_s[:-1]]) & v2
        ofirst = _forward_fill_max(jnp.where(onew, idx2, -1))
        orank = idx2 - ofirst

        dropped = v2 & (orank >= a2a_cap)
        overflow_read = overflow_read.at[
            jnp.where(dropped, r2, R)].set(True, mode="drop")

        put2 = v2 & ~dropped
        tgt2 = jnp.where(put2, o_s * a2a_cap + orank,
                         n_shards * a2a_cap)

        def route(vals, fill):
            buf = jnp.full((n_shards * a2a_cap,), fill,
                           vals.dtype).at[
                tgt2].set(jnp.where(put2, vals, fill), mode="drop")
            return jax.lax.all_to_all(
                buf.reshape(n_shards, a2a_cap), axis, split_axis=0,
                concat_axis=0, tiled=False).reshape(-1)

        a_read = route(r2, INT32_MAX)
        a_mpos = route(m2, 0)
        a_hit = route(h2, jnp.uint32(0))
    overflow_read = jax.lax.pmax(overflow_read.astype(jnp.int32),
                                 axis) == 1  # [R] replicated

    mine = (a_read >= base) & (a_read < base + R_local)
    rloc = jnp.where(mine, a_read - base, INT32_MAX)

    bins = jnp.where(mine,
                     ((a_hit - a_mpos.astype(jnp.uint32))
                      // bin_size).astype(jnp.int32), INT32_MAX)
    r_s, b_s, m_s, h_s = jax.lax.sort(
        (rloc, bins, a_mpos, a_hit), num_keys=4, is_stable=True)
    v_s = r_s != INT32_MAX

    newseg = jnp.concatenate(
        [jnp.ones((1,), bool),
         (r_s[1:] != r_s[:-1]) | (b_s[1:] != b_s[:-1])])
    seg_start = newseg & v_s
    delta = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                             m_s[1:] - m_s[:-1]])
    inc = jnp.where(v_s,
                    jnp.where(seg_start, k, jnp.minimum(delta, k)), 0)
    cum2 = jnp.cumsum(inc)
    seg_base = _forward_fill_max(
        jnp.where(seg_start, cum2 - inc, jnp.int32(-1)))
    count = cum2 - seg_base

    crossing = (count >= threshold) & v_s
    prev_cross = jnp.concatenate([jnp.zeros((1,), bool), crossing[:-1]])
    first_cross = crossing & ~(prev_cross & ~seg_start)

    # --- per-read compaction into [R_local, cand_max] ------------------
    ckey = jnp.where(first_cross, r_s, INT32_MAX)
    c_r, c_m, c_h = jax.lax.sort((ckey, m_s, h_s), num_keys=3,
                                 is_stable=True)
    cvalid = c_r != INT32_MAX
    idx = jax.lax.broadcasted_iota(jnp.int32, (c_r.shape[0], 1), 0)[:, 0]
    rstart = jnp.concatenate([jnp.ones((1,), bool),
                              c_r[1:] != c_r[:-1]]) & cvalid
    seg_first = _forward_fill_max(jnp.where(rstart, idx, -1))
    crank = idx - seg_first

    n_emit = jnp.zeros((R_local,), jnp.int32).at[
        jnp.where(cvalid, c_r, R_local)].add(
            jnp.where(cvalid, 1, 0), mode="drop")
    n_final = jnp.minimum(jnp.minimum(n_emit, max_candidates), cand_max)
    over_c = jnp.minimum(n_emit, max_candidates) > cand_max
    my_overflow = jax.lax.dynamic_slice(overflow_read, (base,),
                                        (R_local,))
    overflow = my_overflow | over_c

    put = cvalid & (crank < n_final[jnp.minimum(c_r, R_local - 1)])
    tgt = jnp.where(put, c_r * cand_max + crank, R_local * cand_max)
    ufill = jnp.uint32(0xFFFFFFFF)  # -1 in the int32 view
    hits_out = jnp.full((R_local * cand_max,), ufill, jnp.uint32).at[
        tgt].set(jnp.where(put, c_h, ufill), mode="drop")
    offs_out = jnp.full((R_local * cand_max,), -1, jnp.int32).at[
        tgt].set(jnp.where(put, c_m, -1), mode="drop")
    return (hits_out.reshape(R_local, cand_max),
            offs_out.reshape(R_local, cand_max), n_final, overflow)


def dsoft_table_sharded_fn(mesh, *, k: int, w: int, bin_size: int,
                           kmer_max_occ: int, num_seeds_cap: int,
                           threshold: int, max_candidates: int,
                           tup_max: int = 8192, cand_max: int = 512,
                           a2a_cap: int | None = None,
                           index: str = "searchsorted",
                           dense_steps: int = 0):
    """shard_map'd table-sharded D-SOFT.

    Returned fn(queries [R, L] uint8, qlens [R], hash_shards [P, Nm],
    pos_shards [P, Nm]) -> (hits [R, cand_max], offs, counts, overflow);
    R must be a multiple of the mesh size.  With index="dense" the fn
    takes five extra trailing args (hd, crs, bkt, base, shift) from a
    DenseShardIndex (whose .steps goes in dense_steps) and replaces
    the per-minimizer binary searches with the two-level probe.
    """
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    assert index in ("searchsorted", "dense"), index

    local = functools.partial(
        _dsoft_table_sharded_local, axis=axis, k=k, w=w,
        bin_size=bin_size, kmer_max_occ=kmer_max_occ,
        num_seeds_cap=num_seeds_cap, threshold=threshold,
        max_candidates=max_candidates, tup_max=tup_max,
        cand_max=cand_max, n_shards=n_shards, a2a_cap=a2a_cap)

    in_specs = [P(None, None), P(None), P(axis, None), P(axis, None)]
    if index == "dense":
        def local_d(queries, qlens, th, tp, hd, crs, bkt, base, shift):
            return local(queries, qlens, th, tp,
                         dindex=(hd, crs, bkt, base, shift),
                         dsteps=dense_steps)
        body = local_d
        in_specs += [P(axis, None), P(axis, None), P(axis, None),
                     P(axis), P(axis)]
    else:
        body = local
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(axis, None), P(axis, None), P(axis), P(axis)),
        check_vma=False)
    return jax.jit(fn)
