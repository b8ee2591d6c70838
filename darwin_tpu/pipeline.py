"""End-to-end overlap pipeline: load -> index -> D-SOFT -> GACT -> records.

Single-host equivalent of the reference driver's AlignReads flow
(darwin.cpp:166-449, GPU build).  On the device path both strands run
as ONE merged engine batch (run_device_merged): a single multithreaded
D-SOFT pass over all forward + reverse-complement read-strands, then
one whole-batch GACT dispatch with the complement flag as per-call
data.  The host path mirrors the reference's per-direction flow.
Multi-device sharding lives in darwin_tpu.parallel and the mesh=
option; multi-host in parallel/distributed.py.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from darwin_tpu.coding import seq_to_bytes
from darwin_tpu.config import Params
from darwin_tpu.dsoft import dsoft
from darwin_tpu.engine.aligner import JaxTileAligner
from darwin_tpu.engine.batch import GactCalls, run_gact_batch
from darwin_tpu.engine.scoring import ScoreParams
from darwin_tpu.engine.seqbank import SeqBank
from darwin_tpu.golden.gact import format_record
from darwin_tpu.index.genome import Genome
from darwin_tpu.index.seed_table import SeedTable
from darwin_tpu.io.fasta import FastaRecord, revcomp


@dataclasses.dataclass
class PipelineResult:
    records: list[str]
    num_candidates_for: int
    num_candidates_rev: int


def collect_calls(table: SeedTable, genome: Genome, queries: SeqBank,
                  params: Params, read_ids=None,
                  num_threads: int | None = None) -> GactCalls:
    """Run D-SOFT for every query and decode hits to GACT anchors.

    Uses the multithreaded native host engine when available (reads are
    data-parallel across host threads, mirroring the reference driver's
    per-thread read split, darwin.cpp:619-632); falls back to the
    vectorized NumPy D-SOFT per read.
    """
    ids = range(len(queries.lengths)) if read_ids is None else read_ids
    from darwin_tpu import native
    if native.available():
        ids_arr = np.asarray(list(ids), dtype=np.int64)
        counts, hits, offsets = native.dsoft_batch(
            table.hashes, table.pos, table.k, table.w, table.bin_size,
            table.ref_size, table.kmer_max_occurence, queries.flat,
            queries.starts, queries.lengths, ids_arr,
            params.num_seeds, params.threshold, params.max_candidates,
            num_threads)
        if len(hits) == 0:
            z = np.empty(0, dtype=np.int64)
            return GactCalls(z, z, z, z)
        chr_id, local = genome.decode_hits(hits)
        qid = np.repeat(ids_arr, counts)
        return GactCalls(chr_id, qid, local, offsets)

    return _collect_calls_python(table, genome, queries, params, ids)


def collect_calls_device(table: SeedTable, genome: Genome,
                         queries: SeqBank, params: Params,
                         read_ids=None, *, tup_max: int = 8192,
                         cand_max: int = 512, mesh=None,
                         index: str = "auto") -> GactCalls:
    """On-device D-SOFT over the read batch (optionally mesh-sharded).

    Reads whose fixed tuple/candidate budget overflows fall back to the
    exact host path, so results are always complete.
    """
    from darwin_tpu.dsoft.device import (default_index_mode,
                                         dense_hash_index,
                                         dsoft_device_batch, pad_reads,
                                         sharded_dsoft_fn)
    import jax

    ids = (np.arange(len(queries.lengths), dtype=np.int64)
           if read_ids is None else np.asarray(list(read_ids)))
    if len(ids) == 0:
        z = np.empty(0, dtype=np.int64)
        return GactCalls(z, z, z, z)
    if index == "auto":
        index = default_index_mode(table.k)
    tl_steps = 0
    if index == "dense":
        # Built once per table in its own jit (see dense_hash_index)
        # and cached on the table object.
        th_arg = getattr(table, "_dense_csr", None)
        if th_arg is None:
            th_arg = dense_hash_index(np.asarray(table.hashes), table.k)
            table._dense_csr = th_arg
    elif index == "twolevel":
        # Host-built two-level index, cached per table.
        cached = getattr(table, "_twolevel", None)
        if cached is None:
            from darwin_tpu.dsoft.device import make_twolevel_index
            cached = table._twolevel = make_twolevel_index(
                np.asarray(table.hashes))
        th_arg, tl_steps = cached[:5], cached[5]
    else:
        th_arg = np.asarray(table.hashes)
    Q, lens = pad_reads(queries, ids)
    # Bucket both dims (reads pow2, lengths half-octave) so compiled
    # programs are reusable across read batches of similar shape (the
    # jit is keyed on [R, L]; padding is masked out by qlens).
    from darwin_tpu.utils import bucket_pow2, bucket_steps
    RP = bucket_pow2(Q.shape[0], 8)
    LPad = bucket_steps(Q.shape[1], 1024)
    if (RP, LPad) != Q.shape:
        Q = np.pad(Q, ((0, RP - Q.shape[0]), (0, LPad - Q.shape[1])))
        lens = np.pad(lens, (0, RP - len(lens)))
    kw = dict(k=table.k, w=table.w, bin_size=table.bin_size,
              kmer_max_occ=table.kmer_max_occurence,
              num_seeds_cap=params.num_seeds,
              threshold=params.threshold,
              max_candidates=params.max_candidates,
              tup_max=tup_max, cand_max=cand_max, index=index,
              tl_steps=tl_steps)
    if mesh is not None:
        n_dev = mesh.devices.size
        R = Q.shape[0]
        RM = -(-R // n_dev) * n_dev
        if RM != R:
            Q = np.pad(Q, ((0, RM - R), (0, 0)))
            lens = np.pad(lens, (0, RM - R))
        fn = sharded_dsoft_fn(mesh, **kw)
        hits, offs, counts, over = jax.device_get(
            fn(Q, lens, th_arg, np.asarray(table.pos)))
        hits, offs = hits[: len(ids)], offs[: len(ids)]
        counts, over = counts[: len(ids)], over[: len(ids)]
    else:
        # Compile time grows with the batch dim, not read length: run
        # R<=256 slices that all share one compiled [256, LPad]
        # program (R is pow2-bucketed above).
        RCAP = 256
        tpos = np.asarray(table.pos)
        if Q.shape[0] > RCAP:
            # Dispatch every slice first (async), fetch once: slice
            # i's transfer overlaps slice i+1's device compute.
            pending = [dsoft_device_batch(
                           Q[i:i + RCAP], lens[i:i + RCAP], th_arg,
                           tpos, **kw)
                       for i in range(0, Q.shape[0], RCAP)]
            outs = jax.device_get(pending)
            hits, offs, counts, over = (
                np.concatenate([o[j] for o in outs]) for j in range(4))
        else:
            hits, offs, counts, over = jax.device_get(
                dsoft_device_batch(Q, lens, th_arg, tpos, **kw))

    rid, qid, rpos, qpos = [], [], [], []
    for r, k in enumerate(ids):
        if over[r]:  # exact host fallback, never truncate silently
            seq = queries.slice(k, 0, int(queries.lengths[k]))
            h, o = dsoft(table, seq, params.num_seeds,
                         params.threshold, params.max_candidates)
        else:
            h = hits[r, : counts[r]].astype(np.int64)
            o = offs[r, : counts[r]].astype(np.int64)
        if len(h) == 0:
            continue
        chr_id, local = genome.decode_hits(h)
        rid.append(chr_id)
        qid.append(np.full(len(h), k, dtype=np.int64))
        rpos.append(local)
        qpos.append(o)

    if not rid:
        z = np.empty(0, dtype=np.int64)
        return GactCalls(z, z, z, z)
    return GactCalls(np.concatenate(rid), np.concatenate(qid),
                     np.concatenate(rpos), np.concatenate(qpos))


def collect_calls_table_sharded(table: SeedTable, genome: Genome,
                                queries: SeqBank, params: Params,
                                mesh, read_ids=None, budgets=None,
                                exchange: str = "all_to_all"
                                ) -> GactCalls:
    """Table-SHARDED D-SOFT over the mesh (hash-range shards +
    cross-device hit exchange; dsoft/sharded_table.py) decoded to GACT
    anchors — the BASELINE north-star path for references too large to
    replicate per device.

    Budgets default to workload-derived sizing (derive_budgets, 2x
    safety over the observed maxima — measured at E.coli scale in
    tools/sharded_scale.py); the exchange defaults to the
    all_to_all, which moves 1/P of all_gather's per-device traffic
    (measured 8x less on an 8-device CPU mesh).  Overflowing reads
    fall back to the exact host path, never silently truncate.
    """
    import jax

    from darwin_tpu.dsoft.device import pad_reads
    from darwin_tpu.dsoft.sharded_table import (derive_budgets,
                                                dsoft_table_sharded_fn,
                                                make_sharded_dense_index,
                                                make_sharded_table)

    n_dev = mesh.devices.size
    ids = (np.arange(len(queries.lengths), dtype=np.int64)
           if read_ids is None else np.asarray(list(read_ids)))
    if len(ids) == 0:
        z = np.empty(0, dtype=np.int64)
        return GactCalls(z, z, z, z)
    if budgets is None:
        # Deriving budgets replays the exact host D-SOFT over the
        # batch — do it once per (table, mesh size) and reuse: the
        # budgets carry 2x safety, they size STATIC shapes (a fresh
        # derivation per batch would recompile the sharded fn), and
        # an under-sized later batch only trips the overflow flag,
        # which falls back to the exact host path below.
        bcache = getattr(table, "_budget_cache", None)
        if bcache is not None and bcache[0] == n_dev:
            budgets = bcache[1]
        else:
            budgets = derive_budgets(
                table,
                [queries.slice(int(k), 0, int(queries.lengths[k]))
                 for k in ids],
                n_dev, num_seeds_cap=params.num_seeds,
                threshold=params.threshold,
                max_candidates=params.max_candidates)
            table._budget_cache = (n_dev, budgets)
    cached = getattr(table, "_shard_cache", None)
    if cached is None or cached[0] != n_dev:
        hs, ps = make_sharded_table(table.hashes, table.pos, n_dev)
        di = make_sharded_dense_index(hs)
        cached = table._shard_cache = (n_dev, hs, ps, di)
    _, hs, ps, di = cached
    Q, lens = pad_reads(queries, ids)
    R = Q.shape[0]
    RM = -(-R // n_dev) * n_dev
    if RM != R:
        Q = np.pad(Q, ((0, RM - R), (0, 0)))
        lens = np.pad(lens, (0, RM - R))
    fn = dsoft_table_sharded_fn(
        mesh, k=table.k, w=table.w, bin_size=table.bin_size,
        kmer_max_occ=table.kmer_max_occurence,
        num_seeds_cap=params.num_seeds, threshold=params.threshold,
        max_candidates=params.max_candidates, tup_max=budgets.tup_max,
        cand_max=budgets.cand_max,
        a2a_cap=(budgets.a2a_cap if exchange == "all_to_all"
                 else None),
        index="dense", dense_steps=di.steps)
    hits, offs, counts, over = jax.device_get(
        fn(Q, lens, hs, ps, di.hd, di.crs, di.bkt, di.base, di.shift))

    rid, qid, rpos, qpos = [], [], [], []
    for r, k in enumerate(ids):
        if over[r]:  # exact host fallback, never truncate silently
            seq = queries.slice(int(k), 0, int(queries.lengths[k]))
            h, o = dsoft(table, seq, params.num_seeds,
                         params.threshold, params.max_candidates)
        else:
            h = hits[r, : counts[r]].astype(np.int64)
            o = offs[r, : counts[r]].astype(np.int64)
        if len(h) == 0:
            continue
        chr_id, local = genome.decode_hits(h)
        rid.append(chr_id)
        qid.append(np.full(len(h), k, dtype=np.int64))
        rpos.append(local)
        qpos.append(o)
    if not rid:
        z = np.empty(0, dtype=np.int64)
        return GactCalls(z, z, z, z)
    return GactCalls(np.concatenate(rid), np.concatenate(qid),
                     np.concatenate(rpos), np.concatenate(qpos))


def _collect_calls_python(table: SeedTable, genome: Genome,
                          queries: SeqBank, params: Params, ids
                          ) -> GactCalls:
    rid, qid, rpos, qpos = [], [], [], []
    for k in ids:
        seq = queries.slice(k, 0, int(queries.lengths[k]))
        hits, offsets = dsoft(table, seq, params.num_seeds,
                              params.threshold, params.max_candidates)
        if len(hits) == 0:
            continue
        chr_id, local = genome.decode_hits(hits)
        rid.append(chr_id)
        qid.append(np.full(len(hits), k, dtype=np.int64))
        rpos.append(local)
        qpos.append(offsets)

    if not rid:
        z = np.empty(0, dtype=np.int64)
        return GactCalls(z, z, z, z)
    return GactCalls(np.concatenate(rid), np.concatenate(qid),
                     np.concatenate(rpos), np.concatenate(qpos))


def make_merged_engine(genome: Genome, fwd_bank: SeqBank,
                       rev_bank: SeqBank, params: Params, *,
                       same_file: bool, batch_size: int,
                       compute_score: bool = True,
                       backend: str = "auto", mesh=None):
    """Build the merged-bank engine once (bank upload included) so
    callers iterating over read ranges reuse it via run_device_merged's
    ``prebuilt`` argument."""
    from darwin_tpu.engine.device_batch import (DeviceGactEngine,
                                                ShardedGactEngine)

    num_reads = len(fwd_bank.lengths)
    merged = SeqBank.concat(fwd_bank, rev_bank)
    kw = dict(
        tile_size=params.tile_size,
        early_terminate=params.early_terminate,
        first_tile_score_threshold=params.first_tile_score_threshold,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_extend=params.gap_extend,
        same_file=same_file, batch_size=batch_size,
        compute_score=compute_score, backend=backend)
    if mesh is not None:
        dev = ShardedGactEngine(genome, merged, mesh=mesh, **kw)
    else:
        dev = DeviceGactEngine(genome, merged, **kw)
    return dev, merged, num_reads


def run_device_merged(genome: Genome, table: SeedTable,
                      fwd_bank: SeqBank, rev_bank: SeqBank,
                      params: Params, *, same_file: bool,
                      batch_size: int, compute_score: bool = True,
                      backend: str = "auto", read_ids=None,
                      num_threads: int | None = None,
                      dsoft: str = "host", mesh=None, prebuilt=None,
                      metrics: dict | None = None):
    """Both strands as ONE merged engine batch.

    comp is per-call data and revcomp reads live in the second half of
    the merged bank: one multithreaded D-SOFT pass over all read-
    strands, one engine dispatch, a shared slot pool with no per-strand
    tails.  Returns (records, [n_fwd_candidates, n_rev_candidates]).
    """
    if prebuilt is not None:
        dev, merged, num_reads = prebuilt
    else:
        dev, merged, num_reads = make_merged_engine(
            genome, fwd_bank, rev_bank, params, same_file=same_file,
            batch_size=batch_size, compute_score=compute_score,
            backend=backend, mesh=mesh)
    if read_ids is None:
        merged_ids = None
    else:
        ids = np.asarray(list(read_ids), dtype=np.int64)
        merged_ids = np.concatenate([ids, ids + num_reads])
    t0 = _time.time()
    if dsoft == "device":
        calls_m = collect_calls_device(table, genome, merged, params,
                                       read_ids=merged_ids)
    else:
        calls_m = collect_calls(table, genome, merged, params,
                                read_ids=merged_ids,
                                num_threads=num_threads)
    t1 = _time.time()
    comp = (calls_m.query_id >= num_reads).astype(np.int32)
    counts = [int((comp == 0).sum()), int((comp == 1).sum())]
    bank_ids = calls_m.query_id
    calls = GactCalls(calls_m.ref_id, calls_m.query_id % num_reads,
                      calls_m.ref_pos, calls_m.query_pos)
    recs = dev.finish(dev.run_async(calls, comp, bank_ids))
    if metrics is not None:
        metrics["seed_s"] = t1 - t0
        metrics["align_s"] = _time.time() - t1
        metrics["engine_iters"] = getattr(dev, "last_iters", None)
    return recs, counts


def run_pipeline(ref_records: list[FastaRecord],
                 read_records: list[FastaRecord], params: Params,
                 same_file: bool, *, batch_size: int = 512,
                 aligner=None, table: SeedTable | None = None,
                 engine: str = "host", backend: str = "auto",
                 compute_score: bool = True,
                 metrics: dict | None = None) -> PipelineResult:
    t0 = _time.time()
    genome = Genome(ref_records, params.bin_size)
    if aligner is None and engine == "host":
        aligner = JaxTileAligner(
            tile_size=params.tile_size,
            early_terminate=params.early_terminate,
            match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_extend=params.gap_extend,
            backend=backend)

    # Device path: kick the seed-table build off on a worker thread
    # first (the native builder releases the GIL for its C sections),
    # so it runs during the engine's waits — the bank upload and the
    # prewarm compile dispatch.
    table_worker = None
    if table is None and engine == "device":
        import threading

        table_box: list = [None, None]  # [table, exception]

        def _build_table():
            try:
                table_box[0] = SeedTable.build(
                    genome.concat, params.seed_size,
                    params.seed_occurence_multiple, params.bin_size,
                    params.window_size)
            except BaseException as e:  # re-raised at join
                table_box[1] = e

        table_worker = threading.Thread(target=_build_table,
                                        name="seed-table-build")
        table_worker.start()

    fwd_bank = SeqBank([seq_to_bytes(r.seq) for r in read_records])
    rev_bank = SeqBank([seq_to_bytes(revcomp(r.seq))
                        for r in read_records])
    t1 = _time.time()

    # Build the engine (bank upload) BEFORE waiting on the seed table
    # and start the background engine pre-warm, so the compile
    # overlaps the table build + seeding.
    prebuilt = None
    if engine == "device":
        prebuilt = make_merged_engine(
            genome, fwd_bank, rev_bank, params, same_file=same_file,
            batch_size=batch_size, compute_score=compute_score,
            backend=backend)
        if hasattr(prebuilt[0], "prewarm_async"):
            # ~1.2 candidates per read-strand at E.coli scale
            prebuilt[0].prewarm_async(
                int(1.3 * 2 * len(read_records)))
    t2 = _time.time()
    if table_worker is not None:
        table_worker.join()
        if table_box[1] is not None:
            # Surface the build failure here, not as a confusing
            # NoneType error deep inside seeding.
            raise table_box[1]
        table = table_box[0]
    elif table is None:
        table = SeedTable.build(genome.concat, params.seed_size,
                                params.seed_occurence_multiple,
                                params.bin_size, params.window_size)
    t3 = _time.time()
    if metrics is not None:
        metrics["genome_banks_s"] = t1 - t0
        metrics["engine_build_s"] = t2 - t1
        metrics["table_s"] = t3 - t2
    sp = ScoreParams(params.match, params.mismatch, params.gap_open,
                     params.gap_extend)

    records: list[str] = []
    counts = []
    if engine == "device":
        all_recs, counts = run_device_merged(
            genome, table, fwd_bank, rev_bank, params,
            same_file=same_file, batch_size=batch_size,
            compute_score=compute_score, backend=backend,
            prebuilt=prebuilt, metrics=metrics)
    else:
        all_recs = []
        for comp, bank in ((False, fwd_bank), (True, rev_bank)):
            ts = _time.time()
            calls = collect_calls(table, genome, bank, params)
            if metrics is not None:
                metrics["seed_s"] = (metrics.get("seed_s", 0.0)
                                     + _time.time() - ts)
                ts = _time.time()
            counts.append(len(calls))
            all_recs.extend(run_gact_batch(
                genome, bank, calls, tile_size=params.tile_size,
                first_tile_score_threshold=(
                    params.first_tile_score_threshold),
                sp=sp, complement=comp, same_file=same_file,
                aligner=aligner, batch_size=batch_size,
                compute_score=compute_score))
            if metrics is not None:
                metrics["align_s"] = (metrics.get("align_s", 0.0)
                                      + _time.time() - ts)
    t4 = _time.time()
    for r in all_recs:
        records.append(format_record(
            genome.names[r.ref_id], read_records[r.query_id].name,
            r.ab, r.ae, r.bb, r.be, r.score, r.comp))
    if metrics is not None:
        metrics["format_s"] = _time.time() - t4
    return PipelineResult(records, counts[0], counts[1])
