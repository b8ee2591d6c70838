"""darwin-compatible command line interface.

Usage (positional args mirror the reference, darwin.cpp:451-507):

    python -m darwin_tpu.cli <REF>.fasta <READS>.fasta NUM_RANGES \
        [NUM_BLOCKS THREADS_PER_BLOCK] [options]

NUM_RANGES plays the role of the reference's CPU_THREADS: reads are
split into that many contiguous ranges, each producing its own
``darwin.<i>.out`` file (darwin.cpp:174, 619-632) so existing merge
tooling (`cat darwin.*.out | sort | uniq`) keeps working.  The optional
NUM_BLOCKS/THREADS_PER_BLOCK pair is accepted for CLI compatibility and
defines the device batch size as their product (darwin.cpp:504-508).

Reads ``params.cfg`` from the working directory like the reference, or
from --params.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from darwin_tpu.coding import seq_to_bytes
from darwin_tpu.config import Params
from darwin_tpu.engine.aligner import JaxTileAligner
from darwin_tpu.engine.batch import run_gact_batch
from darwin_tpu.engine.scoring import ScoreParams
from darwin_tpu.engine.seqbank import SeqBank
from darwin_tpu.golden.gact import format_record
from darwin_tpu.index.genome import Genome
from darwin_tpu.index.seed_table import SeedTable
from darwin_tpu.io.fasta import parse_fasta, revcomp
from darwin_tpu.pipeline import collect_calls


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="darwin-tpu",
        description="D-SOFT + GACT long-read overlapper")
    p.add_argument("reference", help="reference FASTA")
    p.add_argument("reads", help="reads FASTA")
    p.add_argument("num_ranges", type=int, nargs="?", default=1,
                   help="number of darwin.<i>.out output ranges")
    p.add_argument("num_blocks", type=int, nargs="?", default=None)
    p.add_argument("threads_per_block", type=int, nargs="?", default=None)
    p.add_argument("--params", default="params.cfg",
                   help="params.cfg path (reference-compatible INI)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="device tile-batch size (overrides blocks*tpb)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "lax"],
                   help="tile-DP kernel: cuda (GPU), lax (portable); "
                        "auto = by platform")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"],
                   help="device = whole GACT loop on the accelerator "
                        "(default on the GPU); host = per-iteration "
                        "batches")
    p.add_argument("--out-dir", default=".",
                   help="directory for darwin.<i>.out files")
    p.add_argument("--merged-out", default=None,
                   help="also write a sorted-unique merged overlap file")
    p.add_argument("--paf-out", default=None,
                   help="also write overlaps as PAF (sorted unique; "
                        "matches column is exact, 0 under --noscore)")
    p.add_argument("--seed-table", default=None,
                   help="seed table cache path (.npz); built if missing")
    p.add_argument("--noscore", action="store_true",
                   help="skip rescoring (reference NOSCORE build)")
    p.add_argument("--threads", type=int, default=None,
                   help="host threads for the native D-SOFT engine "
                        "(default: all cores)")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard the engine over N local devices "
                        "(independent per-device slot pools)")
    p.add_argument("--chunk-reads", type=int, default=None,
                   help="stream the reads file in chunks of N records "
                        "(bounded memory; reads-vs-reference mode only)")
    p.add_argument("--resume", action="store_true",
                   help="skip read ranges whose darwin.<i>.out already "
                        "exists (restart amortization; the seed table "
                        "is amortized via --seed-table)")
    p.add_argument("--metrics-json", default=None,
                   help="write phase timings/counters as JSON")
    p.add_argument("--dsoft", default="host",
                   choices=["host", "device"],
                   help="seeding engine: host = native C++/NumPy, "
                        "device = on-device fixed-shape D-SOFT")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host mode: this process aligns its "
                        "jax.process_index() read range and writes "
                        "darwin.<process_index>.out; --merged-out "
                        "all-gathers records across hosts")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    if args.distributed:
        # Must run before anything touches the XLA backend.
        from darwin_tpu.parallel import distributed as dist
        dist.maybe_initialize()
    from darwin_tpu.utils import configure_compile_cache
    configure_compile_cache()
    params = (Params.from_cfg(args.params) if Path(args.params).exists()
              else Params())
    same_file = args.reference == args.reads
    print(f"same_file: {int(same_file)}")

    if args.batch_size:
        batch_size = args.batch_size
    elif args.num_blocks and args.threads_per_block:
        batch_size = args.num_blocks * args.threads_per_block
    else:
        batch_size = 512
    print(f"Scores: match = {params.match}, mismatch = {params.mismatch},"
          f" gap_open = {params.gap_open}, gap_extend = {params.gap_extend}")
    print(f"Batch size: {batch_size}, output ranges: {args.num_ranges}")

    metrics: dict = {"batch_size": batch_size}

    t0 = time.time()
    ref_records = parse_fasta(args.reference)
    genome = Genome(ref_records, params.bin_size)
    metrics["ref_load_ms"] = (time.time() - t0) * 1e3
    metrics["ref_length"] = int(genome.total_length)
    print(f"Reference length: {genome.total_length}, "
          f"{len(ref_records)} pieces "
          f"({metrics['ref_load_ms']:.0f} ms)")

    t0 = time.time()
    chunked = bool(args.chunk_reads) and not same_file
    if args.chunk_reads and same_file:
        print("--chunk-reads ignored: self-overlap mode needs the "
              "whole read set in memory (it IS the reference)")
    if chunked:
        read_records = None
        metrics["read_load_ms"] = 0.0
        print(f"Streaming reads in chunks of {args.chunk_reads}")
    else:
        read_records = (ref_records if same_file
                        else parse_fasta(args.reads))
        metrics["read_load_ms"] = (time.time() - t0) * 1e3
        metrics["num_reads"] = len(read_records)
        print(f"Number of reads: {len(read_records)} "
              f"({metrics['read_load_ms']:.0f} ms)")

    engine = args.engine
    if engine == "auto":
        import jax
        engine = "device" if jax.default_backend() == "gpu" else "host"

    # Device path, reads in memory: build the engine (banks upload
    # once) BEFORE the seed table and start the background pre-warm so
    # the engine compile overlaps table build + seeding.
    prebuilt_engine = None
    fwd_bank = rev_bank = None
    all_resumed = False
    if args.resume and not args.distributed and not chunked:
        # Every range already has output: the loop below will resume
        # them all, so skip the device-engine build + prewarm entirely
        # (banks upload gigabytes and the prewarm starts a compile
        # whose result nothing would use).
        nr = max(1, args.num_ranges)
        per = max(1, -(-len(read_records) // nr))
        all_resumed = all(
            (Path(args.out_dir) / f"darwin.{rid}.out").exists()
            for rid in range(len(range(0, len(read_records), per))))
    if engine == "device" and not chunked and not all_resumed:
        from darwin_tpu.pipeline import make_merged_engine
        fwd_bank = SeqBank([seq_to_bytes(r.seq) for r in read_records])
        rev_bank = SeqBank([seq_to_bytes(revcomp(r.seq))
                            for r in read_records])
        mesh = None
        if args.mesh:
            from darwin_tpu.parallel.mesh import make_mesh
            mesh = make_mesh(args.mesh)
        prebuilt_engine = make_merged_engine(
            genome, fwd_bank, rev_bank, params, same_file=same_file,
            batch_size=batch_size, compute_score=not args.noscore,
            backend=args.backend, mesh=mesh)
        if mesh is None:
            prebuilt_engine[0].prewarm_async(
                int(1.3 * 2 * len(read_records)))

    t0 = time.time()
    dist_table = False
    if args.distributed and args.seed_table:
        from darwin_tpu.parallel import distributed as dist
        dist_table = dist.process_count() > 1
    if dist_table:
        # Multi-host table amortization: process 0 builds (or reuses)
        # the table on shared storage, peers wait at the barrier and
        # load — the duplicated global work per peer drops from a full
        # build to one file read (tools/scaling_run.py measures it).
        table = None
        if dist.process_index() == 0 \
                and not Path(args.seed_table).exists():
            table = SeedTable.build(genome.concat, params.seed_size,
                                    params.seed_occurence_multiple,
                                    params.bin_size, params.window_size)
            table.save(args.seed_table)
        dist.barrier("seed-table")
        if table is None:
            table = SeedTable.load(args.seed_table)
        metrics["seed_table_ms"] = (time.time() - t0) * 1e3
        print(f"Seed table ready (coordinator-built, "
              f"{len(table.pos)} minimizers, "
              f"{metrics['seed_table_ms']:.0f} ms)")
    elif args.seed_table and Path(args.seed_table).exists():
        table = SeedTable.load(args.seed_table)
        metrics["seed_table_ms"] = (time.time() - t0) * 1e3
        print(f"Seed table loaded from {args.seed_table} "
              f"({metrics['seed_table_ms']:.0f} ms)")
    else:
        table = SeedTable.build(genome.concat, params.seed_size,
                                params.seed_occurence_multiple,
                                params.bin_size, params.window_size)
        if args.seed_table:
            table.save(args.seed_table)
        metrics["seed_table_ms"] = (time.time() - t0) * 1e3
        print(f"Seed table built: {len(table.pos)} minimizers "
              f"({metrics['seed_table_ms']:.0f} ms)")

    aligner = None
    if engine == "host":
        aligner = JaxTileAligner(
            tile_size=params.tile_size,
            early_terminate=params.early_terminate,
            match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_extend=params.gap_extend,
            backend=args.backend)
    print(f"Engine: {engine}"
          + (f" (backend {aligner.backend})" if aligner else ""))

    sp = ScoreParams(params.match, params.mismatch, params.gap_open,
                     params.gap_extend)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    all_lines: list[str] = []

    if chunked:
        return _run_chunked(args, params, genome, table, engine,
                            aligner, sp, same_file, batch_size,
                            out_dir, metrics)

    if fwd_bank is None:
        fwd_bank = SeqBank([seq_to_bytes(r.seq) for r in read_records])
        rev_bank = SeqBank([seq_to_bytes(revcomp(r.seq))
                            for r in read_records])
    num_reads = len(read_records)

    if args.distributed:
        from darwin_tpu.parallel import distributed as dist
        dist.maybe_initialize()
        rng = dist.read_range(num_reads)
        ranges = [(rng.start, rng.stop)]
        range_ids = [dist.process_index()]
        print(f"distributed: process {dist.process_index()}/"
              f"{dist.process_count()}, reads [{rng.start}, {rng.stop})")
    else:
        nr = max(1, args.num_ranges)
        per = max(1, -(-num_reads // nr))
        ranges = [(lo, min(num_reads, lo + per))
                  for lo in range(0, num_reads, per)]
        range_ids = list(range(len(ranges)))

    read_names = [r.name for r in read_records]
    read_lens = [len(r.seq) for r in read_records]

    def recs_to_paf(recs):
        from darwin_tpu.io.paf import paf_lines
        return paf_lines(recs, genome, read_names, read_lens)

    t_seed = 0.0
    t_gact = 0.0
    n_cand = 0
    all_paf: list[str] = []
    for range_id, (lo, hi) in zip(range_ids, ranges):
        out_file = out_dir / f"darwin.{range_id}.out"
        paf_file = out_dir / f"darwin.{range_id}.paf"
        if args.resume and out_file.exists():
            prior = out_file.read_text().splitlines()
            all_lines.extend(prior)
            print(f"range {range_id}: resumed from {out_file} "
                  f"({len(prior)} records)")
            if args.paf_out:
                # PAF needs per-record data the .out text does not carry
                # (nmatch/ncols); resume from the sidecar the previous
                # --paf-out run wrote alongside the .out file.
                if paf_file.exists():
                    all_paf.extend(paf_file.read_text().splitlines())
                else:
                    print(f"WARNING: no {paf_file} sidecar; range "
                          f"{range_id} will be missing from "
                          f"{args.paf_out} (re-run without --resume "
                          f"to regenerate)", file=sys.stderr)
            continue
        lines: list[str] = []
        range_recs: list = []
        if engine == "device":
            from darwin_tpu.pipeline import run_device_merged
            # prebuilt_engine was built before the seed table (banks
            # upload once, prewarm overlaps); it is None only when
            # every range resumed, in which case this branch is
            # unreachable — run_device_merged would self-build then.
            phase: dict = {}
            recs, cc = run_device_merged(
                genome, table, fwd_bank, rev_bank, params,
                same_file=same_file, batch_size=batch_size,
                compute_score=not args.noscore, backend=args.backend,
                read_ids=range(lo, hi), num_threads=args.threads,
                dsoft=args.dsoft, prebuilt=prebuilt_engine,
                metrics=phase)
            t_seed += phase["seed_s"]
            t_gact += phase["align_s"]
            n_cand += sum(cc)
            print(f"range {range_id}: {cc[0]}+{cc[1]} candidates")
            range_recs.extend(recs)
        else:
            for comp, bank in ((False, fwd_bank), (True, rev_bank)):
                t0 = time.time()
                if args.dsoft == "device":
                    from darwin_tpu.pipeline import collect_calls_device
                    calls = collect_calls_device(table, genome, bank,
                                                 params,
                                                 read_ids=range(lo, hi))
                else:
                    calls = collect_calls(table, genome, bank, params,
                                          read_ids=range(lo, hi),
                                          num_threads=args.threads)
                t_seed += time.time() - t0
                n_cand += len(calls)
                print(f"range {range_id} comp {int(comp)}: "
                      f"{len(calls)} candidates")
                t0 = time.time()
                recs = run_gact_batch(
                    genome, bank, calls, tile_size=params.tile_size,
                    first_tile_score_threshold=(
                        params.first_tile_score_threshold),
                    sp=sp, complement=comp, same_file=same_file,
                    aligner=aligner, batch_size=batch_size,
                    compute_score=not args.noscore)
                t_gact += time.time() - t0
                range_recs.extend(recs)
        for r in range_recs:
            lines.append(format_record(
                genome.names[r.ref_id], read_records[r.query_id].name,
                r.ab, r.ae, r.bb, r.be, r.score, r.comp))
        out_file.write_text("".join(line + "\n" for line in lines))
        all_lines.extend(lines)
        if args.paf_out:
            pl = recs_to_paf(range_recs)
            paf_file.write_text("".join(line + "\n" for line in pl))
            all_paf.extend(pl)

    print(f"Time finding seeds: {t_seed * 1e3:.0f} msec")
    print(f"Time GACT calling: {t_gact * 1e3:.0f} msec")

    if args.metrics_json:
        import json

        from darwin_tpu.engine.device_batch import ENGINE_COMPILE_LOG
        metrics.update(
            seed_ms=t_seed * 1e3, gact_ms=t_gact * 1e3,
            num_candidates=n_cand, num_records=len(all_lines),
            engine=engine, dsoft=args.dsoft,
            engine_compiles=list(ENGINE_COMPILE_LOG),
            reads_per_s=(metrics["num_reads"]
                         / max(1e-9, t_seed + t_gact)))
        Path(args.metrics_json).write_text(
            json.dumps(metrics, indent=2) + "\n")
        print(f"Metrics written to {args.metrics_json}")

    if args.paf_out:
        if args.distributed:
            # All-gather so every process writes the full merged PAF,
            # mirroring the reference's one-merged-output convention
            # (README:25) and --merged-out below.
            from darwin_tpu.parallel import distributed as dist
            paf_merged = dist.allgather_records(all_paf)
        else:
            paf_merged = sorted(set(all_paf))
        Path(args.paf_out).write_text(
            "".join(line + "\n" for line in paf_merged))
        print(f"PAF written to {args.paf_out} "
              f"({len(paf_merged)} records)")

    if args.merged_out:
        if args.distributed:
            from darwin_tpu.parallel import distributed as dist
            merged = dist.allgather_records(all_lines)
        else:
            merged = sorted(set(all_lines))
        Path(args.merged_out).write_text(
            "".join(line + "\n" for line in merged))
        print(f"Merged {len(all_lines)} records -> {len(merged)} unique "
              f"in {args.merged_out}")
    return 0


def _run_chunked(args, params, genome, table, engine, aligner, sp,
                 same_file, batch_size, out_dir, metrics) -> int:
    """Stream the reads file in fixed-size chunks (bounded memory)."""
    import itertools

    from darwin_tpu.io.fasta import iter_fasta

    t_align = 0.0
    n_cand = 0
    n_reads = 0
    all_lines: list[str] = []
    all_paf: list[str] = []
    mesh = None
    if engine == "device" and args.mesh:
        # Built once: each chunk's engine differs (banks differ) but the
        # device mesh does not.
        from darwin_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh)
    it = iter_fasta(args.reads)
    for chunk_id in itertools.count():
        chunk = list(itertools.islice(it, args.chunk_reads))
        if not chunk:
            break
        n_reads += len(chunk)
        out_file = out_dir / f"darwin.{chunk_id}.out"
        paf_file = out_dir / f"darwin.{chunk_id}.paf"
        if args.resume and out_file.exists():
            prior = out_file.read_text().splitlines()
            all_lines.extend(prior)
            print(f"chunk {chunk_id}: resumed ({len(prior)} records)")
            if args.paf_out:
                if paf_file.exists():
                    all_paf.extend(paf_file.read_text().splitlines())
                else:
                    print(f"WARNING: no {paf_file} sidecar; chunk "
                          f"{chunk_id} will be missing from "
                          f"{args.paf_out} (re-run without --resume "
                          f"to regenerate)", file=sys.stderr)
            continue
        fwd = SeqBank([seq_to_bytes(r.seq) for r in chunk])
        rev = SeqBank([seq_to_bytes(revcomp(r.seq)) for r in chunk])
        t0 = time.time()
        lines: list[str] = []
        if engine == "device":
            from darwin_tpu.pipeline import run_device_merged
            recs, cc = run_device_merged(
                genome, table, fwd, rev, params, same_file=same_file,
                batch_size=batch_size, compute_score=not args.noscore,
                backend=args.backend, num_threads=args.threads,
                dsoft=args.dsoft, mesh=mesh)
            n_cand += sum(cc)
        else:
            recs = []
            for comp, bank in ((False, fwd), (True, rev)):
                calls = collect_calls(table, genome, bank, params,
                                      num_threads=args.threads)
                n_cand += len(calls)
                recs.extend(run_gact_batch(
                    genome, bank, calls, tile_size=params.tile_size,
                    first_tile_score_threshold=(
                        params.first_tile_score_threshold),
                    sp=sp, complement=comp, same_file=same_file,
                    aligner=aligner, batch_size=batch_size,
                    compute_score=not args.noscore))
        t_align += time.time() - t0
        for r in recs:
            lines.append(format_record(
                genome.names[r.ref_id], chunk[r.query_id].name,
                r.ab, r.ae, r.bb, r.be, r.score, r.comp))
        out_file.write_text("".join(line + "\n" for line in lines))
        all_lines.extend(lines)
        if args.paf_out:
            from darwin_tpu.io.paf import paf_lines
            pl = paf_lines(recs, genome, [r.name for r in chunk],
                           [len(r.seq) for r in chunk])
            paf_file.write_text("".join(line + "\n" for line in pl))
            all_paf.extend(pl)
        print(f"chunk {chunk_id}: {len(chunk)} reads, "
              f"{len(lines)} records")

    print(f"Time aligning: {t_align * 1e3:.0f} msec "
          f"({n_reads} reads streamed)")
    if args.metrics_json:
        import json
        metrics.update(num_reads=n_reads, gact_ms=t_align * 1e3,
                       seed_ms=0.0, num_candidates=n_cand,
                       num_records=len(all_lines), engine=engine,
                       dsoft=args.dsoft,
                       reads_per_s=n_reads / max(1e-9, t_align))
        Path(args.metrics_json).write_text(
            json.dumps(metrics, indent=2) + "\n")
    if args.paf_out:
        paf_merged = sorted(set(all_paf))
        Path(args.paf_out).write_text(
            "".join(line + "\n" for line in paf_merged))
        print(f"PAF written to {args.paf_out} "
              f"({len(paf_merged)} records)")
    if args.merged_out:
        merged = sorted(set(all_lines))
        Path(args.merged_out).write_text(
            "".join(line + "\n" for line in merged))
        print(f"Merged {len(all_lines)} records -> {len(merged)} "
              f"unique in {args.merged_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
