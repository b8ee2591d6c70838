"""Human-scale coordinate dry run: reference past 2^31 bases.

Builds a multi-piece random reference just beyond 2^31 total bases
(pieces stay < 2^31 each, like real chromosomes), samples reads from
the HIGH end (global origin > 2^31), and drives the real pipeline on
CPU: native seed-table build, native D-SOFT (int64 hits), global->
(piece, local) decode, and the host batch engine.  Asserts every read
re-maps to its sampled origin.

This validates the int64 host-side coordinate path end-to-end; the
device engine's split (row, rem) bank addressing for >2^31 banks is
covered per-op by tests/test_tile_fetch.py and end-to-end here with
--engine device (the whole-loop engine on the real banks: on the GPU
with the CUDA kernel, or on CPU with --backend lax).

Usage: python tools/bigcoord_dryrun.py [--gb 2.4] [--pieces 10]
         [--engine host|device] [--backend auto|lax]
(takes minutes: ~2.5 GB of sequence, table build, seeding).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


_COMP = None


def _revcomp_codes(arr: np.ndarray) -> np.ndarray:
    global _COMP
    if _COMP is None:
        _COMP = np.arange(256, dtype=np.uint8)
        for a, b in zip(b"ACGTacgt", b"TGCAtgca"):
            _COMP[a] = b
    return _COMP[arr[::-1]]


def main(argv=None) -> int:
    import jax

    from darwin_tpu.config import Params
    from darwin_tpu.engine.aligner import JaxTileAligner
    from darwin_tpu.engine.batch import run_gact_batch
    from darwin_tpu.engine.scoring import ScoreParams
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import FastaRecord
    from darwin_tpu.pipeline import collect_calls

    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=2.4)
    ap.add_argument("--pieces", type=int, default=10)
    ap.add_argument("--reads", type=int, default=4)
    ap.add_argument("--read-len", type=int, default=8000)
    ap.add_argument("--engine", choices=("host", "device"),
                    default="host")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--backend", default=None,
                    help="aligner backend (default: lax on host "
                    "engine / auto on device engine)")
    ap.add_argument("--cpu", action="store_true", default=None,
                    help="force the CPU JAX backend (default for "
                    "--engine host)")
    args = ap.parse_args(argv)
    if args.cpu or (args.cpu is None and args.engine == "host"):
        jax.config.update("jax_platforms", "cpu")

    total = int(args.gb * (1 << 30))
    per = total // args.pieces
    rng = np.random.default_rng(31)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    params = Params()

    t0 = time.time()
    pieces = []
    for i in range(args.pieces):
        seq = alpha[rng.integers(0, 4, size=per)]
        pieces.append(FastaRecord([f"chr{i}"],
                                  seq.tobytes().decode("ascii")))
    print(f"genome: {args.pieces} x {per/1e6:.0f} Mb = {total/2**31:.2f}"
          f" x 2^31 bases ({time.time()-t0:.0f} s)")

    big = total > 2**31  # small --gb = CPU smoke of the same code path

    t0 = time.time()
    genome = Genome(pieces, params.bin_size)
    if big:
        assert (int(genome.chr_id_to_start_bin[-1]) * genome.bin_size
                > 2**31)
    print(f"concat+maps: {time.time()-t0:.0f} s "
          f"(last piece starts at "
          f"{int(genome.chr_id_to_start_bin[-1])*genome.bin_size/2**31:.2f}"
          f" x 2^31)")

    t0 = time.time()
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    if big:
        assert int(table.pos.max()) > 2**31, "table positions stayed small?"
    print(f"seed table: {len(table.pos)/1e6:.0f}M minimizers, "
          f"max pos {int(table.pos.max())/2**31:.2f} x 2^31 "
          f"({time.time()-t0:.0f} s)")

    # Reads sampled from the LAST piece: global origins > 2^31.
    reads = []
    origins = []
    gl = np.frombuffer(pieces[-1].seq.encode(), dtype=np.uint8)
    for r in range(args.reads):
        s = int(rng.integers(0, per - args.read_len))
        chunk = gl[s: s + args.read_len].copy()
        mut = rng.random(args.read_len) < 0.05
        chunk[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
        reads.append(chunk)
        origins.append(s)
    bank = SeqBank(reads)

    t0 = time.time()
    calls = collect_calls(table, genome, bank, params)
    print(f"D-SOFT: {len(calls.ref_id)} candidates "
          f"({time.time()-t0:.1f} s)")
    assert len(calls.ref_id) >= args.reads
    last = args.pieces - 1
    # Spurious same-diagonal double 14-mer collisions are expected on
    # 2.4 Gb of random sequence (each k-mer occurs ~9x by chance); the
    # true origin must be among the candidates for every read, decoded
    # into the LAST piece with a >2^31 global offset.
    for r in range(args.reads):
        mine = (calls.query_id == r) & (calls.ref_id == last)
        near = mine & (np.abs(calls.ref_pos
                              - calls.query_pos - origins[r]) < 100)
        assert near.any(), f"read {r}: origin candidate missing"

    t0 = time.time()
    if args.engine == "device":
        # Whole-loop device engine on the real >2^31 banks: exercises
        # the split (row, rem) addressing and span-fetch production
        # path (device_batch._split_offsets) end-to-end.
        from darwin_tpu.pipeline import run_device_merged
        rev_bank = SeqBank([_revcomp_codes(r) for r in reads])
        recs, _ = run_device_merged(
            genome, table, bank, rev_bank, params, same_file=False,
            batch_size=args.batch,
            backend=args.backend or "auto")
    else:
        aligner = JaxTileAligner(
            tile_size=params.tile_size,
            early_terminate=params.early_terminate, match=params.match,
            mismatch=params.mismatch, gap_open=params.gap_open,
            gap_extend=params.gap_extend,
            backend=args.backend or "lax")
        sp = ScoreParams(params.match, params.mismatch,
                         params.gap_open, params.gap_extend)
        recs = run_gact_batch(
            genome, bank, calls, tile_size=params.tile_size,
            first_tile_score_threshold=(
                params.first_tile_score_threshold),
            sp=sp, complement=False, same_file=False, aligner=aligner,
            batch_size=args.batch)
    print(f"GACT ({args.engine}): {len(recs)} records "
          f"({time.time()-t0:.0f} s)")
    ok = 0
    for r in range(args.reads):
        cand = [x for x in recs if x.query_id == r]
        hit = any(abs(x.ab - origins[r] - (x.bb - 1)) < 100
                  and x.ae - x.ab > 0.9 * args.read_len for x in cand)
        ok += hit
        print(f"  read {r}: origin chr{last}:{origins[r]} -> "
              f"{len(cand)} records, remapped={hit}")
    assert ok == args.reads, "some reads failed to re-map"
    where = ("past 2^31 global positions" if big
             else "(small-scale smoke; pass --gb 2.4 for >2^31)")
    print(f"BIGCOORD DRYRUN OK: seeding, decode and alignment are "
          f"exact {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
