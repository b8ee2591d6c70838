"""Resident-serving throughput: table + banks + compiled engine stay
resident, fresh read batches stream through seed + align only.

The serving-mode complement to tools/scale_test.py's one-shot walls:
a production deployment holds the reference's seed table and the
device engine resident (`--seed-table` + a long-lived process) and
pays only D-SOFT + GACT per query batch.  Reports per-batch wall and
reads/s for R repetitions (best-of as the quiet-machine number).

Usage: python tools/resident_serve.py [GENOME_BP] [N_READS] [REPS]
       (defaults: 4.6 Mb, 460 reads, 3 — the E.coli shape;
        3e9 300 for the human-scale row)
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import darwin_tpu  # noqa: F401,E402  (THP madvise guard)
import numpy as np  # noqa: E402

from darwin_tpu.config import Params  # noqa: E402
from darwin_tpu.coding import seq_to_bytes  # noqa: E402
from darwin_tpu.engine.seqbank import SeqBank  # noqa: E402
from darwin_tpu.eval.datagen import sample_reads, synth_genome  # noqa: E402
from darwin_tpu.index.genome import Genome  # noqa: E402
from darwin_tpu.index.seed_table import SeedTable  # noqa: E402
from darwin_tpu.io.fasta import FastaRecord, revcomp  # noqa: E402
from darwin_tpu.pipeline import (make_merged_engine,  # noqa: E402
                                 run_device_merged)


def main() -> int:
    G = int(float(sys.argv[1])) if len(sys.argv) > 1 else 4_600_000
    NR = int(sys.argv[2]) if len(sys.argv) > 2 else 460
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    params = Params()
    rng = np.random.default_rng(42)

    t0 = time.time()
    n_chr = max(1, G // 125_000_000)
    chroms = [synth_genome(G // n_chr, rng) for _ in range(n_chr)]
    print(f"genome {G} bp as {n_chr} pieces: {time.time()-t0:.1f} s",
          flush=True)

    t0 = time.time()
    genome = Genome([FastaRecord([f"chr{i}"], c)
                     for i, c in enumerate(chroms)], params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    print(f"resident table build: {time.time()-t0:.1f} s "
          f"({len(table.pos)} entries)", flush=True)

    # One fixed read batch (serving-shape); a fresh batch per rep
    # would re-pay only host FASTA parse, which scale_test measures.
    reads = []
    for c in chroms:
        reads += sample_reads(c, NR // n_chr + 1, 10_000, rng,
                              error_rate=0.12, rc_fraction=0.5)
    reads = reads[:NR]
    read_recs = [FastaRecord([n], s) for n, s in reads]
    fwd = SeqBank([seq_to_bytes(r.seq) for r in read_recs])
    rev = SeqBank([seq_to_bytes(revcomp(r.seq)) for r in read_recs])

    t0 = time.time()
    prebuilt = make_merged_engine(genome, fwd, rev, params,
                                  same_file=False, batch_size=512)
    print(f"resident engine build + bank upload: "
          f"{time.time()-t0:.1f} s", flush=True)

    # Warm-up (pays the one engine compile).
    t0 = time.time()
    recs, _ = run_device_merged(genome, table, fwd, rev, params,
                                same_file=False, batch_size=512,
                                prebuilt=prebuilt)
    print(f"first batch (incl. compile): {time.time()-t0:.1f} s, "
          f"{len(recs)} records", flush=True)

    best = None
    for i in range(reps):
        m: dict = {}
        t0 = time.time()
        recs, _ = run_device_merged(genome, table, fwd, rev, params,
                                    same_file=False, batch_size=512,
                                    prebuilt=prebuilt, metrics=m)
        dt = time.time() - t0
        print(f"batch {i}: {dt:.2f} s = {NR/dt:.0f} reads/s "
              f"(seed {m['seed_s']*1e3:.0f} + align "
              f"{m['align_s']*1e3:.0f} ms), {len(recs)} records",
              flush=True)
        best = dt if best is None else min(best, dt)
    print(f"RESIDENT-SERVE {G} bp, {NR} reads: best {best:.2f} s = "
          f"{NR/best:.0f} reads/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
