"""Two-tier drain A/B on the E.coli-scale workload: the drain's
engine-phase effect at the production dataset, not only the synthetic
skew of tools/drain_prof.py (run it on the GPU to re-fit the drain
gate's thresholds).

Builds the standard E.coli differential dataset (4.6 Mb genome,
460 x 10 kb reads at 12% error, 50% RC — the scale_test recipe), runs
the merged-strand device engine with the drain enabled and disabled,
and reports warm align-phase wall plus the exported utilization
counters (last_iters, last_active_sum, last_drain_redispatches).
Record sets are asserted identical between the two settings.

Usage: python tools/drain_ecoli.py [reps]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import darwin_tpu  # noqa: F401,E402  (THP madvise guard)
from darwin_tpu.config import Params  # noqa: E402
from darwin_tpu.coding import seq_to_bytes  # noqa: E402
from darwin_tpu.engine.seqbank import SeqBank  # noqa: E402
from darwin_tpu.eval.datagen import sample_reads, synth_genome  # noqa: E402
from darwin_tpu.index.genome import Genome  # noqa: E402
from darwin_tpu.index.seed_table import SeedTable  # noqa: E402
from darwin_tpu.io.fasta import FastaRecord, revcomp  # noqa: E402
from darwin_tpu.pipeline import (collect_calls, make_merged_engine,  # noqa: E402
                                 run_device_merged)


def main() -> int:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    G = int(sys.argv[2]) if len(sys.argv) > 2 else 4_600_000
    NR = int(sys.argv[3]) if len(sys.argv) > 3 else 460
    RL = int(sys.argv[4]) if len(sys.argv) > 4 else 10_000
    params = Params()
    rng = np.random.default_rng(42)
    genome_s = synth_genome(G, rng)
    reads = sample_reads(genome_s, NR, RL, rng, error_rate=0.12,
                         rc_fraction=0.5)
    read_recs = [FastaRecord([name], seq) for name, seq in reads]
    ref_recs = read_recs  # self-overlap, like the differential
    genome = Genome(ref_recs, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    fwd = SeqBank([seq_to_bytes(r.seq) for r in read_recs])
    rev = SeqBank([seq_to_bytes(revcomp(r.seq)) for r in read_recs])

    results = {}
    for drain in ("always", True, False):
        prebuilt = make_merged_engine(genome, fwd, rev, params,
                                      same_file=True, batch_size=512)
        prebuilt[0].drain_enabled = drain
        # compile + warm
        recs, _ = run_device_merged(
            genome, table, fwd, rev, params, same_file=True,
            batch_size=512, prebuilt=prebuilt)
        best = None
        for _ in range(reps):
            m: dict = {}
            recs, _ = run_device_merged(
                genome, table, fwd, rev, params, same_file=True,
                batch_size=512, prebuilt=prebuilt, metrics=m)
            if best is None or m["align_s"] < best["align_s"]:
                best = m
        eng = prebuilt[0]
        results[drain] = (sorted(set(map(str, recs))), best,
                          eng.last_iters, eng.last_active_sum,
                          getattr(eng, "last_drain_redispatches", 0))
        util = (eng.last_active_sum / (eng.last_iters * 512)
                if eng.last_iters else 0.0)
        print(f"drain={drain}: align {best['align_s']*1e3:.0f} ms "
              f"(seed {best['seed_s']*1e3:.0f} ms), "
              f"iters={eng.last_iters} "
              f"active_sum={eng.last_active_sum} util={util:.2f} "
              f"redispatches={results[drain][4]}", flush=True)

    assert (results["always"][0] == results[False][0]
            == results[True][0]), "drain on/off record sets differ!"
    print(f"records identical: {len(results[True][0])} unique",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
