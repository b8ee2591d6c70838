"""Sharded-table D-SOFT at realistic scale on the 8-device CPU mesh.

Runs dsoft/sharded_table.py against an E.coli-scale
reference (>= 4.6 Mb table) with 10 kb reads; check host-engine parity
(dsoft/filter.py, itself golden-differential tested), measure tuple /
candidate / per-destination maxima, derive (not guess) the tup_max /
cand_max / a2a_cap budgets via derive_budgets, and compare the
all_gather exchange against all_to_all on wall + traffic.

Runs on the CPU backend with 8 virtual devices (one process, no GPU),
so it can run alongside chip work.

Usage: python tools/sharded_scale.py [--genome 4600000] [--reads 64]
           [--read-len 10000] [--shards 8] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--genome", type=int, default=4_600_000)
    p.add_argument("--reads", type=int, default=64)
    p.add_argument("--read-len", type=int, default=10_000)
    p.add_argument("--error", type=float, default=0.12)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--safety", type=float, default=2.0)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    import darwin_tpu  # noqa: F401  (THP madvise guard)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from darwin_tpu.config import Params
    from darwin_tpu.dsoft.device import pad_reads
    from darwin_tpu.dsoft.filter import dsoft as host_dsoft
    from darwin_tpu.dsoft.sharded_table import (derive_budgets,
                                                dsoft_table_sharded_fn,
                                                make_sharded_dense_index,
                                                make_sharded_table)
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.parallel.mesh import make_mesh

    P_ = args.shards
    prm = Params()
    rng = np.random.default_rng(args.seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(alpha, size=args.genome).astype(np.uint8)
    t0 = time.time()
    table = SeedTable.build(ref, prm.seed_size,
                            prm.seed_occurence_multiple, prm.bin_size,
                            prm.window_size)
    print(f"table: {len(table.pos)} entries ({time.time()-t0:.1f} s), "
          f"kmer_max_occ={table.kmer_max_occurence}", flush=True)

    R, L = args.reads, args.read_len
    reads = []
    for _ in range(R):
        s = int(rng.integers(0, args.genome - L))
        r = ref[s:s + L].copy()
        mut = rng.random(L) < args.error
        r[mut] = rng.choice(alpha, size=int(mut.sum()))
        reads.append(r)
    bank = SeqBank(reads)
    Q, lens = pad_reads(bank, range(R))

    # --- workload-derived budgets ------------------------------------
    t0 = time.time()
    bud = derive_budgets(table, reads, P_,
                         num_seeds_cap=prm.num_seeds,
                         threshold=prm.threshold,
                         max_candidates=prm.max_candidates,
                         safety=args.safety)
    t_derive = time.time() - t0
    print(f"derive_budgets ({t_derive:.1f} s): tup_max={bud.tup_max} "
          f"cand_max={bud.cand_max} a2a_cap={bud.a2a_cap}", flush=True)
    for k, v in bud.stats.items():
        print(f"  {k}: {v}")

    mesh = make_mesh(P_)
    t0 = time.time()
    hs, ps = make_sharded_table(table.hashes, table.pos, P_)
    di = make_sharded_dense_index(hs)
    t_shard = time.time() - t0
    print(f"shards: [{P_}, {hs.shape[1]}] entries, two-level index "
          f"steps={di.steps} ({t_shard:.1f} s)", flush=True)

    # host oracle (bit-exact vs golden spec per round-1..3 tests)
    t0 = time.time()
    oracle = [host_dsoft(table, r, prm.num_seeds, prm.threshold,
                         prm.max_candidates) for r in reads]
    t_host = time.time() - t0
    n_oracle = sum(len(h) for h, _ in oracle)
    print(f"host oracle: {n_oracle} candidates ({t_host:.1f} s)",
          flush=True)

    kw = dict(k=table.k, w=table.w, bin_size=table.bin_size,
              kmer_max_occ=table.kmer_max_occurence,
              num_seeds_cap=prm.num_seeds, threshold=prm.threshold,
              max_candidates=prm.max_candidates, tup_max=bud.tup_max,
              cand_max=bud.cand_max, index="dense",
              dense_steps=di.steps)
    targs = (Q, lens, hs, ps, di.hd, di.crs, di.bkt, di.base, di.shift)

    results = {}
    for mode, cap in (("all_gather", None), ("all_to_all",
                                             bud.a2a_cap)):
        fn = dsoft_table_sharded_fn(mesh, a2a_cap=cap, **kw)
        t0 = time.time()
        hits, offs, counts, over = jax.device_get(fn(*targs))
        t_cold = time.time() - t0
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            hits, offs, counts, over = jax.device_get(fn(*targs))
        t_warm = (time.time() - t0) / reps

        mism = 0
        for i in range(R):
            want = list(zip(*[x.tolist() for x in oracle[i]]))
            got = list(zip(hits[i, :counts[i]].tolist(),
                           offs[i, :counts[i]].tolist()))
            if over[i] or got != want:
                mism += 1
        # received bytes per device per batch (3 int32 tuple arrays)
        if cap is None:
            traffic = P_ * bud.tup_max * 3 * 4
        else:
            traffic = P_ * cap * 3 * 4
        results[mode] = dict(warm_s=t_warm, cold_s=t_cold,
                             overflow=int(over.sum()),
                             mismatching_reads=mism,
                             recv_bytes_per_device=traffic)
        status = "EXACT" if mism == 0 and not over.any() else "FAIL"
        print(f"{mode}: warm {t_warm:.2f} s/batch (cold {t_cold:.1f}), "
              f"overflow {int(over.sum())}/{R}, parity {status}, "
              f"recv {traffic/1e6:.1f} MB/device", flush=True)

    out = dict(genome=args.genome, reads=R, read_len=L,
               shards=P_, budgets=dict(tup_max=bud.tup_max,
                                       cand_max=bud.cand_max,
                                       a2a_cap=bud.a2a_cap),
               stats=bud.stats, results=results)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    ok = all(r["mismatching_reads"] == 0 and r["overflow"] == 0
             for r in results.values())
    print("PARITY: EXACT" if ok else "PARITY: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
