"""Reproducible scale differential test vs the reference CPU binary.

The counterpart of the reference's x_scalingrun.sh compare flow:
generate a seeded PBSIM-style dataset, run this pipeline (the device
engine on a GPU, the host engine on the CPU) and, when a reference
binary is given, the reference CPU build on the same FASTA, and diff
the sorted-unique overlap records byte-for-byte.

Usage:
    python tools/scale_test.py [--genome 4600000] [--reads 460]
        [--read-len 10000] [--error 0.12] [--seed 42]
        [--darwin /tmp/refbuild/darwin] [--workdir /tmp/scale_test]

Build the reference binary with the g++-only recipe in SURVEY.md §7.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--genome", type=int, default=4_600_000)
    p.add_argument("--reads", type=int, default=460)
    p.add_argument("--read-len", type=int, default=10_000)
    p.add_argument("--read-len-min", type=int, default=0,
                   help="draw each read's length uniformly from "
                        "[min, read-len] (exercises LPT balancing, "
                        "drain tiers and length bucketing); 0 = "
                        "fixed-length reads (default)")
    p.add_argument("--error", type=float, default=0.12)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--darwin", default=None,
                   help="reference binary; skip differential if absent")
    p.add_argument("--workdir", default="/tmp/scale_test")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--threads", type=int, default=8,
                   help="reference binary CPU threads")
    p.add_argument("--chromosomes", type=int, default=1,
                   help="split the synthetic genome into C FASTA "
                        "records (guided mode only).  Mirrors real "
                        "genome shape AND keeps per-chromosome "
                        "positions below the reference binary's int "
                        "ref_pos limit (gact.cpp:51) at 3 Gb scale")
    p.add_argument("--guided", action="store_true",
                   help="reference-guided mode: reads vs the genome "
                        "itself (ref != reads, BASELINE configs[1]) "
                        "instead of self-overlap")
    p.add_argument("--params", default=None,
                   help="params.cfg used by BOTH pipelines; "
                        "default: reference defaults")
    p.add_argument("--only", choices=["both", "ref", "ours"],
                   default="both",
                   help="split the differential across processes: "
                        "'ref' generates the dataset and runs only the "
                        "reference binary (CPU; start it first, it is "
                        "hours at large scale), 'ours' runs "
                        "only this pipeline and diffs against the "
                        "ref.darwin the 'ref' phase left in workdir")
    args = p.parse_args(argv)

    from darwin_tpu.config import Params
    from darwin_tpu.eval.datagen import sample_reads, synth_genome
    from darwin_tpu.io.fasta import parse_fasta, write_fasta
    from darwin_tpu.pipeline import run_pipeline

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    fasta = work / "reads.fasta"

    ref_fasta = (work / "genome.fasta") if args.guided else fasta
    if args.only == "ours" and fasta.exists() and ref_fasta.exists():
        # The 'ref' phase already wrote the (seed-deterministic)
        # dataset; at 250 Mb regeneration costs minutes.
        pass
    else:
        rng = np.random.default_rng(args.seed)
        lr = ((args.read_len_min, args.read_len)
              if args.read_len_min else None)
        C = max(1, args.chromosomes)
        if C > 1:
            assert args.guided, "--chromosomes needs --guided"
            chroms, reads = [], []
            for c in range(C):
                n = args.genome // C
                r = args.reads // C + (1 if c < args.reads % C else 0)
                g = synth_genome(n, rng)
                chroms.append((f"chr{c}", g))
                for name, seq in sample_reads(
                        g, r, args.read_len, rng,
                        error_rate=args.error, rc_fraction=0.5,
                        read_len_range=lr):
                    reads.append((f"c{c}{name}", seq))
            write_fasta(fasta, reads)
            write_fasta(ref_fasta, chroms)
        else:
            genome = synth_genome(args.genome, rng)
            reads = sample_reads(genome, args.reads, args.read_len, rng,
                                 error_rate=args.error, rc_fraction=0.5,
                                 read_len_range=lr)
            write_fasta(fasta, reads)
            if args.guided:
                write_fasta(ref_fasta, [("genome_0", genome)])
    print(f"dataset: {args.reads} x {args.read_len} bp reads over "
          f"{args.genome} bp genome -> {fasta}"
          + (" (guided: vs the genome)" if args.guided else ""))

    ours = None
    if args.only != "ref":
        params = (Params.from_cfg(args.params) if args.params
                  else Params())
        records = parse_fasta(fasta)
        ref_recs = parse_fasta(ref_fasta) if args.guided else records
        same_file = not args.guided
        engine = "device" if _on_accelerator() else "host"
        t0 = time.time()
        res = run_pipeline(ref_recs, records, params,
                           same_file=same_file,
                           batch_size=args.batch_size, engine=engine)
        cold = time.time() - t0
        # Two warm runs, keep the best: the first warm run still pays
        # one-time jit tracing of small helpers.
        warm = float("inf")
        for _ in range(2):
            t0 = time.time()
            res = run_pipeline(ref_recs, records, params,
                               same_file=same_file,
                               batch_size=args.batch_size,
                               engine=engine)
            warm = min(warm, time.time() - t0)
        ours = sorted(set(res.records))
        (work / "ours.darwin").write_text("\n".join(ours) + "\n")
        print(f"ours: cold {cold:.1f} s, warm {warm:.1f} s "
              f"({args.reads / warm:.1f} reads/s), "
              f"{len(ours)} unique records")
        from darwin_tpu.engine.device_batch import ENGINE_COMPILE_LOG
        print(f"engine compiles this process: "
              f"{len(ENGINE_COMPILE_LOG)} {ENGINE_COMPILE_LOG}")

    if args.only == "ours":
        ref_out = work / "ref.darwin"
        if not ref_out.exists():
            print("no ref.darwin in workdir (run --only ref first); "
                  "skipping differential")
            return 0
        ref_records = ref_out.read_text().splitlines()
    else:
        if not args.darwin or not Path(args.darwin).exists():
            print("no reference binary given; skipping differential")
            return 0
        refdir = work / "ref"
        refdir.mkdir(exist_ok=True)
        (refdir / "reads.fasta").write_bytes(fasta.read_bytes())
        if args.guided:
            (refdir / "genome.fasta").write_bytes(ref_fasta.read_bytes())
        if args.params:
            cfg = Path(args.params)
        else:
            cfg = Path(args.darwin).parent / "params.cfg"
            if not cfg.exists():
                cfg = REPO.parent / "reference" / "params.cfg"
        (refdir / "params.cfg").write_bytes(cfg.read_bytes())
        t0 = time.time()
        ref_arg = "genome.fasta" if args.guided else "reads.fasta"
        subprocess.run([str(Path(args.darwin).resolve()), ref_arg,
                        "reads.fasta", str(args.threads)],
                       cwd=refdir, check=True, capture_output=True)
        ref_t = time.time() - t0
        ref_records = sorted(set(
            line for f in sorted(refdir.glob("darwin.*.out"))
            for line in f.read_text().splitlines()))
        (work / "ref.darwin").write_text("\n".join(ref_records) + "\n")
        (work / "ref.wall").write_text(f"{ref_t:.1f}\n")
        print(f"reference: {ref_t:.1f} s "
              f"({args.reads / ref_t:.1f} reads/s), "
              f"{len(ref_records)} unique records")
        if args.only == "ref":
            _print_peak_rss()
            return 0

    if args.only == "ours":
        wall = work / "ref.wall"
        ref_t = float(wall.read_text()) if wall.exists() else None
    _print_peak_rss()
    if ours == ref_records:
        speed = (f"; speedup {ref_t / warm:.0f}x"
                 if ref_t is not None else "")
        print(f"PARITY: EXACT ({len(ours)} records){speed}")
        return 0
    missing = set(ref_records) - set(ours)
    extra = set(ours) - set(ref_records)
    print(f"PARITY: FAILED missing={len(missing)} extra={len(extra)}")
    for line in sorted(missing)[:3]:
        print(f"  missing: {line}")
    for line in sorted(extra)[:3]:
        print(f"  extra:   {line}")
    return 1


def _print_peak_rss():
    """Peak RSS of this process (this pipeline) and of reaped
    children (the reference binary)."""
    import resource
    self_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    kids_gb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6
    print(f"peak RSS: self {self_gb:.2f} GB, children {kids_gb:.2f} GB")


def _on_accelerator() -> bool:
    import jax
    return jax.default_backend() == "gpu"


if __name__ == "__main__":
    sys.exit(main())
