"""Multi-process throughput scaling measurement (CLI, jax.distributed).

Runs the CLI on one generated dataset as a single process and as an
N-process jax.distributed job, and reports per-process phase times,
wall clock, and scaling efficiency.  Every process is forced onto the
CPU backend (JAX_PLATFORMS=cpu): this tool measures the multi-process
orchestration, not the GPU, and N JAX processes could not share one
card's memory anyway.

Efficiency caveat: on a host with fewer cores than processes, the
processes timeslice, so wall-clock efficiency is ~1/N by
construction; the meaningful outputs here are (a) the duplicated
global work per process (parse + seed-table build, by design — see
parallel/distributed.py) and (b) the merge-collective overhead, both
of which bound multi-host scaling when real cores/chips exist:
  efficiency(N) ~= t_align / (t_align/N + t_dup + t_merge).

Usage:
    python tools/scaling_run.py [--procs 2] [--genome 150000]
        [--reads 48] [--read-len 5000] [--workdir /tmp/scaling_run]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def run_cli(work: Path, fasta: Path, tag: str, nprocs: int,
            extra_env=None, extra_args=None) -> dict:
    """Run the CLI (nprocs processes); returns wall + metrics dicts."""
    outdir = work / tag
    outdir.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.time()
    for pid in range(nprocs):
        env = {"PYTHONPATH": str(REPO), "PATH": os.environ["PATH"],
               "JAX_PLATFORMS": "cpu", "HOME": os.environ["HOME"]}
        if nprocs > 1:
            env.update({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:9941",
                        "JAX_NUM_PROCESSES": str(nprocs),
                        "JAX_PROCESS_ID": str(pid)})
        if extra_env:
            env.update(extra_env)
        cmd = [sys.executable, "-m", "darwin_tpu.cli", str(fasta),
               str(fasta), "--batch-size", "128",
               "--out-dir", str(outdir),
               "--metrics-json", str(outdir / f"metrics.{pid}.json"),
               "--merged-out", str(outdir / f"merged.{pid}.out")]
        if extra_args:
            cmd += list(extra_args)
        if nprocs > 1:
            cmd.append("--distributed")
        procs.append(subprocess.Popen(cmd, cwd=outdir,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE,
                                      text=True, env=env))
    for p in procs:
        out, err = p.communicate(timeout=3600)
        if p.returncode != 0:
            raise SystemExit(f"{tag} proc failed:\n{err[-3000:]}")
    wall = time.time() - t0
    metrics = [json.loads((outdir / f"metrics.{i}.json").read_text())
               for i in range(nprocs)]
    merged = (outdir / "merged.0.out").read_text().splitlines()
    return dict(wall=wall, metrics=metrics, merged=merged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--genome", type=int, default=150_000)
    ap.add_argument("--reads", type=int, default=48)
    ap.add_argument("--read-len", type=int, default=5_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--workdir", default="/tmp/scaling_run")
    args = ap.parse_args(argv)

    from darwin_tpu.eval.datagen import sample_reads, synth_genome
    from darwin_tpu.io.fasta import write_fasta

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    genome = synth_genome(args.genome, rng)
    reads = sample_reads(genome, args.reads, args.read_len, rng,
                         error_rate=0.1, rc_fraction=0.5)
    fasta = work / "reads.fasta"
    write_fasta(fasta, reads)
    print(f"dataset: {args.reads} x {args.read_len} bp over "
          f"{args.genome} bp genome; nproc(machine)="
          f"{os.cpu_count()}")

    one = run_cli(work, fasta, "p1", 1)
    many = run_cli(work, fasta, f"p{args.procs}", args.procs)
    # Same job with coordinator-built seed table on shared storage:
    # peers barrier + load instead of rebuilding (cli.py dist_table).
    table = work / "table.npz"
    if table.exists():
        table.unlink()
    amort = run_cli(work, fasta, f"p{args.procs}a", args.procs,
                    extra_args=["--seed-table", str(table)])

    assert sorted(set(one["merged"])) == one["merged"]
    for other, tag in ((many, "N-proc"), (amort, "N-proc amortized")):
        if one["merged"] != other["merged"]:
            print(f"PARITY: FAILED between 1-proc and {tag} merges")
            return 1
    print(f"PARITY: EXACT ({len(one['merged'])} records, "
          f"incl. --seed-table amortized run)")

    m1 = one["metrics"][0]
    align1 = m1["seed_ms"] + m1["gact_ms"]

    def dup_of(run):
        return np.mean([m["ref_load_ms"] + m["read_load_ms"]
                        + m["seed_table_ms"] for m in run["metrics"]])

    dup = dup_of(many)
    dup_a = dup_of(amort)
    peer_table = np.mean([m["seed_table_ms"]
                          for m in amort["metrics"][1:]]) \
        if args.procs > 1 else 0.0
    alignN = max(m["seed_ms"] + m["gact_ms"] for m in many["metrics"])
    r1 = args.reads / one["wall"]
    rN = args.reads / many["wall"]
    print(f"1 proc : wall {one['wall']:.1f} s = {r1:.2f} reads/s "
          f"(align {align1/1e3:.1f} s)")
    print(f"{args.procs} procs: wall {many['wall']:.1f} s = "
          f"{rN:.2f} reads/s (slowest align {alignN/1e3:.1f} s, "
          f"duplicated global work {dup/1e3:.2f} s/proc)")
    print(f"{args.procs} procs + --seed-table: duplicated global work "
          f"{dup_a/1e3:.2f} s/proc (peer table wait+load "
          f"{peer_table/1e3:.2f} s vs build "
          f"{m1['seed_table_ms']/1e3:.2f} s)")
    eff = rN / (r1 * args.procs)
    print(f"wall-clock efficiency: {eff:.2f} "
          f"(1/N-bound on this {os.cpu_count()}-core machine)")
    # Structural model for machines with >= procs free cores:
    model = align1 / (align1 / args.procs + dup)
    model_a = align1 / (align1 / args.procs + dup_a)
    print(f"projected efficiency with {args.procs} real cores/hosts: "
          f"{model / args.procs:.2f} rebuild / "
          f"{model_a / args.procs:.2f} amortized "
          f"(align/N + duplicated-global-work model)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
