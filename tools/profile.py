"""Profiling harness: JAX device traces + phase timing + GCUPS.

The counterpart of the reference's profiling tooling (profile.sh's
nvprof metric collection, gprof hooks, TIME-flag phase splits): runs
the tile step or the end-to-end pipeline under jax.profiler and prints
a phase/GCUPS summary.  On the CPU the numbers describe XLA's CPU
backend, not the GPU.

Usage:
    python tools/profile.py kernel [--trace-dir /tmp/trace] [B] [T]
    python tools/profile.py pipeline REF.fasta READS.fasta \
        [--params params.cfg] [--trace-dir /tmp/trace]

Open trace dirs with TensorBoard or Perfetto (xplane format).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


@contextlib.contextmanager
def maybe_trace(trace_dir):
    import jax

    if trace_dir:
        with jax.profiler.trace(trace_dir):
            yield
        print(f"trace written to {trace_dir}", file=sys.stderr)
    else:
        yield


def profile_kernel(args) -> None:
    import jax
    import jax.numpy as jnp

    from darwin_tpu.engine.aligner import resolve_backend, tile_dp_words
    from darwin_tpu.ops.traceback import traceback_packed6_jax

    B, T = args.B, args.T
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = alpha[rng.integers(0, 4, size=(B, T))]
    query = ref.copy()
    mut = rng.random((B, T)) < 0.1
    query[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
    rlen = np.full(B, T, np.int32)
    firsts = np.zeros(B, bool)
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    backend = resolve_backend()

    @jax.jit
    def step(r, q):
        out, words = tile_dp_words(backend, r, q, rlen, rlen, **kw)
        ops, _mb, i_s, j_s = traceback_packed6_jax(
            words, rlen, rlen, firsts, out["max_i"],
            out["max_j"], early_terminate=200)
        return (ops.astype(jnp.int32).sum() + i_s.sum() + j_s.sum()
                + out["max_score"].sum())

    r_d, q_d = jax.device_put(ref), jax.device_put(query)
    jax.device_get(step(r_d, q_d))  # compile
    with maybe_trace(args.trace_dir):
        t0 = time.time()
        for _ in range(args.reps):
            jax.device_get(step(r_d, q_d))
        dt = (time.time() - t0) / args.reps
    gcups = B * T * T / dt / 1e9
    print(f"kernel: B={B} T={T} {dt * 1e3:.2f} ms/step "
          f"{gcups:.2f} GCUPS")


def profile_pipeline(args) -> None:
    from darwin_tpu.config import Params
    from darwin_tpu.io.fasta import parse_fasta
    from darwin_tpu.pipeline import run_pipeline

    params = (Params.from_cfg(args.params)
              if args.params and Path(args.params).exists() else Params())
    ref = parse_fasta(args.reference)
    reads = ref if args.reference == args.reads else parse_fasta(args.reads)
    same = args.reference == args.reads

    import jax
    engine = "device" if jax.default_backend() == "gpu" else "host"
    run_pipeline(ref, reads, params, same_file=same, engine=engine,
                 batch_size=args.batch_size)  # warm/compile
    best, best_m, best_res = None, None, None
    with maybe_trace(args.trace_dir):
        for _ in range(max(1, args.reps)):
            m: dict = {}
            t0 = time.time()
            res = run_pipeline(ref, reads, params, same_file=same,
                               engine=engine, batch_size=args.batch_size,
                               metrics=m)
            dt = time.time() - t0
            if best is None or dt < best:
                best, best_m, best_res = dt, m, res
    dt, m, res = best, best_m, best_res
    # DP cells actually computable from candidates is workload-shaped;
    # report throughput in the reference's own unit (reads/s).
    print(f"pipeline: {len(reads)} reads in {dt:.2f} s "
          f"({len(reads) / dt:.1f} reads/s), "
          f"{len(res.records)} records, "
          f"{res.num_candidates_for + res.num_candidates_rev} candidates")
    accounted = sum(m.values())
    split = "  ".join(f"{k[:-2]} {v:.3f}" for k, v in m.items())
    print(f"phases (best-of-{args.reps}, s): {split}  "
          f"other {dt - accounted:.3f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernel")
    k.add_argument("B", type=int, nargs="?", default=2048)
    k.add_argument("T", type=int, nargs="?", default=320)
    k.add_argument("--reps", type=int, default=3)
    k.add_argument("--trace-dir", default=None)
    e = sub.add_parser("pipeline")
    e.add_argument("reference")
    e.add_argument("reads")
    e.add_argument("--params", default="params.cfg")
    e.add_argument("--batch-size", type=int, default=512)
    e.add_argument("--reps", type=int, default=3)
    e.add_argument("--trace-dir", default=None)
    args = p.parse_args(argv)
    if args.mode == "kernel":
        profile_kernel(args)
    else:
        profile_pipeline(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
