#!/usr/bin/env python3
"""Chip check: run the D-SOFT + GACT main path on one GPU and verify it.

    python chip_smoke.py            # one GPU: phases 0-3
    python chip_smoke.py --multi    # four GPUs: the sharded path only

Phases, all in this one process (a second JAX process could not get
the card's memory):

0. device: the JAX device, JAX's version, the card's name and power
   limit from nvidia-smi, and whether the native host library built
   (without it D-SOFT falls back to NumPy, ~200x slower; only
   DARWIN_TPU_NATIVE=0 may ask for that).
1. kernel: the CUDA tile-DP kernel against align_tiles_jax run on the
   CPU, at B=2048 and T=320, 376, 64, under the default scoring and two
   others; packed6 words and all four stats must be equal (integer DP,
   so the tolerance is zero).  Prints the kernel's time beside the time
   of the plain version (align_tiles_jax + pack_dir_words6) that XLA
   compiles for the card.  Then runs the gpu-marked tests in this
   process; each must pass.
2. fixtures: every tests/data family through run_pipeline(engine=
   "device") must reproduce the reference binary's out.darwin exactly;
   one family also runs through the CLI with the on-device D-SOFT.
3. scale: a seeded E.coli-sized de novo case (4.6 Mb genome, 10x
   coverage of 10 kb reads with PBSIM-like error, reads = reference)
   through cli.main with the device engine.  Prints the phase timers
   and reads/s; the records of a seeded sample of reads must equal the
   same pipeline's on the CPU with the lax backend.

--multi runs only the four-card path: the mesh-sharded GACT engine and
the hash-sharded seed table with its all_to_all hit exchange, at the
scale dataset, compared with the one-card engine's records and the
host D-SOFT candidates.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or without the repository beside this script, the
script prints {"ok": false, ...} and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 7  # of the scale-case data
SCORINGS = ((1, -1, -1, -1), (2, -3, -4, -2), (5, -4, -8, -6))


def log(msg: str) -> None:
    print(msg, flush=True)


def finish(ok: bool, device: dict | None, error: str | None = None):
    out = {"ok": ok, "device": device}
    if error:
        out["error"] = error
    print(json.dumps(out), flush=True)
    sys.exit(0 if ok else 1)


def timed_ms(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def phase_device(dev) -> None:
    import jax

    log(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}"
        f", jax {jax.__version__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        log(f"[device] nvidia-smi: {line.strip()}")
    from darwin_tpu import native

    log(f"[device] native host library: {native.available()}")
    if not native.available() and os.environ.get(
            "DARWIN_TPU_NATIVE", "1") not in ("0", "off"):
        raise RuntimeError("the native host library did not build or load "
                           "(see its build error above)")


def related_tiles(rng, B: int, T: int, divergence: float = 0.12):
    """Tile pairs: query = ref mutated at `divergence` (substitutions
    and indels), both cut to random lengths in [T/2, T] (1% empty)."""
    import numpy as np

    from darwin_tpu.eval.datagen import mutate
    from darwin_tpu.ops.common import PAD_QUERY, PAD_REF

    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = np.full((B, T), PAD_REF, np.uint8)
    query = np.full((B, T), PAD_QUERY, np.uint8)
    rlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    qlen = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    empty = rng.random(B) < 0.01
    rlen[empty] = 0
    for b in range(B):
        src = alpha[rng.integers(0, 4, size=T)]
        q = mutate(src, divergence, rng)[:T]
        qlen[b] = min(qlen[b], len(q))
        ref[b, :rlen[b]] = src[:rlen[b]]
        query[b, :qlen[b]] = q[:qlen[b]]
    return ref, query, rlen, qlen


def phase_kernel() -> None:
    import jax
    import numpy as np

    from darwin_tpu.ops import cuda_dp
    from darwin_tpu.ops.reference_dp import align_tiles_jax
    from darwin_tpu.ops.traceback import pack_dir_words6

    t0 = time.perf_counter()
    cuda_dp.load()
    log(f"[kernel] built and loaded {cuda_dp.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    cpu = jax.devices("cpu")[0]
    keys = ("max_score", "max_i", "max_j", "pos_score")

    def plain(ref, query, rlen, qlen, **kw):
        out = align_tiles_jax(ref, query, rlen, qlen, **kw)
        return pack_dir_words6(out["dir"]), [out[k] for k in keys]

    B = 2048
    cases = [(320, sc) for sc in SCORINGS] + [(376, SCORINGS[0]),
                                              (64, SCORINGS[0])]
    for T, sc in cases:
        rng = np.random.default_rng(T * 1000 + sum(map(abs, sc)))
        ref, query, rlen, qlen = related_tiles(rng, B, T)
        kw = dict(match=sc[0], mismatch=sc[1], gap_open=sc[2],
                  gap_extend=sc[3])
        got = jax.device_get(cuda_dp.align_tiles_cuda(
            ref, query, rlen, qlen, **kw))
        with jax.default_device(cpu):
            want_w, want_s = jax.device_get(plain(ref, query, rlen, qlen,
                                                  **kw))
        if not np.array_equal(got["dir_words"], want_w):
            bad = np.argwhere(got["dir_words"] != want_w)
            raise AssertionError(
                f"packed6 words differ at T={T} scoring={sc}: "
                f"{len(bad)} cells, first {bad[:3].tolist()}")
        for k, w in zip(keys, want_s):
            if not np.array_equal(got[k], w):
                raise AssertionError(f"{k} differs at T={T} scoring={sc}")
        log(f"[kernel] parity EXACT vs CPU align_tiles_jax: B={B} T={T} "
            f"scoring={sc} (words {got['dir_words'].shape})")

    plain_j = jax.jit(plain, static_argnames=(
        "match", "mismatch", "gap_open", "gap_extend"))
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    for Bt in (512, 2048):
        rng = np.random.default_rng(Bt)
        args = [jax.device_put(a) for a in related_tiles(rng, Bt, 320)]
        xla_ms = timed_ms(lambda *a: plain_j(*a, **kw), *args)
        k_ms = timed_ms(lambda *a: cuda_dp.align_tiles_cuda(*a, **kw),
                        *args)
        log(f"[kernel] B={Bt} T=320: CUDA kernel {k_ms:.3f} ms, XLA "
            f"align_tiles_jax + pack_dir_words6 {xla_ms:.3f} ms")
    run_gpu_tests()


def run_gpu_tests() -> None:
    """The gpu-marked tests, in this process (it holds the card)."""
    import pytest

    class Outcomes:
        def __init__(self):
            self.seen: dict[str, list[str]] = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.seen.setdefault(report.outcome, []).append(
                    report.nodeid)

    os.environ["DARWIN_TPU_TEST_PLATFORM"] = "gpu"
    out = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(HERE / "tests")], plugins=[out])
    passed = out.seen.pop("passed", [])
    if rc != 0 or not passed or out.seen:
        raise AssertionError(f"gpu-marked tests: pytest rc {rc}, "
                             f"{len(passed)} passed, others {out.seen}")
    log(f"[kernel] gpu-marked tests: {len(passed)} passed ({passed})")


def fixture_inputs(d: Path):
    from darwin_tpu.config import Params
    from darwin_tpu.io.fasta import parse_fasta

    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta")
    if (d / "ref.fasta").exists():
        return params, parse_fasta(d / "ref.fasta"), reads, False
    return params, reads, reads, True


def phase_fixtures() -> None:
    from darwin_tpu import cli
    from darwin_tpu.pipeline import run_pipeline

    data = HERE / "tests" / "data"
    families = sorted(p for p in data.iterdir() if p.is_dir())
    for d in families:
        params, ref, reads, same = fixture_inputs(d)
        t0 = time.perf_counter()
        res = run_pipeline(ref, reads, params, same_file=same,
                           batch_size=128, engine="device")
        want = set((d / "out.darwin").read_text().splitlines())
        got = set(res.records)
        if got != want:
            raise AssertionError(
                f"fixture {d.name}: missing {sorted(want - got)[:3]} "
                f"extra {sorted(got - want)[:3]}")
        log(f"[fixtures] {d.name}: EXACT {len(got)} records vs out.darwin "
            f"(T={params.tile_size}, {time.perf_counter() - t0:.1f} s)")
    d = data / "small"
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "merged.out"
        cli.main([str(d / "reads.fasta"), str(d / "reads.fasta"),
                  "--params", str(d / "params.cfg"), "--engine", "device",
                  "--dsoft", "device", "--out-dir", tmp,
                  "--merged-out", str(out)])
        got = out.read_text().splitlines()
    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    if got != want:
        raise AssertionError("fixture small with --dsoft device differs")
    log(f"[fixtures] small via CLI --dsoft device: EXACT {len(got)} records")


def make_scale_data(tmp: Path, n_reads: int, seed: int) -> Path:
    import numpy as np

    from darwin_tpu.eval.datagen import sample_reads, synth_genome
    from darwin_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(seed)
    genome = synth_genome(4_600_000, rng)
    reads = sample_reads(genome, n_reads, 10_000, rng, error_rate=0.12,
                         rc_fraction=0.5)
    path = tmp / "reads.fasta"
    write_fasta(path, reads)
    return path


def query_name(line: str) -> str:
    return line.split("query_id: ", 1)[1].split(",", 1)[0]


def phase_scale(n_reads: int, sample: int = 64) -> None:
    import jax
    import numpy as np

    from darwin_tpu import cli
    from darwin_tpu.coding import seq_to_bytes
    from darwin_tpu.config import Params
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.golden.gact import format_record
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import parse_fasta, revcomp
    from darwin_tpu.pipeline import run_device_merged

    if n_reads != 4600:
        log(f"[scale] CUT: {n_reads} reads instead of 4600 (10x)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        fasta = make_scale_data(tmp, n_reads, SEED)
        log(f"[scale] data: {n_reads} x 10 kb reads, 12% error, 50% "
            f"reverse-complement, 4.6 Mb genome, seed {SEED} "
            f"({time.perf_counter() - t0:.1f} s)")
        merged = tmp / "merged.out"
        for run in ("cold", "warm"):
            mj = tmp / f"metrics_{run}.json"
            t0 = time.perf_counter()
            cli.main([str(fasta), str(fasta), "1",
                      "--params", str(tmp / "absent.cfg"),
                      "--engine", "device", "--out-dir", str(tmp),
                      "--merged-out", str(merged),
                      "--metrics-json", str(mj)])
            wall = time.perf_counter() - t0
            m = json.loads(mj.read_text())
            log(f"[scale] {run}: wall {wall:.2f} s, "
                f"{n_reads / wall:.1f} reads/s end to end; "
                f"seed {m['seed_ms']:.0f} ms, align {m['gact_ms']:.0f} ms,"
                f" table {m['seed_table_ms']:.0f} ms, ref load "
                f"{m['ref_load_ms']:.0f} ms, {m['num_candidates']} "
                f"candidates, {m['num_records']} records, "
                f"{m['reads_per_s']:.1f} reads/s (seed+align)")
        lines = merged.read_text().splitlines()

        # Sample parity: the same pipeline for a seeded read sample on
        # the CPU with the lax backend.
        recs = parse_fasta(fasta)
        params = Params()
        rng = np.random.default_rng(SEED + 1)
        ids = np.sort(rng.choice(len(recs), size=sample, replace=False))
        names = {recs[i].name for i in ids}
        want = sorted(x for x in lines if query_name(x) in names)
        t0 = time.perf_counter()
        genome = Genome(recs, params.bin_size)
        table = SeedTable.build(genome.concat, params.seed_size,
                                params.seed_occurence_multiple,
                                params.bin_size, params.window_size)
        fwd = SeqBank([seq_to_bytes(r.seq) for r in recs])
        rev = SeqBank([seq_to_bytes(revcomp(r.seq)) for r in recs])
        with jax.default_device(jax.devices("cpu")[0]):
            got_recs, _ = run_device_merged(
                genome, table, fwd, rev, params, same_file=True,
                batch_size=128, backend="lax", read_ids=ids)
        got = sorted(set(
            format_record(genome.names[r.ref_id],
                          recs[r.query_id].name, r.ab, r.ae, r.bb, r.be,
                          r.score, r.comp) for r in got_recs))
        if got != want:
            raise AssertionError(
                f"sample parity: GPU {len(want)} vs CPU {len(got)} "
                f"records; first diff "
                f"{sorted(set(want) ^ set(got))[:2]}")
        log(f"[scale] sample parity EXACT: {sample} reads, {len(got)} "
            f"records, GPU cuda vs CPU lax "
            f"({time.perf_counter() - t0:.1f} s)")


def phase_multi(n_reads: int) -> None:
    import dataclasses

    import jax
    import numpy as np

    from darwin_tpu.coding import seq_to_bytes
    from darwin_tpu.config import Params
    from darwin_tpu.engine.batch import GactCalls
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import parse_fasta, revcomp
    from darwin_tpu.parallel.mesh import make_mesh
    from darwin_tpu.pipeline import (collect_calls,
                                     collect_calls_table_sharded,
                                     make_merged_engine)

    nd = 4
    if len(jax.devices()) < nd:
        raise RuntimeError(f"--multi needs {nd} GPUs, found "
                           f"{len(jax.devices())}")
    mesh = make_mesh(nd)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = make_scale_data(Path(tmp), n_reads, SEED)
        recs = parse_fasta(fasta)
    params = Params()
    genome = Genome(recs, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    fwd = SeqBank([seq_to_bytes(r.seq) for r in recs])
    rev = SeqBank([seq_to_bytes(revcomp(r.seq)) for r in recs])
    merged = SeqBank.concat(fwd, rev)
    log(f"[multi] mesh {mesh.devices.tolist()}; {n_reads} reads x 2 "
        f"strands")

    def as_set(c: GactCalls):
        return set(zip(c.ref_id.tolist(), c.query_id.tolist(),
                       c.ref_pos.tolist(), c.query_pos.tolist()))

    t0 = time.perf_counter()
    host = collect_calls(table, genome, merged, params)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard = collect_calls_table_sharded(table, genome, merged, params, mesh)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard = collect_calls_table_sharded(table, genome, merged, params, mesh)
    t_warm = time.perf_counter() - t0
    if as_set(host) != as_set(shard):
        raise AssertionError(
            f"sharded D-SOFT candidates differ: host {len(host)} vs "
            f"sharded {len(shard)}")
    log(f"[multi] sharded-table D-SOFT (all_to_all) candidates EXACT vs "
        f"host: {len(host)} (host {t_host:.2f} s, sharded cold "
        f"{t_cold:.2f} s, warm {t_warm:.2f} s)")

    comp = (host.query_id >= n_reads).astype(np.int32)
    calls = GactCalls(host.ref_id, host.query_id % n_reads, host.ref_pos,
                      host.query_pos)
    eng, _, _ = make_merged_engine(genome, fwd, rev, params,
                                   same_file=True, batch_size=512,
                                   mesh=mesh)
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        handle = eng.run_async(calls, comp, host.query_id)
        (rec_d, nrec_d), _ = handle
        sharded = eng.finish(handle)
        t_sh = time.perf_counter() - t0
    devs = {s.device for s in rec_d.addressable_shards}
    per_dev = np.asarray(jax.device_get(nrec_d)).reshape(-1)
    if len(devs) != nd or not (per_dev > 0).all():
        raise AssertionError(f"work did not land on {nd} cards: shards on "
                             f"{sorted(map(str, devs))}, records {per_dev}")
    one, _, _ = make_merged_engine(genome, fwd, rev, params,
                                   same_file=True, batch_size=512)
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        single = one.finish(one.run_async(calls, comp, host.query_id))
        t_one = time.perf_counter() - t0
    key = dataclasses.astuple
    if sorted(map(key, sharded)) != sorted(map(key, single)):
        raise AssertionError(f"sharded engine records differ: "
                             f"{len(sharded)} vs {len(single)}")
    log(f"[multi] sharded engine records EXACT vs one-card engine: "
        f"{len(sharded)} records, per-card {per_dev.tolist()}, "
        f"{len(calls)} calls; warm {t_sh:.2f} s on {nd} cards vs "
        f"{t_one:.2f} s on one")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: sharded engine + sharded seed table")
    ap.add_argument("--reads", type=int, default=4600,
                    help="scale-case read count (4600 = 10x E.coli; "
                         "fewer is a cut, and is printed as one)")
    args = ap.parse_args()

    import jax

    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        finish(False, None, f"no JAX device: {e}")
    if dev.platform != "gpu":
        finish(False, None, f"no GPU: JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    sys.path.insert(0, str(HERE))
    try:
        import darwin_tpu  # noqa: F401
    except ImportError as e:
        finish(False, device, f"repository not found beside the script: "
                              f"{e}")
    from darwin_tpu.utils import configure_compile_cache

    configure_compile_cache()
    try:
        phase_device(dev)
        if args.multi:
            phase_multi(args.reads)
        else:
            phase_kernel()
            phase_fixtures()
            phase_scale(args.reads)
    except Exception as e:  # noqa: BLE001 - reported, then exit 1
        traceback.print_exc()
        finish(False, device, f"{type(e).__name__}: {e}")
    finish(True, device)


if __name__ == "__main__":
    main()
