"""Tile-DP kernel on the GPU: alone and end to end, CUDA vs plain XLA.

Usage (on a machine with a GPU):
    python tools/kernel_bench.py [--reads 4600]
    python tools/kernel_bench.py --trace-dir DIR [--command-buffers off]

1. Alone: the CUDA kernel against align_tiles_jax + pack_dir_words6 as
   XLA compiles them for the card, at B=512 and B=2048, T=320.
2. End to end: run_pipeline with the device engine on chip_smoke.py's
   seeded E.coli 10x de novo case (4.6 Mb genome, 4600 x 10 kb reads,
   12% error), backend "cuda" and "lax" in turns (cuda, lax, lax, cuda)
   after a warm run of each; records must be equal.
3. With --trace-dir, instead of 1 and 2: one profiled warm run of the
   cuda engine.  Prints the device's busy time (the union of its kernel
   and copy intervals), the span from the first to the last device
   event, the idle share of that span, and device time per named scope
   of the engine loop (tile_fetch, tile_dp, traceback; the rest is slot
   bookkeeping and rescoring).  With XLA's command buffers on (its
   default) most kernels of the loop are replayed as CUDA graphs whose
   events carry no op names, so only the totals mean anything;
   --command-buffers off keeps each kernel's name and scope.  XLA fuses
   the fetch's gathers into kernels named for other ops, so the tool
   reads XLA's optimized HLO (dumped into DIR/hlo), finds the fusions
   that hold a gather from the tile_fetch scope, and adds up their
   device time in the trace.

--reads below 4600 is a cut of the case and is printed as one.  Prints
the card's name and power limit first; refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SCOPES = ("tile_fetch", "tile_dp", "traceback")
# Lines the profiler derives from the stream lines; counting them would
# count every kernel twice.
DERIVED_LINES = ("XLA Ops", "XLA Modules", "Steps", "Framework Ops",
                 "Framework Name Scope", "Source code")


def timed_ms(fn, *args, reps: int = 20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def bench_alone() -> None:
    import jax
    import numpy as np

    from chip_smoke import related_tiles
    from darwin_tpu.ops.cuda_dp import align_tiles_cuda
    from darwin_tpu.ops.reference_dp import align_tiles_jax
    from darwin_tpu.ops.traceback import pack_dir_words6

    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)

    @jax.jit
    def plain(ref, query, rlen, qlen):
        out = align_tiles_jax(ref, query, rlen, qlen, **kw)
        return pack_dir_words6(out["dir"]), out["max_score"]

    for B in (512, 2048):
        args = [jax.device_put(a) for a in
                related_tiles(np.random.default_rng(B), B, 320)]
        k = timed_ms(lambda *a: align_tiles_cuda(*a, **kw), *args)
        x = timed_ms(plain, *args)
        cells = B * 320 * 321
        print(f"alone B={B} T=320: cuda {k:.3f} ms "
              f"({cells / k / 1e6:.1f} GCUPS), XLA plain {x:.3f} ms "
              f"({cells / x / 1e6:.1f} GCUPS), ratio {x / k:.1f}x",
              flush=True)


def fetch_fusions(hlo_dir: Path) -> dict[str, str]:
    """{instruction name: module name} of the kernels that hold a gather
    from the tile_fetch scope, read from XLA's optimized-HLO dump.  A
    gather fused into a fusion counts as that fusion."""
    found: dict[str, str] = {}
    head = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
    inst = re.compile(r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
    calls = re.compile(r"calls=%?([\w.\-]+)")
    for path in sorted(hlo_dir.glob("*after_optimizations.txt")):
        module = re.match(r"module_\d+\.(.*?)\.(?:sm_|cpu_)",
                          path.name).group(1)
        comp = ""
        gathers: dict[str, list[str]] = defaultdict(list)
        fusions: list[tuple[str, str, str]] = []  # (comp, name, callee)
        for line in path.read_text().splitlines():
            if m := head.match(line):
                comp = m.group(1)
            elif m := inst.match(line):
                name, rhs = m.groups()
                if " gather(" in rhs and "tile_fetch" in rhs:
                    gathers[comp].append(name)
                if " fusion(" in rhs and (c := calls.search(rhs)):
                    fusions.append((comp, name, c.group(1)))
        holding = set(gathers)
        fused = {callee for _, _, callee in fusions}
        changed = True
        while changed:  # nested fusions: the outermost one is the kernel
            changed = False
            for comp, name, callee in fusions:
                if callee in holding and comp in fused \
                        and comp not in holding:
                    holding.add(comp)
                    changed = True
        for comp, name, callee in fusions:
            if callee in holding and comp not in fused:
                found[name] = module
        for comp, names in gathers.items():
            if comp not in fused:  # an unfused gather is its own kernel
                found.update(dict.fromkeys(names, module))
    return found


def read_trace(trace_dir: Path, fetch_ops: dict[str, str]) -> float:
    """Device busy time, idle share and per-scope times from the newest
    .xplane.pb under trace_dir; returns the busy time in ms."""
    import jax
    import numpy as np

    path = max(trace_dir.rglob("*.xplane.pb"),
               key=lambda p: p.stat().st_mtime)
    pd = jax.profiler.ProfileData.from_file(str(path))
    fetch_keys = {n.replace(".", "_"): m for n, m in fetch_ops.items()}
    fetch_keys.update(fetch_ops)
    per_scope: dict[str, float] = defaultdict(float)
    per_name: dict[str, float] = defaultdict(float)
    fetch_ns = 0.0
    fetch_names: set[str] = set()
    starts, ends = [], []
    sample = None
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name in DERIVED_LINES:
                continue
            n0, d0 = len(starts), sum(per_scope.values())
            for ev in line.events:
                dur = ev.duration_ns
                starts.append(ev.start_ns)
                ends.append(ev.start_ns + dur)
                stats = {k: str(v) for k, v in ev.stats}
                if sample is None and "hlo_op" in stats:
                    sample = (ev.name, stats)
                text = " ".join((ev.name, *stats.values()))
                scope = next((s for s in SCOPES if s in text), "other")
                per_scope[scope] += dur
                per_name[f"{scope}: {ev.name}"] += dur
                op = stats.get("hlo_op", ev.name)
                mod = fetch_keys.get(op, fetch_keys.get(ev.name))
                if mod is not None and mod in stats.get("hlo_module",
                                                        mod):
                    fetch_ns += dur
                    fetch_names.add(op)
            print(f"  line {line.name}: {len(starts) - n0} events, "
                  f"{(sum(per_scope.values()) - d0) / 1e6:.1f} ms")
    total = sum(per_scope.values())
    s = np.asarray(starts, np.int64)
    e = np.asarray(ends, np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    # Busy time is the union of the intervals: a new busy stretch starts
    # wherever an event begins after every earlier one has ended.
    gap = np.r_[True, s[1:] > e[:-1]]
    first = np.flatnonzero(gap)
    last = np.r_[first[1:] - 1, len(s) - 1]
    busy = float((e[last] - s[first]).sum())
    span = float(e[-1] - s[0])
    print(f"trace {path.name}: {len(s)} device events, {total / 1e6:.1f} ms"
          f" summed, busy {busy / 1e6:.1f} ms (union) of a "
          f"{span / 1e6:.1f} ms span from first to last device event: "
          f"idle share {100 * (1 - busy / span):.1f}%")
    if sample:
        print(f"  sample kernel event {sample[0][:60]}: "
              f"{ {k: v[:80] for k, v in sample[1].items()} }")
    for sc in SCOPES + ("other",):
        print(f"  scope {sc}: {per_scope[sc] / 1e6:.1f} ms "
              f"({100 * per_scope[sc] / max(total, 1):.1f}%)")
    print(f"  fusions holding the fetch's gathers "
          f"({len(fetch_ops)} in the HLO: {sorted(fetch_ops)[:6]}; "
          f"seen in the trace: {sorted(fetch_names)[:6]}): "
          f"{fetch_ns / 1e6:.1f} ms ({100 * fetch_ns / max(total, 1):.1f}%)")
    for name, dur in sorted(per_name.items(), key=lambda x: -x[1])[:15]:
        print(f"  event {name[:70]}: {dur / 1e6:.1f} ms")
    return busy / 1e6


def bench_e2e(n_reads: int, trace_dir: Path | None) -> None:
    import tempfile

    import jax

    from chip_smoke import SEED, make_scale_data
    from darwin_tpu.config import Params
    from darwin_tpu.io.fasta import parse_fasta
    from darwin_tpu.pipeline import run_pipeline

    if n_reads != 4600:
        print(f"CUT: {n_reads} reads instead of 4600 (10x)")
    with tempfile.TemporaryDirectory() as tmp:
        recs = parse_fasta(make_scale_data(Path(tmp), n_reads, SEED))
    params = Params()

    def run(backend: str):
        m: dict = {}
        t0 = time.perf_counter()
        res = run_pipeline(recs, recs, params, same_file=True,
                           batch_size=512, engine="device",
                           backend=backend, metrics=m)
        return time.perf_counter() - t0, m, set(res.records)

    def report(tag: str, wall: float, m: dict, n: int) -> None:
        print(f"e2e {n_reads} reads, {tag}: wall {wall:.2f} s, align "
              f"{m['align_s']:.3f} s, seed {m['seed_s']:.3f} s, "
              f"{m['engine_iters']} engine iterations, {n} records",
              flush=True)

    if trace_dir:
        report("cuda (warm-up)", *run("cuda")[:2], 0)
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 0
        opts.advanced_configuration = {
            "gpu_max_activity_api_events": 1 << 25,
            "gpu_max_callback_api_events": 1 << 25}
        with jax.profiler.trace(str(trace_dir), profiler_options=opts):
            wall, m, res = run("cuda")
        report("cuda, traced", wall, m, len(res))
        read_trace(trace_dir, fetch_fusions(trace_dir / "hlo"))
        return
    results = {b: run(b)[2] for b in ("cuda", "lax")}  # compile + warm
    if results["cuda"] != results["lax"]:
        raise AssertionError("cuda and lax engines disagree")
    for backend in ("cuda", "lax", "lax", "cuda"):
        wall, m, _ = run(backend)
        report(f"backend {backend}", wall, m, len(results[backend]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=4600)
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="profile one warm cuda run into this directory")
    ap.add_argument("--command-buffers", choices=("on", "off"),
                    default="on", help="XLA's CUDA-graph command buffers")
    args = ap.parse_args()

    flags = [os.environ.get("XLA_FLAGS", "")]
    if args.command_buffers == "off":
        flags.append("--xla_gpu_enable_command_buffer=")
    if args.trace_dir:
        flags.append(f"--xla_dump_to={args.trace_dir / 'hlo'} "
                     f"--xla_dump_hlo_as_text")
    os.environ["XLA_FLAGS"] = " ".join(f for f in flags if f)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("kernel_bench needs a GPU", file=sys.stderr)
        return 1
    if args.trace_dir:  # a cached executable would skip the HLO dump
        jax.config.update("jax_enable_compilation_cache", False)
    else:
        from darwin_tpu.utils import configure_compile_cache

        configure_compile_cache()
    from darwin_tpu.ops import cuda_dp

    cuda_dp.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}; command buffers "
          f"{args.command_buffers}", flush=True)
    if not args.trace_dir:
        bench_alone()
    bench_e2e(args.reads, args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
