"""Generate test fixtures and golden outputs from the reference binary.

Usage:
    python tests/make_fixtures.py [--darwin /path/to/reference/darwin]

Writes FASTA inputs plus (if the reference binary is available) its
merged, sorted, uniq'd overlap output (`out.darwin` convention,
reference README:25) under tests/data/<name>/.

The reference binary is the CPU build of Tongdongq/darwin-gpu; see
SURVEY.md §7 for the g++-only build recipe.  Fixtures are checked in so
the test suite never needs the binary.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from darwin_tpu.eval.datagen import sample_reads, synth_genome  # noqa: E402
from darwin_tpu.io.fasta import write_fasta  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"

# name -> (genome_len, num_reads, read_len, error_rate, rc_fraction,
#          params overrides)
FIXTURES = {
    # Tiny, perfect reads, small tiles: golden scalar pipeline tractable.
    "tiny": (8_000, 8, 1_200, 0.0, 0.0,
             {"tile_size": 64, "tile_overlap": 24}),
    # Mid-size, perfect reads, default params: main differential fixture.
    "small": (200_000, 40, 10_000, 0.0, 0.0, {}),
    # Noisy reads incl. reverse-complemented ones, default params.
    "noisy": (150_000, 30, 8_000, 0.10, 0.4, {}),
    # Noisy reads with N runs / scattered N no-calls in half the reads
    # (N packs to 0='A' in seeding but stays N in DP char compares,
    # ntcoding.cpp:56-69 vs align.cpp:134 — a dedicated parity hazard).
    "nbase": (150_000, 24, 6_000, 0.08, 0.4, {"inject_n": True}),
    # A non-default tile geometry (tile_size=376): parity at a tile
    # size other than the reference default.  Oracle comes from the
    # reference binary running the same tile_size (an ordinary
    # params.cfg knob, reference darwin.cpp:491).
    "tpucfg": (150_000, 24, 8_000, 0.10, 0.4, {"tile_size": 376}),
}

PARAMS_TEMPLATE = """\
[GACT_scoring]
match = 1
mismatch = -1
gap_open = -1
gap_extend = -1

[DSOFT_params]
seed_size  = 14
bin_size   = 64
window_size= 4
threshold  = 21
num_seeds  = 800
seed_occurence_multiple = 32
max_candidates = 1000000
num_nz_bins    = 2500000

[GACT_first_tile]
first_tile_size = 128
first_tile_score_threshold = 35

[GACT_extend]
tile_size = {tile_size}
tile_overlap = {tile_overlap}
"""


def gen_fixture(name: str, darwin: str | None) -> None:
    glen, nreads, rlen, err, rcf, overrides = FIXTURES[name]
    d = DATA / name
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)
    genome = synth_genome(glen, rng)
    reads = sample_reads(genome, nreads, rlen, rng, error_rate=err,
                         rc_fraction=rcf)
    if overrides.get("inject_n"):
        injected = []
        for i, (rname, seq) in enumerate(reads):
            s = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
            if i % 2 == 0:
                p = int(rng.integers(100, len(s) - 200))
                s[p:p + int(rng.integers(5, 60))] = ord("N")
                s[rng.integers(0, len(s), size=30)] = ord("N")
            injected.append((rname, s.tobytes().decode()))
        reads = injected
    write_fasta(d / "reads.fasta", reads)
    params = PARAMS_TEMPLATE.format(
        tile_size=overrides.get("tile_size", 320),
        tile_overlap=overrides.get("tile_overlap", 120))
    (d / "params.cfg").write_text(params)

    if darwin:
        with tempfile.TemporaryDirectory() as td:
            tdp = Path(td)
            shutil.copy(d / "reads.fasta", tdp / "reads.fasta")
            (tdp / "params.cfg").write_text(params)
            shutil.copy(darwin, tdp / "darwin")
            subprocess.run(["./darwin", "reads.fasta", "reads.fasta", "2"],
                           cwd=td, check=True, capture_output=True)
            lines: set[str] = set()
            for f in tdp.glob("darwin.*.out"):
                lines.update(f.read_text().splitlines())
            (d / "out.darwin").write_text(
                "\n".join(sorted(lines)) + ("\n" if lines else ""))
            print(f"{name}: {len(lines)} golden records")
    else:
        print(f"{name}: inputs written (no reference binary given)")


def gen_twofile(darwin: str | None) -> None:
    """Two-file de-novo fixture (ref != reads, same_file=False, at a
    scale beyond the small 'guided' fixture): two independent noisy
    read sets from one genome (generateperfect.py:75-106 mode), run as
    `darwin set1.fasta set2.fasta`."""
    from darwin_tpu.eval.datagen import two_readsets

    d = DATA / "twofile"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(77)
    genome = synth_genome(150_000, rng)
    set1, set2 = two_readsets(genome, 20, 8_000, rng, error_rate=0.08,
                              rc_fraction=0.4)
    write_fasta(d / "ref.fasta", set1)
    write_fasta(d / "reads.fasta", set2)
    params = PARAMS_TEMPLATE.format(tile_size=320, tile_overlap=120)
    (d / "params.cfg").write_text(params)
    if not darwin:
        print("twofile: inputs written (no reference binary given)")
        return
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        shutil.copy(d / "ref.fasta", tdp / "ref.fasta")
        shutil.copy(d / "reads.fasta", tdp / "reads.fasta")
        (tdp / "params.cfg").write_text(params)
        shutil.copy(darwin, tdp / "darwin")
        subprocess.run(["./darwin", "ref.fasta", "reads.fasta", "2"],
                       cwd=td, check=True, capture_output=True)
        lines: set[str] = set()
        for f in tdp.glob("darwin.*.out"):
            lines.update(f.read_text().splitlines())
        (d / "out.darwin").write_text(
            "\n".join(sorted(lines)) + ("\n" if lines else ""))
        print(f"twofile: {len(lines)} golden records")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--darwin", default=None,
                    help="path to reference CPU darwin binary")
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    for name in FIXTURES:
        if args.only and name != args.only:
            continue
        gen_fixture(name, args.darwin)
    if not args.only or args.only == "twofile":
        gen_twofile(args.darwin)


if __name__ == "__main__":
    main()
