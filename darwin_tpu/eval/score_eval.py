"""Score-accuracy evaluation: reported scores vs exact SW scores.

Python-3, self-contained re-design of the reference's hidden NPBSS
evaluator (.measure_sensitivity_NPBSS.py): for a two-file de-novo run
it (1) recomputes theoretical overlaps (> min_overlap bp) from the
origin coordinates in the read names, (2) computes the EXACT local
affine alignment score of every theoretically-overlapping read pair,
and (3) matches darwin's reported overlaps by (ref read, query read)
id pair and compares scores — counting exact / higher / lower (with
the reference's <50 / <200 / <20 difference buckets), plus FN
(theoretical pair never reported) and FP (reported pair with no
theoretical counterpart).

Where the reference shells out to an external `ksw` binary
(.measure_sensitivity_NPBSS.py:136-139), this uses the in-repo
score-only SW op (ops/swscore.py) — batched, exact, runs on CPU or
GPU, same affine gap convention as the pipeline.
"""

from __future__ import annotations

import dataclasses
import re


def _ints(line: str) -> list[int]:
    return [int(x) for x in re.findall(r"\d+", line)]


@dataclasses.dataclass
class ScoreEvalResult:
    n_theoretical: int
    n_matched: int
    same_score: int
    higher_score: int     # reported > exact (shouldn't happen for
    lower_score: int      # exact SW; reference tracked it anyway)
    c1: int               # higher, diff < 50   (reference counters)
    c2: int               # higher, diff < 200
    c3: int               # lower, diff < 20
    fn: int
    fp: int


def theoretical_pairs(names1: list[str], names2: list[str],
                      min_overlap: int = 1000
                      ) -> list[tuple[int, int]]:
    """(idx1, idx2) of reads whose genomic intervals overlap enough
    (.measure_sensitivity_NPBSS.py:57-88: a2<b1 / b2<a1 exclusion,
    ovl_length > min_overlap)."""
    info1 = [_ints(n) for n in names1]
    info2 = [_ints(n) for n in names2]
    out = []
    for i1, r1 in enumerate(info1):
        a1, a2 = r1[1], r1[1] + r1[2]
        for i2, r2 in enumerate(info2):
            b1, b2 = r2[1], r2[1] + r2[2]
            if a2 < b1 or b2 < a1:
                continue
            if min(a2, b2) - max(a1, b1) > min_overlap:
                out.append((i1, i2))
    return out


def exact_pair_scores(seq_pairs: list[tuple[str, str]], *,
                      match: int, mismatch: int, gap_open: int,
                      gap_extend: int, batch: int = 64) -> list[int]:
    """Exact local SW score for each (seq1, seq2) pair via the batched
    score-only op; full read lengths, no tiling approximation."""
    import numpy as np

    from darwin_tpu.ops.swscore import local_score_batch

    scores: list[int] = []
    for lo in range(0, len(seq_pairs), batch):
        chunk = seq_pairs[lo: lo + batch]
        l1 = max(len(s1) for s1, _ in chunk)
        l2 = max(len(s2) for _, s2 in chunk)
        a = np.zeros((len(chunk), l1), np.uint8)
        b = np.zeros((len(chunk), l2), np.uint8)
        al = np.zeros(len(chunk), np.int32)
        bl = np.zeros(len(chunk), np.int32)
        for r, (s1, s2) in enumerate(chunk):
            e1, e2 = s1.encode(), s2.encode()
            a[r, : len(e1)] = np.frombuffer(e1, np.uint8)
            b[r, : len(e2)] = np.frombuffer(e2, np.uint8)
            al[r], bl[r] = len(e1), len(e2)
        got = local_score_batch(a, b, al, bl, match=match,
                                mismatch=mismatch, gap_open=gap_open,
                                gap_extend=gap_extend)
        scores.extend(int(x) for x in np.asarray(got))
    return scores


def evaluate_scores(records: list[str], names1: list[str],
                    names2: list[str], seqs1: list[str],
                    seqs2: list[str], *, match: int = 1,
                    mismatch: int = -1, gap_open: int = -1,
                    gap_extend: int = -1, min_overlap: int = 1000
                    ) -> ScoreEvalResult:
    """Compare darwin record scores to exact pair scores.

    ``records`` are format_record lines from a ref=file1, reads=file2
    run; ids are recovered by integer-parsing like the reference
    (.measure_sensitivity_NPBSS.py:163-171: 14 integers per record).
    A comp=1 record aligned the read's reverse complement, so it is
    compared against the exact score of that strand (the reference
    evaluator ignored strand; its datasets were forward-only).
    """
    from darwin_tpu.io.fasta import revcomp

    hovls = []
    for line in records:
        l = _ints(line)
        # [ref_id, pos, len, read_id, pos, len, ab, ae, bb, be,
        #  score, comp]
        hovls.append(l + [0])

    pairs = theoretical_pairs(names1, names2, min_overlap)
    pair_set = set(pairs)
    keys = sorted(
        {(h[0], h[3], h[11]) for h in hovls
         if (h[0], h[3]) in pair_set} |
        {(i1, i2, 0) for (i1, i2) in pairs})
    seqs2_rc = {j: revcomp(seqs2[j]) for (_, j, c) in keys if c}
    exact = dict(zip(keys, exact_pair_scores(
        [(seqs1[i], seqs2_rc[j] if c else seqs2[j])
         for (i, j, c) in keys],
        match=match, mismatch=mismatch, gap_open=gap_open,
        gap_extend=gap_extend)))

    n = same = higher = lower = c1 = c2 = c3 = fn = 0
    for (i1, i2) in pairs:
        matched = False
        for h in hovls:
            if h[0] == i1 and h[3] == i2:
                matched = True
                h[12] = 1
                n += 1
                rs = h[10]
                ps = exact[(i1, i2, h[11])]
                if rs == ps:
                    same += 1
                elif rs > ps:
                    higher += 1
                    c1 += rs - ps < 50
                    c2 += rs - ps < 200
                else:
                    lower += 1
                    c3 += ps - rs < 20
        if not matched:
            fn += 1
    fp = sum(1 for h in hovls if h[12] == 0)
    return ScoreEvalResult(
        n_theoretical=len(pairs), n_matched=n, same_score=same,
        higher_score=higher, lower_score=lower, c1=c1, c2=c2, c3=c3,
        fn=fn, fp=fp)


def _main(argv=None) -> int:
    """python -m darwin_tpu.eval.score_eval OUT.darwin REF.fasta \\
           READS.fasta [--min-overlap 1000] [--params params.cfg]"""
    import argparse

    from darwin_tpu.config import Params
    from darwin_tpu.io.fasta import parse_fasta

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("overlaps")
    p.add_argument("reference")
    p.add_argument("reads")
    p.add_argument("--min-overlap", type=int, default=1000)
    p.add_argument("--params", default=None)
    args = p.parse_args(argv)

    prm = Params.from_cfg(args.params) if args.params else Params()
    r1 = parse_fasta(args.reference)
    r2 = parse_fasta(args.reads)
    records = [l for l in open(args.overlaps).read().splitlines() if l]
    res = evaluate_scores(
        records, [r.name for r in r1], [r.name for r in r2],
        [r.seq for r in r1], [r.seq for r in r2],
        match=prm.match, mismatch=prm.mismatch, gap_open=prm.gap_open,
        gap_extend=prm.gap_extend, min_overlap=args.min_overlap)
    print(f"num theoretical ovls: {res.n_theoretical}")
    print(f"n: {res.n_matched}")
    print(f"same score: {res.same_score}")
    print(f"higher score: {res.higher_score}")
    print(f"lower score: {res.lower_score}")
    print(f"c1: {res.c1}")
    print(f"c2: {res.c2}")
    print(f"c3: {res.c3}")
    print(f"FN: {res.fn}")
    print(f"FP: {res.fp}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
