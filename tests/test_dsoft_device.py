"""On-device D-SOFT parity vs the golden scalar spec, plus the
fixed-budget overflow semantics and the mesh-sharded path."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from darwin_tpu.dsoft.device import (dsoft_device_batch, pad_reads,
                                     sharded_dsoft_fn)
from darwin_tpu.engine.seqbank import SeqBank
from darwin_tpu.golden.dsoft import GoldenSeedTable, dsoft_scalar

ALPHA = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _fixture(seed, n_reads=10, ref_len=30000, err=0.12, n_frac=0.0):
    rng = np.random.default_rng(seed)
    p = [(1 - n_frac) / 4] * 4 + [n_frac]
    ref = rng.choice(ALPHA, size=ref_len, p=p).astype(np.uint8)
    gt = GoldenSeedTable(ref, 12, 32, 64, 4)
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, max(1, ref_len - 3000)))
        length = int(rng.integers(400, 2500))
        r = ref[s:s + length].copy()
        mut = rng.random(len(r)) < err
        r[mut] = rng.choice(ALPHA[:4], size=int(mut.sum()))
        reads.append(r)
    return gt, reads


def _run_device(gt, reads, threshold=18, cap_seeds=800, cap_cand=10**6,
                tup_max=8192, cand_max=256, fn=None):
    bank = SeqBank(reads)
    Q, lens = pad_reads(bank, range(len(reads)))
    call = fn or (lambda q, l, th, tp: dsoft_device_batch(
        q, l, th, tp, k=gt.k, w=gt.w, bin_size=gt.bin_size,
        kmer_max_occ=gt.kmer_max_occurence, num_seeds_cap=cap_seeds,
        threshold=threshold, max_candidates=cap_cand, tup_max=tup_max,
        cand_max=cand_max))
    return jax.device_get(call(Q, lens, gt.hashes, gt.pos_table))


def _check_parity(gt, reads, out, threshold=18, cap_seeds=800,
                  cap_cand=10**6):
    hits, offs, counts, over = out
    for i, r in enumerate(reads):
        assert not over[i], f"read {i} overflowed"
        gold = dsoft_scalar(gt, r, cap_seeds, threshold, cap_cand)
        got = list(zip(hits[i, :counts[i]].tolist(),
                       offs[i, :counts[i]].tolist()))
        assert got == gold, f"read {i}"
        # hits are uint32 (full 4.29 Gb position range); padding is
        # 0xFFFFFFFF, i.e. -1 in the int32 view.
        assert (hits[i, counts[i]:].astype(np.int32) == -1).all()


@pytest.mark.parametrize("seed,threshold", [(3, 18), (7, 12), (11, 21)])
def test_device_dsoft_matches_golden(seed, threshold):
    gt, reads = _fixture(seed)
    out = _run_device(gt, reads, threshold=threshold)
    _check_parity(gt, reads, out, threshold=threshold)


def test_device_dsoft_with_n_bases_and_num_seeds_cap():
    gt, reads = _fixture(19, n_frac=0.03)
    out = _run_device(gt, reads, threshold=15, cap_seeds=40)
    _check_parity(gt, reads, out, threshold=15, cap_seeds=40)


def test_device_dsoft_max_candidates_cap():
    gt, reads = _fixture(23)
    out = _run_device(gt, reads, threshold=12, cap_cand=2)
    _check_parity(gt, reads, out, threshold=12, cap_cand=2)
    assert (out[2] <= 2).all()


def test_device_dsoft_tuple_overflow_flagged():
    gt, reads = _fixture(5, n_reads=4)
    hits, offs, counts, over = _run_device(gt, reads, threshold=12,
                                           tup_max=8)
    # A tiny tuple budget must raise the overflow flag, not silently
    # return wrong results, for reads with more tuples than budget.
    bank = SeqBank(reads)
    Q, lens = pad_reads(bank, range(len(reads)))
    assert over.any()


def test_device_dsoft_cand_max_below_emissions_flagged():
    gt, reads = _fixture(29, err=0.02)  # low error -> many candidates?
    hits, offs, counts, over = _run_device(gt, reads, threshold=12,
                                           cand_max=1, cap_cand=10**6)
    for i, r in enumerate(reads):
        gold = dsoft_scalar(gt, r, 800, 12, 10**6)
        if len(gold) > 1:
            assert over[i]
        else:
            assert counts[i] == len(gold)


def test_device_dsoft_empty_and_short_reads():
    gt, _ = _fixture(31, n_reads=1)
    reads = [np.frombuffer(b"ACGT", dtype=np.uint8).copy(),
             np.frombuffer(b"A" * 40, dtype=np.uint8).copy()]
    out = _run_device(gt, reads)
    _check_parity(gt, reads, out)


def test_sharded_dsoft_matches_single_device():
    from darwin_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    gt, reads = _fixture(13, n_reads=16)
    mesh = make_mesh(8)
    fn = sharded_dsoft_fn(
        mesh, k=gt.k, w=gt.w, bin_size=gt.bin_size,
        kmer_max_occ=gt.kmer_max_occurence, num_seeds_cap=800,
        threshold=18, max_candidates=10**6, tup_max=4096, cand_max=128)
    bank = SeqBank(reads)
    Q, lens = pad_reads(bank, range(len(reads)))
    out = jax.device_get(fn(Q, lens, np.asarray(gt.hashes),
                            np.asarray(gt.pos_table)))
    _check_parity(gt, reads, out)


def test_collect_calls_device_matches_host():
    from darwin_tpu.config import Params
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import FastaRecord
    from darwin_tpu.pipeline import collect_calls, collect_calls_device

    rng = np.random.default_rng(41)
    ref = rng.choice(ALPHA[:4], size=30000).astype(np.uint8)
    params = Params(seed_size=12, threshold=15)
    genome = Genome([FastaRecord(["ref"], ref.tobytes().decode())],
                    params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    reads = []
    for _ in range(9):
        s = int(rng.integers(0, 27000))
        r = ref[s:s + int(rng.integers(500, 2000))].copy()
        mut = rng.random(len(r)) < 0.1
        r[mut] = rng.choice(ALPHA[:4], size=int(mut.sum()))
        reads.append(r)
    bank = SeqBank(reads)
    host = collect_calls(table, genome, bank, params)
    dev = collect_calls_device(table, genome, bank, params)
    np.testing.assert_array_equal(dev.ref_id, host.ref_id)
    np.testing.assert_array_equal(dev.query_id, host.query_id)
    np.testing.assert_array_equal(dev.ref_pos, host.ref_pos)
    np.testing.assert_array_equal(dev.query_pos, host.query_pos)
    # The production default is the wedge-free two-level index (the
    # dense 4^k CSR wedges this environment's remote compiler) — the
    # "auto" path above must have built and cached it on the table.
    from darwin_tpu.dsoft.device import default_index_mode
    assert default_index_mode(table.k) == "twolevel"
    assert getattr(table, "_twolevel", None) is not None


@pytest.mark.parametrize("seed", [3, 11])
def test_device_dsoft_dense_index_matches_golden(seed):
    """index='dense' (CSR gathers over the 4^k hash space) must be
    bit-identical to the searchsorted path and the golden spec."""
    gt, reads = _fixture(seed)
    out_ss = _run_device(gt, reads, fn=lambda q, l, th, tp:
                         dsoft_device_batch(
                             q, l, th, tp, k=gt.k, w=gt.w,
                             bin_size=gt.bin_size,
                             kmer_max_occ=gt.kmer_max_occurence,
                             num_seeds_cap=800, threshold=18,
                             max_candidates=10**6, tup_max=8192,
                             cand_max=256, index="searchsorted"))
    from darwin_tpu.dsoft.device import dense_hash_index
    csr = dense_hash_index(gt.hashes, gt.k)
    out_d = _run_device(gt, reads, fn=lambda q, l, th, tp:
                        dsoft_device_batch(
                            q, l, csr, tp, k=gt.k, w=gt.w,
                            bin_size=gt.bin_size,
                            kmer_max_occ=gt.kmer_max_occurence,
                            num_seeds_cap=800, threshold=18,
                            max_candidates=10**6, tup_max=8192,
                            cand_max=256, index="dense"))
    for a, b in zip(out_ss, out_d):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _check_parity(gt, reads, out_d)


@pytest.mark.parametrize("seed", [3, 11])
def test_device_dsoft_twolevel_index_matches_golden(seed):
    """index='twolevel' (distinct-hash probe, no 4^k array) must be
    bit-identical to the searchsorted path and the golden spec."""
    from darwin_tpu.dsoft.device import make_twolevel_index

    gt, reads = _fixture(seed)
    out_ss = _run_device(gt, reads, fn=lambda q, l, th, tp:
                         dsoft_device_batch(
                             q, l, th, tp, k=gt.k, w=gt.w,
                             bin_size=gt.bin_size,
                             kmer_max_occ=gt.kmer_max_occurence,
                             num_seeds_cap=800, threshold=18,
                             max_candidates=10**6, tup_max=8192,
                             cand_max=256, index="searchsorted"))
    tl = make_twolevel_index(np.asarray(gt.hashes))
    out_t = _run_device(gt, reads, fn=lambda q, l, th, tp:
                        dsoft_device_batch(
                            q, l, tl[:5], tp, k=gt.k, w=gt.w,
                            bin_size=gt.bin_size,
                            kmer_max_occ=gt.kmer_max_occurence,
                            num_seeds_cap=800, threshold=18,
                            max_candidates=10**6, tup_max=8192,
                            cand_max=256, index="twolevel",
                            tl_steps=tl[5]))
    for a, b in zip(out_ss, out_t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _check_parity(gt, reads, out_t)


def test_collect_calls_device_twolevel_matches_host():
    """collect_calls_device(index='twolevel') equals the host engine's
    exact call set (and caches the index on the table)."""
    from darwin_tpu.config import Params
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import FastaRecord
    from darwin_tpu.pipeline import collect_calls, collect_calls_device

    rng = np.random.default_rng(13)
    ref = rng.choice(ALPHA[:4], size=20000).astype(np.uint8)
    reads = []
    for _ in range(6):
        s = int(rng.integers(0, 17000))
        r = ref[s:s + int(rng.integers(500, 2500))].copy()
        mut = rng.random(len(r)) < 0.1
        r[mut] = rng.choice(ALPHA[:4], size=int(mut.sum()))
        reads.append(FastaRecord(["r"], r.tobytes().decode()))
    params = Params(seed_size=12, bin_size=32)
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    from darwin_tpu.coding import seq_to_bytes
    from darwin_tpu.engine.seqbank import SeqBank
    bank = SeqBank([seq_to_bytes(r.seq) for r in reads])
    host = collect_calls(table, genome, bank, params)
    dev = collect_calls_device(table, genome, bank, params,
                               index="twolevel")
    assert getattr(table, "_twolevel", None) is not None
    np.testing.assert_array_equal(dev.ref_id, host.ref_id)
    np.testing.assert_array_equal(dev.query_id, host.query_id)
    np.testing.assert_array_equal(dev.ref_pos, host.ref_pos)
    np.testing.assert_array_equal(dev.query_pos, host.query_pos)


def test_collect_calls_device_rcap_slices_match_host():
    """Batches above the RCAP=256 compile cap run as R<=256 slices of
    one compiled program; results must equal the host filtration
    exactly across the slice boundaries."""
    from darwin_tpu.coding import seq_to_bytes
    from darwin_tpu.config import Params
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import FastaRecord
    from darwin_tpu.pipeline import collect_calls, collect_calls_device

    rng = np.random.default_rng(47)
    ref = rng.choice(ALPHA[:4], size=20000).astype(np.uint8)
    params = Params(seed_size=12, threshold=12)
    genome = Genome([FastaRecord(["ref"], ref.tobytes().decode())],
                    params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    reads = []
    for _ in range(300):  # pads to 512 -> two 256-read slices
        s = int(rng.integers(0, 19000))
        r = ref[s:s + int(rng.integers(150, 400))].copy()
        mut = rng.random(len(r)) < 0.1
        r[mut] = rng.choice(ALPHA[:4], size=int(mut.sum()))
        reads.append(r)
    bank = SeqBank(reads)
    host = collect_calls(table, genome, bank, params)
    dev = collect_calls_device(table, genome, bank, params)
    np.testing.assert_array_equal(dev.ref_id, host.ref_id)
    np.testing.assert_array_equal(dev.query_id, host.query_id)
    np.testing.assert_array_equal(dev.ref_pos, host.ref_pos)
    np.testing.assert_array_equal(dev.query_pos, host.query_pos)


def test_device_dsoft_positions_past_2_31():
    """Reference positions above 2^31 (GRCh38-scale concats): hits
    stay uint32 end to end (the reference's own pos width,
    seed_pos_table.cpp uint64 = (hash << 32) | pos), so a table whose
    positions live past int32 range must still match the golden
    scalar spec bit for bit.  An int32 lane anywhere in the hit path
    turns these positions negative and fails this test."""
    gt, reads = _fixture(13)
    shift = np.uint64(2_600_000_000)  # past 2^31, within uint32
    gt.pos_table = (gt.pos_table.astype(np.uint64)
                    + shift).astype(np.uint32)
    gt.ref_size += int(shift)  # keep the golden hit<ref_size invariant
    out = _run_device(gt, reads)
    hits = out[0]
    assert hits.dtype == np.uint32
    # At least one emitted hit actually exercises the >2^31 range.
    counts = out[2]
    real = np.concatenate([hits[i, :counts[i]] for i in
                           range(len(reads))])
    assert (real.astype(np.uint64) > np.uint64(2**31)).any()
    _check_parity(gt, reads, out)
