"""On-device engine vs reference golden outputs (CPU backend)."""

import pytest

from darwin_tpu.config import Params
from darwin_tpu.io.fasta import parse_fasta
from darwin_tpu.pipeline import run_pipeline


@pytest.mark.parametrize("fixture,batch", [("tiny", 32), ("tiny", 8),
                                           ("noisy", 64)])
@pytest.mark.slow
def test_device_engine_matches_reference(data_dir, fixture, batch):
    d = data_dir / fixture
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta")
    result = run_pipeline(reads, reads, params, same_file=True,
                          batch_size=batch, engine="device",
                          backend="lax")
    want = set((d / "out.darwin").read_text().splitlines())
    got = set(result.records)
    assert got == want, (
        f"missing={sorted(want - got)[:5]} extra={sorted(got - want)[:5]}")


def test_sharded_gact_engine_matches_single_device(data_dir):
    """Mesh-sharded engine (independent per-device slot pools) must
    reproduce the single-device engine's record set."""
    import jax
    import numpy as np
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from darwin_tpu.config import Params
    from darwin_tpu.coding import seq_to_bytes
    from darwin_tpu.engine.device_batch import (DeviceGactEngine,
                                                ShardedGactEngine)
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import parse_fasta, revcomp
    from darwin_tpu.parallel.mesh import make_mesh
    from darwin_tpu.pipeline import collect_calls

    d = data_dir / "tiny"
    params = Params.from_cfg(d / "params.cfg")
    reads = parse_fasta(d / "reads.fasta")
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    fwd = SeqBank([seq_to_bytes(r.seq) for r in reads])
    rev = SeqBank([seq_to_bytes(revcomp(r.seq)) for r in reads])
    merged = SeqBank.concat(fwd, rev)
    calls_m = collect_calls(table, genome, merged, params)
    R = len(reads)
    comp = (calls_m.query_id >= R).astype(np.int32)
    bank_ids = calls_m.query_id
    from darwin_tpu.engine.batch import GactCalls
    calls = GactCalls(calls_m.ref_id, calls_m.query_id % R,
                      calls_m.ref_pos, calls_m.query_pos)

    kw = dict(tile_size=params.tile_size,
              early_terminate=params.early_terminate,
              first_tile_score_threshold=(
                  params.first_tile_score_threshold),
              match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_extend=params.gap_extend,
              same_file=True, batch_size=64)
    single = DeviceGactEngine(genome, merged, **kw)
    recs1 = single.run(calls, comp)
    mesh = make_mesh(8)
    sharded = ShardedGactEngine(genome, merged, mesh=mesh, **kw)
    recs2 = sharded.finish(sharded.run_async(calls, comp, bank_ids))
    # bank_ids defaults differ; rerun single with explicit bank_ids.
    recs1 = single.finish(single.run_async(calls, comp, bank_ids))

    def key(rs):
        return sorted((r.ref_id, r.query_id, r.ab, r.ae, r.bb, r.be,
                       r.score, r.comp) for r in rs)
    assert key(recs1) == key(recs2)
    assert len(recs1) > 0


@pytest.mark.parametrize("tb_format", ["packed", "packed6"])
def test_two_tier_drain_matches_host_engine(tb_format):
    """A batch big enough to trigger the drain (N > B_eff >= 256) must
    produce the host engine's exact record set, and the drain must
    actually fire (re-dispatch of stragglers into a smaller engine).
    Parametrized over both traceback word formats — packed6's holes
    exercise the scoring lookback end to end."""
    import numpy as np

    from darwin_tpu.config import Params
    from darwin_tpu.engine.aligner import JaxTileAligner
    from darwin_tpu.engine.batch import GactCalls, run_gact_batch
    from darwin_tpu.engine.device_batch import DeviceGactEngine
    from darwin_tpu.engine.scoring import ScoreParams
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.io.fasta import FastaRecord

    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq = alpha[rng.integers(0, 4, size=8192)]
    genome = Genome([FastaRecord(["g"], ref_seq.tobytes().decode())],
                    64)
    # Skewed read lengths so stragglers outlive the refill stream.
    reads = []
    for i in range(64):
        L = 2000 if i % 16 == 0 else int(rng.integers(120, 400))
        s = int(rng.integers(0, 8192 - L))
        r = ref_seq[s:s + L].copy()
        mut = rng.random(L) < 0.1
        r[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
        reads.append(r)
    bank = SeqBank(reads)

    N = 600
    anchors = GactCalls(
        ref_id=np.zeros(N, np.int64),
        query_id=rng.integers(0, 64, N).astype(np.int64),
        ref_pos=rng.integers(0, 8000, N).astype(np.int64),
        query_pos=np.zeros(N, np.int64))
    anchors.query_pos[:] = np.minimum(
        bank.lengths[anchors.query_id] // 2, 100)

    params = Params(tile_size=16, tile_overlap=8,
                    first_tile_score_threshold=4)
    kw = dict(tile_size=params.tile_size,
              early_terminate=params.early_terminate,
              match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    eng = DeviceGactEngine(
        genome, bank, first_tile_score_threshold=4, same_file=False,
        batch_size=256, backend="lax", tb_format=tb_format, **kw)
    recs_dev = eng.finish(eng.run_async(anchors, False))
    assert eng.last_drain_redispatches >= 1, \
        "drain did not fire; test workload no longer triggers it"

    aligner = JaxTileAligner(backend="lax", **kw)
    recs_host = run_gact_batch(
        genome, bank, anchors, tile_size=params.tile_size,
        first_tile_score_threshold=4,
        sp=ScoreParams(1, -1, -1, -1), complement=False,
        same_file=False, aligner=aligner, batch_size=256)

    def key(rs):
        return sorted((r.ref_id, r.query_id, r.ab, r.ae, r.bb, r.be,
                       r.score, r.comp, r.nmatch, r.ncols) for r in rs)
    assert len(recs_dev) > 0
    assert key(recs_dev) == key(recs_host)


def test_drain_auto_gate_calibration():
    """The auto drain gate (slot-pool tail simulation) must match the
    calibration points it was fitted on (on another accelerator; not
    yet re-fitted on the GPU): OFF at near-uniform read lengths (the
    E.coli shape, where the drain lost) and ON under harsh depth skew
    (the 16:1 workload the drain won, the test above)."""
    import numpy as np

    from darwin_tpu.engine.device_batch import (DRAIN_MIN_TAIL_FRAC,
                                                DRAIN_MIN_TAIL_ITERS,
                                                _drain_tail_span)

    def gate(costs, B):
        tail, total = _drain_tail_span(costs, B)
        return (tail >= DRAIN_MIN_TAIL_ITERS
                and tail >= DRAIN_MIN_TAIL_FRAC * total)

    rng = np.random.default_rng(0)
    # E.coli-like: ~1100 calls, all 10 kb reads, ET=256, B=512.
    uniform = np.full(1100, 10_000 // 256 + 2)
    assert not gate(uniform, 512)
    # Harsh skew (the drain-test shape): ET=8, 1/16 of calls 250
    # iterations deep, the rest 17-52.
    skew = rng.integers(17, 53, size=600)
    skew[::16] = 252
    assert gate(skew, 256)
    # Moderate skew at a big pool (the drain_prof synthetic, a wash
    # when measured): 15% x 50-iter, 85% x 10-iter, B=2048.
    moderate = np.where(rng.random(3000) < 0.15, 52, 12)
    assert not gate(moderate, 2048)


def test_balance_calls_skewed_loads():
    """LPT assignment: skewed costs must spread within ~20% across
    devices while per-device counts stay at ceil(N/nd)."""
    import numpy as np

    from darwin_tpu.engine.device_batch import balance_calls

    rng = np.random.default_rng(0)
    # Pathological: first quarter of the calls are 20x as expensive.
    costs = np.concatenate([np.full(16, 8000), np.full(48, 400)])
    rng.shuffle(costs)
    parts = balance_calls(costs, 8)
    # Partition sanity.
    got = np.sort(np.concatenate(parts))
    np.testing.assert_array_equal(got, np.arange(64))
    counts = [len(p) for p in parts]
    assert max(counts) == 8  # ceil(64/8): count cap respected
    loads = np.array([costs[p].sum() for p in parts])
    assert loads.max() <= 1.2 * loads.mean(), loads
    # The contiguous-block split this replaces would have been 5.7x
    # imbalanced on the unshuffled ordering.


def test_sharded_engine_skewed_read_lengths(data_dir):
    """Record parity sharded vs single-device on a workload with
    strongly skewed read lengths (long reads first, so the old
    contiguous split would pile every long call on device 0)."""
    import jax
    import numpy as np

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from darwin_tpu.coding import seq_to_bytes
    from darwin_tpu.engine.batch import GactCalls
    from darwin_tpu.engine.device_batch import (DeviceGactEngine,
                                                ShardedGactEngine,
                                                balance_calls)
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.eval.datagen import sample_reads, synth_genome
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.io.fasta import FastaRecord, revcomp
    from darwin_tpu.parallel.mesh import make_mesh
    from darwin_tpu.pipeline import collect_calls

    rng = np.random.default_rng(123)
    genome_s = synth_genome(60_000, rng)
    long_reads = sample_reads(genome_s, 6, 6_000, rng, error_rate=0.05,
                              rc_fraction=0.3)
    short_reads = sample_reads(genome_s, 18, 700, rng, error_rate=0.05,
                               rc_fraction=0.3)
    reads = [FastaRecord([n], s) for n, s in long_reads + short_reads]

    params = Params(seed_size=12, tile_size=64, tile_overlap=24,
                    threshold=12, bin_size=32)
    genome = Genome(reads, params.bin_size)
    table = SeedTable.build(genome.concat, params.seed_size,
                            params.seed_occurence_multiple,
                            params.bin_size, params.window_size)
    fwd = SeqBank([seq_to_bytes(r.seq) for r in reads])
    rev = SeqBank([seq_to_bytes(revcomp(r.seq)) for r in reads])
    merged = SeqBank.concat(fwd, rev)
    calls_m = collect_calls(table, genome, merged, params)
    R = len(reads)
    comp = (calls_m.query_id >= R).astype(np.int32)
    bank_ids = calls_m.query_id
    calls = GactCalls(calls_m.ref_id, calls_m.query_id % R,
                      calls_m.ref_pos, calls_m.query_pos)
    assert len(calls) >= 16

    # The cost-aware split must beat 20% spread on this skew.
    loads = np.array([merged.lengths[bank_ids][p].sum() for p in
                      balance_calls(merged.lengths[bank_ids], 8)])
    assert loads.max() <= 1.2 * max(1, loads.mean())

    kw = dict(tile_size=params.tile_size,
              early_terminate=params.early_terminate,
              first_tile_score_threshold=(
                  params.first_tile_score_threshold),
              match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_extend=params.gap_extend,
              same_file=True, batch_size=32)
    single = DeviceGactEngine(genome, merged, **kw)
    recs1 = single.finish(single.run_async(calls, comp, bank_ids))
    sharded = ShardedGactEngine(genome, merged,
                                mesh=make_mesh(8), **kw)
    recs2 = sharded.finish(sharded.run_async(calls, comp, bank_ids))

    def key(rs):
        return sorted((r.ref_id, r.query_id, r.ab, r.ae, r.bb, r.be,
                       r.score, r.comp) for r in rs)
    assert key(recs1) == key(recs2)
    assert len(recs1) > 0
