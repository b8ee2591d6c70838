"""Fully on-device GACT batch engine.

The host engine (engine/batch.py) round-trips tiles and op streams
between host and device every iteration — fatal when the accelerator
sits behind a high-latency link and wasteful everywhere.  This engine
runs the ENTIRE GACT_Batch loop (reference gact.cpp:231-560) on device
inside one lax.while_loop:

* sequence banks (padded genome concat + read bank) are uploaded once;
* the per-slot state machine (phase swap, emission, slot refill,
  first-tile re-anchoring, termination) is expressed as masked vector
  ops over the slot and call tables, with scatter updates — each
  in-flight call lives in exactly one slot, so scatters never collide;
* tiles stream on device from combined forward+reversed banks with
  split (row, byte-in-row) addressing (ops/tile_fetch.py), so banks
  of any size stay int32-indexed;
* the DP kernel (CUDA on the GPU, lax on the CPU) and the traceback
  run per iteration;
* affine rescoring accumulates on device from the dir bytes' MATCH_BIT
  (same formulation as engine/scoring.py, incl. the anchor-junction
  correction) — no sequence gathers;
* finished overlaps are scattered into a fixed [n_calls, 8] record
  buffer with a per-call complement column, so both strands run as ONE
  merged batch: one dispatch, one download at the end.

Record semantics are identical to the host engine, which is
differentially tested against the reference binary; the device engine
is in turn tested record-for-record against the host engine.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from darwin_tpu.engine.batch import SCORE_THRESHOLD, GactCalls, OverlapRecord
from darwin_tpu.utils import bucket_pow2 as _bucket
from darwin_tpu.engine.seqbank import SeqBank
from darwin_tpu.index.genome import Genome
from darwin_tpu.ops.common import PAD_QUERY, PAD_REF
from darwin_tpu.engine.aligner import resolve_backend, tile_dp_words
from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.tile_fetch import ROW, build_combined_bank, fetch_tiles
from darwin_tpu.ops.traceback import (pack_dir_words,
                                      traceback_packed6_jax,
                                      traceback_packed_jax)

I32 = jnp.int32

# Engine functions are cached globally: tracing + lowering the
# while_loop body is expensive (seconds), and jax.jit's cache keys on
# function identity, so per-instance closures would retrace every run.
_ENGINE_FN_CACHE: dict[tuple, object] = {}

# Census of engine compiles this process (cold-start accounting): one
# entry per _ENGINE_FN_CACHE miss.
ENGINE_COMPILE_LOG: list[dict] = []


@dataclasses.dataclass
class _Static:
    """Static (compile-time) engine configuration."""
    B: int
    T: int
    ET: int
    Ncap: int
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int
    threshold: int
    same_file: bool
    compute_score: bool
    backend: str
    # (The two-tier drain threshold is a RUNTIME scalar of the engine
    # fn, not a static: one compiled engine serves both the drained
    # main dispatch and the run-to-completion straggler tier, halving
    # cold-start compile count — see _dispatch/finish.)
    # Traceback word format: "packed" (2 steps/gather, lax only) or
    # "packed6" (5-bit fields, 2-4 steps/gather on match runs).
    tbfmt: str = "packed6"


def _align(st: _Static, ref_t, query_t, rlen, qlen, first_b):
    kw = dict(match=st.match, mismatch=st.mismatch,
              gap_open=st.gap_open, gap_extend=st.gap_extend)
    with jax.named_scope("tile_dp"):
        if st.tbfmt == "packed6":
            out, words = tile_dp_words(st.backend, ref_t, query_t, rlen,
                                       qlen, **kw)
        else:
            out = align_tiles_jax(ref_t, query_t, rlen, qlen, **kw)
            words = pack_dir_words(out["dir"])
    walker = (traceback_packed6_jax if st.tbfmt == "packed6"
              else traceback_packed_jax)
    with jax.named_scope("traceback"):
        ops, mbits, i_steps, j_steps = walker(
            words, rlen, qlen, first_b, out["max_i"], out["max_j"],
            early_terminate=st.ET)
    score = jnp.where(first_b, out["max_score"], out["pos_score"])
    return (ops.T, mbits.T, i_steps, j_steps, score, out["max_i"],
            out["max_j"])


def _score_ops(st: _Static, opsT, mbitsT, prev_gap):
    """Device port of engine/scoring.py::score_ops_batch.

    Match/mismatch per MATCH op comes from the dir byte's MATCH_BIT
    (carried through the traceback), so no sequence gathers and no
    walked-position cumsums are needed — re-gathering the chars from
    the flat banks measured ~6 ms/iteration at B=1024.
    """
    opsT = opsT.astype(I32)
    valid = opsT != 0
    is_gap = (opsT == 1) | (opsT == 2)
    is_m = opsT == 3

    m_contrib = jnp.where(mbitsT, st.match, st.mismatch)

    # Previous-op gap flag with hole skipping (packed6 walker leaves
    # up to two zero slots per 4-slot group; see engine/scoring.py).
    B2, S2 = opsT.shape
    pg = prev_gap[:, None]
    gpad = jnp.concatenate(
        [jnp.broadcast_to(pg, (B2, 3)), is_gap], axis=1)
    vpad = jnp.concatenate(
        [jnp.ones((B2, 3), bool), valid], axis=1)
    prev_col_gap = jnp.where(
        vpad[:, 2: 2 + S2], gpad[:, 2: 2 + S2],
        jnp.where(vpad[:, 1: 1 + S2], gpad[:, 1: 1 + S2],
                  gpad[:, 0: S2]))
    gap_contrib = jnp.where(prev_col_gap, st.gap_extend, st.gap_open)

    delta = jnp.sum(jnp.where(is_m, m_contrib, gap_contrib) * valid,
                    axis=1)
    n_match = jnp.sum((mbitsT & is_m.astype(bool)).astype(I32), axis=1)
    has_ops = valid.any(axis=1)
    S = valid.shape[1]
    last_idx = jnp.where(
        has_ops, S - 1 - jnp.argmax(valid[:, ::-1], axis=1), 0)
    last_gap = jnp.take_along_axis(is_gap, last_idx[:, None],
                                   axis=1)[:, 0]
    new_prev_gap = jnp.where(has_ops, last_gap, prev_gap)
    first_col_gap = is_gap[:, 0] & valid[:, 0]
    return delta, new_prev_gap, first_col_gap, has_ops, n_match


def _make_engine_fn(st: _Static):
    """Build the jitted whole-batch engine function.

    gconcat/qflat are combined [rows, ROW] banks (ops/tile_fetch.py);
    span bases arrive pre-split as (row, byte-in-row) pairs.
    """
    B, T, Ncap = st.B, st.T, st.Ncap
    DUMP = Ncap  # scatter target for masked-off lanes

    def scatter(arr, idx, val, mask):
        return arr.at[jnp.where(mask, idx, DUMP)].set(val)

    def engine(n_calls, drain, gconcat, qflat,
               rid, qid, comp, g_row, g_rem, grv_row, grv_rem, g_len,
               q_row, q_rem, qrv_row, qrv_rem, q_len,
               cstate):
        # drain: RUNTIME early-stop threshold — the loop stops once
        # every call has been issued and fewer than `drain` slots stay
        # active (0 disables: n_active < 0 never holds), so the same
        # compiled engine serves drained and run-to-completion tiers.
        # Call state (index Ncap = dump lane).  cstate is the
        # [Ncap, 16] int32 per-call state matrix (column layout
        # CSTATE_COLS): fresh batches pass anchors + defaults, the
        # two-tier drain passes a previous dispatch's exported state.
        def padded(x, fill=0):
            return jnp.concatenate(
                [x, jnp.full((1,), fill, x.dtype)])

        def coli(i):
            return padded(cstate[:, i])

        def colb(i):
            return padded(cstate[:, i] != 0)

        rpos = coli(0)
        qpos = coli(1)
        rbpos = coli(2)
        qbpos = coli(3)
        first = colb(4)
        reverse = colb(5)
        prev_gap = colb(6)
        termp = colb(7)
        donep = colb(8)
        score = coli(9)
        nmat = coli(10)
        ncol = coli(11)
        hp0 = colb(12)
        hp1 = colb(13)
        fg0 = colb(14)
        fg1 = colb(15)

        ridp = padded(rid)
        qidp = padded(qid)
        compp = padded(comp)
        # Bank offsets arrive split as (row, byte-in-row) pairs so all
        # device arithmetic stays int32 even for banks beyond 2^31
        # bytes (rows cap at bytes/ROW; per-piece/per-read coordinates
        # are < 2^31 by validation).  grv/qrv are the reverse-copy
        # bases 2*GP - start, pre-split on host.
        grwp, grmp = padded(g_row), padded(g_rem)
        gvwp, gvmp = padded(grv_row), padded(grv_rem)
        glp = padded(g_len)
        qrwp, qrmp = padded(q_row), padded(q_rem)
        qvwp, qvmp = padded(qrv_row), padded(qrv_rem)
        qlp = padded(q_len)

        slot_iota = jnp.arange(B, dtype=I32)
        assign = jnp.where(slot_iota < n_calls, slot_iota, -1)

        records = jnp.full((Ncap + 1, 10), -1, I32)
        state = (rpos, qpos, rbpos, qbpos, first, reverse, prev_gap,
                 score, nmat, ncol, hp0, hp1, fg0, fg1, assign, termp,
                 donep,
                 jnp.minimum(jnp.asarray(B, I32), n_calls),
                 jnp.asarray(0, I32), jnp.asarray(0, I32), records,
                 jnp.minimum(jnp.asarray(B, I32), n_calls),  # n_active
                 jnp.asarray(0, I32), jnp.asarray(0, I32))   # iters/act

        def cond(state):
            calls_done, next_ci = state[18], state[17]
            n_active = state[21]
            return ((calls_done < n_calls)
                    & ~((next_ci >= n_calls) & (n_active < drain)))

        def body(state):
            (rpos, qpos, rbpos, qbpos, first, reverse, prev_gap, score,
             nmat, ncol, hp0, hp1, fg0, fg1, assign, termp, donep,
             next_ci, calls_done, nrec, records, n_active, iters,
             act_sum) = state

            # ---- prepare (gact.cpp:298-410) -------------------------
            act = assign >= 0
            ci = jnp.where(act, assign, DUMP)
            c_rev = reverse[ci]

            # Phase swap: reverse extension finished.
            swap = act & c_rev & ((rpos[ci] <= 0) | (qpos[ci] <= 0)
                                  | termp[ci])
            old_rpos, old_rbpos = rpos[ci], rbpos[ci]
            old_qpos, old_qbpos = qpos[ci], qbpos[ci]
            rpos = scatter(rpos, ci, old_rbpos, swap)
            rbpos = scatter(rbpos, ci, old_rpos, swap)
            qpos = scatter(qpos, ci, old_qbpos, swap)
            qbpos = scatter(qbpos, ci, old_qpos, swap)
            reverse = scatter(reverse, ci, jnp.zeros(B, bool), swap)
            prev_gap = scatter(prev_gap, ci, jnp.zeros(B, bool), swap)
            termp = scatter(termp, ci, jnp.zeros(B, bool), swap)

            # Emission: forward extension finished (checked on the
            # pre-swap reverse flag, like the reference's if/else).
            fwd_done = act & ~c_rev & (
                (rpos[ci] >= glp[ci]) | (qpos[ci] >= qlp[ci])
                | termp[ci])
            corr = hp0[ci] & hp1[ci] & fg0[ci] & fg1[ci]
            fscore = score[ci] + jnp.where(
                corr, st.gap_extend - st.gap_open, 0)
            keep = fwd_done
            if st.same_file:
                keep = keep & (ridp[ci] != qidp[ci])
            if st.compute_score:
                keep = keep & (fscore > SCORE_THRESHOLD)
            rows = jnp.stack(
                [ridp[ci], qidp[ci], rbpos[ci], rpos[ci], qbpos[ci],
                 qpos[ci],
                 fscore if st.compute_score else jnp.zeros(B, I32),
                 compp[ci], nmat[ci], ncol[ci]], axis=1)
            krank = jnp.cumsum(keep.astype(I32)) - keep
            records = records.at[
                jnp.where(keep, nrec + krank, Ncap)].set(rows)
            nrec = nrec + keep.sum(dtype=I32)
            calls_done = calls_done + fwd_done.sum(dtype=I32)
            donep = scatter(donep, ci, jnp.ones(B, bool), fwd_done)

            # Slot refill.
            erank = jnp.cumsum(fwd_done.astype(I32)) - fwd_done
            new_ci = next_ci + erank
            got_new = fwd_done & (new_ci < n_calls)
            assign = jnp.where(fwd_done,
                               jnp.where(got_new, new_ci, -1), assign)
            next_ci = jnp.minimum(
                n_calls, next_ci + fwd_done.sum(dtype=I32))
            # Fresh calls anchored at an edge skip the reverse phase.
            fci = jnp.where(got_new, new_ci, DUMP)
            fresh_skip = got_new & ((rpos[fci] <= 0) | (qpos[fci] <= 0))
            reverse = scatter(reverse, fci, jnp.zeros(B, bool),
                              fresh_skip)
            rbpos = scatter(rbpos, fci, rpos[fci], fresh_skip)
            qbpos = scatter(qbpos, fci, qpos[fci], fresh_skip)

            # ---- tile gather ----------------------------------------
            act2 = assign >= 0
            ci2 = jnp.where(act2, assign, DUMP)
            rev2 = reverse[ci2]
            p_r = rpos[ci2]
            p_q = qpos[ci2]
            first_b = first[ci2] & act2

            rl = jnp.where(rev2, jnp.minimum(p_r, T),
                           jnp.minimum(T, glp[ci2] - p_r))
            ql = jnp.where(rev2, jnp.minimum(p_q, T),
                           jnp.minimum(T, qlp[ci2] - p_q))
            rl = jnp.where(act2, jnp.maximum(rl, 0), 0)
            ql = jnp.where(act2, jnp.maximum(ql, 0), 0)

            k = jnp.arange(T, dtype=I32)[None, :]
            # Reverse tiles read [pos-rl, pos) forward; forward tiles
            # read [pos, pos+rl) back-to-front (align.cpp:130 order).
            # Both orientations are contiguous spans of the combined
            # (forward + reversed) banks.  Span starts are built in
            # split (row, rem) form: the base row carries the >2^31
            # part, the in-piece remainder is int32; jnp // and %
            # floor, so negative rev-copy remainders stay exact.
            s_r = jnp.where(rev2, grmp[ci2] + p_r - rl,
                            gvmp[ci2] - p_r - rl)
            row_r = (jnp.where(rev2, grwp[ci2], gvwp[ci2])
                     + s_r // ROW)
            s_q = jnp.where(rev2, qrmp[ci2] + p_q - ql,
                            qvmp[ci2] - p_q - ql)
            row_q = (jnp.where(rev2, qrwp[ci2], qvwp[ci2])
                     + s_q // ROW)
            with jax.named_scope("tile_fetch"):
                ref_f = fetch_tiles(row_r, s_r % ROW, gconcat, T=T)
                query_f = fetch_tiles(row_q, s_q % ROW, qflat, T=T)
                ref_t = jnp.where(k < rl[:, None], ref_f,
                                  jnp.uint8(PAD_REF))
                query_t = jnp.where(k < ql[:, None], query_f,
                                    jnp.uint8(PAD_QUERY))

            # ---- align ----------------------------------------------
            opsT, mbitsT, i_steps, j_steps, tscore, max_i, max_j = (
                _align(st, ref_t, query_t, rl, ql, first_b))

            # ---- postprocess (gact.cpp:427-550) ---------------------
            ra_r = jnp.where(rev2, p_r - rl + max_i, p_r + rl - max_i)
            ra_q = jnp.where(rev2, p_q - ql + max_j, p_q + ql - max_j)
            rp_t = jnp.where(first_b, ra_r, p_r)
            qp_t = jnp.where(first_b, ra_q, p_q)
            thr_fail = first_b & (tscore < st.threshold) & act2
            apply = act2 & ~thr_fail

            # First reverse tiles re-anchor the begin positions.
            fb_rev = first_b & rev2
            rbpos = scatter(rbpos, ci2, rp_t, fb_rev)
            qbpos = scatter(qbpos, ci2, qp_t, fb_rev)

            opsT = opsT * apply[:, None]
            n_ops = jnp.sum((opsT != 0).astype(I32), axis=1)
            ncol = scatter(ncol, ci2, ncol[ci2] + n_ops, apply)
            if st.compute_score:
                delta, new_pg, first_gap, has_ops, n_m = _score_ops(
                    st, opsT, mbitsT, prev_gap[ci2])
                score = scatter(score, ci2, score[ci2] + delta, apply)
                nmat = scatter(nmat, ci2, nmat[ci2] + n_m, apply)
                prev_gap = scatter(prev_gap, ci2, new_pg, apply)
            else:
                has_ops = (opsT != 0).any(axis=1)
                first_gap = jnp.zeros(B, bool)

            # Phase bookkeeping for the junction correction.
            new0 = apply & has_ops & rev2 & ~hp0[ci2]
            new1 = apply & has_ops & ~rev2 & ~hp1[ci2]
            fg0 = scatter(fg0, ci2, first_gap, new0)
            fg1 = scatter(fg1, ci2, first_gap, new1)
            hp0 = scatter(hp0, ci2, jnp.ones(B, bool), new0)
            hp1 = scatter(hp1, ci2, jnp.ones(B, bool), new1)

            first = scatter(first, ci2, jnp.zeros(B, bool),
                            apply & has_ops)

            i_steps = jnp.where(apply, i_steps, 0)
            j_steps = jnp.where(apply, j_steps, 0)
            nr = jnp.where(rev2, rp_t - i_steps, rp_t + i_steps)
            nq = jnp.where(rev2, qp_t - j_steps, qp_t + j_steps)
            upd_pos = apply | thr_fail
            rpos = scatter(rpos, ci2, jnp.where(apply, nr, rp_t),
                           upd_pos)
            qpos = scatter(qpos, ci2, jnp.where(apply, nq, qp_t),
                           upd_pos)
            new_term = thr_fail | (
                apply & ((i_steps == 0) | (j_steps == 0)))
            termp = scatter(termp, ci2, termp[ci2] | new_term, act2)

            return (rpos, qpos, rbpos, qbpos, first, reverse, prev_gap,
                    score, nmat, ncol, hp0, hp1, fg0, fg1, assign,
                    termp, donep, next_ci, calls_done, nrec, records,
                    act2.sum(dtype=I32), iters + 1,
                    act_sum + act2.sum(dtype=I32))

        state = jax.lax.while_loop(cond, body, state)
        (rpos, qpos, rbpos, qbpos, first, reverse, prev_gap, score,
         nmat, ncol, hp0, hp1, fg0, fg1, assign, termp, donep,
         next_ci, calls_done, nrec, records, n_active, iters,
         act_sum) = state
        state_out = jnp.stack(
            [a[:Ncap].astype(I32) for a in
             (rpos, qpos, rbpos, qbpos, first, reverse, prev_gap,
              termp, donep, score, nmat, ncol, hp0, hp1, fg0, fg1)],
            axis=1)
        return (records[:Ncap], nrec, state_out, iters, act_sum,
                calls_done)

    return jax.jit(engine)


def _drain_tail_span(costs: np.ndarray, B: int) -> tuple[int, int]:
    """Event-driven slot-pool simulation: N calls with per-call
    iteration costs, issued in order into B persistent slots (a slot
    takes the next queued call when its current one finishes — the
    engine's refill rule).  Returns (tail, total): total = predicted
    engine iterations, tail = iterations the pool runs with fewer than
    B//4 active slots, i.e. the span the two-tier drain could hand to
    a small-B engine.  O(N log B) on the host, run once per dispatch.
    """
    import heapq

    n = len(costs)
    k = min(B, n)
    finish = [int(c) for c in costs[:k]]
    heapq.heapify(finish)
    for c in costs[k:]:
        t = heapq.heappop(finish)
        heapq.heappush(finish, t + int(c))
    f = sorted(finish, reverse=True)
    total = f[0] if f else 0
    q = B // 4
    tail = total - f[q - 1] if q - 1 < len(f) else total
    return tail, total


# Auto-drain gate constants (see drain_enabled): engaging the drain
# costs one state export + host round trip + straggler re-dispatch, and
# when the natural small-B engine is not already compiled the
# redispatch reuses the parent's B (finish()), saving nothing.  The
# gate therefore demands a DEEP straggler tail (not the one-call
# quantization tail every uniform workload shows at its last refill
# wave) that also dominates the run.  Both thresholds were fitted on
# another accelerator (the engine's earlier target) from three points:
# uniform 10 kb E.coli reads (sim tail 41 iters / frac 0.33, drain
# lost), a 16:1 length skew (tail 218 / frac 0.69, drain won) and a
# moderate skew (tail 40 / frac 0.63, a wash).  They are not yet
# re-fitted on the GPU.
DRAIN_MIN_TAIL_ITERS = 64
DRAIN_MIN_TAIL_FRAC = 0.5


class DeviceGactEngine:
    """One-dispatch-per-direction GACT engine with device-resident
    sequence banks."""

    # Two-tier drain switch: True = auto (engage only when the
    # workload-tail simulation predicts a harvestable straggler tail
    # — see _drain_tail_span; at near-uniform read lengths the drain
    # costs more than it saves), "always" = skip the gate (A/B
    # instrument), False = off.
    drain_enabled: bool | str = True

    def __init__(self, genome: Genome, queries: SeqBank, *,
                 tile_size: int, early_terminate: int,
                 first_tile_score_threshold: int, match: int,
                 mismatch: int, gap_open: int, gap_extend: int,
                 same_file: bool, batch_size: int = 256,
                 compute_score: bool = True, backend: str = "auto",
                 tb_format: str = "packed6"):
        backend = resolve_backend(backend)
        if backend == "cuda" and tb_format != "packed6":
            raise ValueError("the CUDA kernel emits packed6 words only")
        self.genome = genome
        self.queries = queries
        self._static = _Static(
            B=batch_size, T=tile_size, ET=early_terminate, Ncap=0,
            match=match, mismatch=mismatch, gap_open=gap_open,
            gap_extend=gap_extend, threshold=first_tile_score_threshold,
            same_file=same_file, compute_score=compute_score,
            backend=backend, tbfmt=tb_format)
        # Pad banks to power-of-two buckets so compiled engines are
        # reusable across datasets of similar size (gathers/fetches are
        # clipped and masked, so padding bytes are never observed).
        gpad = _bucket(max(1, len(genome.concat)), 4096)
        qpad = _bucket(max(1, len(queries.flat)), 4096)
        gflat = np.pad(genome.concat, (0, gpad - len(genome.concat)),
                       constant_values=PAD_REF)
        qflat = np.pad(queries.flat, (0, qpad - len(queries.flat)),
                       constant_values=PAD_QUERY)
        # The device-resident genome bank is cached per genome so
        # per-strand engine instances over the same reference share one
        # upload (at human scale the combined bank is gigabytes).
        cache = getattr(genome, "_device_bank_cache", None)
        if cache is None:
            cache = genome._device_bank_cache = {}
        if len(gflat) not in cache:
            gbank, gp = build_combined_bank(gflat, PAD_REF)
            cache[len(gflat)] = (jax.device_put(gbank), gp)
        self._gconcat, self._GP_G = cache[len(gflat)]
        qbank, self._GP_Q = build_combined_bank(qflat, PAD_QUERY)
        self._qflat = jax.device_put(qbank)
        # Piece starts stay int64 on host; the device sees them only as
        # split (row, byte-in-row) pairs, so references beyond 2^31
        # bytes work.  Per-piece / per-read local
        # coordinates must individually fit int32 (true for any real
        # chromosome or read).
        self._g_start_all = (genome.chr_id_to_start_bin.astype(np.int64)
                             * genome.bin_size)
        # Split addressing adds a byte-in-row remainder (< ROW) to
        # in-piece positions in int32, so the per-piece bound is
        # 2^31 - ROW, not 2^31 (no real sequence approaches either).
        if len(genome.piece_lengths) and \
                int(genome.piece_lengths.max()) >= 2**31 - ROW:
            raise ValueError("a reference piece exceeds 2^31-512 bases")
        if len(queries.lengths) and \
                int(queries.lengths.max()) >= 2**31 - ROW:
            raise ValueError("a read exceeds 2^31-512 bases")
        self._prewarmed: _Static | None = None
        self._prewarm_thread = None

    def prewarm_async(self, n_calls_estimate: int):
        """Start compiling a generously-sized engine config in a
        background thread, overlapping the compile with the host's
        table build and seeding phases.  The config holds any call count up to 2x the
        estimate, and _dispatch adopts it via st_override whenever the
        natural config is not yet compiled — so an over-estimate can
        never trigger a second compile; only an under-run past 2x
        falls back to the natural (compiling) path.  Engages only when
        the estimate saturates the slot count: small workloads' engines
        are cheap enough to compile at dispatch."""
        import threading

        est = max(1, int(n_calls_estimate))
        st = self._natural_static(2 * est)
        if st.B < self._static.B:
            return None
        self._prewarmed = st
        key = self._key(st)
        if key in _ENGINE_FN_CACHE:
            return None
        ENGINE_COMPILE_LOG.append(dict(
            kind="prewarm", Ncap=st.Ncap, B=st.B, T=st.T,
            tbfmt=st.tbfmt, n_calls=-1))
        fn = _ENGINE_FN_CACHE[key] = _make_engine_fn(st)

        def work():
            z = np.zeros(st.Ncap, np.int32)
            cz = np.zeros((st.Ncap, 16), np.int32)
            out = fn(np.int32(0), np.int32(0), self._gconcat,
                     self._qflat, *([z] * 13), cz)
            jax.device_get(out[5])  # fence: compile fully done

        t = threading.Thread(target=work, daemon=True,
                             name="engine-prewarm")
        t.start()
        self._prewarm_thread = t
        return t

    @staticmethod
    def _split_offsets(start64: np.ndarray, GP: int):
        """(row, rem, rev_row, rev_rem) int32 quadruple for the split
        combined-bank addressing (rev base = 2*GP - start)."""
        start64 = start64.astype(np.int64)
        rv = 2 * np.int64(GP) - start64
        return (start64 // ROW, start64 % ROW, rv // ROW, rv % ROW)

    def run(self, calls: GactCalls, complement) -> list[OverlapRecord]:
        return self.finish(self.run_async(calls, complement))

    @staticmethod
    def _fresh_state(ref_pos, query_pos) -> np.ndarray:
        """[N, 16] per-call state matrix for fresh anchors (CSTATE
        column layout: rpos, qpos, rbpos, qbpos, first, reverse,
        prev_gap, term, done, score, nmat, ncol, hp0, hp1, fg0, fg1)."""
        N = len(ref_pos)
        cs = np.zeros((N, 16), np.int32)
        cs[:, 0] = cs[:, 2] = ref_pos
        cs[:, 1] = cs[:, 3] = query_pos
        cs[:, 4] = 1  # first
        cs[:, 5] = 1  # reverse phase
        return cs

    def _natural_static(self, N: int) -> "_Static":
        """The compile config _dispatch would pick for an N-call batch:
        Ncap pow2-bucketed; slot count shrunk to the workload
        (iterations are bounded by max-tiles-per-call, so surplus slots
        only add per-iteration cost — measured 2x end-to-end on a
        122-call batch, 512 -> 128; half-octave buckets cap idle-slot
        waste at 33%)."""
        from darwin_tpu.utils import bucket_steps
        Ncap = _bucket(N)
        B_eff = min(self._static.B, bucket_steps(N, 64))
        return dataclasses.replace(self._static, Ncap=Ncap, B=B_eff)

    def _key(self, st: "_Static") -> tuple:
        return (dataclasses.astuple(st), self._gconcat.shape,
                self._qflat.shape)

    def _dispatch(self, rid, qid, bid, comp, cstate, drain_on: bool,
                  st_override: "_Static | None" = None):
        """Dispatch N calls (metadata arrays + [N, 16] state matrix).

        st_override re-runs an already-compiled configuration (the
        cold-path straggler tier reuses its parent's engine instead of
        compiling the natural smaller one, DeviceGactEngine.finish)."""
        N = len(rid)
        if st_override is not None:
            st = st_override
        else:
            st = self._natural_static(N)
            pw = self._prewarmed
            if (pw is not None and pw.Ncap >= N
                    and self._key(st) not in _ENGINE_FN_CACHE):
                # Adopt the prewarmed config instead of compiling the
                # natural one (surplus slots/capacity cost ms; a
                # compile costs seconds).
                if self._prewarm_thread is not None:
                    self._prewarm_thread.join()
                    self._prewarm_thread = None
                st = pw
        Ncap = st.Ncap
        # Two-tier drain: only worthwhile when the batch refills slots
        # (N > B), the batch is big enough that tail iterations are
        # expensive, and (auto mode) the slot-pool simulation predicts
        # a straggler tail long enough to beat the redispatch overhead
        # (_drain_tail_span; drain_enabled == "always" skips the
        # simulation for A/B runs).  The drain dispatch itself runs to
        # completion.
        drain = 0
        if drain_on and N > st.B and st.B >= 256:
            if drain_on == "always":
                drain = st.B // 4
            else:
                costs = (self.queries.lengths[bid]
                         // max(1, st.ET) + 2)
                tail, total = _drain_tail_span(costs, st.B)
                if (tail >= DRAIN_MIN_TAIL_ITERS
                        and tail >= DRAIN_MIN_TAIL_FRAC * total):
                    drain = st.B // 4
        key = self._key(st)
        fn = _ENGINE_FN_CACHE.get(key)
        if fn is None:
            ENGINE_COMPILE_LOG.append(dict(
                kind="engine", Ncap=Ncap, B=st.B, T=st.T,
                tbfmt=st.tbfmt, n_calls=N))
            fn = _ENGINE_FN_CACHE[key] = _make_engine_fn(st)

        def pad(x, fill=0):
            return np.concatenate(
                [x.astype(np.int32),
                 np.full(Ncap - N, fill, np.int32)])

        g4 = self._split_offsets(self._g_start_all[rid], self._GP_G)
        q4 = self._split_offsets(self.queries.starts[bid], self._GP_Q)
        cpad = np.concatenate(
            [cstate.astype(np.int32),
             np.zeros((Ncap - N, 16), np.int32)])
        out = fn(
            np.int32(N), np.int32(drain), self._gconcat, self._qflat,
            pad(rid), pad(qid), pad(comp),
            *[pad(x) for x in g4],
            pad(self.genome.piece_lengths[rid].astype(np.int32)),
            *[pad(x) for x in q4],
            pad(self.queries.lengths[bid].astype(np.int32)),
            cpad)
        return out, st, drain

    def run_async(self, calls: GactCalls, complement, bank_ids=None):
        """Dispatch the whole batch; returns a handle for finish().

        The device computes while the host proceeds (e.g. seeding the
        other strand); only finish() blocks on the transfer.

        complement: bool for a single-strand batch, or an [N] array for
        merged-strand batches.  bank_ids (default query_id) indexes the
        query bank when it differs from the record read id (merged
        forward+revcomp banks).
        """
        N = len(calls)
        if N == 0:
            return None
        rid = calls.ref_id.astype(np.int64)
        qid = calls.query_id.astype(np.int64)
        bid = qid if bank_ids is None else np.asarray(bank_ids,
                                                     dtype=np.int64)
        comp = np.broadcast_to(
            np.asarray(complement, dtype=np.int32), (N,)).copy()
        cs = self._fresh_state(calls.ref_pos, calls.query_pos)
        out, st, drain = self._dispatch(rid, qid, bid, comp, cs,
                                        self.drain_enabled)
        return (out, st, drain, (rid, qid, bid, comp))

    @staticmethod
    def _decode(records, nrec) -> list[OverlapRecord]:
        out = []
        for row in np.asarray(records[: int(nrec)]):
            out.append(OverlapRecord(
                int(row[0]), int(row[1]), int(row[2]), int(row[3]),
                int(row[4]), int(row[5]), int(row[6]), bool(row[7]),
                int(row[8]), int(row[9])))
        return out

    def finish(self, handle) -> list[OverlapRecord]:
        """Block on a run_async handle, decode records, and — when the
        dispatch drain-stopped early — re-dispatch the unfinished calls
        into a smaller-B engine resumed from the exported state."""
        if handle is None:
            return []
        out, st, drain, meta = handle
        records_d, nrec_d, state_d, iters_d, act_d, cdone_d = out
        records, nrec, cdone = jax.device_get(
            (records_d, nrec_d, cdone_d))
        recs = self._decode(records, nrec)
        self.last_iters, self.last_active_sum = (
            int(jax.device_get(iters_d)), int(jax.device_get(act_d)))
        self.last_drain_redispatches = 0
        # Only fetch the per-call state when the dispatch actually
        # stopped early (cheap scalar check; a completed loop has
        # calls_done == n_calls and nothing to resume).
        while drain and int(cdone) < len(meta[0]):
            rid, qid, bid, comp = meta
            state = np.asarray(jax.device_get(state_d))[: len(rid)]
            undone = state[:, 8] == 0
            if not undone.any():
                break
            idx = np.flatnonzero(undone)
            meta = (rid[idx], qid[idx], bid[idx], comp[idx])
            # Straggler tier: the natural small-B engine when it is
            # already compiled; otherwise (cold process) reuse the
            # parent's compiled config — a few ms of surplus-slot cost
            # against a fresh engine compile.
            if self._key(self._natural_static(len(idx))) not in \
                    _ENGINE_FN_CACHE:
                ovr = st
            else:
                ovr = None
            (records_d, nrec_d, state_d, it_d, ac_d, cdone_d), st, \
                drain = self._dispatch(*meta, state[idx], False,
                                       st_override=ovr)
            records, nrec, cdone = jax.device_get(
                (records_d, nrec_d, cdone_d))
            recs += self._decode(records, nrec)
            self.last_iters += int(jax.device_get(it_d))
            self.last_active_sum += int(jax.device_get(ac_d))
            self.last_drain_redispatches += 1
        return recs


def balance_calls(costs: np.ndarray, nd: int) -> list[np.ndarray]:
    """Cost-aware call assignment: greedy LPT (longest job first onto
    the least-loaded device) with per-device counts capped at
    ceil(N/nd), so the shard_map's fixed per-device capacity stays
    minimal while one device never collects all the long-extension
    calls.  Returns nd index arrays (a partition of arange(len(costs))).
    """
    import heapq

    n = len(costs)
    cap = -(-n // nd) if n else 0
    order = np.argsort(-np.asarray(costs), kind="stable")
    heap = [(0, d) for d in range(nd)]
    heapq.heapify(heap)
    out: list[list[int]] = [[] for _ in range(nd)]
    spill: list[tuple[int, int]] = []
    for idx in order:
        while True:
            load, d = heapq.heappop(heap)
            if len(out[d]) < cap:
                break
            spill.append((load, d))
        out[d].append(int(idx))
        heapq.heappush(heap, (load + int(costs[idx]), d))
        for it in spill:
            heapq.heappush(heap, it)
        spill.clear()
    return [np.asarray(x, dtype=np.int64) for x in out]


class ShardedGactEngine(DeviceGactEngine):
    """Mesh-sharded whole-batch engine: call shards run independent
    slot pools on every local device (shard_map; banks replicated, no
    cross-device traffic — each device's while_loop trips its own
    count).  The single-process multi-chip rung between the one-chip
    engine and per-host process parallelism (parallel/distributed.py).

    Calls are distributed cost-aware (balance_calls with the query
    span as the tile-count estimate), not as contiguous blocks: the
    dispatch returns when the slowest device finishes, so skewed read
    lengths would otherwise stall the whole step on one device.
    """

    def __init__(self, *args, mesh, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self.n_dev = mesh.devices.size

    def run_async(self, calls: GactCalls, complement, bank_ids=None):
        from jax.sharding import PartitionSpec as P

        N = len(calls)
        if N == 0:
            return (None, None)
        nd = self.n_dev
        Ncap = _bucket(-(-N // nd))  # per-device call capacity
        B_eff = min(self._static.B, Ncap)
        st = dataclasses.replace(self._static, Ncap=Ncap, B=B_eff)
        key = ("sharded", dataclasses.astuple(st),
               self._gconcat.shape, self._qflat.shape, nd,
               self.mesh.axis_names)
        fn = _ENGINE_FN_CACHE.get(key)
        if fn is None:
            ENGINE_COMPILE_LOG.append(dict(
                kind="sharded", Ncap=Ncap, B=B_eff, T=st.T,
                tbfmt=st.tbfmt, n_calls=N))
            base = _make_engine_fn(st).__wrapped__
            axis = self.mesh.axis_names[0]

            def local(n_calls, gconcat, qflat, *arrs):
                # drain=0: sharded dispatches run to completion (the
                # two-tier drain is a single-device engine feature).
                rec, nrec, _state, _iters, _act, _cdone = base(
                    n_calls[0], jnp.int32(0), gconcat, qflat, *arrs)
                return rec, jnp.reshape(nrec, (1,))

            spec_c = P(axis)
            fn = _ENGINE_FN_CACHE[key] = jax.jit(jax.shard_map(
                local, mesh=self.mesh,
                in_specs=(spec_c, P(*(None,) * self._gconcat.ndim),
                          P(*(None,) * self._qflat.ndim))
                + (spec_c,) * 13 + (P(axis, None),),
                out_specs=(spec_c, spec_c), check_vma=False))

        rid = calls.ref_id.astype(np.int64)
        qid = calls.query_id.astype(np.int64)
        bid = qid if bank_ids is None else np.asarray(bank_ids,
                                                     dtype=np.int64)
        comp = np.broadcast_to(
            np.asarray(complement, dtype=np.int32), (N,))

        # Cost-aware placement: a call's tile count is bounded by its
        # query span, so query length is the load estimate.
        assign = balance_calls(
            self.queries.lengths[bid].astype(np.int64), nd)
        perm = np.concatenate(assign)
        slot_of = np.full(nd * Ncap, N, np.int64)  # N = pad row
        pos = 0
        n_local = np.zeros(nd, dtype=np.int32)
        for d, idxs in enumerate(assign):
            slot_of[d * Ncap: d * Ncap + len(idxs)] = perm[
                pos: pos + len(idxs)]
            n_local[d] = len(idxs)
            pos += len(idxs)

        def pad(x, fill=0):
            src = np.concatenate(
                [x.astype(np.int32), np.full(1, fill, np.int32)])
            return src[np.minimum(slot_of, len(x))].astype(np.int32)
        g4 = self._split_offsets(self._g_start_all[rid], self._GP_G)
        q4 = self._split_offsets(self.queries.starts[bid], self._GP_Q)
        cs = self._fresh_state(calls.ref_pos, calls.query_pos)
        cs_pad = np.concatenate([cs, np.zeros((1, 16), np.int32)])
        records_d, nrec_d = fn(
            n_local, self._gconcat, self._qflat,
            pad(rid), pad(qid), pad(comp),
            *[pad(x) for x in g4],
            pad(self.genome.piece_lengths[rid].astype(np.int32)),
            *[pad(x) for x in q4],
            pad(self.queries.lengths[bid].astype(np.int32)),
            cs_pad[np.minimum(slot_of, N)])
        return ((records_d, nrec_d), None)

    @staticmethod
    def finish(handle) -> list[OverlapRecord]:
        h, _ = handle
        if h is None:
            return []
        records_d, nrec_d = h
        records, nrec = jax.device_get((records_d, nrec_d))
        records = np.asarray(records)
        nrec = np.asarray(nrec).reshape(-1)
        nd = len(nrec)
        per = records.shape[0] // nd
        out = []
        for d in range(nd):
            for row in records[d * per: d * per + int(nrec[d])]:
                out.append(OverlapRecord(
                    int(row[0]), int(row[1]), int(row[2]), int(row[3]),
                    int(row[4]), int(row[5]), int(row[6]),
                    bool(row[7]), int(row[8]), int(row[9])))
        return out
