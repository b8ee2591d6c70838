"""Vectorized traceback over a batch of direction matrices.

Semantics of AlignWithBT's traceback loop (reference align.cpp:185-231):
walk from the start cell until a ZERO op or until either axis has
consumed early_terminate steps; INSERT moves up (ref axis), DELETE moves
left (query axis), and their "gap-open won" flag at the *current* cell
switches the next state to MATCH.

All batch items step in lockstep inside a while_loop that exits as soon
as every item is done (real walks rarely exceed ~ET steps).  One
batched gather per step suffices: the INSERT/DELETE flag test uses the
*current* cell (whose byte we carry from the previous step), and only
the MATCH transition needs the newly entered cell — which is exactly
the one gather fetches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from darwin_tpu.ops.common import (GAP_OPEN_FLAG_D, GAP_OPEN_FLAG_I,
                                   MATCH_BIT)


@functools.partial(jax.jit, static_argnames=("early_terminate",))
def traceback_jax(dirm: jnp.ndarray, ref_len: jnp.ndarray,
                  query_len: jnp.ndarray, first: jnp.ndarray,
                  max_i: jnp.ndarray, max_j: jnp.ndarray,
                  *, early_terminate: int):
    """Args:
      dirm: [B, T, C] uint8 direction matrices; row r holds DP row r+1
        (DP row 0 and column 0 read as ZERO).
      ref_len, query_len: [B] tile lengths = anchor cell for non-first
        tiles (GACT always anchors at the corner, gact.cpp:93, 155).
      first: [B] bool; first tiles start at (max_i, max_j).

    Returns:
      ops: [S, B] uint8 op stream in walk order (0 = none), S = 2*ET-1.
      mbits: [S, B] bool — for MATCH ops, whether the cell's chars were
        equal (the dir byte's MATCH_BIT), so rescoring needs no
        sequence gathers; False for non-MATCH ops.
      i_steps, j_steps: [B] int32 ref/query steps consumed.
    """
    B, T, C = dirm.shape
    ET = early_terminate
    S = 2 * ET - 1
    dt = jnp.int32
    # Keep the dir matrix uint8 and widen only the gathered column:
    # widening [B, T*C] up front would materialize ~4x the matrix's
    # footprint in HBM every step (measured ~5 ms/step at B=2048,T=320).
    flat = dirm.reshape(B, T * C)

    def cell(i, j):
        # DP coordinates; row 0 / col 0 are implicit ZERO.  Clip
        # defensively: inactive walkers can sit at i == -1 after a
        # boundary MATCH, exactly like the reference's i_curr (which it
        # never reads again either).
        idx = jnp.clip(i - 1, 0, T - 1) * C + jnp.clip(j, 0, C - 1)
        v = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
        return jnp.where((i >= 1) & (j >= 1), v.astype(dt), 0)

    i0 = jnp.where(first, max_i, ref_len).astype(dt)
    j0 = jnp.where(first, max_j, query_len).astype(dt)
    val0 = cell(i0, j0)

    ops0 = jnp.zeros((S, B), jnp.uint8)
    zero = jnp.zeros((B,), dt)

    def cond(carry):
        s, ops, val, state, i, j, i_steps, j_steps = carry
        active = (state != 0) & (i_steps < ET) & (j_steps < ET)
        return (s < S) & jnp.any(active)

    def step(carry):
        s, ops, val, state, i, j, i_steps, j_steps = carry
        active = (state != 0) & (i_steps < ET) & (j_steps < ET)
        # One scatter carries both the op and, for MATCH ops, the
        # current cell's MATCH_BIT; they are split after the loop.
        rec = state + jnp.where(state == 3, val & MATCH_BIT, 0)
        ops = ops.at[s].set(jnp.where(active, rec, 0).astype(jnp.uint8))

        is_m = state == 3
        is_i = state == 2
        di = jnp.where(is_m | is_i, 1, 0)
        dj = jnp.where(is_m, 1, jnp.where(is_i, 0, 1))
        ni = jnp.where(active, i - di, i)
        nj = jnp.where(active, j - dj, j)

        # The cell just entered — needed for the MATCH transition now
        # and carried as "current cell" for the next step's flag tests.
        nval = cell(ni, nj)
        next_state = jnp.where(
            is_m, nval % 4,
            jnp.where(
                is_i,
                jnp.where((val & GAP_OPEN_FLAG_I) != 0, 3, 2),
                jnp.where((val & GAP_OPEN_FLAG_D) != 0, 3, 1)))

        state = jnp.where(active, next_state, state)
        val = jnp.where(active, nval, val)
        i_steps = i_steps + jnp.where(active, di, 0)
        j_steps = j_steps + jnp.where(active, dj, 0)
        return (s + 1, ops, val, state, ni, nj, i_steps, j_steps)

    state0 = val0 % 4
    carry = (jnp.int32(0), ops0, val0, state0, i0, j0, zero, zero)
    _, raw, _, _, _, _, i_steps, j_steps = jax.lax.while_loop(
        cond, step, carry)
    return raw & 3, raw >= MATCH_BIT, i_steps, j_steps


def pack_dir_words(dirm: jnp.ndarray) -> jnp.ndarray:
    """[B, T, C] uint8 dir matrix -> [B, T, C] int32 traceback words.

    words[b, r, c] = D(r,c) | D(r,c+1)<<8 | D(r-1,c)<<16 | D(r-1,c+1)<<24
    (missing neighbours read 0): the layout of the 2-step walker (traceback_packed_jax); the lax
    path and differential tests use it.
    """
    d = dirm.astype(jnp.int32)
    right = jnp.pad(d[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
    t = d + (right << 8)
    t_up = jnp.pad(t[:, :-1, :], ((0, 0), (1, 0), (0, 0)))
    return t + (t_up << 16)


def pack_dir_words6(dirm: jnp.ndarray) -> jnp.ndarray:
    """[B, T, C] uint8 dir matrix -> int32 5-bit-field traceback words.

    Dir bytes are 5 bits (op 0-3 | openD 4 | openI 8 | MATCH_BIT 16),
    so one int32 holds six cells:

      W[r,c] = D[r,c] | D[r,c+1]<<5 | D[r-1,c]<<10 | D[r-1,c+1]<<15
               | D[r-2,c-1]<<20 | D[r-3,c-2]<<25     (missing -> 0)

    Gathered at (i-1, j-1), the low four fields are the same 2x2 quad
    as pack_dir_words (current cell + all three move targets); the two
    extra fields are the MM and MMM diagonal cells (i-2,j-2) and
    (i-3,j-3), so a walker on a match run advances up to FOUR steps per
    gather (traceback_packed6_jax).  The CUDA kernel
    (ops/cuda_dp.py) emits this layout directly.
    """
    d = dirm.astype(jnp.int32)
    right = jnp.pad(d[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
    t5 = d + (right << 5)
    t5_up = jnp.pad(t5[:, :-1, :], ((0, 0), (1, 0), (0, 0)))
    w = t5 + (t5_up << 10)
    d2 = jnp.pad(d[:, :-2, :-1], ((0, 0), (2, 0), (1, 0)))
    d3 = jnp.pad(d[:, :-3, :-2], ((0, 0), (3, 0), (2, 0)))
    return w + (d2 << 20) + (d3 << 25)


@functools.partial(jax.jit,
                   static_argnames=("early_terminate", "compact_b"))
def traceback_packed6_jax(words: jnp.ndarray, ref_len: jnp.ndarray,
                          query_len: jnp.ndarray, first: jnp.ndarray,
                          max_i: jnp.ndarray, max_j: jnp.ndarray,
                          *, early_terminate: int, compact_b: int = 0):
    """Walk pack_dir_words6 words: 2-4 steps per gather.

    Steps A and B work exactly like traceback_packed_jax; when both
    moves were diagonal the word also carries the (i-2,j-2) byte, so a
    third step resolves in the same iteration, and a third diagonal
    move exposes (i-3,j-3) for a fourth.  Per-gather cost is unchanged
    (one [B] int32 gather); match-run-heavy walks need ~2x fewer
    gathers.

    Variable advance leaves up to two zero slots inside a lane's
    4-slot group; consumers treat zeros as skips (the scoring lookback
    in engine/scoring.py / device _score_ops spans them), and
    (ops != 0) subsequences, step counts, mbits and scores are
    identical to traceback_jax's.

    compact_b > 0 enables two-phase lane compaction (the "ET-early-
    drop" lever): the full-width loop exits as soon as <= compact_b
    walkers are still pending (walkers retire at a ZERO op or when
    either axis hits early_terminate, align.cpp:188), the survivors
    are compacted into a compact_b-lane batch, and the tail runs at
    that width — when the per-iteration [B] gather is bound by lane
    throughput, the tail iterations cost compact_b/B of the
    full-width ones.  The op stream is merged back
    into the survivors' original lanes at the slots after the phase-1
    groups, so outputs are bit-identical to compact_b=0.
    """
    B, T, C = words.shape
    ET = early_terminate
    S = 2 * ET - 1
    # Each iteration records a 4-slot group holding 2-4 ops, so a full
    # S-step walk may spread over 4*ceil(S/2) slots (worst case: every
    # group advances only 2).  The returned arrays keep this width;
    # consumers already treat zeros as skips.
    SP = 4 * (-(-(S + 1) // 2))
    if compact_b >= B or B * T * C >= 2 ** 31:
        compact_b = 0  # nothing to win / flat int32 indexing unsafe
    # The compact tail appends its groups after phase 1's.  The
    # longest-pending lane is active in every group of BOTH phases, so
    # the combined group count obeys the same ceil((S+1)/2) bound; one
    # spare group absorbs the phase boundary (each phase may end with
    # a partially-advancing group).
    SPo = SP + 4 if compact_b else SP
    dt = jnp.int32
    flat = words.reshape(B, T * C)

    def gather_word(i, j):
        idx = (jnp.clip(i - 1, 0, T - 1) * C
               + jnp.clip(j - 1, 0, C - 1))
        w = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
        return jnp.where((i >= 1) & (j >= 1), w, 0)

    def resolve(pstate, pval, cur_op):
        return jnp.where(
            pstate == 3, cur_op & 3,
            jnp.where(
                pstate == 2,
                jnp.where((pval & GAP_OPEN_FLAG_I) != 0, 3, 2),
                jnp.where(
                    pstate == 1,
                    jnp.where((pval & GAP_OPEN_FLAG_D) != 0, 3, 1),
                    0)))

    i0 = jnp.where(first, max_i, ref_len).astype(dt)
    j0 = jnp.where(first, max_j, query_len).astype(dt)
    ops0 = jnp.zeros((SPo, B), jnp.uint8)
    zero = jnp.zeros((B,), dt)

    def pending_of(carry):
        s, ops, pstate, pval, i, j, i_steps, j_steps = carry
        return (pstate != 0) & (i_steps < ET) & (j_steps < ET)

    def cond(carry):
        pending = pending_of(carry)
        npend = jnp.sum(pending.astype(dt))
        return (carry[0] + 1 < SPo) & (npend > compact_b)

    def substep(state, val, have, i, j, i_steps, j_steps,
                v_next, have_next):
        """One walk step at (i, j), whose state/byte are (state, val)
        when `have`; records the op, moves, and chains to the next
        cell's (state, val) ONLY when that cell's byte `v_next` is
        actually in the word (`have_next`) — otherwise the carry keeps
        describing this cell, exactly the 2-step walker's convention
        (the next iteration's gather resolves the rest)."""
        act = have & (state != 0) & (i_steps < ET) & (j_steps < ET)
        rec = jnp.where(
            act, state + jnp.where(state == 3, val & MATCH_BIT, 0), 0)
        is_m = state == 3
        is_i = state == 2
        di = jnp.where(is_m | is_i, 1, 0)
        dj = jnp.where(is_m, 1, jnp.where(is_i, 0, 1))
        ni = jnp.where(act, i - di, i)
        nj = jnp.where(act, j - dj, j)
        n_is = i_steps + jnp.where(act, di, 0)
        n_js = j_steps + jnp.where(act, dj, 0)
        v_next = jnp.where((ni >= 1) & (nj >= 1), v_next, 0)
        upd = act & have_next
        n_val = jnp.where(upd, v_next, val)
        n_state = jnp.where(upd, resolve(state, val, v_next), state)
        return (rec, act, is_m, n_state, n_val, upd,
                ni, nj, n_is, n_js)

    def make_step(gather):
        def step(carry):
            s, ops, pstate, pval, i, j, i_steps, j_steps = carry
            w = gather(i, j)
            val = (w >> 5) & 31            # current cell (i, j)
            state = resolve(pstate, pval, val)
            true_b = jnp.full(i.shape, True)

            # Step A: target byte always in the quad.
            is_m_a = state == 3
            is_i_a = state == 2
            vb1 = jnp.where(is_m_a, (w >> 10) & 31,
                            jnp.where(is_i_a, (w >> 15) & 31, w & 31))
            rec_a, act_a, _, st1, v1, have1, i1, j1, is1, js1 = substep(
                state, val, true_b, i, j, i_steps, j_steps, vb1, true_b)

            # Step B: cell2's byte is in-word only for the MM diagonal
            # (A and B both match moves).
            vb2 = (w >> 20) & 31
            rec_b, act_b, is_m_b, st2, v2, have2, i2, j2, is2, js2 = \
                substep(st1, v1, have1, i1, j1, is1, js1, vb2,
                        is_m_a & (st1 == 3))

            # Step C: cell3's byte needs the MMM diagonal.
            vb3 = (w >> 25) & 31
            rec_c, act_c, _, st3, v3, have3, i3, j3, is3, js3 = substep(
                st2, v2, have2, i2, j2, is2, js2, vb3, st2 == 3)

            # Step D: no further byte; the carry keeps cell3's
            # state/byte.
            rec_d, act_d, _, st4, v4, _, i4, j4, is4, js4 = substep(
                st3, v3, have3, i3, j3, is3, js3,
                jnp.zeros_like(i), jnp.zeros(i.shape, bool))

            group = jnp.stack([rec_a, rec_b, rec_c, rec_d]).astype(
                jnp.uint8)
            ops = jax.lax.dynamic_update_slice(
                ops, group, (s, jnp.int32(0)))
            return (s + 4, ops, st4, v4, i4, j4, is4, js4)
        return step

    carry = (jnp.int32(0), ops0, jnp.full((B,), 3, dt), zero,
             i0, j0, zero, zero)
    carry = jax.lax.while_loop(cond, make_step(gather_word), carry)
    if not compact_b:
        _, raw, _, _, _, _, i_steps, j_steps = carry
        return raw & 3, raw >= MATCH_BIT, i_steps, j_steps

    K = compact_b
    flatall = words.reshape(-1)
    pending1 = pending_of(carry)

    def finish_done(c):
        s, ops, pstate, pval, i, j, i_steps, j_steps = c
        return ops, i_steps, j_steps

    def finish_compact(c):
        s, ops, pstate, pval, i, j, i_steps, j_steps = c
        pending = (pstate != 0) & (i_steps < ET) & (j_steps < ET)
        # Stable compaction of the <= K pending lanes (cumsum rank +
        # one scatter; cheaper than an argsort over B lanes).
        lane = jax.lax.broadcasted_iota(dt, (B, 1), 0)[:, 0]
        rank = jnp.cumsum(pending.astype(dt)) - 1
        selbuf = jnp.full((K,), B, dt).at[
            jnp.where(pending, rank, K)].set(lane, mode="drop")
        valid = selbuf < B
        sel = jnp.minimum(selbuf, B - 1)
        cols = jnp.where(valid, selbuf, B)  # OOB -> dropped on merge

        ps2 = jnp.where(valid, pstate[sel], 0)
        base2 = sel * (T * C)

        def gather2(ii, jj):
            idx = (base2 + jnp.clip(ii - 1, 0, T - 1) * C
                   + jnp.clip(jj - 1, 0, C - 1))
            w = jnp.take(flatall, idx)
            return jnp.where((ii >= 1) & (jj >= 1), w, 0)

        carry2 = (jnp.int32(0), jnp.zeros((SPo, K), jnp.uint8),
                  ps2, pval[sel], i[sel], j[sel],
                  i_steps[sel], j_steps[sel])

        def cond2(c2):
            return (c2[0] + 1 < SPo) & jnp.any(pending_of(c2))

        _, ops2, _, _, _, _, is2, js2 = jax.lax.while_loop(
            cond2, make_step(gather2), carry2)

        # Merge: scatter the narrow op stream back to its lanes and
        # shift it to start at the first slot after phase 1's groups
        # (slot sets are disjoint: phase 1 wrote nothing at >= s, and
        # the combined group-count bound keeps the roll from wrapping
        # any nonzero row).
        wide = jnp.zeros((SPo, B), jnp.uint8).at[:, cols].set(
            ops2, mode="drop")
        ops = ops | jnp.roll(wide, s, axis=0)
        i_steps = i_steps.at[cols].set(is2, mode="drop")
        j_steps = j_steps.at[cols].set(js2, mode="drop")
        return ops, i_steps, j_steps

    raw, i_steps, j_steps = jax.lax.cond(
        jnp.any(pending1), finish_compact, finish_done, carry)
    return raw & 3, raw >= MATCH_BIT, i_steps, j_steps


@functools.partial(jax.jit, static_argnames=("early_terminate", "unroll"))
def traceback_packed_jax(words: jnp.ndarray, ref_len: jnp.ndarray,
                         query_len: jnp.ndarray, first: jnp.ndarray,
                         max_i: jnp.ndarray, max_j: jnp.ndarray,
                         *, early_terminate: int, unroll: int = 1):
    """Bit-identical to traceback_jax, two walk steps per iteration.

    One int32 gather at (i-1, j-1) of the packed word matrix (see
    pack_dir_words) yields the walker's current cell AND all three move
    targets, so each while_loop iteration — whose cost is dominated by
    a fixed ~20us loop overhead plus one [B] gather — advances two
    steps instead of one.  Returns the same (ops, mbits, i_steps,
    j_steps) as traceback_jax.

    unroll=U runs U gather+advance pairs per while_loop trip (2U walk
    steps), amortizing the fixed per-trip overhead; the op layout is
    unchanged (uniform advance), so outputs stay bit-identical for any
    U.  The early-exit check runs every U pairs — finished lanes just
    record zeros, exactly as in the U=1 loop.
    """
    B, T, C = words.shape
    ET = early_terminate
    S = 2 * ET - 1
    # Slot count rounded to the per-trip record width (2 per pair).
    SP = -(-(S + 1) // (2 * unroll)) * (2 * unroll)
    dt = jnp.int32
    flat = words.reshape(B, T * C)

    def gather_word(i, j):
        idx = (jnp.clip(i - 1, 0, T - 1) * C
               + jnp.clip(j - 1, 0, C - 1))
        w = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
        return jnp.where((i >= 1) & (j >= 1), w, 0)

    def resolve(pstate, pval, cur_op):
        # State on entering a cell, from the state/byte of the cell we
        # left: a MATCH consumes the entered cell's op bits; I/D turn
        # into MATCH when the left cell carries the gap-open-won flag
        # (align.cpp:205-226 semantics, as in traceback_jax).
        return jnp.where(
            pstate == 3, cur_op & 3,
            jnp.where(
                pstate == 2,
                jnp.where((pval & GAP_OPEN_FLAG_I) != 0, 3, 2),
                jnp.where(
                    pstate == 1,
                    jnp.where((pval & GAP_OPEN_FLAG_D) != 0, 3, 1),
                    0)))

    i0 = jnp.where(first, max_i, ref_len).astype(dt)
    j0 = jnp.where(first, max_j, query_len).astype(dt)
    ops0 = jnp.zeros((SP, B), jnp.uint8)
    zero = jnp.zeros((B,), dt)

    def cond(carry):
        s, ops, pstate, pval, i, j, i_steps, j_steps = carry
        pending = (pstate != 0) & (i_steps < ET) & (j_steps < ET)
        return (s + 1 < SP) & jnp.any(pending)

    def gather_pair(pstate, pval, i, j, i_steps, j_steps):
        """One gather, two walk steps; returns the two op records and
        the advanced walker state."""
        w = gather_word(i, j)
        val = (w >> 8) & 0xFF          # current cell (i, j)
        state = resolve(pstate, pval, val)

        # Sub-step A: the op taken at (i, j).
        act_a = (state != 0) & (i_steps < ET) & (j_steps < ET)
        rec_a = jnp.where(
            act_a, state + jnp.where(state == 3, val & MATCH_BIT, 0), 0)
        is_m = state == 3
        is_i = state == 2
        di = jnp.where(is_m | is_i, 1, 0)
        dj = jnp.where(is_m, 1, jnp.where(is_i, 0, 1))
        i1 = jnp.where(act_a, i - di, i)
        j1 = jnp.where(act_a, j - dj, j)
        i_steps1 = i_steps + jnp.where(act_a, di, 0)
        j_steps1 = j_steps + jnp.where(act_a, dj, 0)
        # The entered cell's byte, from the same word.
        v_moved = jnp.where(is_m, (w >> 16) & 0xFF,
                            jnp.where(is_i, (w >> 24) & 0xFF, w & 0xFF))
        v_moved = jnp.where((i1 >= 1) & (j1 >= 1), v_moved, 0)
        val1 = jnp.where(act_a, v_moved, val)
        state1 = jnp.where(act_a, resolve(state, val, v_moved), state)

        # Sub-step B: the op taken at (i1, j1).
        act_b = (state1 != 0) & (i_steps1 < ET) & (j_steps1 < ET)
        rec_b = jnp.where(
            act_b,
            state1 + jnp.where(state1 == 3, val1 & MATCH_BIT, 0), 0)
        is_m1 = state1 == 3
        is_i1 = state1 == 2
        di1 = jnp.where(is_m1 | is_i1, 1, 0)
        dj1 = jnp.where(is_m1, 1, jnp.where(is_i1, 0, 1))
        i2 = jnp.where(act_b, i1 - di1, i1)
        j2 = jnp.where(act_b, j1 - dj1, j1)
        i_steps2 = i_steps1 + jnp.where(act_b, di1, 0)
        j_steps2 = j_steps1 + jnp.where(act_b, dj1, 0)
        # The next pair resolves the state at (i2, j2) from the
        # state/byte at (i1, j1); act_b=False lanes carry state1 whose
        # re-resolution is never observed (their act_a stays False).
        return (rec_a, rec_b), (state1, val1, i2, j2, i_steps2,
                                j_steps2)

    def step(carry):
        s, ops, pstate, pval, i, j, i_steps, j_steps = carry
        recs = []
        walker = (pstate, pval, i, j, i_steps, j_steps)
        for _ in range(unroll):
            (rec_a, rec_b), walker = gather_pair(*walker)
            recs += [rec_a, rec_b]
        group = jnp.stack(recs).astype(jnp.uint8)
        ops = jax.lax.dynamic_update_slice(ops, group, (s, zero[0]))
        return (s + 2 * unroll, ops) + walker

    # pstate=MATCH, pval=0 makes the first resolve() yield the start
    # cell's own op bits, exactly traceback_jax's state0 = val0 % 4.
    carry = (jnp.int32(0), ops0, jnp.full((B,), 3, dt), zero,
             i0, j0, zero, zero)
    _, raw, _, _, _, _, i_steps, j_steps = jax.lax.while_loop(
        cond, step, carry)
    raw = raw[:S]
    return raw & 3, raw >= MATCH_BIT, i_steps, j_steps
