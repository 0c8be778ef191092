"""True top-k token-passing beam search with frontier compaction.

The threshold beam in ``ops/viterbi_banded.py`` only *masks* pruned
states to POS_INF — every frame still does O(S) work and O(S) emission
gathers.  This kernel keeps the live frontier as K (state, cost)
tokens, so the per-frame work is O(K·(3 + C) + R·L·K-one-hot) and —
crucially for big-vocabulary lexical trees — emissions are gathered
only for candidate tokens, straight from the compact *unit-bank* row
``[U]``, never materializing the ``[T, S]`` graph-state plane
(SURVEY.md §7 hard part 5: "fixed-width masked top-k frontiers",
supplanting the reference's Python token dicts,
``/root/reference/sr/recognition/decode.py:45-68``).

Per frame, for each token at state s with cost c:

* band proposals to ``s+d`` (d = 0..2) at ``c + band[d, s+d]``;
* cross proposals to every child-arc start of s (static ``child_starts``
  table, fan-out padded to the trie's max branching);
* the merged, emission-added candidates feed the same-column epsilon
  re-entry: end-tokens reduce through the ``[R, L]`` block (one-hot
  column select + min over tokens), re-entering as R extra candidates.

Candidates are deduped by state with *dense-kernel tie-breaking*
(lowest origin state wins; epsilon loses ties) via a three-key
``lax.sort``, then top-K pruned.  With K >= the number of reachable
states the result is bit-identical to the exact banded kernel
(asserted in tests); with narrow K it is the classic beam
approximation (ties beyond capacity drop in candidate order).

Backpointers are compact per-frame planes ``[T, K]`` (token state,
previous-token index, ended-word id), so the backtrace is a pure index
chain — word identities fall out of the ``eps_word`` plane without any
state decoding.

Bigram on deep trees (``bigram_cost`` argument): each token carries its
predecessor word id; when a token exits a leaf of word v carrying
predecessor u, the epsilon hop adds ``bigram[u, v]`` (exactly the
"bigram at word-end -> root re-entry" placement — both words are known
there), and the re-entered token's predecessor becomes v.  Tokens
merging inside a shared prefix keep the min-cost predecessor — the
standard single-tree token-passing approximation (exact bigram needs a
tree copy per predecessor); with a flat tree or a pred-independent LM
it introduces no approximation beyond the beam itself.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.ops.viterbi_banded import MAX_BAND, BandedGraph
from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["BeamTables", "beam_tables", "beam_search", "beam_backtrace"]

_NO_WORD = -1


class BeamTables(NamedTuple):
    """Static per-state lookup tables for token expansion."""

    band: jnp.ndarray  # [MAX_BAND+1, S] arrival costs (band[d, s] from s-d)
    child_starts: jnp.ndarray  # [S, C] child-arc start states (-1 pad)
    child_costs: jnp.ndarray  # [S, C] cross-edge costs
    end_slot: jnp.ndarray  # [S] leaf slot l, or -1
    end_word: jnp.ndarray  # [S] word id ending at this state, or -1
    word_starts: jnp.ndarray  # [R]
    eps_block: jnp.ndarray  # [R, L]
    init_states: jnp.ndarray  # [R0] states with finite init cost
    init_costs: jnp.ndarray  # [R0]
    bank_state: jnp.ndarray  # [S] emission row per state
    end_states: jnp.ndarray  # [E]
    end_bonus: jnp.ndarray  # [E]
    n_states: int


def beam_tables(g: BandedGraph, leaf_word=None) -> BeamTables:
    """Build expansion tables from a (lex or word) banded graph.

    ``leaf_word [L]`` maps leaves to word ids (lex graphs); word graphs
    default to the start-slot index (= vocab position in loop graphs)."""
    if not np.array_equal(np.asarray(g.end_states), np.asarray(g.word_ends)):
        raise ValueError("token beam expects end_states == word_ends "
                         "(loop and lex graphs)")
    band = np.asarray(g.band)
    s = band.shape[1]
    cross_src = None if g.cross_src is None else np.asarray(g.cross_src)
    cross_cost = None if g.cross_cost is None else np.asarray(g.cross_cost)

    children = [[] for _ in range(s)]
    if cross_src is not None:
        for st in np.nonzero(cross_cost < POS_INF / 2)[0]:
            children[int(cross_src[st])].append(int(st))
    c_max = max(1, max(len(c) for c in children))
    child_starts = np.full((s, c_max), -1, np.int32)
    child_costs = np.full((s, c_max), POS_INF, np.float32)
    for src, cs in enumerate(children):
        for i, st in enumerate(cs):
            child_starts[src, i] = st
            child_costs[src, i] = cross_cost[st]

    ends = np.asarray(g.word_ends)
    end_slot = np.full(s, -1, np.int32)
    end_slot[ends] = np.arange(len(ends))
    end_word = np.full(s, _NO_WORD, np.int32)
    if leaf_word is None:
        leaf_word = np.arange(len(ends))
    end_word[ends] = np.asarray(leaf_word, np.int32)

    init = np.asarray(g.init_cost)
    init_states = np.nonzero(init < POS_INF / 2)[0].astype(np.int32)

    return BeamTables(
        band=jnp.asarray(band),
        child_starts=jnp.asarray(child_starts),
        child_costs=jnp.asarray(child_costs),
        end_slot=jnp.asarray(end_slot),
        end_word=jnp.asarray(end_word),
        word_starts=jnp.asarray(g.word_starts),
        eps_block=jnp.asarray(g.eps_block),
        init_states=jnp.asarray(init_states),
        init_costs=jnp.asarray(init[init_states]),
        bank_state=jnp.asarray(g.bank_state),
        end_states=jnp.asarray(g.end_states),
        end_bonus=jnp.asarray(g.end_bonus),
        n_states=s,
    )


def _merge_topk(cand_state, cand_cost, cand_tie, payload, k):
    """Dedup candidates by state (keep the (cost, tie)-first entry —
    dense argmin semantics) and prune to the best k by cost.

    Returns ``(state [k], cost [k], payload' [k, ...])`` with dropped
    slots as (-1, POS_INF)."""
    # three-key sort: state asc, then cost asc, then tie asc
    sorted_ = jax.lax.sort(
        (cand_state, cand_cost, cand_tie) + tuple(payload), num_keys=3)
    st, co, tie = sorted_[0], sorted_[1], sorted_[2]
    pay = sorted_[3:]
    first = jnp.concatenate([jnp.array([True]), st[1:] != st[:-1]])
    co = jnp.where(first, co, POS_INF)
    # top-k by cost (keep state/tie/payload aligned): sort by cost
    resorted = jax.lax.sort((co, st, tie) + tuple(pay), num_keys=1)
    co2, st2, tie2 = resorted[0], resorted[1], resorted[2]
    pay2 = resorted[3:]
    return (st2[:k], co2[:k], tie2[:k]) + tuple(p[:k] for p in pay2)


@functools.partial(jax.jit, static_argnames=("k", "has_cross"))
def beam_search(nll_bank, tables: BeamTables, n_frames, k: int,
                has_cross: bool = True, bigram_cost=None):
    """Token-passing beam over one utterance.

    Args:
      nll_bank: ``[T, U]`` compact unit-bank emission costs.
      n_frames: true length.
      k: static beam capacity (tokens per frame).
      has_cross: static; False skips the child-expansion loop for
        graphs without cross edges (loop graphs).
      bigram_cost: optional ``[V+1, V]`` word-boundary costs, row V =
        sentence-start costs.  Enables predecessor-carried token
        passing (module docstring): ``bigram_cost[u, v]`` is added when
        a token exits word v's leaf carrying predecessor u.  Build the
        graph WITHOUT an LM when using this.

    Returns ``(final_state [k], final_cost [k], final_pred [k],
    tok_state [T, k], tok_prev [T, k], tok_word [T, k])``: the final
    frontier (with each token's predecessor word) plus the per-frame
    token planes for :func:`beam_backtrace`.
    """
    t_len, u = nll_bank.shape
    r = tables.word_starts.shape[0]
    c_max = tables.child_starts.shape[1]
    r0 = tables.init_states.shape[0]
    n_vocab = 0 if bigram_cost is None else bigram_cost.shape[1]
    start_pred = jnp.int32(n_vocab)  # row V = sentence start

    def emis_at(states, nll_t):
        rows = tables.bank_state[jnp.clip(states, 0, tables.n_states - 1)]
        return jnp.where(states >= 0, nll_t[rows], POS_INF)

    def eps_expand(state, cost, prev_idx, pred, nll_t):
        """Same-column re-entry candidates from end tokens.

        For each re-entry slot r: best over tokens of
        ``eps[r, end_slot(token)] + cost (+ bigram[pred, word])`` — a
        one-hot column select — then + emission at the start state.
        Carries the source token's prev_idx (the eps hop consumes no
        frame) and its word id.
        """
        slot = tables.end_slot[jnp.clip(state, 0, tables.n_states - 1)]
        slot = jnp.where(state >= 0, slot, -1)
        word = tables.end_word[jnp.clip(state, 0, tables.n_states - 1)]
        l = tables.eps_block.shape[1]
        onehot = (slot[:, None] == jnp.arange(l)[None, :]).astype(jnp.float32)
        # [R, K] column select: exact (one operand 0/1)
        eps_cols = jax.lax.dot_general(
            tables.eps_block, onehot.T, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)
        exit_cost = cost
        if bigram_cost is not None:
            flat = jnp.clip(pred, 0, n_vocab) * n_vocab + jnp.clip(word, 0, n_vocab - 1)
            exit_cost = cost + jnp.where(
                word >= 0, bigram_cost.reshape(-1)[flat], POS_INF)
        scores = jnp.where(slot[None, :] >= 0, eps_cols + exit_cost[None, :],
                           POS_INF)
        # first-minimum over tokens in (cost, tie) order: tokens arrive
        # sorted by cost from _merge_topk, but dense semantics break eps
        # ties by lowest origin u = lowest end slot
        tie = jnp.where(slot >= 0, slot, jnp.int32(l))
        order = jnp.argsort(tie)
        scores_o = scores[:, order]
        besti_o = jnp.argmin(scores_o, axis=1)
        best = jnp.min(scores, axis=1)
        besti = order[besti_o]
        starts = tables.word_starts
        cand_cost = jnp.minimum(best + emis_at(starts, nll_t), POS_INF)
        cand_prev = prev_idx[besti]
        cand_word = tables.end_word[
            jnp.clip(state[besti], 0, tables.n_states - 1)]
        cand_pred = cand_word if bigram_cost is not None \
            else jnp.full((r,), start_pred)
        # eps loses ties to frame arrivals: tie rank above any state id
        cand_tie = jnp.full((r,), tables.n_states + 1, jnp.int32)
        return (starts.astype(jnp.int32), cand_cost, cand_tie, cand_prev,
                cand_word, cand_pred)

    def column(cand_state, cand_cost, cand_tie, cand_prev, cand_pred, nll_t):
        """Emission add -> merge -> eps -> final top-k."""
        cand_cost = jnp.minimum(cand_cost + emis_at(cand_state, nll_t),
                                POS_INF)
        cand_word = jnp.full(cand_state.shape, _NO_WORD, jnp.int32)
        st, co, tie, pr, wd, pd = _merge_topk(
            cand_state, cand_cost, cand_tie,
            (cand_prev, cand_word, cand_pred), k)
        e_st, e_co, e_tie, e_pr, e_wd, e_pd = eps_expand(st, co, pr, pd, nll_t)
        st2, co2, _, pr2, wd2, pd2 = _merge_topk(
            jnp.concatenate([st, e_st]),
            jnp.concatenate([co, e_co]),
            jnp.concatenate([tie, e_tie]),
            (jnp.concatenate([pr, e_pr]), jnp.concatenate([wd, e_wd]),
             jnp.concatenate([pd, e_pd])),
            k,
        )
        st2 = jnp.where(co2 < POS_INF / 2, st2, -1)
        return st2, co2, pr2, wd2, pd2

    # column 0: init tokens
    pad = k - r0 if k >= r0 else 0
    if k < r0:
        raise ValueError(f"beam k={k} smaller than {r0} init states")
    st0 = jnp.concatenate([tables.init_states.astype(jnp.int32),
                           jnp.full((pad,), -1, jnp.int32)])
    co0 = jnp.concatenate([tables.init_costs,
                           jnp.full((pad,), POS_INF, jnp.float32)])
    tie0 = jnp.where(st0 >= 0, st0, tables.n_states)
    pr0 = jnp.full((k,), -1, jnp.int32)
    pd_init = jnp.full((k,), start_pred)
    st0, co0, pr0, wd0, pd0 = column(st0, co0, tie0, pr0, pd_init,
                                     nll_bank[0])

    def expand(state, cost, pred):
        """Band + cross proposals from the current frontier."""
        ss, cs, ts, ps, pds = [], [], [], [], []
        idx = jnp.arange(k, dtype=jnp.int32)
        smax = tables.n_states
        for d in range(MAX_BAND + 1):
            tgt = jnp.where(state >= 0, state + d, -1)
            tgt = jnp.where(tgt < smax, tgt, -1)
            w = tables.band[d][jnp.clip(tgt, 0, smax - 1)]
            ss.append(tgt)
            cs.append(jnp.where(tgt >= 0, cost + w, POS_INF))
            ts.append(jnp.where(state >= 0, state, smax))  # origin state
            ps.append(idx)
            pds.append(pred)
        if has_cross:
            src = jnp.clip(state, 0, smax - 1)
            for c in range(c_max):
                tgt = jnp.where(state >= 0, tables.child_starts[src, c], -1)
                w = tables.child_costs[src, c]
                ss.append(tgt)
                cs.append(jnp.where(tgt >= 0, cost + w, POS_INF))
                ts.append(jnp.where(state >= 0, state, smax))
                ps.append(idx)
                pds.append(pred)
        return (jnp.concatenate(ss), jnp.concatenate(cs),
                jnp.concatenate(ts), jnp.concatenate(ps),
                jnp.concatenate(pds))

    def step(carry, inputs):
        state, cost, pred, final_state, final_cost, final_pred = carry
        t, nll_t = inputs
        cst, cco, ctie, cprev, cpred = expand(state, cost, pred)
        nst, nco, nprev, nwd, npred = column(cst, cco, ctie, cprev, cpred,
                                             nll_t)
        active = t < n_frames
        nst = jnp.where(active, nst, state)
        nco = jnp.where(active, nco, cost)
        npred = jnp.where(active, npred, pred)
        last = t == n_frames - 1
        final_state = jnp.where(last, nst, final_state)
        final_cost = jnp.where(last, nco, final_cost)
        final_pred = jnp.where(last, npred, final_pred)
        out = (jnp.where(active, nst, -1),
               jnp.where(active, nprev, -1),
               jnp.where(active, nwd, _NO_WORD))
        return (nst, nco, npred, final_state, final_cost, final_pred), out

    ts = jnp.arange(1, t_len)
    init_final_s = jnp.where(n_frames == 1, st0, -1)
    init_final_c = jnp.where(n_frames == 1, co0, POS_INF)
    (_, _, _, fst, fco, fpd), (tok_s, tok_p, tok_w) = jax.lax.scan(
        step, (st0, co0, pd0, init_final_s, init_final_c, pd0),
        (ts, nll_bank[1:]))
    tok_state = jnp.concatenate([st0[None], tok_s], axis=0)
    tok_prev = jnp.concatenate([pr0[None], tok_p], axis=0)
    tok_word = jnp.concatenate([wd0[None], tok_w], axis=0)
    return fst, fco, fpd, tok_state, tok_prev, tok_word


@jax.jit
def beam_backtrace(final_state, final_cost, tok_prev, tok_word,
                   tables: BeamTables, n_frames, final_pred=None,
                   bigram_cost=None, bigram_end=None):
    """Best-final-token selection + index-chain backtrace.

    With ``bigram_cost``/``bigram_end`` (pred-carried mode) the final
    token additionally pays ``bigram[pred, word] + end[word]`` — its
    own word-boundary cost was never applied (it never exited).

    Returns ``(best_cost, words_rev [T] int32)``: the ended-word ids
    along the best path in *reverse* order, padded with -1 — callers
    reverse and filter, then append the final token's word."""
    smax = tables.n_states
    slot = tables.end_slot[jnp.clip(final_state, 0, smax - 1)]
    is_end = (final_state >= 0) & (slot >= 0)
    # end bonus is indexed like end_states = word_ends (slot order)
    bonus = tables.end_bonus[jnp.clip(slot, 0, tables.end_bonus.shape[0] - 1)]
    if bigram_cost is not None:
        nv = bigram_cost.shape[1]
        word = tables.end_word[jnp.clip(final_state, 0, smax - 1)]
        flat = jnp.clip(final_pred, 0, nv) * nv + jnp.clip(word, 0, nv - 1)
        bonus = bonus + bigram_cost.reshape(-1)[flat]
        if bigram_end is not None:
            bonus = bonus + bigram_end[jnp.clip(word, 0, nv - 1)]
    tot = jnp.where(is_end, final_cost + bonus, POS_INF)
    best_idx = jnp.argmin(tot)
    best_cost = tot[best_idx]
    final_word = tables.end_word[
        jnp.clip(final_state[best_idx], 0, smax - 1)]

    t_len = tok_prev.shape[0]

    def step(carry, t):
        idx = carry
        active = (t < n_frames) & (idx >= 0)
        word = jnp.where(active, tok_word[t, jnp.maximum(idx, 0)], _NO_WORD)
        prev = jnp.where(active & (t > 0), tok_prev[t, jnp.maximum(idx, 0)], idx)
        return prev, word

    ts = jnp.arange(t_len - 1, -1, -1)
    _, words_rev = jax.lax.scan(step, best_idx.astype(jnp.int32), ts)
    return best_cost, jnp.concatenate([final_word[None], words_rev])
