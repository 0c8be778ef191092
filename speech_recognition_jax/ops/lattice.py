"""Word-lattice generation + exact bigram rescoring over the lattice.

The production answer to "bigram LM x large vocabulary at production
speed" (SURVEY.md §1 L4 north star; the reference's LM file is empty,
``/root/reference/sr/langmodel/langmodel.py:1``): exact bigram
composition onto the decoding graph only works on flat vocabularies
(``models/lexgraph.py`` docstring), and predecessor-carried token
passing (``ops/beam.py``) is both approximate and slow.  Classical
production decoders instead generate a WORD LATTICE from the
unigram-pass tree decode and rescore it with the LM — that is what
this module does, array-first: the lattice is three dense per-frame
planes (no ragged arc lists), and the rescoring is one masked DP scan.

Pass 1 (:func:`viterbi_lattice_tb`): the banded lex Viterbi with an
extra ENTRY-TIME value plane ``tau [S, B]`` carried through every
band/cross/eps decision.  Per frame it emits the leaf-arc end costs
``S0 [T, L, B]`` and their entry times ``tau [T, L, B]`` — for each
(frame t, word w) the lattice arc "w spans (tau, t] with pass-1 score
S0".  Identity used by the rescorer (exact algebra on pass-1
quantities, no approximation): with re-entry cost Q[tau] =
wic + min_l' S0[tau, l'], the acoustic-only score of the arc is
``S0[t, l] - Q[tau]`` (what pass 1 charged the word's span, minus what
it charged at entry).

Pass 2 (:func:`lattice_rescore`): exact bigram Viterbi over the
lattice arcs::

    D[t, l]   = S0[t, l] - Q[tau] + H[tau, w(l)]      (tau > 0)
                S0[t, l] + start_cost[w(l)]           (tau == 0)
    H[t, w]   = min_w' (D[t, leaf(w')] + bigram(w', w))
    answer    = min_l (D[nf-1, l] + end_cost[w(l)])

The lattice (hence the rescoring) is exact up to the classical
word-pair approximation: each (t, leaf) keeps pass 1's single best
entry time.  Tests assert exactness against a brute-force bigram
oracle on separable cases and the sandwich bound (oracle <= rescored)
always.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.ops.viterbi_banded import (
    _eps_base_tb,
    _select_band,
    BandedGraph,
)
from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["viterbi_lattice_tb", "lattice_rescore", "lattice_words",
           "lattice_words_device", "decode_lextree_bigram",
           "rescore_backoff", "rescore_backoff_sliced"]


@functools.partial(jax.jit, static_argnames=("unroll",))
def viterbi_lattice_tb(nll_tb, g: BandedGraph, n_frames, unroll: int = 1):
    """Banded lex Viterbi (``viterbi_banded_tb`` semantics, eps_depth 1)
    that also carries per-token entry times and emits the lattice
    planes.  ``nll_tb [T, S, B]`` -> ``(final [S, B],
    ends_cost [T, L, B], ends_tau [T, L, B] int32)`` where L indexes
    ``g.word_ends`` (leaf arcs, slot order).  The graph must be a
    no-LM lex build (row-constant eps = word-insertion cost only) so
    the rescorer's Q-identity holds."""
    t_len, s, b = nll_tb.shape
    r = g.word_starts.shape[0]
    nll_tb = jnp.minimum(nll_tb, POS_INF)

    def shift_s(x, d, fill):
        if d == 0:
            return x
        pad = jnp.full((d, x.shape[-1]), fill, x.dtype)
        return jnp.concatenate([pad, x[:-d, :]], axis=0)

    def band_relax(prev):
        return _select_band(
            [g.band[d][:, None] + shift_s(prev, d, POS_INF)
             for d in range(3)])

    def tau_select(tau, d_sel):
        out = tau
        for d in (1, 2):
            out = jnp.where(d_sel == jnp.int8(d), shift_s(tau, d, 0), out)
        return out

    def step(carry, inputs):
        prev, tau, final, fin_tau = carry
        t, emis = inputs
        base, d_sel = band_relax(prev)
        tau_new = tau_select(tau, d_sel)
        if g.cross_src is not None:
            cand = jnp.minimum(prev[g.cross_src, :] + g.cross_cost[:, None],
                               POS_INF)
            take = cand <= base
            base = jnp.where(take, cand, base)
            tau_new = jnp.where(take, tau[g.cross_src, :], tau_new)
        cost = jnp.minimum(base + emis, POS_INF)
        # eps re-entry (depth 1)
        end_vals = cost[g.word_ends, :]  # [L, B]
        eb, origin_u = _eps_base_tb(end_vals, g)
        cand_re = jnp.minimum(eb + emis[g.word_starts, :], POS_INF)
        cand_dense = cand_re[g.start_pos, :]
        better = g.is_start[:, None] & (cand_dense < cost)
        cost = jnp.where(better, cand_dense, cost)
        tau_new = jnp.where(better, t.astype(jnp.int32), tau_new)

        active = t < n_frames  # [B]
        cost = jnp.where(active[None, :], cost, prev)
        tau_new = jnp.where(active[None, :], tau_new, tau)
        final = jnp.where((t == n_frames - 1)[None, :], cost, final)
        return ((cost, tau_new, final, fin_tau),
                (cost[g.word_ends, :], tau_new[g.word_ends, :]))

    init = jnp.broadcast_to(g.init_cost[:, None], (s, b))
    cost0 = jnp.minimum(init + nll_tb[0], POS_INF)
    # frame-0 eps (a word cannot complete at frame 0 on >=2-state
    # units, but keep the column semantics identical to the kernel)
    end_vals0 = cost0[g.word_ends, :]
    eb0, _ = _eps_base_tb(end_vals0, g)
    cand0 = jnp.minimum(eb0 + nll_tb[0][g.word_starts, :], POS_INF)
    cand0_dense = cand0[g.start_pos, :]
    better0 = g.is_start[:, None] & (cand0_dense < cost0)
    cost0 = jnp.where(better0, cand0_dense, cost0)
    tau0 = jnp.where(better0, 0, jnp.zeros((s, b), jnp.int32))

    ts = jnp.arange(1, t_len)
    init_final = jnp.where((n_frames == 1)[None, :], cost0, POS_INF)
    (last, tau_last, final, _), (ends, taus) = jax.lax.scan(
        step, (cost0, tau0, init_final, tau0), (ts, nll_tb[1:]),
        unroll=unroll)
    ends = jnp.concatenate([cost0[g.word_ends, :][None], ends], axis=0)
    taus = jnp.concatenate([tau0[g.word_ends, :][None], taus], axis=0)
    return final, ends, taus


class RescoreResult(NamedTuple):
    cost: jnp.ndarray  # [B] best rescored sentence cost
    best_leaf: jnp.ndarray  # [B] final leaf slot
    pred_w: jnp.ndarray  # [T, L, B] int32 argmin predecessor leaf (values
    #   are original leaf slots; columns are PERMUTED when lane_invperm
    #   is set — walkers index column lane_invperm[leaf])
    ends_tau: jnp.ndarray  # [T, L, B] int32 (pass-1 entry times, echoed)
    lane_invperm: jnp.ndarray = None  # [L] int32, set by the sliced-
    #   backoff path (see lattice_rescore backoff_counts)


@functools.partial(jax.jit, static_argnames=("block", "max_dur",
                                             "block_frames", "backoff_counts"))
def lattice_rescore(ends_cost, ends_tau, leaf_word, bigram_cost, start_cost,
                    end_cost, n_frames, block: int = 128,
                    max_dur: int = 128, backoff=None,
                    block_frames: int = 8, backoff_counts=None):
    """Exact bigram Viterbi over the lattice planes (one lax.scan).

    ``ends_cost/ends_tau [T, L, B]`` from :func:`viterbi_lattice_tb`;
    ``leaf_word [L]`` maps leaf slots to word ids (a permutation for
    dedicated-leaf tries); ``bigram_cost [V, V]``, ``start/end [V]``.
    The pass-1 word-insertion cost cancels exactly: pass 1 charged
    ``Q[tau] = wic + min_l' S0[tau, l']`` at entry and the rescorer
    re-charges the same wic (it is an acoustic-side penalty, kept
    identical across passes), so only ``min_l' S0`` is subtracted.
    Returns costs, final leaves, and the predecessor-word planes for
    :func:`lattice_words`.

    ``backoff``: optional ``(base_l [L], pred_idx [L, K], pred_cost
    [L, K])`` device arrays in LEAF-SLOT order (from
    :func:`langmodel.bigram.bigram_backoff` applied to the slot-
    permuted cost matrix).  When given, the per-frame O(L^2) min-plus
    recombination collapses to one global backoff min + a [L, K]
    sparse min (exact for backoff-structured LMs; add-k smoothing
    always is).  Between exact-cost ties the recorded predecessor can
    differ from the dense path.

    Layout and blocking: the scan runs in [B, L] orientation, leaves
    minor, so small serving batches still fill the vector width; every
    arg-selection is the min + first-minimum iota-compare idiom
    instead of a variadic argmin reduce; the sparse gather is K
    separate takes with an [L]-index vector each; and the scan is
    BLOCKED over ``block_frames`` frames so each sweep of the
    [Dmax, B, L] H-ring serves a whole block instead of one frame.
    Lookups into H rows computed WITHIN the current block ride a small
    sequential inner loop (a lattice arc spans at least one frame, so
    intra-block dependencies only reach backward).  The ring holds
    ``ceil(min(max_dur, T) / block_frames) * block_frames`` frames.

    ``backoff_counts`` (static tuple, from
    :func:`rescore_backoff_sliced`): real bigrams average few seen
    predecessors per word, so the dense-K takes move several times more
    elements than the LM has pairs.  With
    counts given, ``backoff`` is the sliced 5-tuple ``(base_l,
    pidx_src, pcost, pidx_val, invperm)``: TARGET lanes sorted by
    descending predecessor count (sources stay in original lane
    space), so the k-th take covers only the ``counts[k]``-lane prefix
    — exactly nnz gathered elements per frame — and the merged sparse
    H row is un-permuted with one lane take.  The predecessor plane
    stays in permuted columns (values are original leaf slots);
    walkers map columns through ``RescoreResult.lane_invperm``.  Costs
    are bit-identical to the dense-K form; recorded predecessors match
    except between exact-cost ties."""
    t_len, l, b = ends_cost.shape
    # reorder word-indexed LM arrays into leaf-slot order
    if backoff is None:
        big_ll = bigram_cost[leaf_word][:, leaf_word]  # [L, L] (w', w)
    start_l = start_cost[leaf_word]
    end_l = end_cost[leaf_word]

    f_blk = max(1, block_frames)
    t_pad = (t_len + f_blk - 1) // f_blk * f_blk
    # ring depth: a multiple of the frame block so each block's H rows
    # land as ONE contiguous [F, B, L] slice
    dmax = min(max_dur, t_pad)
    dmax = (dmax + f_blk - 1) // f_blk * f_blk
    ec_bl = jnp.transpose(ends_cost, (0, 2, 1))  # [T, B, L]
    et_bl = jnp.transpose(ends_tau, (0, 2, 1))
    if t_pad != t_len:
        # pad frames are inert: s0 = POS_INF everywhere, tau = 0
        ec_bl = jnp.pad(ec_bl, ((0, t_pad - t_len), (0, 0), (0, 0)),
                        constant_values=POS_INF)
        et_bl = jnp.pad(et_bl, ((0, t_pad - t_len), (0, 0), (0, 0)))
    q = jnp.min(ec_bl, axis=2)  # [Tp, B]
    iota_l = jnp.arange(l, dtype=jnp.int32)[None, :]  # [1, L]
    nf_last = jnp.clip(n_frames.astype(jnp.int32) - 1, 0, t_len - 1)

    def recombine(d):
        """H row + first-min predecessor from one D row [B, L].

        Returns ``(h_new [B, L] in ORIGINAL lane order, p_new [B, L])``;
        under ``backoff_counts`` the p columns are in PERMUTED order
        (values are original leaf slots either way)."""
        if backoff_counts is not None:
            base_l, pidx_src, pcost, pidx_val, invperm = backoff
            db = d + base_l[None, :]
            m_all = jnp.min(db, axis=1, keepdims=True)  # [B, 1]
            arg_all = jnp.min(
                jnp.where(db == m_all, iota_l, jnp.int32(l)), axis=1,
                keepdims=True)  # [B, 1] first minimum (original order)
            # sliced sparse chain: take k covers the counts[k]-lane
            # prefix of the permuted target space; lanes [counts[k+1],
            # counts[k]) are final after take k
            h_cur = p_cur = None
            pieces_h, pieces_p = [], []
            prev_n = None
            for ki, nk in enumerate(backoff_counts):
                cand = (jnp.take(d, pidx_src[:nk, ki], axis=1)
                        + pcost[None, :nk, ki])  # [B, nk]
                pv = jnp.broadcast_to(pidx_val[None, :nk, ki], cand.shape)
                if ki == 0:
                    h_cur, p_cur = cand, pv
                else:
                    if nk < prev_n:
                        pieces_h.append(h_cur[:, nk:prev_n])
                        pieces_p.append(p_cur[:, nk:prev_n])
                    hp, pp_ = h_cur[:, :nk], p_cur[:, :nk]
                    tk = cand < hp
                    h_cur = jnp.where(tk, cand, hp)
                    p_cur = jnp.where(tk, pv, pp_)
                prev_n = nk
            n1 = backoff_counts[0] if backoff_counts else 0
            fill_h = jnp.full((b, l - n1), POS_INF, d.dtype)
            fill_p = jnp.zeros((b, l - n1), jnp.int32)
            h_ext = jnp.concatenate(
                ([h_cur] if h_cur is not None else []) + pieces_h[::-1]
                + [fill_h], axis=1)  # [B, L] permuted columns
            p_ext = jnp.concatenate(
                ([p_cur] if p_cur is not None else []) + pieces_p[::-1]
                + [fill_p], axis=1)
            # H row back in original lane order (ONE lane take); the
            # predecessor plane stays permuted — walkers remap columns
            h_sp = jnp.take(h_ext, invperm, axis=1)
            take_h = h_sp < m_all
            h_new = jnp.minimum(jnp.where(take_h, h_sp, m_all), POS_INF)
            take_p = h_ext < m_all
            p_new = jnp.where(take_p, p_ext, arg_all).astype(jnp.int32)
            return h_new, p_new
        if backoff is not None:
            base_l, pidx, pcost = backoff
            kk = pidx.shape[1]
            db = d + base_l[None, :]
            m_all = jnp.min(db, axis=1, keepdims=True)  # [B, 1]
            arg_all = jnp.min(
                jnp.where(db == m_all, iota_l, jnp.int32(l)), axis=1,
                keepdims=True)  # [B, 1] first minimum
            # K separate lane takes (fast) + running first-min merge:
            # ties resolve to the smallest k, matching the round-3
            # argmin-over-k semantics
            h_sp = jnp.full((b, l), POS_INF, d.dtype)
            p_sp = jnp.zeros((b, l), jnp.int32)
            for ki in range(kk):
                cand = (jnp.take(d, pidx[:, ki], axis=1)
                        + pcost[None, :, ki])
                tk = cand < h_sp
                h_sp = jnp.where(tk, cand, h_sp)
                p_sp = jnp.where(tk, pidx[None, :, ki], p_sp)
            take_sp = h_sp < m_all
            h_new = jnp.minimum(jnp.where(take_sp, h_sp, m_all), POS_INF)
            p_new = jnp.where(take_sp, p_sp, arg_all).astype(jnp.int32)
        else:
            h_cols, p_cols = [], []
            for j0 in range(0, l, block):  # bound the [B, L, lb] transient
                blk = big_ll[:, j0 : j0 + block]
                sc = d[:, :, None] + blk[None, :, :]  # [B, L, lb]
                m = jnp.min(sc, axis=1)  # [B, lb]
                iota_src = jnp.arange(l, dtype=jnp.int32)[None, :, None]
                a = jnp.min(jnp.where(sc == m[:, None, :], iota_src,
                                      jnp.int32(l)), axis=1)
                h_cols.append(jnp.minimum(m, POS_INF))
                p_cols.append(a.astype(jnp.int32))
            h_new = jnp.concatenate(h_cols, axis=1)
            p_new = jnp.concatenate(p_cols, axis=1)
        return h_new, p_new

    iota_d = jnp.arange(dmax, dtype=jnp.int32)[:, None, None, None]

    def step(carry, inputs):
        hq_ring, d_fin = carry
        t0, s0_f, tau_f, q_f = inputs  # [F, B, L], [F, B, L], [F, B]
        tau_c = jnp.clip(tau_f, 0, t_pad - 1)
        slot = tau_c % dmax  # [F, B, L]
        ts = t0 + jnp.arange(f_blk)
        # block-start boundary: slots written by THIS block are
        # [t0 % dmax, t0 % dmax + F) — lookups for tau >= t0 are served
        # by the sequential inner loop instead.  H and Q are always
        # consumed together as H[tau] - Q[tau], so ONE combined ring
        # serves both (halves the select work).  The lookup is a single
        # masked sum-reduce over the ring axis, which XLA fuses into one
        # reduction.
        coarse = (tau_c < t0) & ((ts[:, None, None] - tau_c) <= dmax)
        sel = ((iota_d == slot[None]) & coarse[None]).astype(s0_f.dtype)
        hq = jnp.sum(hq_ring[:, None, :, :] * sel, axis=0)  # [F, B, L]
        hq = jnp.where(coarse, hq, POS_INF)

        h_rows, p_rows = [], []
        for f in range(f_blk):
            hq_f = hq[f]
            # intra-block lookups: H rows computed earlier in this block
            for ff in range(f):
                m = tau_c[f] == t0 + ff
                hq_f = jnp.where(m, h_rows[ff] - q_f[ff][:, None], hq_f)
            is_start = tau_f[f] <= 0
            d = jnp.where(is_start, s0_f[f] + start_l[None, :],
                          s0_f[f] + hq_f)  # [B, L]
            h_new, p_new = recombine(d)
            h_rows.append(h_new)
            p_rows.append(p_new)
            d_fin = jnp.where((ts[f] == nf_last)[:, None], d, d_fin)
        hq_ring = jax.lax.dynamic_update_slice(
            hq_ring,
            jnp.stack(h_rows) - q_f[:, :, None], (t0 % dmax, 0, 0))
        return (hq_ring, d_fin), jnp.stack(p_rows)

    h0 = jnp.full((dmax, b, l), POS_INF, ends_cost.dtype)
    d0 = jnp.full((b, l), POS_INF, ends_cost.dtype)
    n_blocks = t_pad // f_blk
    (_, d_at_end), p_all = jax.lax.scan(
        step, (h0, d0),
        (jnp.arange(n_blocks) * f_blk,
         ec_bl.reshape(n_blocks, f_blk, b, l),
         et_bl.reshape(n_blocks, f_blk, b, l),
         q.reshape(n_blocks, f_blk, b)))
    p_all = p_all.reshape(t_pad, b, l)[:t_len]

    final_costs = d_at_end + end_l[None, :]  # [B, L]
    best_leaf = jnp.min(
        jnp.where(final_costs == jnp.min(final_costs, axis=1, keepdims=True),
                  iota_l, jnp.int32(l)), axis=1)
    cost = jnp.min(final_costs, axis=1)
    inv_out = backoff[4] if backoff_counts is not None else None
    return RescoreResult(cost=cost, best_leaf=best_leaf.astype(jnp.int32),
                         pred_w=jnp.transpose(p_all, (0, 2, 1)),
                         ends_tau=ends_tau, lane_invperm=inv_out)


@functools.partial(jax.jit, static_argnames=("max_words",))
def lattice_words_device(pred_w, ends_tau, best_leaf, n_frames,
                         max_words: int = 128, lane_invperm=None):
    """Device-side word backtrace through the rescore DP: follows the
    (entry time, predecessor leaf) chain for up to ``max_words`` steps
    with tiny flattened gathers, so only a ``[max_words, B]`` leaf-id
    plane crosses the host link instead of the full ``[T, L, B]``
    ``pred_w``/``ends_tau`` planes (~400 MB at dictionary scale).

    Returns ``(leaves_rev [max_words, B] int32, -1 past the first word,
    n_words [B])``; reverse per stream and map through ``leaf_word``."""
    t_len, l, b = pred_w.shape
    flat_p = pred_w.reshape(-1, b)
    flat_t = ends_tau.reshape(-1, b)
    cols = jnp.arange(b)
    t0 = jnp.clip(n_frames.astype(jnp.int32) - 1, 0, t_len - 1)

    def step(carry, _):
        leaf, t, alive = carry
        out = jnp.where(alive, leaf, -1)
        lc = jnp.clip(leaf, 0, l - 1)
        idx = jnp.clip(t, 0, t_len - 1) * l + lc
        tau = flat_t[idx, cols]
        # sliced-backoff rescores store pred columns in permuted order
        col = lc if lane_invperm is None else lane_invperm[lc]
        nxt = flat_p[jnp.clip(tau, 0, t_len - 1) * l + col, cols]
        cont = alive & (tau > 0)
        return (jnp.where(cont, nxt, leaf), jnp.where(cont, tau, t),
                cont), out

    (_, _, _), leaves_rev = jax.lax.scan(
        step, (best_leaf.astype(jnp.int32), t0, n_frames > 0), None,
        length=max_words)
    return leaves_rev, jnp.sum(leaves_rev >= 0, axis=0)


def lattice_words(res: RescoreResult, leaf_word, n_frames) -> List[List[int]]:
    """Host word backtrace through the rescore DP: follow
    (entry time, predecessor leaf) chains from the best final leaf.
    O(#words) python per utterance."""
    pred = np.asarray(res.pred_w)  # [T, L, B]
    taus = np.asarray(res.ends_tau)
    leaf_word = np.asarray(leaf_word)
    best = np.asarray(res.best_leaf)
    nfs = np.asarray(n_frames)
    inv = (np.asarray(res.lane_invperm)
           if res.lane_invperm is not None else None)
    out: List[List[int]] = []
    t_len = pred.shape[0]
    for i in range(pred.shape[2]):
        words: List[int] = []
        t = min(int(nfs[i]) - 1, t_len - 1)
        leaf = int(best[i])
        for _ in range(t_len + 1):  # bounded walk
            words.append(int(leaf_word[leaf]))
            tau = int(taus[t, leaf, i])
            if tau <= 0:
                break
            # predecessor word of THIS word = argmin recorded for
            # H[tau, leaf]: stored at frame tau, column leaf (permuted
            # column under the sliced-backoff layout)
            col = leaf if inv is None else int(inv[leaf])
            leaf = int(pred[tau, col, i])
            t = tau
        out.append(words[::-1])
    return out


@functools.partial(jax.jit, static_argnames=("max_dur",))
def _lattice_truncation_count(ends_cost, ends_tau, n_frames,
                              max_dur: int = 128):
    """Number of LIVE lattice arcs whose span exceeds ``max_dur`` frames
    (the rescorer's H/Q rings silently drop them — the classical
    per-word duration cap).  One masked reduce, fetched as a scalar."""
    t_len = ends_cost.shape[0]
    ts = jnp.arange(t_len)[:, None, None]
    live = (ends_cost < POS_INF / 2) & (ts < n_frames[None, None, :])
    too_long = (ts - ends_tau) > max_dur
    return jnp.sum(live & too_long)


def decode_lextree_bigram(bank, lexg, lm, feats, n_frames,
                          max_dur: int = 128,
                          ) -> Tuple[List[List[int]], np.ndarray]:
    """Production bigram decode over a deep lexical tree: no-LM pass-1
    lattice (:func:`viterbi_lattice_tb`) + exact bigram rescoring over
    the lattice.  ``lexg`` must be built with NO lm/unigram
    (word_insertion_cost allowed, passed as ``wic``).

    ``max_dur``: per-word duration cap of the rescorer; arcs spanning
    more frames are dropped from the lattice, and a ``RuntimeWarning``
    reports how many live arcs that truncated.

    Returns ``(word sequences, rescored costs)``."""
    import warnings

    from speech_recognition_jax.models.hmm import bank_nll

    g = lexg.banded
    feats = jnp.asarray(feats)
    n_frames = jnp.asarray(n_frames)
    b, t, d = feats.shape

    def emis(x, nf):
        return bank_nll(bank, x, jnp.arange(t) < nf)

    nll_bank = jax.vmap(emis)(feats, n_frames)  # [B, T, U]
    nll_tb = jnp.transpose(nll_bank, (1, 2, 0))[:, g.bank_state, :]
    _, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, g, n_frames)
    n_trunc = int(_lattice_truncation_count(ends_cost, ends_tau, n_frames,
                                            max_dur=max_dur))
    if n_trunc:
        warnings.warn(
            f"lattice_rescore: {n_trunc} live lattice arc(s) span more "
            f"than max_dur={max_dur} frames and were dropped from the "
            "lattice; raise max_dur for slow speech / long words",
            RuntimeWarning, stacklevel=2)
    sliced = rescore_backoff_sliced(lm, lexg.leaf_word)
    if sliced is not None:
        bo_arrays, bo_counts = sliced
    else:  # no seen pairs / no backoff: legacy dense-K (or dense-LL) form
        bo_arrays, bo_counts = rescore_backoff(lm, lexg.leaf_word), None
    res = lattice_rescore(
        ends_cost, ends_tau, jnp.asarray(lexg.leaf_word),
        jnp.asarray(np.asarray(lm.cost, np.float32)),
        jnp.asarray(np.asarray(lm.start_cost, np.float32)),
        jnp.asarray(np.asarray(lm.end_cost, np.float32)),
        n_frames, max_dur=max_dur, backoff=bo_arrays,
        backoff_counts=bo_counts)
    # device chain walk: every unit dwells >= 1 frame, so a word takes
    # at least su frames and the chain is bounded
    su = lexg.n_states // lexg.n_arcs
    leaves_rev, n_words = lattice_words_device(
        res.pred_w, res.ends_tau, res.best_leaf, n_frames,
        max_words=min(t, t // max(su, 1) + 1),
        lane_invperm=res.lane_invperm)
    lw = np.asarray(lexg.leaf_word)
    lr = np.asarray(leaves_rev)
    nw = np.asarray(n_words)
    seqs = [lw[lr[: nw[i], i][::-1]].tolist() for i in range(b)]
    return seqs, np.asarray(res.cost)


def rescore_backoff(lm, leaf_word):
    """Leaf-slot-space backoff arrays for :func:`lattice_rescore`, or
    None when the LM has no row-constant backoff level (the rescorer
    then runs the dense O(L^2)/frame recombination)."""
    from speech_recognition_jax.langmodel.bigram import bigram_backoff

    leaf_word = np.asarray(leaf_word)
    big_ll = np.asarray(lm.cost)[leaf_word][:, leaf_word]
    bo = bigram_backoff(big_ll)
    if bo is None:
        return None
    return (jnp.asarray(bo.base), jnp.asarray(bo.pred_idx),
            jnp.asarray(bo.pred_cost))


def rescore_backoff_sliced(lm, leaf_word):
    """Sliced-take backoff for :func:`lattice_rescore`: ``(arrays,
    counts)`` with target lanes sorted by descending seen-predecessor
    count, or None when the LM has no backoff structure.

    ``arrays = (base_l [L], pidx_src [L, K] int32, pcost [L, K],
    pidx_val [L, K] int32, invperm [L] int32)``: row j of the pidx
    arrays describes the j-th MOST-connected leaf; ``pidx_src`` holds
    gather sources in ORIGINAL lane space, ``pidx_val`` the same
    predecessors as original leaf slots (the values stored in the pred
    plane).  ``counts[k]`` (static ints) = number of lanes with more
    than k seen predecessors, so per-frame take k covers exactly the
    ``counts[k]`` prefix and the gather volume is the LM's true nnz
    (avg ~1.2/word on real bigrams) instead of L*K."""
    bo = rescore_backoff(lm, leaf_word)
    if bo is None:
        return None
    base_l, pidx, pcost = (np.asarray(x) for x in bo)
    finite = pcost < POS_INF / 2
    # pack finite entries first within each row (stable), then sort
    # rows by descending count so per-k finite sets are prefixes
    order = np.argsort(~finite, axis=1, kind="stable")
    pidx = np.take_along_axis(pidx, order, axis=1)
    pcost = np.take_along_axis(pcost, order, axis=1)
    nnz = finite.sum(axis=1)
    perm = np.argsort(-nnz, kind="stable")
    invperm = np.argsort(perm)
    counts = tuple(int((nnz >= k + 1).sum()) for k in range(pidx.shape[1]))
    while counts and counts[-1] == 0:
        counts = counts[:-1]
    if not counts:
        return None  # no seen pairs: plain global backoff == dense K=0
    pidx_p = pidx[perm]
    arrays = (jnp.asarray(base_l), jnp.asarray(pidx_p, jnp.int32),
              jnp.asarray(pcost[perm], jnp.float32),
              jnp.asarray(pidx_p, jnp.int32),
              jnp.asarray(invperm, jnp.int32))
    return arrays, counts
