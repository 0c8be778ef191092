"""Streaming / long-audio connected decoding with a carried frontier.

The reference processes utterances whole, frame-by-frame in Python
(``/root/reference/sr/recognition/decode.py:97-124``) — nothing scales
to long audio.  Here the cost frontier ``[S]`` is the *only* state
carried between fixed-size chunks (SURVEY.md §5 long-context note: the
classical-ASR analog of ring attention is passing the DP frontier):

* each chunk is one jitted banded-Viterbi pass seeded with the carried
  frontier (its first column applies the frame-edge band relaxation
  against the previous chunk's last column — exactly what the
  monolithic scan would do);
* per-chunk int8 backpointer planes STAY ON DEVICE (1 byte per
  (frame, state)); ``push`` fetches nothing, so N pushes dispatch
  back-to-back and the wall-clock cost is the device compute plus the
  feature upload — not a per-chunk plane download;
* the final backtrace is ONE batched device call over the
  device-concatenated planes (``banded_backtrace_tb``) for all
  streams; only the ``[B, T]`` state/eps paths are fetched.

Ragged mid-stream pushes (a stream pushing a partial chunk before its
final one) leave holes the device concatenation cannot express; that
rare shape falls back to host compaction (bit-parity kept either way,
asserted in tests).

Chunked output is bit-identical to the monolithic decode (asserted in
tests).  Across devices the same frontier hand-off becomes a
``ppermute`` of ``[S]`` floats at chunk boundaries — the collective is
a few kilobytes regardless of audio length.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.graph import WordGraph
from speech_recognition_jax.models.hmm import HMMBank, bank_nll
from speech_recognition_jax.ops.viterbi_banded import (
    _CROSS,
    _EPS,
    MAX_BAND,
    BandedGraph,
    _band_relax,
    _cross_relax,
    _eps_relax,
    _eps_u_dtype,
    banded_arrays,
    banded_backtrace_tb,
)
from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["StreamingDecoder"]


@jax.jit
def _immortal_scan(org_stack, alive):
    """Compose chunk ancestor maps newest-to-oldest.

    ``org_stack [N, B, S]`` (chunk k's map: end-of-chunk state -> state
    at the last frame of chunk k-1), ``alive [B, S]`` ->
    packed ``[N, B, 2] int32`` where row j refers to boundary
    ``N-1-j``: ``[..., 0]`` = 1 when every live state shares one
    ancestor there, ``[..., 1]`` = that ancestor.  Packed so the host
    fetches ONE small array per flush attempt instead of two (each fetch
    is a device round trip)."""
    n, b, s = org_stack.shape
    ident = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))

    def f(a, org_k):
        a2 = jnp.take_along_axis(org_k, a, axis=1)
        mn = jnp.min(jnp.where(alive, a2, jnp.int32(s)), axis=1)
        mx = jnp.max(jnp.where(alive, a2, jnp.int32(-1)), axis=1)
        return a2, jnp.stack([(mn == mx).astype(jnp.int32), mn], axis=-1)

    _, packed = jax.lax.scan(f, ident, org_stack[::-1])
    return packed


@functools.partial(jax.jit, static_argnames=("eps_depth", "first_chunk",
                                              "track_org"))
def _chunk_step(
    bank: HMMBank,
    g: BandedGraph,
    frontier,
    feats_chunk,
    n_valid,
    eps_depth: int = 1,
    first_chunk: bool = False,
    track_org: bool = False,
):
    """Advance the frontier over one chunk.

    Returns ``(new frontier [S], bp8 [C, S] int8, eps_u [C, R])``, plus
    an ancestor map ``org [S] int32`` when ``track_org``: for each
    state, the state at the CHUNK START its best token descends from
    (the same value-carry pattern as the lattice pass's entry times) —
    the building block of incremental emission: composing chunk maps
    tells when every live hypothesis shares one ancestor, at which
    point the path up to that frame is immortal and can be flushed.

    For the first chunk the frontier is the graph's init cost (no band
    relaxation before the first emission); later chunks relax from the
    carried frontier first.
    """
    c, d = feats_chunk.shape
    frame_mask = jnp.arange(c) < n_valid
    nll = bank_nll(bank, feats_chunk, frame_mask)[:, g.bank_state]
    nll = jnp.minimum(nll, POS_INF)
    s = g.init_cost.shape[0]
    r = g.word_starts.shape[0]
    u_dtype = _eps_u_dtype(g.word_ends.shape[0])

    def shift_org(x, dd):
        if dd == 0:
            return x
        return jnp.concatenate([jnp.zeros((dd,), x.dtype), x[:-dd]])

    def column(base, d_sel, emis, prev, org):
        cost = jnp.minimum(base + emis, POS_INF)
        bp8 = d_sel
        eps_u = jnp.zeros((r,), u_dtype)
        if track_org:
            new_org = org
            for dd in range(1, MAX_BAND + 1):
                new_org = jnp.where(d_sel == jnp.int8(dd),
                                    shift_org(org, dd), new_org)
            if g.cross_src is not None:
                new_org = jnp.where(d_sel == jnp.int8(_CROSS),
                                    org[g.cross_src], new_org)
        else:
            new_org = org
        for _ in range(eps_depth):
            cost, better, better_r, origin_u = _eps_relax(cost, emis, g)
            bp8 = jnp.where(better, jnp.int8(_EPS), bp8)
            eps_u = jnp.where(better_r, origin_u.astype(u_dtype), eps_u)
            if track_org:
                # eps arrivals inherit the origin end-state's ancestor
                org_ends = new_org[g.word_ends]  # [L]
                arc_org = org_ends[origin_u]  # [R]
                dense = arc_org[g.start_pos]
                new_org = jnp.where(better, dense, new_org)
        return cost, bp8, eps_u, new_org

    def step(carry, inputs):
        prev, org = carry
        t, emis = inputs
        if first_chunk:
            # column 0 of the whole utterance: init cost enters directly,
            # no band relaxation before the first emission
            is_first = t == 0
            base1, d1 = _band_relax(prev, g.band)
            base1, d1 = _cross_relax(base1, d1, prev, g)
            base = jnp.where(is_first, frontier, base1)
            d_sel = jnp.where(is_first, jnp.int8(0), d1)
        else:
            base, d_sel = _band_relax(prev, g.band)
            base, d_sel = _cross_relax(base, d_sel, prev, g)
        cost, bp8, eps_u, new_org = column(base, d_sel, emis, prev, org)
        active = t < n_valid
        cost = jnp.where(active, cost, prev)
        if track_org:
            new_org = jnp.where(active, new_org, org)
        return (cost, new_org), (bp8, eps_u)

    ts = jnp.arange(c)
    org0 = jnp.arange(s, dtype=jnp.int32)  # identity at the chunk start
    (new_frontier, org_out), (bps, eps_us) = jax.lax.scan(
        step, (frontier, org0), (ts, nll))
    if track_org:
        return new_frontier, bps, eps_us, org_out
    return new_frontier, bps, eps_us


class StreamingDecoder:
    """Push-based long-audio decoder over a word graph.

    ``batch`` > 1 decodes that many independent streams in lock-step
    (each ``push`` takes ``[B, C, D]`` chunks with per-stream valid
    counts) — the production serving shape."""

    def __init__(self, bank: HMMBank, graph, chunk_frames: int = 256,
                 batch: int = 1, emit_incremental: bool = False,
                 window_chunks: int = 8, flush_every: int = 2):
        """``graph`` is a WordGraph or a LexGraph — streaming over the
        lexical tree works unchanged (the chunk step already relaxes
        cross-arc edges, and the ancestor maps follow cross/eps origins;
        only word recovery differs: trie leaves name words at epsilon
        re-entries instead of slot changes).

        ``emit_incremental``: bounded-memory mode for unbounded audio.
        Each chunk step also carries an ANCESTOR MAP (state -> the
        chunk-boundary state its best token descends from); when every
        live hypothesis of a stream shares one ancestor at some
        buffered boundary, the path up to that frame is IMMORTAL — it
        is a prefix of whatever the final backtrace will produce — so
        its words are emitted (``push`` returns them), its plane chunks
        are dropped, and device memory stays O(window + flush_every)
        regardless of audio length.  Emitted + final output is
        bit-identical to the monolithic decode (asserted in tests).
        Requires full-width pushes (the final push may be partial).

        ``flush_every``: attempt a flush every this many pushes once
        the window fills — the immortality scan's composition gathers
        and the per-flush path fetch are the incremental mode's
        wall-clock overhead, so amortizing them over a few pushes buys
        most of it back at the cost of `flush_every - 1` extra buffered
        chunks."""
        from speech_recognition_jax.models.lexgraph import LexGraph

        self.bank = bank
        self.graph = graph
        self._is_lex = isinstance(graph, LexGraph)
        self.bg = graph.banded if self._is_lex else banded_arrays(graph)
        self.chunk_frames = chunk_frames
        self.batch = batch
        self.emit_incremental = emit_incremental
        self.window_chunks = max(2, int(window_chunks))
        self.flush_every = max(1, int(flush_every))

        def make_step(first):
            return jax.vmap(
                lambda fr, x, n: _chunk_step(
                    self.bank, self.bg, fr, x, n,
                    eps_depth=self.graph.eps_depth, first_chunk=first,
                    track_org=self.emit_incremental,
                )
            )

        self._step_first = make_step(True)
        self._step_rest = make_step(False)
        self.reset()

    def reset(self):
        s = self.bg.init_cost.shape[0]
        self._frontier = jnp.broadcast_to(self.bg.init_cost, (self.batch, s))
        self._bp_chunks: List[jnp.ndarray] = []  # device-resident [B, C, S]
        self._eps_chunks: List[jnp.ndarray] = []  # device-resident [B, C, R]
        self._org_chunks: List[jnp.ndarray] = []  # [B, S] ancestor maps
        self._nv_history: List[np.ndarray] = []
        self._n_frames = np.zeros((self.batch,), dtype=np.int64)
        self._flushed = 0  # frames already emitted (uniform across streams)
        self._emitted: List[List[int]] = [[] for _ in range(self.batch)]
        self._prev_slot = [-1] * self.batch
        self._prev_wa = [-1] * self.batch  # lex: word id at the last frame
        self._since_flush = 0
        self._saw_partial = False
        self._first = True

    def _as_batch(self, a, extra_dims):
        if not isinstance(a, jnp.ndarray):
            a = np.asarray(a)
        if a.ndim == extra_dims:  # unbatched convenience for batch == 1
            a = a[None]
        return a

    def push(self, feats_chunk, n_valid=None):
        """Feed ``[C, D]`` (batch=1 convenience) or ``[B, C, D]`` feature
        frames; ``n_valid`` is a scalar or ``[B]`` for partial chunks.

        ``feats_chunk`` may be a device (jax) array — e.g. the output
        of the on-chip MFCC frontend — in which case the push is
        entirely device-side: no host copy in, nothing fetched out."""
        x = self._as_batch(feats_chunk, 2)
        c = x.shape[1]
        if n_valid is None:
            nv = np.full((self.batch,), c, np.int32)
        else:
            nv = np.broadcast_to(np.asarray(n_valid, np.int32), (self.batch,)).copy()
        step = self._step_first if self._first else self._step_rest
        outs = step(self._frontier, jnp.asarray(x, jnp.float32),
                    jnp.asarray(nv))
        if self.emit_incremental:
            if getattr(self, "_saw_partial", False):
                raise ValueError("emit_incremental needs full-width pushes "
                                 "(only the final chunk may be partial)")
            if int(nv.min()) != c:
                self._saw_partial = True
            self._frontier, bp8, eps_u, org = outs
            self._org_chunks.append(org)
        else:
            self._frontier, bp8, eps_u = outs
        self._first = False
        self._bp_chunks.append(bp8)  # stays on device
        self._eps_chunks.append(eps_u)
        self._nv_history.append(nv)
        self._n_frames += nv
        if (self.emit_incremental
                and len(self._bp_chunks) > self.window_chunks
                and int(nv.min()) == c):
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._since_flush = 0
                return self._try_flush()
        return [[] for _ in range(self.batch)]

    def _extend_words(self, i, states, eps_flags):
        """Continue the per-stream word state machine over a new path
        segment (same boundary rule as ``states_to_words``, with slot
        continuity carried across flushes)."""
        slot = np.asarray(self.graph.slot)
        labels = np.asarray(self.graph.slot_label)
        base_t = self._flushed
        new: List[int] = []
        for t, st in enumerate(states):
            s = int(slot[int(st)])
            gt = base_t + t
            boundary = s != self._prev_slot[i] or (gt > 0 and eps_flags[t])
            if boundary:
                w = int(labels[s])
                new.append(w)
                self._emitted[i].append(w)
            self._prev_slot[i] = s
        return new

    def _extend_words_lex(self, i, states, eps_flags):
        """Lexgraph twin of :meth:`_extend_words`: a word completes when
        a re-entry epsilon fires (the word id lives at the *previous*
        frame's leaf arc — ``lex_words_from_path`` semantics), so the
        machine carries the last frame's word-at-state across flushes.
        The word under construction at the segment end is NOT emitted
        (it completes at a later eps or at finish())."""
        wa = self.graph.arc_leaf_word[self.graph.arc_of_state[states]]
        base_t = self._flushed
        new: List[int] = []
        for t in range(len(states)):
            if eps_flags[t] and base_t + t > 0:
                w = int(self._prev_wa[i])
                new.append(w)
                self._emitted[i].append(w)
            self._prev_wa[i] = int(wa[t])
        return new

    def _try_flush(self):
        """Emit every word whose path is immortal and drop its planes.

        Composes the buffered ancestor maps newest-to-oldest; the most
        recent boundary where every live hypothesis of every stream
        shares one ancestor is a fixed point of the final backtrace, so
        the segment before it decodes NOW, bit-identically."""
        n = len(self._org_chunks)
        out: List[List[int]] = [[] for _ in range(self.batch)]
        packed = np.asarray(_immortal_scan(jnp.stack(self._org_chunks),
                                           self._frontier < POS_INF / 2))
        imm, sig = packed[..., 0], packed[..., 1]
        for j in range(n):
            k = n - 1 - j
            if k >= 1 and bool(imm[j].all()):
                break
        else:
            return out
        seg_bp = jnp.concatenate(self._bp_chunks[:k], axis=1).transpose(1, 2, 0)
        seg_eps = jnp.concatenate(self._eps_chunks[:k], axis=1).transpose(1, 2, 0)
        t_seg = int(seg_bp.shape[0])
        states_tb, eps_tb = banded_backtrace_tb(
            seg_bp, seg_eps, self.bg,
            jnp.asarray(sig[j].astype(np.int32)),
            jnp.full((self.batch,), t_seg, jnp.int32),
            eps_depth=self.graph.eps_depth)
        s_np = np.asarray(states_tb).T
        e_np = np.asarray(eps_tb).T
        extend = self._extend_words_lex if self._is_lex else self._extend_words
        for i in range(self.batch):
            out[i] = extend(i, s_np[i, :t_seg], e_np[i, :t_seg])
        del self._bp_chunks[:k]
        del self._eps_chunks[:k]
        del self._org_chunks[:k]
        del self._nv_history[:k]
        self._flushed += t_seg
        return out

    def best_cost(self):
        f = np.asarray(self._frontier)
        ends = np.asarray(self.bg.end_states)
        costs = np.min(f[:, ends] + np.asarray(self.bg.end_bonus)[None], axis=1)
        return float(costs[0]) if self.batch == 1 else costs

    def finish(self):
        """Backtrace over all pushed audio.

        All streams backtrace in ONE device call
        (:func:`banded_backtrace_tb` over the concatenated backpointer
        planes) — the round-1 per-frame host Python loop was O(T)
        interpreter work per stream, which defeated the purpose of a
        long-audio decoder.  Returns ``(word_ids, states, cost)`` for
        batch=1, or lists of per-stream results otherwise."""
        from speech_recognition_jax.decode.connected import states_to_words

        f = np.asarray(self._frontier)
        ends = np.asarray(self.bg.end_states)
        bonus = np.asarray(self.bg.end_bonus)

        s = f.shape[1]
        r = int(self.bg.word_starts.shape[0])
        best = np.argmin(f[:, ends] + bonus[None], axis=1)
        costs = (f[:, ends] + bonus[None])[np.arange(self.batch), best]
        end_states = ends[best].astype(np.int32)

        # the common serving shape — every pre-final push full-width for
        # every stream — concatenates on DEVICE: valid frames are
        # contiguous and trailing garbage is masked by n_frames, so no
        # plane ever leaves the device (only the [B, T] paths do)
        nf_bt = (self._n_frames - self._flushed).astype(np.int32)
        contiguous = all(
            int(nv.min()) == c.shape[1]
            for c, nv in zip(self._bp_chunks[:-1], self._nv_history[:-1]))
        if contiguous and self._bp_chunks:
            bp_tsb = jnp.concatenate(self._bp_chunks, axis=1).transpose(1, 2, 0)
            eps_tsb = jnp.concatenate(self._eps_chunks, axis=1).transpose(1, 2, 0)
        else:
            # ragged mid-stream pushes: host compaction (rare shape)
            t_max = int(self._n_frames.max()) if len(self._bp_chunks) else 0
            bp = np.zeros((self.batch, t_max, s), np.int8)
            epsp = np.zeros(
                (self.batch, t_max, r),
                np.asarray(self._eps_chunks[0]).dtype
                if self._eps_chunks else np.int8)
            for b in range(self.batch):
                rows = [np.asarray(c[b])[: int(nv[b])]
                        for c, nv in zip(self._bp_chunks, self._nv_history)]
                erows = [np.asarray(c[b])[: int(nv[b])]
                         for c, nv in zip(self._eps_chunks, self._nv_history)]
                t_total = int(self._n_frames[b])
                if rows:
                    bp[b, :t_total] = np.concatenate(rows, axis=0)
                    epsp[b, :t_total] = np.concatenate(erows, axis=0)
            bp_tsb = jnp.asarray(bp.transpose(1, 2, 0))
            eps_tsb = jnp.asarray(epsp.transpose(1, 2, 0))
        states_tb, eps_tb = banded_backtrace_tb(
            bp_tsb, eps_tsb,
            self.bg, jnp.asarray(end_states),
            jnp.asarray(nf_bt),
            eps_depth=self.graph.eps_depth,
        )
        states_all = np.asarray(states_tb).T  # [B, T]
        eps_all = np.asarray(eps_tb).T

        results = []
        for b in range(self.batch):
            t_total = int(nf_bt[b])
            states = states_all[b, :t_total].astype(np.int32)
            if self.emit_incremental:
                # residual segment continues the incremental machine;
                # emitted + residual == the monolithic word sequence
                if self._is_lex:
                    self._extend_words_lex(b, states, eps_all[b, :t_total])
                    # the in-flight word completes at the final frame
                    self._emitted[b].append(int(self._prev_wa[b]))
                else:
                    self._extend_words(b, states, eps_all[b, :t_total])
                words = list(self._emitted[b])
            elif self._is_lex:
                from speech_recognition_jax.models.lexgraph import (
                    lex_words_from_path,
                )

                words = lex_words_from_path(self.graph, states, t_total,
                                            eps_all[b, :t_total])
            else:
                words = states_to_words(self.graph, states, t_total,
                                        eps_all[b, :t_total])
            results.append((words, states, float(costs[b])))
        if self.batch == 1:
            return results[0]
        return results
