"""Connected-word decoding over a composed sausage graph.

Replaces ``main.py``'s connected-digit recognizer
(the reference's ``main.py:35-81``): it builds a 7-slot x
11-digit layered graph with NES states (393 states dense) and runs an
O(T x 393 x 393) Python Viterbi per utterance; here the epsilon-closed
graph from ``models/graph.py`` is decoded by the vmapped ``lax.scan``
kernel, with emissions gathered from one bank-wide GEMM.  Word
sequences are recovered from per-frame slot labels (consecutive
dedupe), the NES-split equivalent of ``main.py:63-67``.

Variable-length digit strings use the LM-weighted loop graph
(``models/graph.build_loop_graph``); the fixed-slot sausage is the
reference-parity mode (``main.py`` hard-codes 7 slots).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.graph import WordGraph, build_word_graph
from speech_recognition_jax.models.hmm import HMMBank, bank_nll
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.ops.viterbi_banded import (
    DEFAULT_UNROLL,
    BandedGraph,
    banded_arrays,
    banded_backtrace,
    banded_backtrace_tb,
    viterbi_banded,
    viterbi_banded_tb,
)

__all__ = [
    "connected_graph_arrays",
    "decode_connected",
    "states_to_words",
]


def connected_graph_arrays(bank: HMMBank, n_slots: int, vocab=None) -> WordGraph:
    """Build the n_slots-layer sausage over the given vocabulary
    (default: all models — ``main.py:35``)."""
    vocab = list(range(bank.n_models)) if vocab is None else list(vocab)
    model_trans = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    return build_word_graph(model_trans, [vocab] * n_slots)


@functools.partial(jax.jit, static_argnames=("eps_depth",))
def _decode_graph_batch(
    bank: HMMBank,
    feats,
    n_frames,
    trans,
    eps_trans,
    init_cost,
    end_states,
    end_bonus,
    bank_state,
    eps_depth: int = 1,
):
    """Batched graph Viterbi: returns (state paths [B, T], word-start
    epsilon flags [B, T], best costs [B])."""
    b, t, d = feats.shape

    def one(x, nf):
        frame_mask = jnp.arange(t) < nf
        nll_bank = bank_nll(bank, x, frame_mask)  # [T, N*S]
        nll = nll_bank[:, bank_state]  # [T, S_graph]
        res = viterbi(
            nll, trans, init_cost, nf, eps_trans=eps_trans, eps_depth=eps_depth
        )
        end_costs = res.final_cost[end_states] + end_bonus
        best = jnp.argmin(end_costs)
        end_state = end_states[best]
        states, eps_flags = viterbi_backtrace(
            res.bp, res.eps_bp, end_state, nf, eps_depth=eps_depth
        )
        return states, eps_flags, end_costs[best]

    return jax.vmap(one)(feats, n_frames)


@functools.partial(jax.jit, static_argnames=("eps_depth", "beam_width", "unroll"))
def _decode_banded_batch(bank: HMMBank, feats, n_frames, g: BandedGraph,
                         eps_depth: int = 1, beam_width: int = 0,
                         unroll: int = DEFAULT_UNROLL):
    """Banded fast path: O(3S + V^2) per frame instead of O(S^2).

    Without a beam the batch runs through the state-major ``[T, S, B]``
    scan (``viterbi_banded_tb``); the bank emissions are transposed
    *before* the gather to graph states (55 bank states instead of the
    385-state graph plane).  Beam pruning needs a per-item top-k along
    S, so ``beam_width > 0`` takes the vmapped layout.  Both layouts are
    bit-identical (asserted in tests).
    """
    b, t, d = feats.shape

    if beam_width:
        def one(x, nf):
            frame_mask = jnp.arange(t) < nf
            nll = bank_nll(bank, x, frame_mask)[:, g.bank_state]
            final, bp8, eps_u = viterbi_banded(nll, g, nf, eps_depth=eps_depth,
                                               beam_width=beam_width,
                                               unroll=unroll)
            end_costs = final[g.end_states] + g.end_bonus
            best = jnp.argmin(end_costs)
            states, eps_flags = banded_backtrace(
                bp8, eps_u, g, g.end_states[best], nf, eps_depth=eps_depth,
                unroll=unroll
            )
            return states, eps_flags, end_costs[best]

        return jax.vmap(one)(feats, n_frames)

    def emis(x, nf):
        frame_mask = jnp.arange(t) < nf
        return bank_nll(bank, x, frame_mask)

    nll_bank = jax.vmap(emis)(feats, n_frames)  # [B, T, S_bank]
    nll_tb = jnp.transpose(nll_bank, (1, 2, 0))[:, g.bank_state, :]
    final, bp8, eps_u = viterbi_banded_tb(nll_tb, g, n_frames,
                                          eps_depth=eps_depth,
                                          unroll=unroll)
    end_costs = final[g.end_states, :] + g.end_bonus[:, None]  # [E, B]
    best = jnp.argmin(end_costs, axis=0)  # [B]
    states, eps_flags = banded_backtrace_tb(
        bp8, eps_u, g, g.end_states[best], n_frames, eps_depth=eps_depth,
        unroll=unroll,
    )
    costs = jnp.take_along_axis(end_costs, best[None, :], axis=0)[0]
    return states.T, eps_flags.T, costs


def decode_connected(
    bank: HMMBank, graph: WordGraph, feats, n_frames, backend: str = "auto",
    drop_labels=None, beam_width: int = 0,
) -> Tuple[List[List[int]], np.ndarray]:
    """Decode a batch of utterances to word-id sequences.

    ``backend``: 'banded' (word-graph fast path), 'dense', or 'auto'
    (banded when the graph structure allows, else dense).
    ``beam_width`` > 0 enables per-frame rank pruning of the frontier.

    Returns ``(word_sequences, costs)`` where each sequence is the
    consecutive-deduped slot labels along the best path.
    """
    if backend in ("auto", "banded"):
        try:
            bg = banded_arrays(graph)
        except ValueError:
            if backend == "banded":
                raise
            bg = None
        if bg is not None:
            states, eps_flags, costs = _decode_banded_batch(
                bank, jnp.asarray(feats), jnp.asarray(n_frames), bg,
                eps_depth=graph.eps_depth, beam_width=beam_width,
            )
            _warn_no_path(costs)
            if not drop_labels:
                # production words-out: the whole wav -> word-ids chain
                # stays on device (states_to_words_device); only the
                # [B, W] id plane crosses the host boundary
                t_cap = states.shape[1]
                counts = np.bincount(np.asarray(graph.slot))
                min_dwell = max(1, int(counts[counts > 0].min()))
                words, n_words = states_to_words_device(
                    jnp.asarray(np.asarray(graph.slot, np.int32)),
                    jnp.asarray(np.asarray(graph.slot_label[graph.slot],
                                           np.int32)),
                    states, eps_flags, jnp.asarray(n_frames),
                    max_words=min(t_cap, t_cap // min_dwell + 1))
                words = np.asarray(words)
                n_words = np.asarray(n_words)
                seqs = [words[i, : n_words[i]].tolist()
                        for i in range(words.shape[0])]
                return seqs, np.asarray(costs)
            states = np.asarray(states)
            eps_flags = np.asarray(eps_flags)
            seqs = [
                states_to_words(graph, states[i], int(n_frames[i]), eps_flags[i],
                                drop_labels=drop_labels)
                for i in range(states.shape[0])
            ]
            return seqs, np.asarray(costs)

    states, eps_flags, costs = _decode_graph_batch(
        bank,
        jnp.asarray(feats),
        jnp.asarray(n_frames),
        jnp.asarray(graph.trans),
        jnp.asarray(graph.eps_trans),
        jnp.asarray(graph.init_cost),
        jnp.asarray(graph.end_states),
        jnp.asarray(graph.end_bonus),
        jnp.asarray(graph.bank_state),
        eps_depth=graph.eps_depth,
    )
    states = np.asarray(states)
    eps_flags = np.asarray(eps_flags)
    _warn_no_path(costs)
    seqs = [
        states_to_words(graph, states[i], int(n_frames[i]), eps_flags[i],
                        drop_labels=drop_labels)
        for i in range(states.shape[0])
    ]
    return seqs, np.asarray(costs)


def _warn_no_path(costs):
    """Reference parity: warn when no path reaches an end state
    (the reference's ``sr/recognition/decode.py:136-140``)."""
    from speech_recognition_jax.utils.numerics import POS_INF

    bad = np.asarray(costs) >= POS_INF / 2
    if np.any(bad):
        import warnings

        warnings.warn(
            f"decode: cannot find a path for {int(bad.sum())} utterance(s)"
        )


@functools.partial(jax.jit, static_argnames=("max_words",))
def states_to_words_device(slot_of_state, label_of_state, states, eps_flags,
                           n_frames, max_words: int):
    """Device-resident :func:`states_to_words` for a whole batch: the
    per-frame host Python loop becomes two small table lookups + a
    cumsum + one fused masked sum-reduce, all on the device.

    A word starts where the slot changes or a word-boundary epsilon
    fired (the reference's ``main.py:63-67`` NES-split semantics).
    Word w of stream b is the label at the w-th boundary frame,
    compacted with an iota-compare masked reduce (no gathers, no sort).

    Args:
      slot_of_state / label_of_state: ``[S]`` int32 tables
        (``graph.slot`` and ``graph.slot_label[graph.slot]``).
      states: ``[B, T]`` best-path state ids; eps_flags: ``[B, T]``.
      n_frames: ``[B]``; max_words: static output width.

    Returns ``(words [B, max_words] int32 with -1 past each end,
    n_words [B] int32)``.
    """
    states = jnp.asarray(states)
    b, t = states.shape

    def lut(idx, table):
        # small-table lookup as an iota-compare masked reduce over a
        # virtual [B, T, S] compare instead of a gather
        s = table.shape[0]
        eq = idx[:, :, None] == jnp.arange(s, dtype=idx.dtype)[None, None, :]
        return jnp.sum(jnp.where(eq, table[None, None, :], 0), axis=2)

    slot_t = lut(states, slot_of_state)   # [B, T]
    label_t = lut(states, label_of_state)
    prev = jnp.concatenate(
        [jnp.full((b, 1), -1, slot_t.dtype), slot_t[:, :-1]], axis=1)
    ti = jnp.arange(t)[None, :]
    valid = ti < jnp.asarray(n_frames)[:, None]
    eps = jnp.asarray(eps_flags) > 0
    boundary = valid & ((slot_t != prev) | ((ti > 0) & eps))
    idx = jnp.cumsum(boundary.astype(jnp.int32), axis=1) - 1
    w_iota = jnp.arange(max_words, dtype=jnp.int32)
    hit = boundary[:, :, None] & (idx[:, :, None] == w_iota[None, None, :])
    words = jnp.sum(jnp.where(hit, label_t[:, :, None], 0), axis=1)
    n_words = jnp.sum(boundary, axis=1).astype(jnp.int32)
    words = jnp.where(w_iota[None, :] < n_words[:, None], words, -1)
    return words.astype(jnp.int32), n_words


def states_to_words(
    graph: WordGraph,
    states: np.ndarray,
    n_frames: int,
    eps_flags: np.ndarray = None,
    drop_labels=None,
) -> List[int]:
    """Per-frame states -> word-id sequence: a new word starts when the
    slot changes *or* a word-boundary epsilon edge fired at that frame
    (the NES-split equivalent of ``main.py:63-67``; the epsilon flag is
    what separates repeated words in loop graphs).  ``drop_labels``
    filters non-lexical arcs (e.g. the silence model) from the output."""
    slots = graph.slot[states[:n_frames]]
    out: List[int] = []
    prev = -1
    for t, s in enumerate(slots):
        boundary = s != prev or (eps_flags is not None and t > 0 and eps_flags[t])
        if boundary:
            label = int(graph.slot_label[s])
            if not (drop_labels and label in drop_labels):
                out.append(label)
            prev = s
    return out
