"""Large-vocabulary connected decoding over a lexical-tree graph.

The production big-vocabulary decoder (SURVEY.md §7 step 6's north
star): emissions are computed once against the *unit* bank (one GEMM
over n_units x n_states rows, independent of vocabulary size), gathered
to trie states, and relaxed by the banded kernel with cross-arc frame
edges (``models/lexgraph.py``).  Word identities are read off the path
with :func:`~speech_recognition_jax.models.lexgraph.lex_words_from_path`.

Compare the reference's ``main.py:35-81``: it enumerates one
full HMM copy of every word per sentence slot and runs an O(T x S^2)
Python relaxation; here shared prefixes share states and the per-frame
work is O(3S + R x L).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.hmm import HMMBank, bank_nll
from speech_recognition_jax.models.lexgraph import LexGraph
from speech_recognition_jax.ops.viterbi_banded import (
    BandedGraph,
    banded_backtrace,
    banded_backtrace_tb,
    viterbi_banded,
    viterbi_banded_tb,
)

__all__ = ["decode_lextree", "beam_decode_lextree"]


@functools.partial(jax.jit, static_argnames=("eps_depth", "beam_width"))
def _decode_lex_batch(bank: HMMBank, feats, n_frames, g: BandedGraph,
                      eps_depth: int = 1, beam_width: int = 0):
    """Batched lextree Viterbi: ``feats [B, T, D]`` ->
    ``(states [B, T], eps flags [B, T], costs [B])``."""
    b, t, d = feats.shape

    def emis(x, nf):
        frame_mask = jnp.arange(t) < nf
        return bank_nll(bank, x, frame_mask)

    if beam_width:
        def one(x, nf):
            nll = emis(x, nf)[:, g.bank_state]
            final, bp8, eps_u = viterbi_banded(
                nll, g, nf, eps_depth=eps_depth, beam_width=beam_width)
            end_costs = final[g.end_states] + g.end_bonus
            best = jnp.argmin(end_costs)
            states, eps_flags = banded_backtrace(
                bp8, eps_u, g, g.end_states[best], nf, eps_depth=eps_depth)
            return states, eps_flags, end_costs[best]

        return jax.vmap(one)(feats, n_frames)

    nll_bank = jax.vmap(emis)(feats, n_frames)  # [B, T, S_bank]
    nll_tb = jnp.transpose(nll_bank, (1, 2, 0))[:, g.bank_state, :]
    final, bp8, eps_u = viterbi_banded_tb(nll_tb, g, n_frames,
                                          eps_depth=eps_depth)
    end_costs = final[g.end_states, :] + g.end_bonus[:, None]  # [E, B]
    best = jnp.argmin(end_costs, axis=0)
    states, eps_flags = banded_backtrace_tb(
        bp8, eps_u, g, g.end_states[best], n_frames, eps_depth=eps_depth)
    costs = jnp.take_along_axis(end_costs, best[None, :], axis=0)[0]
    return states.T, eps_flags.T, costs


def decode_lextree(
    bank: HMMBank, lexg: LexGraph, feats, n_frames, beam_width: int = 0,
) -> Tuple[List[List[int]], np.ndarray]:
    """Decode a batch of utterances to word-id sequences over the trie.

    ``bank`` is the *unit* bank (the models ``lexg`` was built from, in
    the same order as its ``unit_trans``).  Returns ``(word_sequences,
    costs)`` with word ids indexing ``lexg.words``."""
    from speech_recognition_jax.decode.connected import _warn_no_path
    from speech_recognition_jax.models.lexgraph import (
        lex_words_from_path_batch,
    )

    states, eps_flags, costs = _decode_lex_batch(
        bank, jnp.asarray(feats), jnp.asarray(n_frames), lexg.banded,
        eps_depth=lexg.eps_depth, beam_width=beam_width)
    _warn_no_path(costs)
    seqs = lex_words_from_path_batch(lexg, np.asarray(states), n_frames,
                                     np.asarray(eps_flags))
    return seqs, np.asarray(costs)


@functools.partial(jax.jit, static_argnames=("k", "has_cross"))
def _beam_batch(bank: HMMBank, feats, n_frames, tables, k: int,
                has_cross: bool, bigram_cost=None, bigram_end=None):
    from speech_recognition_jax.ops.beam import beam_backtrace, beam_search

    b, t, d = feats.shape

    def one(x, nf):
        frame_mask = jnp.arange(t) < nf
        nll = bank_nll(bank, x, frame_mask)  # [T, U] compact bank
        fst, fco, fpd, tok_s, tok_p, tok_w = beam_search(
            nll, tables, nf, k, has_cross=has_cross, bigram_cost=bigram_cost)
        cost, words_rev = beam_backtrace(
            fst, fco, tok_p, tok_w, tables, nf, final_pred=fpd,
            bigram_cost=bigram_cost, bigram_end=bigram_end)
        return cost, words_rev

    return jax.vmap(one)(feats, n_frames)


def beam_decode_lextree(
    bank: HMMBank, lexg: LexGraph, feats, n_frames, k: int, lm=None,
) -> Tuple[List[List[int]], np.ndarray]:
    """Fixed-width token-passing beam decode (``ops/beam.py``): per
    frame only the k best tokens survive, and emissions are gathered
    per token from the compact unit bank — O(k) per frame instead of
    O(S), the big-vocabulary serving path.  Exact for k >= the
    reachable state count (asserted in tests); narrower beams are the
    classic approximation.

    ``lm`` (a BigramLM over word ids) enables predecessor-carried
    bigram scoring on ANY tree shape — the single-tree token-passing
    approximation (``ops/beam.py`` docstring).  Build ``lexg`` without
    an LM in that case (insertion/unigram smears compose fine)."""
    from speech_recognition_jax.ops.beam import beam_tables

    tables = beam_tables(lexg.banded, leaf_word=lexg.leaf_word)
    has_cross = lexg.banded.cross_src is not None and bool(
        (np.asarray(tables.child_starts) >= 0).any())
    bigram_cost = bigram_end = None
    if lm is not None:
        bigram_cost = jnp.asarray(
            np.concatenate([np.asarray(lm.cost, np.float32),
                            np.asarray(lm.start_cost, np.float32)[None]]))
        bigram_end = jnp.asarray(np.asarray(lm.end_cost, np.float32))
    costs, words_rev = _beam_batch(
        bank, jnp.asarray(feats), jnp.asarray(n_frames), tables, k, has_cross,
        bigram_cost=bigram_cost, bigram_end=bigram_end)
    words_rev = np.asarray(words_rev)
    seqs = []
    for i in range(words_rev.shape[0]):
        final_w = int(words_rev[i, 0])
        ws = [int(w) for w in words_rev[i, :0:-1] if w >= 0]
        seqs.append(ws + [final_w])
    from speech_recognition_jax.decode.connected import _warn_no_path

    _warn_no_path(costs)
    return seqs, np.asarray(costs)
