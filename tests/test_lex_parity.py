"""Lexical-tree decoding on the production path — the state-major
``viterbi_banded_tb`` scan + ``banded_backtrace_tb`` — against the dense
reference kernel (``ops/viterbi.py``) on deep, bigger, flat and
partially-referenced trees, with variable lengths."""

import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.langmodel.bigram import fit_bigram
from speech_recognition_jax.models.lexgraph import (
    build_lex_graph,
    lex_words_from_path,
)
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.ops.viterbi_banded import (
    banded_backtrace_tb,
    viterbi_banded_tb,
)
from tests.test_lextree_decode import lex_to_dense, ltr


def _deep(rng, unigram=False):
    words = ["aa", "ab", "abb", "ba", "b", "cab", "ca"]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng, skip=(i % 2 == 0)) for i in range(len(units))]
    uni = (rng.uniform(0.5, 3.0, len(words)).astype(np.float32)
           if unigram else None)
    return build_lex_graph(words, unit_trans, unit_ids, unigram_cost=uni,
                           word_insertion_cost=0.4), len(units) * 3


def _vocab(rng, n_words, max_len, seed, units="abcde", wic=0.4):
    units = list(units)
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng, skip=False) for _ in units]
    nprng = np.random.default_rng(seed)
    vocab = set()
    while len(vocab) < n_words:
        vocab.add("".join(nprng.choice(units, int(nprng.integers(2, max_len)))))
    return build_lex_graph(sorted(vocab), unit_trans, unit_ids,
                           word_insertion_cost=wic), len(units) * 3


def _flat_bigram(rng, words, n_states, seqs, wic):
    unit_ids = {ch: i for i, ch in enumerate(words)}
    unit_trans = [ltr(n_states, rng, skip=n_states > 4) for _ in words]
    lm = fit_bigram(seqs, len(words))
    return build_lex_graph(words, unit_trans, unit_ids, lm=lm,
                           word_insertion_cost=wic), len(words) * n_states


def _unused_trailing_units(rng):
    # vocabulary over units a, b of a 4-unit bank: the bank has rows
    # the trie never references
    units4 = list("abcd")
    unit_ids = {ch: i for i, ch in enumerate(units4)}
    unit_trans = [ltr(3, rng, skip=False) for _ in units4]
    lexg = build_lex_graph(["ab", "ba", "a", "bb"], unit_trans, unit_ids,
                           word_insertion_cost=0.3)
    assert int(np.asarray(lexg.banded.bank_state).max()) + 1 < 12
    return lexg, 12


TREES = {
    "deep": lambda rng: _deep(rng),
    "deep_unigram": lambda rng: _deep(rng, unigram=True),
    "bigger_200": lambda rng: _vocab(rng, 200, 7, seed=3, wic=0.5),
    "vocab_220": lambda rng: _vocab(rng, 220, 8, seed=7),
    "vocab_60": lambda rng: _vocab(rng, 60, 8, seed=7),
    "flat_digits_bigram": lambda rng: _flat_bigram(
        rng, list("123456789OZ"), 5,
        [[0, 1, 2, 3, 4], [10, 9, 8], [5, 6, 7, 0]], 0.2),
    "flat_bigram_4state": lambda rng: _flat_bigram(
        rng, list("12345"), 4, [[0, 1, 2], [4, 3], [2, 2, 0]], 0.2),
    "unused_trailing_units": _unused_trailing_units,
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_state_major_lex_matches_dense(rng, tree):
    lexg, n_bank = TREES[tree](rng)
    T, B = 23, 8
    e = rng.uniform(0, 5, (T, n_bank, B)).astype(np.float32)
    nf = np.array([T, 9, T, 4, 15, T, 1, 12], np.int32)
    g = lexg.banded
    bank_state = np.asarray(g.bank_state)
    fin, bp8, eps_u = viterbi_banded_tb(jnp.asarray(e)[:, bank_state, :], g,
                                        jnp.asarray(nf))
    ends = np.asarray(g.end_states)
    costs = np.asarray(fin)[ends] + np.asarray(g.end_bonus)[:, None]
    best = ends[np.argmin(costs, axis=0)]
    states, flags = banded_backtrace_tb(bp8, eps_u, g, jnp.asarray(best),
                                        jnp.asarray(nf))
    trans, eps, init = lex_to_dense(lexg)
    for i in range(B):
        n = int(nf[i])
        ref = viterbi(jnp.asarray(e[:, bank_state, i]), jnp.asarray(trans),
                      jnp.asarray(init), jnp.int32(n),
                      eps_trans=jnp.asarray(eps), eps_depth=lexg.eps_depth)
        np.testing.assert_array_equal(np.asarray(fin)[:, i],
                                      np.asarray(ref.final_cost))
        s_ref, f_ref = viterbi_backtrace(ref.bp, ref.eps_bp,
                                         jnp.int32(best[i]), jnp.int32(n),
                                         eps_depth=lexg.eps_depth)
        np.testing.assert_array_equal(np.asarray(states)[:n, i],
                                      np.asarray(s_ref)[:n])
        np.testing.assert_array_equal(np.asarray(flags)[:n, i],
                                      np.asarray(f_ref)[:n])
        assert (lex_words_from_path(lexg, np.asarray(states)[:, i], n,
                                    np.asarray(flags)[:, i])
                == lex_words_from_path(lexg, np.asarray(s_ref), n,
                                       np.asarray(f_ref)))


def _gmm_units(units, dim, seed, sep=6.0):
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    nprng = np.random.default_rng(seed)
    models, unit_trans, means = [], [], []
    for _ in units:
        p = random_gmm_hmm(nprng, n_states=3, n_mix=1, dim=dim, sep=sep)
        models.append(GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
        ))
        unit_trans.append(p["trans"])
        means.append(p["means"][:, 0, :])
    return HMMBank.stack(models), unit_trans, means, nprng


def test_decode_lextree_recovers_planted_words():
    """decode_lextree on GMM-bank features spelling known words returns
    those words."""
    from speech_recognition_jax.decode.lextree import decode_lextree

    units = list("abcd")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    bank, unit_trans, means, _ = _gmm_units(units, 6, seed=5)
    words = ["ab", "abc", "ba", "d", "ca"]
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           word_insertion_cost=0.5)
    paths = [["ab", "d"], ["ca", "ba"], ["abc"]]
    feats, nfs = [], []
    for seq in paths:
        rows = [m for w in seq for ch in w for m in means[unit_ids[ch]]
                for _ in range(3)]
        feats.append(np.asarray(rows, np.float32))
        nfs.append(len(rows))
    x = np.zeros((len(paths), max(nfs), 6), np.float32)
    for i, f in enumerate(feats):
        x[i, : len(f)] = f
    seqs, costs = decode_lextree(bank, lexg, x, np.asarray(nfs, np.int32))
    assert seqs == [[words.index(w) for w in seq] for seq in paths]
    assert np.all(np.isfinite(costs))


@pytest.mark.parametrize("full_beam", [False, True])
def test_decode_lextree_matches_dense_oracle(full_beam):
    """decode_lextree on random GMM-bank features — the state-major
    batch (beam_width 0) and the vmapped layout (a beam wide enough to
    keep every state) — equals the dense kernel's best cost per
    utterance."""
    from speech_recognition_jax.decode.lextree import decode_lextree
    from speech_recognition_jax.models.hmm import bank_nll

    units = list("abcd")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    bank, unit_trans, _, nprng = _gmm_units(units, 6, seed=5)
    lexg = build_lex_graph(["ab", "abc", "ba", "d", "ca"], unit_trans,
                           unit_ids, word_insertion_cost=0.5)
    feats = nprng.standard_normal((4, 22, 6)).astype(np.float32)
    nfs = np.array([22, 13, 7, 18], np.int32)
    seqs, costs = decode_lextree(bank, lexg, feats, nfs,
                                 beam_width=lexg.n_states if full_beam else 0)
    trans, eps, init = lex_to_dense(lexg)
    g = lexg.banded
    for i in range(4):
        nll = np.asarray(bank_nll(bank, jnp.asarray(feats[i])))
        ref = viterbi(jnp.asarray(nll[:, np.asarray(g.bank_state)]),
                      jnp.asarray(trans), jnp.asarray(init),
                      jnp.int32(nfs[i]), eps_trans=jnp.asarray(eps),
                      eps_depth=lexg.eps_depth)
        want = np.min(np.asarray(ref.final_cost)[np.asarray(g.end_states)]
                      + np.asarray(g.end_bonus))
        np.testing.assert_allclose(costs[i], want, rtol=1e-6)
        assert len(seqs[i]) >= 1
