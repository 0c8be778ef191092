"""Lexical-tree decoder: equivalence proofs and the big-vocab demo.

The lexgraph is defined to be *exactly* the loop graph with shared
prefixes (module docstring of ``models/lexgraph.py``), so these tests
assert bit-equality, not approximate WER:

* dense-oracle parity: the lexgraph's band/cross/eps arrays expanded to
  dense [S, S] matrices and decoded by ``ops.viterbi.viterbi``;
* flat vocabulary (the digit task shape) + bigram LM == the loop graph,
  array-for-array and decode-for-decode;
* multi-unit words (deep tree, shared prefixes) == the loop graph over
  concatenated unit HMMs, with and without the exact unigram smear;
* a 1,000-word vocabulary decodes correctly while the equivalent loop
  graph is asserted to be several times larger.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.langmodel.bigram import BigramLM, fit_bigram
from speech_recognition_jax.models.graph import build_loop_graph
from speech_recognition_jax.models.lexgraph import (
    build_lex_graph,
    lex_words_from_path,
)
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.ops.viterbi_banded import (
    MAX_BAND,
    banded_arrays,
    banded_backtrace,
    viterbi_banded,
)
from speech_recognition_jax.utils.numerics import POS_INF


def ltr(S, rng, skip=True):
    t = np.full((S, S), np.inf)
    for i in range(S):
        t[i, i] = rng.uniform(0.1, 1)
        if i + 1 < S:
            t[i + 1, i] = rng.uniform(0.1, 1)
        if skip and i + 2 < S:
            t[i + 2, i] = rng.uniform(0.5, 2)
    return t


def lex_to_dense(lexg):
    """Expand the lexgraph's banded arrays to dense [S, S] matrices for
    the reference dense kernel."""
    bg = lexg.banded
    s = lexg.n_states
    band = np.asarray(bg.band)
    trans = np.full((s, s), POS_INF, np.float32)
    for d in range(MAX_BAND + 1):
        idx = np.arange(d, s)
        trans[idx, idx - d] = band[d, idx]
    cross_src = np.asarray(bg.cross_src)
    cross_cost = np.asarray(bg.cross_cost)
    for st in np.nonzero(cross_cost < POS_INF / 2)[0]:
        trans[st, cross_src[st]] = np.minimum(
            trans[st, cross_src[st]], cross_cost[st])
    eps = np.full((s, s), POS_INF, np.float32)
    starts = np.asarray(bg.word_starts)
    ends = np.asarray(bg.word_ends)
    eps[np.ix_(starts, ends)] = np.asarray(bg.eps_block)
    return trans, eps, np.asarray(bg.init_cost)


def unit_emissions(rng, T, unit_trans):
    su = max(np.asarray(t).shape[0] for t in unit_trans)
    return rng.uniform(0, 5, (T, len(unit_trans) * su)).astype(np.float32), su


def concat_word_trans(word, unit_ids, unit_trans):
    """Concatenated word HMM: block-diagonal unit models + 0-cost
    end->start boundary step edges (the lexgraph's cross-edge cost)."""
    mats = [np.asarray(unit_trans[unit_ids[ch]], np.float64) for ch in word]
    n = sum(m.shape[0] for m in mats)
    out = np.full((n, n), np.inf)
    o = 0
    for i, m in enumerate(mats):
        k = m.shape[0]
        out[o : o + k, o : o + k] = m
        if i + 1 < len(mats):
            out[o + k, o + k - 1] = 0.0
        o += k
    return out


def loop_nll_for_words(e, words, unit_ids, unit_trans, su):
    """Gather unit-bank emissions to the concatenated loop graph's
    states (vocab order, unit-major within each word)."""
    cols = []
    for w in words:
        for ch in w:
            u = unit_ids[ch]
            k = np.asarray(unit_trans[u]).shape[0]
            cols.extend(u * su + j for j in range(k))
    return e[:, np.asarray(cols)]


@pytest.mark.parametrize("nf_frac", [1.0, 0.6])
def test_lexgraph_matches_dense_oracle(rng, nf_frac):
    words = ["ab", "abc", "ad", "b", "ba"]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng) for _ in units]
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           word_insertion_cost=0.3)
    trans, eps, init = lex_to_dense(lexg)

    T = 31
    nf = max(1, int(T * nf_frac))
    e, su = unit_emissions(rng, T, unit_trans)
    nll = e[:, np.asarray(lexg.banded.bank_state)]

    ref = viterbi(jnp.asarray(nll), jnp.asarray(trans), jnp.asarray(init),
                  jnp.int32(nf), eps_trans=jnp.asarray(eps), eps_depth=1)
    fin, bp8, eps_u = viterbi_banded(jnp.asarray(nll), lexg.banded,
                                     jnp.int32(nf))
    np.testing.assert_array_equal(np.asarray(fin), np.asarray(ref.final_cost))

    ends = np.asarray(lexg.banded.end_states)
    best = int(ends[np.argmin(np.asarray(fin)[ends])])
    s_ref, f_ref = viterbi_backtrace(ref.bp, ref.eps_bp, jnp.int32(best),
                                     jnp.int32(nf))
    s_lex, f_lex = banded_backtrace(bp8, eps_u, lexg.banded, jnp.int32(best),
                                    jnp.int32(nf))
    np.testing.assert_array_equal(np.asarray(s_ref)[:nf], np.asarray(s_lex)[:nf])
    np.testing.assert_array_equal(np.asarray(f_ref)[:nf], np.asarray(f_lex)[:nf])


def test_flat_vocab_is_the_loop_graph(rng):
    """Single-unit words (the 11-digit shape): the lexgraph IS the loop
    graph — same state enumeration, same arrays, same decode — with the
    exact bigram on the re-entry epsilon edges."""
    words = list("123456789OZ")
    unit_ids = {ch: i for i, ch in enumerate(words)}
    unit_trans = [ltr(5, rng) for _ in words]
    lm = fit_bigram([[0, 1, 2, 3, 4], [10, 9, 8], [5, 6, 7, 0]], len(words))

    lexg = build_lex_graph(words, unit_trans, unit_ids, lm=lm,
                           word_insertion_cost=0.2)
    gl = build_loop_graph(unit_trans, lm=lm, word_insertion_cost=0.2)
    bgl = banded_arrays(gl)

    np.testing.assert_array_equal(np.asarray(lexg.banded.band),
                                  np.asarray(bgl.band))
    np.testing.assert_allclose(np.asarray(lexg.banded.eps_block),
                               np.asarray(bgl.eps_block), rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(lexg.banded.init_cost),
                                  np.asarray(bgl.init_cost))
    np.testing.assert_array_equal(np.asarray(lexg.banded.word_starts),
                                  np.asarray(bgl.word_starts))
    np.testing.assert_array_equal(np.asarray(lexg.banded.word_ends),
                                  np.asarray(bgl.word_ends))
    np.testing.assert_array_equal(np.asarray(lexg.banded.end_bonus),
                                  np.asarray(bgl.end_bonus))
    assert np.all(np.asarray(lexg.banded.cross_cost) >= POS_INF / 2)
    np.testing.assert_array_equal(lexg.leaf_word, np.arange(len(words)))

    T = 40
    e, su = unit_emissions(rng, T, unit_trans)
    nll = e[:, np.asarray(lexg.banded.bank_state)]
    fin_lex, bp_lex, eu_lex = viterbi_banded(jnp.asarray(nll), lexg.banded,
                                             jnp.int32(T))
    fin_loop, bp_loop, eu_loop = viterbi_banded(jnp.asarray(nll), bgl,
                                                jnp.int32(T))
    np.testing.assert_array_equal(np.asarray(fin_lex), np.asarray(fin_loop))

    ends = np.asarray(bgl.end_states)
    bonus = np.asarray(bgl.end_bonus)
    best = int(ends[np.argmin(np.asarray(fin_loop)[ends] + bonus)])
    s1, f1 = banded_backtrace(bp_lex, eu_lex, lexg.banded, jnp.int32(best),
                              jnp.int32(T))
    s2, f2 = banded_backtrace(bp_loop, eu_loop, bgl, jnp.int32(best),
                              jnp.int32(T))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))

    from speech_recognition_jax.decode.connected import states_to_words

    w_loop = states_to_words(gl, np.asarray(s2), T, np.asarray(f2))
    w_lex = lex_words_from_path(lexg, np.asarray(s1), T, np.asarray(f1))
    assert w_lex == w_loop


@pytest.mark.parametrize("use_unigram", [False, True])
def test_deep_tree_matches_concatenated_loop(rng, use_unigram):
    """Multi-unit words with shared prefixes: the trie decode equals the
    loop graph over concatenated word HMMs — costs bit-equal, word
    sequences identical.  With ``use_unigram`` the [V] word costs are
    min-smeared down the tree and the loop graph carries them on its
    boundary edges (constant-row bigram), exercising the telescoping
    increments."""
    words = ["aa", "ab", "abb", "ba", "b", "cab"]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng, skip=(i % 2 == 0)) for i in range(len(units))]
    wic = 0.4

    unigram = rng.uniform(0.5, 3.0, len(words)).astype(np.float32) \
        if use_unigram else None
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           unigram_cost=unigram, word_insertion_cost=wic)

    word_trans = [concat_word_trans(w, unit_ids, unit_trans) for w in words]
    if use_unigram:
        # pred-independent word costs as a constant-row "bigram"
        lm = BigramLM(cost=np.tile(unigram, (len(words), 1)),
                      start_cost=unigram.copy(),
                      end_cost=np.zeros(len(words), np.float32))
        gl = build_loop_graph(word_trans, lm=lm, word_insertion_cost=wic)
    else:
        gl = build_loop_graph(word_trans, word_insertion_cost=wic)
    bgl = banded_arrays(gl)

    # prefix sharing shrinks the graph
    assert lexg.n_states < gl.n_states

    T = 37
    e, su = unit_emissions(rng, T, unit_trans)
    nll_lex = e[:, np.asarray(lexg.banded.bank_state)]
    nll_loop = loop_nll_for_words(e, words, unit_ids, unit_trans, su)

    for nf in [T, 19]:
        fin_lex, bp_lex, eu_lex = viterbi_banded(
            jnp.asarray(nll_lex), lexg.banded, jnp.int32(nf))
        fin_loop, bp_loop, eu_loop = viterbi_banded(
            jnp.asarray(nll_loop), bgl, jnp.int32(nf))

        ends_lex = np.asarray(lexg.banded.end_states)
        ends_loop = np.asarray(bgl.end_states)
        cl = np.asarray(fin_lex)[ends_lex] + np.asarray(lexg.banded.end_bonus)
        cg = np.asarray(fin_loop)[ends_loop] + np.asarray(bgl.end_bonus)
        # leaf order differs from vocab order; compare by word id
        order = np.argsort(lexg.leaf_word)
        np.testing.assert_array_equal(cl[order], cg)

        bl = int(np.argmin(cl))
        bgi = int(np.argmin(cg))
        s1, f1 = banded_backtrace(bp_lex, eu_lex, lexg.banded,
                                  jnp.int32(ends_lex[bl]), jnp.int32(nf))
        s2, f2 = banded_backtrace(bp_loop, eu_loop, bgl,
                                  jnp.int32(ends_loop[bgi]), jnp.int32(nf))
        from speech_recognition_jax.decode.connected import states_to_words

        w_lex = lex_words_from_path(lexg, np.asarray(s1), nf, np.asarray(f1))
        w_loop = states_to_words(gl, np.asarray(s2), nf, np.asarray(f2))
        assert w_lex == w_loop


def test_bigram_on_deep_tree_raises(rng):
    words = ["ab", "ac"]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng) for _ in units]
    lm = fit_bigram([[0, 1]], 2)
    with pytest.raises(ValueError, match="predecessor"):
        build_lex_graph(words, unit_trans, unit_ids, lm=lm)


def test_thousand_word_vocabulary(rng):
    """1,000-word trie decodes a known word sequence; the equivalent
    loop graph's state count is asserted to be a multiple larger (the
    round-1 production path died at 124 words)."""
    units = list("abcdefgh")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng, skip=False) for _ in units]
    su = 3

    nprng = np.random.default_rng(7)
    vocab = set()
    while len(vocab) < 1000:
        n = int(nprng.integers(3, 9))
        vocab.add("".join(nprng.choice(units, n)))
    words = sorted(vocab)
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           word_insertion_cost=0.5)

    loop_states = sum(len(w) for w in words) * su
    ratio = loop_states / lexg.n_states
    assert lexg.n_words == 1000
    assert ratio > 1.5, f"prefix sharing ratio only {ratio:.2f}"

    # synthesize emissions that strongly favor a known 3-word path
    target = [words[17], words[503], words[998]]
    frames_per_state = 2
    cols = []
    for w in target:
        for ch in w:
            u = unit_ids[ch]
            for j in range(su):
                cols.extend([u * su + j] * frames_per_state)
    T = len(cols)
    e = np.full((T, len(units) * su), 8.0, np.float32)
    e[np.arange(T), np.asarray(cols)] = 0.1
    nll = e[:, np.asarray(lexg.banded.bank_state)]

    fin, bp8, eps_u = viterbi_banded(jnp.asarray(nll), lexg.banded,
                                     jnp.int32(T))
    ends = np.asarray(lexg.banded.end_states)
    costs = np.asarray(fin)[ends]
    best = int(ends[np.argmin(costs)])
    assert np.min(costs) < POS_INF / 2
    states, flags = banded_backtrace(bp8, eps_u, lexg.banded, jnp.int32(best),
                                     jnp.int32(T))
    got = lex_words_from_path(lexg, np.asarray(states), T, np.asarray(flags))
    assert [words[i] for i in got] == target


def test_decode_lextree_api(rng):
    """The public decode path (unit-bank emissions + batched kernel +
    word recovery), with and without a beam."""
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.decode.lextree import decode_lextree
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    units = list("abcd")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    D = 6
    nprng = np.random.default_rng(5)
    models, unit_trans, means = [], [], []
    for _ in units:
        p = random_gmm_hmm(nprng, n_states=3, n_mix=1, dim=D, sep=6.0)
        models.append(GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
        ))
        unit_trans.append(p["trans"])
        means.append(p["means"][:, 0, :])  # [S, D]
    bank = HMMBank.stack(models)
    words = ["ab", "abc", "ba", "d", "ca"]
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           word_insertion_cost=0.5)

    # features tracing unit means for a 2-word path per utterance
    paths = [["ab", "d"], ["ca", "ba"]]
    feats, nfs, refs = [], [], []
    for seq in paths:
        fs = []
        for w in seq:
            for ch in w:
                m = means[unit_ids[ch]]
                for j in range(m.shape[0]):
                    fs.extend([m[j]] * 3)
        feats.append(np.asarray(fs, np.float32))
        nfs.append(len(fs))
        refs.append([words.index(w) for w in seq])
    tmax = max(nfs)
    x = np.zeros((len(paths), tmax, D), np.float32)
    for i, f in enumerate(feats):
        x[i, : len(f)] = f

    seqs, costs = decode_lextree(bank, lexg, x, np.asarray(nfs, np.int32))
    assert seqs == refs
    seqs_b, costs_b = decode_lextree(bank, lexg, x, np.asarray(nfs, np.int32),
                                     beam_width=lexg.n_states)
    assert seqs_b == refs
    np.testing.assert_array_equal(costs, costs_b)


def test_non_banded_unit_raises(rng):
    """A unit HMM with a finite transition outside the band (jump 3 >
    MAX_BAND, or backward) must fail loudly instead of decoding with
    silently dropped costs (advisor finding, round 2)."""
    units = ["a", "b"]
    unit_ids = {ch: i for i, ch in enumerate(units)}
    good = np.full((4, 4), np.inf)
    for i in range(4):
        good[i, i] = 0.5
        if i + 1 < 4:
            good[i + 1, i] = 0.5
    skip3 = good.copy()
    skip3[3, 0] = 0.9  # jump of 3: outside diagonals 0..MAX_BAND
    with pytest.raises(ValueError, match="not banded"):
        build_lex_graph(["ab"], [good, skip3], unit_ids)
    back = good.copy()
    back[0, 2] = 0.9  # backward transition
    with pytest.raises(ValueError, match="not banded"):
        build_lex_graph(["ab"], [back, good], unit_ids)
    build_lex_graph(["ab"], [good, good], unit_ids)  # sanity: banded ok
