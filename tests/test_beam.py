"""Token-passing beam (ops/beam.py): exactness at full width, correct
decoding at narrow width, and the batched decode API."""

import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.langmodel.bigram import fit_bigram
from speech_recognition_jax.models.graph import build_loop_graph
from speech_recognition_jax.models.lexgraph import (
    build_lex_graph,
    lex_words_from_path,
)
from speech_recognition_jax.ops.beam import beam_backtrace, beam_search, beam_tables
from speech_recognition_jax.ops.viterbi_banded import (
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


def exact_decode(bg, nll, nf, words_of):
    fin, bp8, eps_u = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(nf))
    ends = np.asarray(bg.end_states)
    costs = np.asarray(fin)[ends] + np.asarray(bg.end_bonus)
    best = int(np.argmin(costs))
    states, flags = banded_backtrace(bp8, eps_u, bg, jnp.int32(ends[best]),
                                     jnp.int32(nf))
    return float(costs[best]), words_of(np.asarray(states), np.asarray(flags))


def beam_words(words_rev):
    w = np.asarray(words_rev)
    return [int(x) for x in w[:0:-1] if x >= 0] + [int(w[0])]


def test_full_width_beam_is_exact_lexgraph(rng):
    words = ["ab", "abc", "ad", "ba", "c"]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng) for _ in units]
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           word_insertion_cost=0.3)
    tables = beam_tables(lexg.banded, leaf_word=lexg.leaf_word)

    T = 29
    su = 3
    e = rng.uniform(0, 5, (T, len(units) * su)).astype(np.float32)
    nll = e[:, np.asarray(lexg.banded.bank_state)]

    for nf in [T, 14]:
        c_ref, w_ref = exact_decode(
            lexg.banded, nll, nf,
            lambda s, f: lex_words_from_path(lexg, s, nf, f))
        fst, fco, fpd, tok_s, tok_p, tok_w = beam_search(
            jnp.asarray(e), tables, jnp.int32(nf), k=lexg.n_states)
        cost, words_rev = beam_backtrace(fst, fco, tok_p, tok_w, tables,
                                         jnp.int32(nf))
        assert float(cost) == c_ref
        assert beam_words(words_rev) == w_ref


def test_full_width_beam_is_exact_loop_graph(rng):
    """No cross edges (flat loop graph) + bigram LM."""
    n_words = 6
    trans = [ltr(4, rng) for _ in range(n_words)]
    lm = fit_bigram([[0, 1, 2], [5, 4, 3, 0]], n_words)
    g = build_loop_graph(trans, lm=lm, word_insertion_cost=0.2)
    bg = banded_arrays(g)
    tables = beam_tables(bg)

    T = 33
    nll = rng.uniform(0, 5, (T, g.n_states)).astype(np.float32)
    from speech_recognition_jax.decode.connected import states_to_words

    c_ref, w_ref = exact_decode(
        bg, nll, T, lambda s, f: states_to_words(g, s, T, f))
    # bank row == graph state here (identity bank_state makes nll the
    # "compact" block)
    fst, fco, fpd, tok_s, tok_p, tok_w = beam_search(
        jnp.asarray(nll), tables._replace(
            bank_state=jnp.arange(g.n_states, dtype=jnp.int32)),
        jnp.int32(T), k=g.n_states, has_cross=False)
    cost, words_rev = beam_backtrace(fst, fco, tok_p, tok_w, tables,
                                     jnp.int32(T))
    assert float(cost) == c_ref
    assert beam_words(words_rev) == w_ref


def test_narrow_beam_decodes_favorable_path(rng):
    """k = 12 tokens on a 1,000-word trie (9.6k states): the beam finds
    the planted path exactly and matches the exact kernel's cost."""
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
    tables = beam_tables(lexg.banded, leaf_word=lexg.leaf_word)

    target = [words[42], words[777]]
    cols = []
    for w in target:
        for ch in w:
            u = unit_ids[ch]
            for j in range(su):
                cols.extend([u * su + j] * 2)
    T = len(cols)
    e = np.full((T, len(units) * su), 8.0, np.float32)
    e[np.arange(T), np.asarray(cols)] = 0.1

    fst, fco, fpd, tok_s, tok_p, tok_w = beam_search(
        jnp.asarray(e), tables, jnp.int32(T), k=12)
    cost, words_rev = beam_backtrace(fst, fco, tok_p, tok_w, tables,
                                     jnp.int32(T))
    got = beam_words(words_rev)
    assert [words[i] for i in got] == target
    # cost equals the exact kernel's on this easy path
    nll = e[:, np.asarray(lexg.banded.bank_state)]
    c_ref, w_ref = exact_decode(
        lexg.banded, nll, T,
        lambda s, f: lex_words_from_path(lexg, s, T, f))
    assert w_ref == got
    np.testing.assert_allclose(float(cost), c_ref, rtol=1e-6)


def test_beam_decode_lextree_api(rng):
    """Batched API vs the exact decode on GMM-bank features."""
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.decode.lextree import (
        beam_decode_lextree,
        decode_lextree,
    )
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix
    import jax

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
        means.append(p["means"][:, 0, :])
    bank = HMMBank.stack(models)
    words = ["ab", "abc", "ba", "d", "ca"]
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           word_insertion_cost=0.5)

    paths = [["ab", "d"], ["ca", "ba"], ["abc"]]
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
    nfs = np.asarray(nfs, np.int32)

    seqs_exact, costs_exact = decode_lextree(bank, lexg, x, nfs)
    seqs_beam, costs_beam = beam_decode_lextree(bank, lexg, x, nfs,
                                                k=lexg.n_states)
    assert seqs_beam == seqs_exact == refs
    np.testing.assert_allclose(costs_beam, costs_exact, rtol=1e-6)

    seqs_n, costs_n = beam_decode_lextree(bank, lexg, x, nfs, k=16)
    assert seqs_n == refs

    # pred-carried bigram on the deep tree: with dominant acoustics the
    # decoded sequence is unchanged and the reported cost decomposes as
    # acoustic + LM sequence cost (bigram applied at each word exit with
    # the carried predecessor, start row at the first exit, end cost at
    # the final leaf)
    from speech_recognition_jax.langmodel.bigram import fit_bigram, sequence_cost

    lm = fit_bigram([[0, 3], [4, 2], [1]], len(words))
    seqs_lm, costs_lm = beam_decode_lextree(bank, lexg, x, nfs,
                                            k=lexg.n_states, lm=lm)
    assert seqs_lm == refs
    for i, seq in enumerate(refs):
        np.testing.assert_allclose(
            costs_lm[i] - costs_exact[i], sequence_cost(lm, seq), rtol=1e-5)
