"""The reference's own 6,250-word dictionary
(``/root/reference/tests/test_data/dict1.txt``) on the production lex
path: layout parity of the state-major scan on a deterministic subset,
the flat-LM lattice identity at full dictionary scale, and batch
independence of the bigram decode.  Skipped where the reference data is
absent.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.models.lexgraph import build_lex_graph
from speech_recognition_jax.ops.viterbi_banded import (
    banded_backtrace_tb,
    viterbi_banded_tb,
)

DICT1 = "/root/reference/tests/test_data/dict1.txt"


def load_dict1():
    words = [line.strip() for line in open(DICT1)][1:]
    seen, out = set(), []
    for w in words:
        if w and w not in seen:  # dict1 carries 2 duplicate entries
            seen.add(w)
            out.append(w)
    return out


def ltr(S, rng):
    t = np.full((S, S), np.inf)
    for i in range(S):
        t[i, i] = rng.uniform(0.1, 1)
        if i + 1 < S:
            t[i + 1, i] = rng.uniform(0.1, 1)
    return t


@pytest.mark.skipif(not os.path.exists(DICT1), reason="reference dict absent")
def test_dict1_subset_layout_parity(rng):
    """The state-major production scan + backtrace equal the vmapped
    [B, S] kernels on a 1,500-word deterministic subset of dict1 (real
    charset and trie shape), variable lengths."""
    import jax

    from speech_recognition_jax.ops.viterbi_banded import (
        banded_backtrace,
        viterbi_banded,
    )

    words = load_dict1()[::4][:1500]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    su = 3
    lexg = build_lex_graph(words, [ltr(su, rng) for _ in units], unit_ids,
                           word_insertion_cost=0.5)
    T, B = 8, 8
    e = rng.uniform(0, 5, (T, len(units) * su, B)).astype(np.float32)
    nf = np.array([T, 5, T, 2, 6, T, 1, 7], np.int32)
    g = lexg.banded
    nll_tsb = jnp.asarray(e)[:, np.asarray(g.bank_state), :]
    fin_x, bp_x, eu_x = viterbi_banded_tb(nll_tsb, g, jnp.asarray(nf))
    fin_v, bp_v, eu_v = jax.vmap(lambda x, n: viterbi_banded(x, g, n))(
        jnp.transpose(nll_tsb, (2, 0, 1)), jnp.asarray(nf))
    np.testing.assert_array_equal(np.asarray(fin_x), np.asarray(fin_v).T)
    ends = np.asarray(g.end_states)
    costs = np.asarray(fin_x)[ends] + np.asarray(g.end_bonus)[:, None]
    best = ends[np.argmin(costs, axis=0)]
    s_x, f_x = banded_backtrace_tb(bp_x, eu_x, g, jnp.asarray(best),
                                   jnp.asarray(nf))
    for i in range(B):
        n = int(nf[i])
        s_v, f_v = banded_backtrace(bp_v[i], eu_v[i], g, jnp.int32(best[i]),
                                    jnp.int32(n))
        np.testing.assert_array_equal(np.asarray(s_x)[:n, i],
                                      np.asarray(s_v)[:n])
        np.testing.assert_array_equal(np.asarray(f_x)[:n, i],
                                      np.asarray(f_v)[:n])


@pytest.mark.skipif(not os.path.exists(DICT1), reason="reference dict absent")
def test_dict1_uniform_lm_reproduces_pass1(rng):
    """Property test at full dict1 scale: rescoring the pass-1 lattice
    with a FLAT (all-zero) bigram reproduces the
    plain pass-1 decode — words and costs — so the tau/Q/H algebra is
    sound on the reference's own dictionary
    (``/root/reference/tests/test_data/dict1.txt``)."""
    from speech_recognition_jax.langmodel.bigram import uniform_bigram
    from speech_recognition_jax.models.lexgraph import lex_words_from_path
    from speech_recognition_jax.ops.lattice import (
        lattice_rescore,
        lattice_words,
        viterbi_lattice_tb,
    )

    words = load_dict1()
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    su = 3
    wic = 0.4
    lexg = build_lex_graph(words, [ltr(su, rng) for _ in units], unit_ids,
                           word_insertion_cost=wic)
    T, B = 6, 4
    e = rng.uniform(0, 5, (T, len(units) * su, B)).astype(np.float32)
    nf = np.array([T, 3, T, 5], np.int32)
    _, ends_p, taus_p = viterbi_lattice_tb(
        jnp.asarray(e)[:, np.asarray(lexg.banded.bank_state), :],
        lexg.banded, jnp.asarray(nf))

    lm0 = uniform_bigram(len(words), flat=True)
    res = lattice_rescore(
        ends_p, taus_p, jnp.asarray(lexg.leaf_word),
        jnp.asarray(lm0.cost), jnp.asarray(lm0.start_cost),
        jnp.asarray(lm0.end_cost), jnp.asarray(nf))
    w_resc = lattice_words(res, lexg.leaf_word, nf)

    # pass-1 ground truth on the banded scan
    g = lexg.banded
    bank_state = np.asarray(g.bank_state)
    nll_tb = jnp.asarray(e)[:, bank_state, :]
    fin_x, bp_x, eu_x = viterbi_banded_tb(nll_tb, g, jnp.asarray(nf))
    ends = np.asarray(g.end_states)
    costs = np.asarray(fin_x)[ends] + np.asarray(g.end_bonus)[:, None]
    best = np.argmin(costs, axis=0)
    pass1 = costs[best, np.arange(B)]
    np.testing.assert_allclose(np.asarray(res.cost), pass1, rtol=1e-6)
    s_x, f_x = banded_backtrace_tb(bp_x, eu_x, g, jnp.asarray(ends[best]),
                                   jnp.asarray(nf))
    for i in range(B):
        w_ref = lex_words_from_path(lexg, np.asarray(s_x)[:, i], int(nf[i]),
                                    np.asarray(f_x)[:, i])
        assert w_resc[i] == w_ref, i


@pytest.mark.skipif(not os.path.exists(DICT1), reason="reference dict absent")
def test_dict1_subset_bigram_batch_independence(rng):
    """``decode_lextree_bigram`` at real dict1 trie shapes (a 600-word
    subset): a batch of 5 streams decodes each stream exactly as it
    decodes alone."""
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.langmodel.bigram import fit_bigram
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.ops.lattice import decode_lextree_bigram
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    words = load_dict1()[::10][:600]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    nprng = np.random.default_rng(9)
    models, u_trans = [], []
    for _ in units:
        p = random_gmm_hmm(nprng, n_states=3, n_mix=1, dim=6, sep=6.0)
        models.append(GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
        ))
        u_trans.append(p["trans"])
    bank = HMMBank.stack(models)
    lexg = build_lex_graph(words, u_trans, unit_ids,
                           word_insertion_cost=0.3)
    lm = fit_bigram([[int(x) for x in nprng.integers(0, len(words), 7)]
                     for _ in range(40)], len(words))
    b, t = 5, 18
    feats = nprng.standard_normal((b, t, 6)).astype(np.float32)
    nfs = np.array([t, 9, t, 4, 13], np.int32)
    sx, cx = decode_lextree_bigram(bank, lexg, lm, feats, nfs)
    for i in range(b):
        si, ci = decode_lextree_bigram(bank, lexg, lm, feats[i:i + 1],
                                       nfs[i:i + 1])
        assert si[0] == sx[i]
        np.testing.assert_allclose(ci[0], cx[i], rtol=1e-6)
