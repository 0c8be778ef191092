"""Lexical tree, text Viterbi spell checking, bigram LM, and the
LM-weighted loop-graph decoder."""

import numpy as np
import pytest

from speech_recognition_jax.langmodel.bigram import (
    fit_bigram,
    sequence_cost,
    uniform_bigram,
)
from speech_recognition_jax.langmodel.lextree import lextree_from_words
from speech_recognition_jax.langmodel.spellcheck import SpellChecker, text_viterbi
from tests.oracles.text_ref import text_viterbi_oracle

WORDS = ["cat", "car", "card", "care", "dog", "do", "door", "a", "an", "and"]


def test_lextree_structure():
    tree = lextree_from_words(list(WORDS))
    # every word reconstructable from exactly one word-end leaf
    ends = tree.word_ends
    recovered = sorted(tree.word_of(int(e)) for e in ends)
    assert recovered == sorted(WORDS)
    # preorder: parent always before child
    assert np.all(tree.parent[1:] < np.arange(1, tree.n_nodes))
    assert tree.prop[0] == 1


@pytest.mark.parametrize(
    "text", ["cat", "cta", "carrd", "dog and cat", "doog", "xyz", "cardcare"]
)
def test_text_viterbi_cost_matches_oracle(text):
    tree = lextree_from_words(list(WORDS))
    cost, matched = text_viterbi(text, tree)
    _, ref_cost = text_viterbi_oracle(text, tree.val, tree.parent, tree.prop)
    assert cost == pytest.approx(ref_cost), (text, matched)


def test_spellchecker_corrects():
    sc = SpellChecker().fit(WORDS)
    # exact dictionary words come back intact; misspellings move toward a
    # dictionary word.  (Note the reference cost model charges every
    # string a fixed entry cost of 3 — root children have no match branch,
    # spellchecker.py:84-92 — so costs are compared, not required to be 0.)
    cost_exact, matched = text_viterbi("door", sc.tree)
    assert matched == "door"
    cost_typo, matched_typo = text_viterbi("doorr", sc.tree)
    assert cost_typo > cost_exact
    assert matched_typo.startswith("door")


def test_spellchecker_emits_whole_words():
    """spell_check reconstructs complete dictionary words from the
    word-end leaves on the path — even when the reference-exact
    text_viterbi string is a mid-word suffix (insertion-chain entry)."""
    sc = SpellChecker().fit(WORDS)
    assert sc.spell_check("dog and cat") == "dog and cat"
    assert sc.spell_check("czrd") == "card"
    # repeated word -> two leaf runs, both emitted
    assert sc.spell_check("cat cat") == "cat cat"
    # text_viterbi('at') enters mid-word ('at' of cat via insertion);
    # spell_check still names the whole word
    cost, matched = text_viterbi("at", sc.tree)
    assert matched in ("at", "cat")  # suffix quirk is cost-tied
    assert sc.spell_check("at") in ("cat", "a")


def test_bigram_fit_and_costs():
    seqs = [[0, 1, 2], [0, 1, 1], [2, 0, 1]]
    lm = fit_bigram(seqs, 3, add_k=0.5)
    # P(1|0) should be the highest continuation of 0
    assert np.argmin(lm.cost[0]) == 1
    assert np.argmin(lm.start_cost) == 0
    c_good = sequence_cost(lm, [0, 1, 2])
    c_bad = sequence_cost(lm, [1, 0, 0])
    assert c_good < c_bad
    flat = uniform_bigram(3)
    assert sequence_cost(flat, [0, 1, 2]) == 0.0


def test_loop_graph_decodes_repeated_words(rng):
    """A loop graph must separate '9 9' — requires epsilon-hop flags."""
    import jax.numpy as jnp

    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.graph import build_loop_graph
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.decode.connected import decode_connected
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    n_words, S, M, D = 3, 3, 1, 6
    params = [random_gmm_hmm(rng, n_states=S, n_mix=M, dim=D, sep=6.0) for _ in range(n_words)]
    bank = HMMBank.stack(
        [
            GMMHMM(
                means=jnp.asarray(p["means"], jnp.float32),
                log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
                log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
                trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
            )
            for p in params
        ]
    )

    # synthesize an utterance: word 1, word 1, word 0 (repeated word!)
    seq = [1, 1, 0]
    frames = []
    for w in seq:
        for s in range(S):
            n = int(rng.integers(2, 5))
            frames += [
                params[w]["means"][s, 0]
                + 0.2 * rng.standard_normal(D) * np.sqrt(params[w]["variances"][s, 0])
                for _ in range(n)
            ]
    x = np.asarray(frames, dtype=np.float32)

    graph = build_loop_graph([p["trans"] for p in params])
    seqs, costs = decode_connected(
        bank, graph, x[None], np.asarray([len(x)], np.int32)
    )
    assert seqs[0] == seq, f"decoded {seqs[0]} expected {seq}"


def test_loop_graph_bigram_biases_decode(rng):
    """With ambiguous acoustics, the bigram LM should tip the decision."""
    import jax.numpy as jnp

    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.langmodel.bigram import BigramLM
    from speech_recognition_jax.models.graph import build_loop_graph
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.decode.connected import decode_connected
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    S, M, D = 3, 1, 6
    base = random_gmm_hmm(rng, n_states=S, n_mix=M, dim=D, sep=5.0)
    # two nearly identical words (same means, slightly different)
    p0 = {k: np.copy(v) for k, v in base.items()}
    p1 = {k: np.copy(v) for k, v in base.items()}
    p1["means"] = p1["means"] + 0.01

    def to_model(p):
        return GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
        )

    bank = HMMBank.stack([to_model(p0), to_model(p1)])
    frames = []
    for s in range(S):
        frames += [base["means"][s, 0] for _ in range(3)]
    x = np.asarray(frames, dtype=np.float32)

    v = 2
    strong_0 = BigramLM(
        cost=np.zeros((v, v), np.float32),
        start_cost=np.asarray([0.0, 50.0], np.float32),
        end_cost=np.zeros((v,), np.float32),
    )
    strong_1 = BigramLM(
        cost=np.zeros((v, v), np.float32),
        start_cost=np.asarray([50.0, 0.0], np.float32),
        end_cost=np.zeros((v,), np.float32),
    )
    trans = [p0["trans"], p1["trans"]]
    g0 = build_loop_graph(trans, lm=strong_0)
    g1 = build_loop_graph(trans, lm=strong_1)
    s0, _ = decode_connected(bank, g0, x[None], np.asarray([len(x)], np.int32))
    s1, _ = decode_connected(bank, g1, x[None], np.asarray([len(x)], np.int32))
    assert s0[0] == [0] and s1[0] == [1]


def test_bigram_helps_on_noisy_markov_corpus():
    """End-to-end LM benefit: structured transcripts + noisy audio."""
    import jax

    from speech_recognition_jax.config import FrontendConfig, HMMConfig
    from speech_recognition_jax.data.synthetic import SyntheticDigits
    from speech_recognition_jax.decode.connected import decode_connected
    from speech_recognition_jax.models.graph import build_loop_graph
    from speech_recognition_jax.models.hmm import HMMBank
    from speech_recognition_jax.ops.frontend import mfcc39, padded_length
    from speech_recognition_jax.train.isolated import fit_hmm
    from speech_recognition_jax.utils.metrics import wer

    cfg = FrontendConfig()
    gen = SyntheticDigits(seed=5, noise=1.2)
    L = padded_length(cfg, 70000)

    def feat(sig):
        buf = np.zeros(L, np.float32)
        buf[: len(sig)] = sig
        f, nf = mfcc39(buf, np.int32(len(sig)), cfg)
        return np.asarray(f), int(nf)

    iso = gen.isolated_corpus(6, tag="tr")
    by_digit = {d: [] for d in range(11)}
    for u in iso:
        f, nf = feat(u.samples)
        by_digit[u.labels[0]].append(f[:nf].astype(np.float64))
    models = [
        fit_hmm(jax.random.PRNGKey(d), by_digit[d], hmm_cfg=HMMConfig(n_mix=2))
        for d in range(11)
    ]
    bank = HMMBank.stack(models)

    lm_train = gen.continuous_corpus(150, tag="lmtr", markov=0.85)
    lm = fit_bigram([u.labels for u in lm_train], 11, add_k=0.2)
    from speech_recognition_jax.langmodel.bigram import BigramLM

    lm4 = BigramLM(cost=lm.cost * 4, start_cost=lm.start_cost * 4,
                   end_cost=lm.end_cost * 4)

    test = gen.continuous_corpus(20, min_len=3, max_len=5, tag="te", markov=0.85)
    feats, lens, refs = [], [], []
    for u in test:
        f, nf = feat(u.samples)
        feats.append(f)
        lens.append(nf)
        refs.append(u.labels)
    tmax = max(lens)
    fb = np.zeros((len(test), tmax, 39), np.float32)
    for i in range(len(test)):
        fb[i, : lens[i]] = feats[i][: lens[i]]
    nb = np.asarray(lens, np.int32)

    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(11)]
    h0, _ = decode_connected(bank, build_loop_graph(trans_np), fb, nb)
    h1, _ = decode_connected(bank, build_loop_graph(trans_np, lm=lm4), fb, nb)
    assert wer(h1, refs) <= wer(h0, refs), (wer(h0, refs), wer(h1, refs))
