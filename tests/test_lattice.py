"""Word-lattice generation + bigram rescoring (ops/lattice.py).

Ground truths:
* flat (all-zero) LM: the rescored cost/words must equal the plain
  pass-1 decode exactly — any bug in the tau/Q/H algebra breaks this;
* exact bigram oracle: the loop graph over concatenated word HMMs with
  the bigram composed onto its boundary eps edges (exact on flat
  word-level vocabularies) — on separable emissions the lattice
  rescore must match its cost and recover the planted words; on random
  emissions the oracle is a lower bound (every lattice path is a real
  path, so rescored >= oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.langmodel.bigram import fit_bigram, uniform_bigram
from speech_recognition_jax.models.graph import build_loop_graph
from speech_recognition_jax.models.lexgraph import build_lex_graph
from speech_recognition_jax.ops.lattice import (
    lattice_rescore,
    lattice_words,
    viterbi_lattice_tb,
)
from speech_recognition_jax.ops.viterbi_banded import (
    banded_arrays,
    banded_backtrace_tb,
    viterbi_banded_tb,
)
from tests.test_lextree_decode import (
    concat_word_trans,
    loop_nll_for_words,
    ltr,
    unit_emissions,
)

WORDS = ["aa", "ab", "abb", "ba", "b", "cab", "ca"]


def make_case(rng, wic=0.0):
    units = sorted(set("".join(WORDS)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng, skip=False) for _ in units]
    lexg = build_lex_graph(WORDS, unit_trans, unit_ids,
                           word_insertion_cost=wic)
    return lexg, units, unit_ids, unit_trans


def run_lattice(lexg, e_tu, nf, lm, wic):
    g = lexg.banded
    bank_state = np.asarray(g.bank_state)
    b = e_tu.shape[-1]
    nll_tb = jnp.asarray(e_tu)[:, bank_state, :]
    final, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, g,
                                                    jnp.asarray(nf))
    res = lattice_rescore(
        ends_cost, ends_tau, jnp.asarray(lexg.leaf_word),
        jnp.asarray(lm.cost), jnp.asarray(lm.start_cost),
        jnp.asarray(lm.end_cost), jnp.asarray(nf))
    words = lattice_words(res, lexg.leaf_word, nf)
    return final, res, words


def test_flat_lm_reduces_to_pass1(rng):
    """All-zero LM: rescored == plain pass-1 decode (cost and words)."""
    from speech_recognition_jax.models.lexgraph import lex_words_from_path

    wic = 0.35
    lexg, units, unit_ids, unit_trans = make_case(rng, wic=wic)
    T, B = 29, 8
    e = rng.uniform(0, 5, (T, len(units) * 3, B)).astype(np.float32)
    nf = np.array([T, 15, T, 7, 21, T, 2, 11], np.int32)
    lm0 = uniform_bigram(len(WORDS), flat=True)
    final, res, words = run_lattice(lexg, e, nf, lm0, wic)

    g = lexg.banded
    ends = np.asarray(g.end_states)
    costs = np.asarray(final)[ends] + np.asarray(g.end_bonus)[:, None]
    best = np.argmin(costs, axis=0)
    pass1 = costs[best, np.arange(B)]
    np.testing.assert_allclose(np.asarray(res.cost), pass1, rtol=1e-6)

    # pass-1 word sequences via the standard backtrace
    bank_state = np.asarray(g.bank_state)
    nll_tb = jnp.asarray(e)[:, bank_state, :]
    _, bp8, eps_u = viterbi_banded_tb(nll_tb, g, jnp.asarray(nf))
    s_x, f_x = banded_backtrace_tb(bp8, eps_u, g, jnp.asarray(ends[best]),
                                   jnp.asarray(nf))
    for i in range(B):
        w_ref = lex_words_from_path(lexg, np.asarray(s_x)[:, i], int(nf[i]),
                                    np.asarray(f_x)[:, i])
        assert words[i] == w_ref, i


def _plant(rng, lexg, unit_ids, unit_trans, seqs, su=3, dwell=3):
    """Separable emissions: near-zero cost along each planted word
    path, expensive elsewhere."""
    n_units = len(unit_trans)
    frames = []
    for seq in seqs:
        rows = []
        for w in seq:
            for ch in w:
                u = unit_ids[ch]
                for j in range(su):
                    rows.extend([u * su + j] * dwell)
        frames.append(rows)
    T = max(len(r) for r in frames)
    B = len(seqs)
    e = np.full((T, n_units * su, B), 8.0, np.float32)
    nf = np.zeros(B, np.int32)
    for i, rows in enumerate(frames):
        nf[i] = len(rows)
        for t, row in enumerate(rows):
            e[t, row, i] = 0.05
    return e, nf


def test_bigram_rescore_matches_exact_oracle(rng):
    """Separable emissions: lattice-rescored cost == the exact bigram
    oracle (loop graph over concatenated word HMMs, bigram on its eps
    block) and the planted word sequences are recovered."""
    wic = 0.0
    lexg, units, unit_ids, unit_trans = make_case(rng, wic=wic)
    lm = fit_bigram([[0, 1, 2], [5, 3, 1], [4, 4, 6], [2, 0]], len(WORDS))

    seqs = [["aa", "ab", "abb"], ["cab", "ba", "ab"], ["b", "b", "ca"],
            ["ca", "aa"]]
    e, nf = _plant(rng, lexg, unit_ids, unit_trans, seqs)
    final, res, words = run_lattice(lexg, e, nf, lm, wic)
    planted = [[WORDS.index(w) for w in s] for s in seqs]
    assert words == planted

    # exact oracle: flat word-level loop graph with the bigram
    word_trans = [concat_word_trans(w, unit_ids, unit_trans) for w in WORDS]
    gl = build_loop_graph(word_trans, lm=lm, word_insertion_cost=wic)
    bgl = banded_arrays(gl)
    su = 3
    nll_loop = np.stack(
        [loop_nll_for_words(e[:, :, i], WORDS, unit_ids, unit_trans, su)
         for i in range(e.shape[-1])], axis=-1)
    fin_l, _, _ = viterbi_banded_tb(jnp.asarray(nll_loop), bgl,
                                    jnp.asarray(nf))
    ends_l = np.asarray(bgl.end_states)
    oracle = np.min(np.asarray(fin_l)[ends_l]
                    + np.asarray(bgl.end_bonus)[:, None], axis=0)
    np.testing.assert_allclose(np.asarray(res.cost), oracle, rtol=1e-5)


def test_bigram_rescore_bounded_by_oracle(rng):
    """Random emissions: every lattice path is a real path, so the
    rescored cost can never beat the exact oracle."""
    wic = 0.2
    lexg, units, unit_ids, unit_trans = make_case(rng, wic=wic)
    lm = fit_bigram([[0, 1, 2], [5, 3, 1], [4, 4, 6]], len(WORDS))
    T, B = 33, 8
    e = rng.uniform(0, 5, (T, len(units) * 3, B)).astype(np.float32)
    nf = np.array([T, 17, T, 9, 25, T, 3, 13], np.int32)
    final, res, words = run_lattice(lexg, e, nf, lm, wic)

    word_trans = [concat_word_trans(w, unit_ids, unit_trans) for w in WORDS]
    gl = build_loop_graph(word_trans, lm=lm, word_insertion_cost=wic)
    bgl = banded_arrays(gl)
    nll_loop = np.stack(
        [loop_nll_for_words(e[:, :, i], WORDS, unit_ids, unit_trans, 3)
         for i in range(B)], axis=-1)
    fin_l, _, _ = viterbi_banded_tb(jnp.asarray(nll_loop), bgl,
                                    jnp.asarray(nf))
    ends_l = np.asarray(bgl.end_states)
    oracle = np.min(np.asarray(fin_l)[ends_l]
                    + np.asarray(bgl.end_bonus)[:, None], axis=0)
    got = np.asarray(res.cost)
    assert np.all(oracle <= got + 1e-4), (oracle, got)
    # and the rescored costs stay finite / sane
    assert np.all(got < 1e9)
    assert all(len(w) >= 1 for w in words)


def _unit_bank(units, seed):
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    nprng = np.random.default_rng(seed)
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
    return HMMBank.stack(models), u_trans, nprng


def test_decode_lextree_bigram_is_lattice_then_rescore(rng):
    """The bigram decode entry point is exactly its parts: unit-bank
    emissions -> viterbi_lattice_tb -> lattice_rescore (sliced backoff)
    -> lattice_words, words and costs."""
    from speech_recognition_jax.models.hmm import bank_nll
    from speech_recognition_jax.ops.lattice import (
        decode_lextree_bigram,
        rescore_backoff_sliced,
    )

    units = sorted(set("".join(WORDS)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    bank, u_trans, nprng = _unit_bank(units, 5)
    lexg = build_lex_graph(WORDS, u_trans, unit_ids, word_insertion_cost=0.2)
    lm = fit_bigram([[0, 1, 2], [5, 3, 1]], len(WORDS))
    feats = nprng.standard_normal((3, 25, 6)).astype(np.float32)
    nfs = np.array([25, 14, 8], np.int32)
    seqs, costs = decode_lextree_bigram(bank, lexg, lm, feats, nfs)

    g = lexg.banded
    nll = np.stack([np.asarray(bank_nll(bank, jnp.asarray(x), jnp.arange(25) < n))
                    for x, n in zip(feats, nfs)])
    nll_tb = jnp.asarray(np.transpose(nll, (1, 2, 0))[:, np.asarray(g.bank_state)])
    _, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, g, jnp.asarray(nfs))
    arrays, counts = rescore_backoff_sliced(lm, lexg.leaf_word)
    res = lattice_rescore(
        ends_cost, ends_tau, jnp.asarray(lexg.leaf_word),
        jnp.asarray(np.asarray(lm.cost, np.float32)),
        jnp.asarray(np.asarray(lm.start_cost, np.float32)),
        jnp.asarray(np.asarray(lm.end_cost, np.float32)),
        jnp.asarray(nfs), backoff=arrays, backoff_counts=counts)
    np.testing.assert_allclose(costs, np.asarray(res.cost), rtol=1e-6)
    assert seqs == lattice_words(res, lexg.leaf_word, nfs)


def _rescore_reference(ends_cost, ends_tau, leaf_word, lm, nf, span):
    """The rescorer's equations as a plain per-frame DP with every H row
    kept (no ring, no frame blocks); an arc spanning more than ``span``
    frames is dropped.  Returns (costs, word sequences)."""
    from speech_recognition_jax.utils.numerics import POS_INF

    f32 = np.float32
    ec = np.asarray(ends_cost, f32)
    et = np.asarray(ends_tau)
    t_len, n_leaf, n_b = ec.shape
    lw = np.asarray(leaf_word)
    big = np.asarray(lm.cost, f32)[lw][:, lw]
    start = np.asarray(lm.start_cost, f32)[lw]
    end = np.asarray(lm.end_cost, f32)[lw]
    costs, seqs = [], []
    for b in range(n_b):
        q = ec[:, :, b].min(axis=1)
        h = np.full((t_len, n_leaf), POS_INF, f32)
        pred = np.zeros((t_len, n_leaf), np.int64)
        for t in range(t_len):
            s0, tau = ec[t, :, b], et[t, :, b]
            d = np.empty(n_leaf, f32)
            for l in range(n_leaf):
                if tau[l] <= 0:
                    d[l] = s0[l] + start[l]
                elif tau[l] < t and t - tau[l] <= span:
                    d[l] = s0[l] + (h[tau[l], l] - q[tau[l]])
                else:
                    d[l] = s0[l] + f32(POS_INF)
            sc = d[:, None] + big
            h[t] = np.minimum(sc.min(axis=0), f32(POS_INF))
            pred[t] = sc.argmin(axis=0)
            if t == nf[b] - 1:
                fin = d + end
        leaf = int(np.argmin(fin))
        costs.append(fin[leaf])
        words, t = [], int(nf[b]) - 1
        while True:
            words.append(int(lw[leaf]))
            tau = int(et[t, leaf, b])
            if tau <= 0:
                break
            leaf, t = int(pred[tau, leaf]), tau
        seqs.append(words[::-1])
    return np.asarray(costs), seqs


@pytest.mark.parametrize("block_frames,max_dur", [
    (1, 64), (3, 64), (8, 64), (3, 10), (8, 10), (5, 7)])
def test_ring_rescore_matches_plain_dp(rng, block_frames, max_dur):
    """The blocked H-ring rescorer (dense and sliced-backoff
    recombination) equals the plain per-frame DP: frame counts that do
    not divide the block, and rings shorter than the utterance whose
    depth rounds up to the block (ceil(min(max_dur, T) / F) * F
    frames)."""
    from speech_recognition_jax.ops.lattice import rescore_backoff_sliced

    lexg, units, unit_ids, unit_trans = make_case(rng, wic=0.3)
    v = len(WORDS)
    lm = fit_bigram([[int(x) for x in rng.integers(0, v, 6)]
                     for _ in range(15)], v)
    T, B = 25, 4
    e = rng.uniform(0, 5, (T, len(units) * 3, B)).astype(np.float32)
    nf = np.array([T, 13, 22, 9], np.int32)
    g = lexg.banded
    nll_tb = jnp.asarray(e)[:, np.asarray(g.bank_state), :]
    _, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, g, jnp.asarray(nf))
    t_pad = -(-T // block_frames) * block_frames
    span = -(-min(max_dur, t_pad) // block_frames) * block_frames
    want_c, want_w = _rescore_reference(ends_cost, ends_tau, lexg.leaf_word,
                                        lm, nf, span)
    args = (ends_cost, ends_tau, jnp.asarray(lexg.leaf_word),
            jnp.asarray(lm.cost), jnp.asarray(lm.start_cost),
            jnp.asarray(lm.end_cost), jnp.asarray(nf))
    arrays, counts = rescore_backoff_sliced(lm, lexg.leaf_word)
    for kw in ({}, {"backoff": arrays, "backoff_counts": counts}):
        res = lattice_rescore(*args, block_frames=block_frames,
                              max_dur=max_dur, **kw)
        np.testing.assert_allclose(np.asarray(res.cost), want_c, rtol=1e-6)
        assert lattice_words(res, lexg.leaf_word, nf) == want_w


def test_max_dur_truncation_warns(rng):
    """A live lattice arc spanning more than max_dur frames triggers the
    RuntimeWarning guard (and a large-enough max_dur does not)."""
    import warnings

    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.ops.lattice import decode_lextree_bigram
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    lexg, units, unit_ids, unit_trans = make_case(rng, wic=0.1)
    nprng = np.random.default_rng(7)
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
    from speech_recognition_jax.langmodel.bigram import uniform_bigram

    lexg2 = build_lex_graph(WORDS, u_trans, unit_ids,
                            word_insertion_cost=0.1)
    lm = uniform_bigram(len(WORDS))
    T = 40  # > max_dur=16: the planted dwell spans deeper than the cap
    # constant features at one unit's mean force the best token to dwell
    # inside a single word for all T frames -> a live arc of span T-1
    mu = np.asarray(bank.means)[unit_ids["b"], 0, 0]
    feats = np.broadcast_to(mu, (2, T, 6)).astype(np.float32).copy()
    nfs = np.array([T, T], np.int32)
    with pytest.warns(RuntimeWarning, match="max_dur"):
        decode_lextree_bigram(bank, lexg2, lm, feats, nfs, max_dur=16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        decode_lextree_bigram(bank, lexg2, lm, feats, nfs, max_dur=T + 1)


def test_backoff_rescore_matches_dense(rng):
    """The O(V + nnz)/frame backoff recombination == the dense
    O(V^2)/frame path: same rescored costs, same word sequences (away
    from exact-cost ties), on an add-k LM over a deep tree."""
    from speech_recognition_jax.ops.lattice import rescore_backoff

    lexg, units, unit_ids, unit_trans = make_case(rng, wic=0.3)
    v = len(WORDS)
    lm = fit_bigram([[int(x) for x in rng.integers(0, v, 6)]
                     for _ in range(15)], v)
    T, B = 25, 6
    e = rng.uniform(0, 5, (T, len(units) * 3, B)).astype(np.float32)
    nf = np.array([T, 13, T, 9, 17, 5], np.int32)

    g = lexg.banded
    nll_tb = jnp.asarray(e)[:, np.asarray(g.bank_state), :]
    _, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, g, jnp.asarray(nf))
    args = (ends_cost, ends_tau, jnp.asarray(lexg.leaf_word),
            jnp.asarray(lm.cost), jnp.asarray(lm.start_cost),
            jnp.asarray(lm.end_cost), jnp.asarray(nf))
    dense = lattice_rescore(*args)
    bo = rescore_backoff(lm, lexg.leaf_word)
    assert bo is not None
    sparse = lattice_rescore(*args, backoff=bo)
    np.testing.assert_allclose(np.asarray(sparse.cost),
                               np.asarray(dense.cost), rtol=1e-6)
    w_d = lattice_words(dense, lexg.leaf_word, nf)
    w_s = lattice_words(sparse, lexg.leaf_word, nf)
    assert w_d == w_s


def test_sliced_backoff_matches_dense_k(rng):
    """The sliced-take backoff (lanes sorted by predecessor count,
    per-k prefix gathers, permuted pred plane) == the dense-K backoff
    AND the dense O(V^2) path: same costs, same word sequences, host
    and device walks (tie caveat as the dense-K form)."""
    from speech_recognition_jax.ops.lattice import (
        lattice_words_device,
        rescore_backoff,
        rescore_backoff_sliced,
    )

    lexg, units, unit_ids, unit_trans = make_case(rng, wic=0.3)
    v = len(WORDS)
    lm = fit_bigram([[int(x) for x in rng.integers(0, v, 6)]
                     for _ in range(15)], v)
    T, B = 25, 6
    e = rng.uniform(0, 5, (T, len(units) * 3, B)).astype(np.float32)
    nf = np.array([T, 13, T, 9, 17, 5], np.int32)

    g = lexg.banded
    nll_tb = jnp.asarray(e)[:, np.asarray(g.bank_state), :]
    _, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, g, jnp.asarray(nf))
    args = (ends_cost, ends_tau, jnp.asarray(lexg.leaf_word),
            jnp.asarray(lm.cost), jnp.asarray(lm.start_cost),
            jnp.asarray(lm.end_cost), jnp.asarray(nf))
    bo = rescore_backoff(lm, lexg.leaf_word)
    dense_k = lattice_rescore(*args, backoff=bo)
    arrays, counts = rescore_backoff_sliced(lm, lexg.leaf_word)
    assert counts[0] <= len(lexg.leaf_word)
    sliced = lattice_rescore(*args, backoff=arrays, backoff_counts=counts)
    np.testing.assert_array_equal(np.asarray(sliced.cost),
                                  np.asarray(dense_k.cost))
    np.testing.assert_array_equal(np.asarray(sliced.best_leaf),
                                  np.asarray(dense_k.best_leaf))
    w_k = lattice_words(dense_k, lexg.leaf_word, nf)
    w_s = lattice_words(sliced, lexg.leaf_word, nf)
    assert w_k == w_s
    lr, nw = lattice_words_device(sliced.pred_w, sliced.ends_tau,
                                  sliced.best_leaf, jnp.asarray(nf),
                                  max_words=T,
                                  lane_invperm=sliced.lane_invperm)
    lw = np.asarray(lexg.leaf_word)
    lr, nw = np.asarray(lr), np.asarray(nw)
    w_dev = [lw[lr[: nw[i], i][::-1]].tolist() for i in range(B)]
    assert w_dev == w_s


def test_backoff_detection_rejects_unstructured():
    """A generic (non-backoff) cost matrix yields None -> dense path."""
    from speech_recognition_jax.langmodel.bigram import bigram_backoff

    rng = np.random.default_rng(3)
    cost = rng.uniform(0, 5, (200, 200)).astype(np.float32)
    assert bigram_backoff(cost) is None


def test_backoff_identity_numpy(rng):
    """H[w] = min(global backoff min, sparse seen-pair min) — the exact
    decomposition the rescorer relies on, brute-checked."""
    from speech_recognition_jax.langmodel.bigram import bigram_backoff

    v = 40
    lm = fit_bigram([[int(x) for x in rng.integers(0, v, 9)]
                     for _ in range(25)], v)
    bo = bigram_backoff(lm.cost)
    for _ in range(5):
        d = rng.uniform(0, 8, v)
        h_dense = np.min(d[:, None] + lm.cost, axis=0)
        m_all = np.min(d + bo.base)
        sp = np.where(bo.pred_cost < 1e29,
                      d[bo.pred_idx] + bo.pred_cost, 1e30).min(axis=1)
        np.testing.assert_allclose(np.minimum(m_all, sp), h_dense,
                                   rtol=1e-6)


def test_lattice_words_device_matches_host(rng):
    """The device chain walk (tiny flattened gathers, [W, B] fetch)
    reproduces the host lattice_words exactly."""
    from speech_recognition_jax.langmodel.bigram import fit_bigram
    from speech_recognition_jax.ops.lattice import lattice_words_device

    wic = 0.25
    lexg, units, unit_ids, unit_trans = make_case(rng, wic=wic)
    lm = fit_bigram([[0, 1, 2], [5, 3, 1], [4, 4, 6]], len(WORDS))
    T, B = 31, 6
    e = rng.uniform(0, 5, (T, len(units) * 3, B)).astype(np.float32)
    nf = np.array([T, 17, T, 9, 25, 3], np.int32)
    final, res, words = run_lattice(lexg, e, nf, lm, wic)
    leaves_rev, n_words = lattice_words_device(
        res.pred_w, res.ends_tau, res.best_leaf, jnp.asarray(nf),
        max_words=T)
    lw = np.asarray(lexg.leaf_word)
    lr = np.asarray(leaves_rev)
    nw = np.asarray(n_words)
    got = [lw[lr[: nw[i], i][::-1]].tolist() for i in range(B)]
    assert got == words
