"""Banded Viterbi: bit-parity with the dense kernel on every graph
family, and the decode_connected banded backend."""

import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.models.graph import build_loop_graph, build_word_graph
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.ops.viterbi_banded import (
    banded_arrays,
    banded_backtrace,
    viterbi_banded,
)


def ltr(S, rng, skip=True):
    t = np.full((S, S), np.inf)
    for i in range(S):
        t[i, i] = rng.uniform(0.1, 1)
        if i + 1 < S:
            t[i + 1, i] = rng.uniform(0.1, 1)
        if skip and i + 2 < S:
            t[i + 2, i] = rng.uniform(0.5, 2)
    return t


def graphs(rng):
    return [
        ("sausage", build_word_graph([ltr(5, rng) for _ in range(4)], [list(range(4))] * 3)),
        ("linear", build_word_graph([ltr(5, rng) for _ in range(4)], [[2], [0], [3]])),
        ("loop", build_loop_graph([ltr(5, rng) for _ in range(4)])),
    ]


@pytest.mark.parametrize("nf", [37, 19, 1])
def test_banded_matches_dense(rng, nf):
    for name, g in graphs(rng):
        bg = banded_arrays(g)
        T = 37
        nll = rng.uniform(0, 5, (T, g.n_states)).astype(np.float32)
        ref = viterbi(
            jnp.asarray(nll), jnp.asarray(g.trans), jnp.asarray(g.init_cost),
            jnp.int32(nf), eps_trans=jnp.asarray(g.eps_trans), eps_depth=g.eps_depth,
        )
        fin, bp8, eps_u = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(nf), eps_depth=g.eps_depth)
        np.testing.assert_allclose(
            np.asarray(fin), np.asarray(ref.final_cost), rtol=1e-6, err_msg=name
        )
        end = int(g.end_states[-1])
        s1, f1 = viterbi_backtrace(
            ref.bp, ref.eps_bp, jnp.int32(end), jnp.int32(nf), eps_depth=g.eps_depth
        )
        s2, f2 = banded_backtrace(bp8, eps_u, bg, jnp.int32(end), jnp.int32(nf), eps_depth=g.eps_depth)
        np.testing.assert_array_equal(np.asarray(s1)[:nf], np.asarray(s2)[:nf], err_msg=name)
        np.testing.assert_array_equal(np.asarray(f1)[:nf], np.asarray(f2)[:nf], err_msg=name)


def test_state_major_layout_bit_parity(rng):
    """viterbi_banded_tb / banded_backtrace_tb ([T,S,B] layout) are
    bit-identical to the vmapped [B,S] kernels, incl. tie-breaking and
    variable lengths."""
    from speech_recognition_jax.ops.viterbi_banded import (
        banded_backtrace_tb,
        viterbi_banded_tb,
    )
    import jax

    for name, g in graphs(rng):
        bg = banded_arrays(g)
        B, T = 5, 31
        nll = rng.uniform(0, 5, (B, T, g.n_states)).astype(np.float32)
        # force exact ties so tie-breaking is exercised
        nll[:, :, 1::3] = nll[:, :, 0::3][:, :, : nll[:, :, 1::3].shape[2]]
        nfs = np.array([31, 17, 1, 30, 8], np.int32)
        f_ref, bp_ref, eu_ref = jax.vmap(
            lambda x, nf: viterbi_banded(x, bg, nf, eps_depth=g.eps_depth)
        )(jnp.asarray(nll), jnp.asarray(nfs))
        f_tb, bp_tb, eu_tb = viterbi_banded_tb(
            jnp.asarray(nll.transpose(1, 2, 0)), bg, jnp.asarray(nfs),
            eps_depth=g.eps_depth,
        )
        np.testing.assert_array_equal(np.asarray(f_ref), np.asarray(f_tb).T,
                                      err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(bp_ref), np.transpose(np.asarray(bp_tb), (2, 0, 1)),
            err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(eu_ref), np.transpose(np.asarray(eu_tb), (2, 0, 1)),
            err_msg=name)
        ends = np.full((B,), int(g.end_states[-1]), np.int32)
        s_ref, e_ref = jax.vmap(
            lambda bp, eu, nf: banded_backtrace(bp, eu, bg, jnp.int32(ends[0]),
                                                nf, eps_depth=g.eps_depth)
        )(bp_ref, eu_ref, jnp.asarray(nfs))
        s_tb, e_tb = banded_backtrace_tb(bp_tb, eu_tb, bg, jnp.asarray(ends),
                                         jnp.asarray(nfs), eps_depth=g.eps_depth)
        for i, nf in enumerate(nfs):
            np.testing.assert_array_equal(np.asarray(s_ref)[i, :nf],
                                          np.asarray(s_tb).T[i, :nf], err_msg=name)
            np.testing.assert_array_equal(np.asarray(e_ref)[i, :nf],
                                          np.asarray(e_tb).T[i, :nf], err_msg=name)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_state_major_matches_dense(rng, which):
    """The production state-major scan + backtrace ([T, S, B] layout)
    equals the dense kernel on every graph family, with forced ties and
    variable lengths."""
    from speech_recognition_jax.ops.viterbi_banded import (
        banded_backtrace_tb,
        viterbi_banded_tb,
    )

    name, g = graphs(rng)[which]
    bg = banded_arrays(g)
    B, T = 4, 17
    nll = rng.uniform(0, 5, (T, g.n_states, B)).astype(np.float32)
    nll[:, 1::3, :] = nll[:, 0::3, :][:, : nll[:, 1::3, :].shape[1], :]  # ties
    nfs = np.array([17, 9, 1, 13], np.int32)
    f_tb, bp_tb, eu_tb = viterbi_banded_tb(jnp.asarray(nll), bg,
                                           jnp.asarray(nfs),
                                           eps_depth=g.eps_depth)
    ends = np.full((B,), int(np.asarray(bg.end_states)[-1]), np.int32)
    s_tb, e_tb = banded_backtrace_tb(bp_tb, eu_tb, bg, jnp.asarray(ends),
                                     jnp.asarray(nfs), eps_depth=g.eps_depth)
    for i, nf in enumerate(nfs):
        ref = viterbi(jnp.asarray(nll[:, :, i]), jnp.asarray(g.trans),
                      jnp.asarray(g.init_cost), jnp.int32(nf),
                      eps_trans=jnp.asarray(g.eps_trans),
                      eps_depth=g.eps_depth)
        np.testing.assert_allclose(np.asarray(f_tb)[:, i],
                                   np.asarray(ref.final_cost), rtol=1e-6,
                                   err_msg=name)
        s_ref, e_ref = viterbi_backtrace(ref.bp, ref.eps_bp,
                                         jnp.int32(ends[i]), jnp.int32(nf),
                                         eps_depth=g.eps_depth)
        np.testing.assert_array_equal(np.asarray(s_tb)[:nf, i],
                                      np.asarray(s_ref)[:nf], err_msg=name)
        np.testing.assert_array_equal(np.asarray(e_tb)[:nf, i],
                                      np.asarray(e_ref)[:nf], err_msg=name)


def _planted_bank(seed, n_models=4, n_states=3, n_mix=1, dim=6, sep=6.0):
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    nprng = np.random.default_rng(seed)
    params = [random_gmm_hmm(nprng, n_states=n_states, n_mix=n_mix, dim=dim,
                             sep=sep) for _ in range(n_models)]
    bank = HMMBank.stack([GMMHMM(
        means=jnp.asarray(p["means"], jnp.float32),
        log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
        log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
        trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
    ) for p in params])
    return bank, params, nprng


def test_decode_banded_batch_matches_dense_graph(rng):
    """The production banded batch (bank emissions gathered to graph
    states, state-major scan, backtrace, end-cost wiring) equals the
    dense-graph batch decoder on the same bank and features."""
    from speech_recognition_jax.decode.connected import (
        _decode_banded_batch,
        _decode_graph_batch,
        connected_graph_arrays,
    )

    bank, _, nprng = _planted_bank(3, n_mix=2, dim=8, sep=2.0)
    graph = connected_graph_arrays(bank, 3)
    bg = banded_arrays(graph)
    B, T = 3, 19
    feats = jnp.asarray(nprng.standard_normal((B, T, 8)), jnp.float32)
    nfs = jnp.asarray(np.array([19, 11, 10], np.int32))
    s0, e0, c0 = _decode_banded_batch(bank, feats, nfs, bg,
                                      eps_depth=graph.eps_depth)
    s1, e1, c1 = _decode_graph_batch(
        bank, feats, nfs, jnp.asarray(graph.trans),
        jnp.asarray(graph.eps_trans), jnp.asarray(graph.init_cost),
        jnp.asarray(graph.end_states), jnp.asarray(graph.end_bonus),
        jnp.asarray(graph.bank_state), eps_depth=graph.eps_depth)
    np.testing.assert_allclose(np.asarray(c0), np.asarray(c1), rtol=1e-6)
    for i, nf in enumerate(np.asarray(nfs)):
        np.testing.assert_array_equal(np.asarray(s0)[i, :nf],
                                      np.asarray(s1)[i, :nf])
        np.testing.assert_array_equal(np.asarray(e0)[i, :nf],
                                      np.asarray(e1)[i, :nf])


@pytest.mark.parametrize("kind", ["loop", "sausage"])
def test_decode_connected_recovers_planted_words(kind):
    """Planted audio with REPEATED words (an eps re-entry to the same
    slot) and variable lengths: the production decode returns the
    planted words, identical to the dense backend, on loop and sausage
    graphs."""
    from speech_recognition_jax.decode.connected import (
        connected_graph_arrays,
        decode_connected,
    )

    bank, params, nprng = _planted_bank(7)
    seqs = [[0, 1, 1, 2], [3, 0], [2, 2, 2]]
    fs, nfs = [], []
    for seq in seqs:
        rows = []
        for w in seq:
            for s in range(3):
                rows += [params[w]["means"][s, 0]
                         + 0.1 * nprng.standard_normal(6)] * 3
        fs.append(np.asarray(rows, np.float32))
        nfs.append(len(rows))
    fb = np.zeros((len(seqs), max(nfs), 6), np.float32)
    for i, x in enumerate(fs):
        fb[i, : len(x)] = x
    nfs = np.asarray(nfs, np.int32)
    graph = (build_loop_graph([p["trans"] for p in params],
                              word_insertion_cost=0.2) if kind == "loop"
             else connected_graph_arrays(bank, 4))
    got, costs = decode_connected(bank, graph, fb, nfs)
    dense, costs_d = decode_connected(bank, graph, fb, nfs, backend="dense")
    if kind == "loop":
        assert got == seqs
    assert got == dense
    np.testing.assert_allclose(costs, costs_d, rtol=1e-5)


def test_need_bp_false_same_costs(rng):
    _, g = graphs(rng)[0]
    bg = banded_arrays(g)
    nll = rng.uniform(0, 5, (20, g.n_states)).astype(np.float32)
    fin1, _, _ = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(20), eps_depth=g.eps_depth)
    fin2, bp, eps_u = viterbi_banded(
        jnp.asarray(nll), bg, jnp.int32(20), eps_depth=g.eps_depth, need_bp=False
    )
    assert bp.shape[0] == 0 and eps_u.shape[0] == 0
    np.testing.assert_allclose(np.asarray(fin1), np.asarray(fin2), rtol=0)


def test_decode_connected_backends_agree(rng):
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.decode.connected import decode_connected
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    n_words, S, M, D = 3, 4, 2, 6
    params = [random_gmm_hmm(rng, S, M, D, sep=4.0) for _ in range(n_words)]
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
    g = build_word_graph([p["trans"] for p in params], [list(range(n_words))] * 2)
    feats = rng.standard_normal((3, 40, D)).astype(np.float32)
    nf = np.asarray([40, 25, 13], np.int32)
    s_b, c_b = decode_connected(bank, g, feats, nf, backend="banded")
    s_d, c_d = decode_connected(bank, g, feats, nf, backend="dense")
    assert s_b == s_d
    np.testing.assert_allclose(c_b, c_d, rtol=1e-5)


def test_banded_beam_wide_is_exact(rng):
    _, g = graphs(rng)[0]
    bg = banded_arrays(g)
    nll = rng.uniform(0, 5, (25, g.n_states)).astype(np.float32)
    exact, _, _ = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(25), eps_depth=g.eps_depth)
    wide, _, _ = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(25),
                                eps_depth=g.eps_depth, beam_width=g.n_states)
    np.testing.assert_allclose(np.asarray(exact), np.asarray(wide), rtol=0)
    narrow, _, _ = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(25),
                                  eps_depth=g.eps_depth, beam_width=6)
    # narrow beam keeps the best end-state cost close to exact here
    e = int(g.end_states[-1])
    assert np.isfinite(np.asarray(narrow)[e])


def test_states_to_words_device_matches_host(rng):
    """The device words-out compaction (states_to_words_device — the
    production wav->word-ids tail) equals the host per-frame loop on a
    LOOP graph with repeated words, where the epsilon-boundary flag is
    what separates consecutive repeats."""
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.decode.connected import (
        _decode_banded_batch,
        states_to_words,
        states_to_words_device,
    )
    from speech_recognition_jax.models.graph import build_loop_graph
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    n_words, S, M, D = 4, 3, 1, 5
    params = [random_gmm_hmm(rng, S, M, D, sep=5.0) for _ in range(n_words)]
    bank = HMMBank.stack(
        [GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
        ) for p in params])
    g = build_loop_graph([p["trans"] for p in params])
    bg = banded_arrays(g)
    # emissions that force repeated words: word 2's means twice in a row
    means = np.asarray(bank.means)[:, :, 0, :]  # [N, S, D]
    rows = []
    for w in (2, 2, 0, 3, 3):
        for st in range(S):
            rows.extend([means[w, st]] * 3)
    feats = np.asarray(rows, np.float32)[None, :, :]
    feats = np.repeat(feats, 2, axis=0)
    feats = feats + 0.05 * rng.standard_normal(feats.shape).astype(np.float32)
    nf = np.asarray([feats.shape[1], feats.shape[1] - 7], np.int32)

    states, eps_flags, costs = _decode_banded_batch(
        bank, jnp.asarray(feats), jnp.asarray(nf), bg,
        eps_depth=g.eps_depth)
    states_np = np.asarray(states)
    eps_np = np.asarray(eps_flags)
    host = [states_to_words(g, states_np[i], int(nf[i]), eps_np[i])
            for i in range(2)]
    words, n_words_ = states_to_words_device(
        jnp.asarray(np.asarray(g.slot, np.int32)),
        jnp.asarray(np.asarray(g.slot_label[g.slot], np.int32)),
        states, eps_flags, jnp.asarray(nf),
        max_words=feats.shape[1])
    words = np.asarray(words)
    dev = [words[i, : int(n_words_[i])].tolist() for i in range(2)]
    assert dev == host
    assert 2 in host[0] and host[0].count(2) >= 2  # repeats actually occur
