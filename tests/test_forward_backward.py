"""Forward-backward: brute-force path-enumeration parity on tiny HMMs."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.ops.forward_backward import forward_backward
from speech_recognition_jax.utils.numerics import POS_INF, to_cost_matrix


def brute_force(nll, trans_cost, init_cost, end_scores):
    """Enumerate all state paths; return (log_z, gamma, xi_sum)."""
    T, S = nll.shape
    logp_paths = []
    gamma = np.zeros((T, S))
    xi = np.zeros((S, S))
    total = 0.0
    contribs = []
    for path in itertools.product(range(S), repeat=T):
        lp = -init_cost[path[0]] - nll[0, path[0]]
        ok = init_cost[path[0]] < POS_INF / 2
        for t in range(1, T):
            c = trans_cost[path[t], path[t - 1]]
            if c >= POS_INF / 2:
                ok = False
                break
            lp += -c - nll[t, path[t]]
        if not ok:
            continue
        lp += end_scores[path[-1]]
        contribs.append((path, lp))
    if not contribs:
        return -np.inf, gamma, xi
    lps = np.array([lp for _, lp in contribs])
    log_z = np.log(np.sum(np.exp(lps - lps.max()))) + lps.max()
    for (path, lp) in contribs:
        w = np.exp(lp - log_z)
        for t in range(T):
            gamma[t, path[t]] += w
        for t in range(1, T):
            xi[path[t], path[t - 1]] += w
    return log_z, gamma, xi


@pytest.mark.parametrize("seed", [0, 1])
def test_fb_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    T, S = 5, 3
    nll = rng.uniform(0.2, 2.0, (T, S))
    trans = np.full((S, S), POS_INF)
    for i in range(S):
        trans[i, i] = rng.uniform(0.2, 1.5)
        if i + 1 < S:
            trans[i + 1, i] = rng.uniform(0.2, 1.5)
    init = np.full((S,), POS_INF)
    init[0] = 0.0
    end_scores = np.full((S,), -np.inf)
    end_scores[S - 1] = 0.0

    ref_z, ref_gamma, ref_xi = brute_force(nll, trans, init, end_scores)

    res = forward_backward(
        jnp.asarray(nll),
        jnp.asarray(to_cost_matrix(trans.astype(np.float32))),
        jnp.asarray(np.where(np.isfinite(init), init, POS_INF).astype(np.float32)),
        jnp.int32(T),
        end_scores=jnp.asarray(np.where(np.isfinite(end_scores), end_scores, -1e30)),
    )
    np.testing.assert_allclose(float(res.log_z), ref_z, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(res.gamma), ref_gamma, atol=1e-4)
    np.testing.assert_allclose(np.asarray(res.xi_sum), ref_xi, atol=1e-4)


def test_fb_masked_frames(rng):
    T, S, nf = 8, 3, 5
    nll = rng.uniform(0.2, 2.0, (T, S)).astype(np.float32)
    trans = np.full((S, S), POS_INF, np.float32)
    for i in range(S):
        trans[i, i] = 0.5
        if i + 1 < S:
            trans[i + 1, i] = 0.7
    init = np.full((S,), POS_INF, np.float32)
    init[0] = 0.0
    full = forward_backward(
        jnp.asarray(nll[:nf]), jnp.asarray(trans), jnp.asarray(init), jnp.int32(nf)
    )
    padded = forward_backward(
        jnp.asarray(nll), jnp.asarray(trans), jnp.asarray(init), jnp.int32(nf)
    )
    np.testing.assert_allclose(float(full.log_z), float(padded.log_z), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(full.gamma), np.asarray(padded.gamma)[:nf], atol=1e-5
    )
    assert np.all(np.asarray(padded.gamma)[nf:] == 0)


def brute_force_eps(nll, trans_cost, eps_cost, init_cost, end_scores, eps_depth=1):
    """Path enumeration including same-column epsilon hops with the
    boundary double-emission semantics (each eps hop's destination
    re-emits the current frame), limited to eps_depth hops per column."""
    T, S = nll.shape
    INF = POS_INF / 2
    terminal = []

    def finish_path(lp, s):
        if np.isfinite(end_scores[s]) and end_scores[s] > -INF:
            terminal.append(lp + end_scores[s])

    def column(t, lp, s, hops):
        # s has just emitted frame t with accumulated log-prob lp
        if t == T - 1:
            finish_path(lp, s)
        else:
            for v in range(S):
                if trans_cost[v, s] < INF:
                    column(t + 1, lp - trans_cost[v, s] - nll[t + 1, v], v, 0)
        if hops < eps_depth:
            for v in range(S):
                if eps_cost[v, s] < INF:
                    column(t, lp - eps_cost[v, s] - nll[t, v], v, hops + 1)

    for s in range(S):
        if init_cost[s] < INF:
            column(0, -init_cost[s] - nll[0, s], s, 0)

    lps = np.array(terminal)
    assert len(lps) > 0
    return float(np.log(np.sum(np.exp(lps - lps.max()))) + lps.max())


def test_fb_with_epsilon_matches_brute_force(rng):
    """Two 2-state words in sequence, connected by an epsilon edge."""
    S, T = 4, 4
    nll = rng.uniform(0.2, 1.5, (T, S))
    trans = np.full((S, S), POS_INF)
    for i in (0, 2):
        trans[i, i] = 0.4
        trans[i + 1, i] = 0.6
        trans[i + 1, i + 1] = 0.4
    eps = np.full((S, S), POS_INF)
    eps[2, 1] = 0.3  # word-1 end -> word-2 start, same column
    init = np.asarray([0.0, POS_INF, POS_INF, POS_INF])
    end_scores = np.full((S,), -1e30)
    end_scores[3] = 0.0

    ref_z = brute_force_eps(nll, trans, eps, init, end_scores)
    res = forward_backward(
        jnp.asarray(nll), jnp.asarray(trans), jnp.asarray(init), jnp.int32(T),
        eps_trans=jnp.asarray(eps), eps_depth=1,
        end_scores=jnp.asarray(end_scores),
    )
    np.testing.assert_allclose(float(res.log_z), ref_z, rtol=1e-4)


def test_band_xi_matches_dense(rng):
    """xi_mode="band" equals the band diagonals of the dense xi on a
    composed (banded) word graph."""
    from speech_recognition_jax.models.graph import build_word_graph
    from speech_recognition_jax.ops.viterbi_banded import MAX_BAND

    def ltr(S):
        t = np.full((S, S), np.inf)
        for i in range(S):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < S:
                t[i + 1, i] = rng.uniform(0.1, 1)
            if i + 2 < S:
                t[i + 2, i] = rng.uniform(0.5, 2)
        return t

    g = build_word_graph([ltr(4) for _ in range(3)], [[0], [2], [1]])
    T = 21
    nll = rng.uniform(0, 3, (T, g.n_states)).astype(np.float32)
    for nf in [T, 11]:
        dense = forward_backward(
            jnp.asarray(nll), jnp.asarray(g.trans), jnp.asarray(g.init_cost),
            jnp.int32(nf), eps_trans=jnp.asarray(g.eps_trans),
            eps_depth=g.eps_depth)
        band = forward_backward(
            jnp.asarray(nll), jnp.asarray(g.trans), jnp.asarray(g.init_cost),
            jnp.int32(nf), eps_trans=jnp.asarray(g.eps_trans),
            eps_depth=g.eps_depth, xi_mode="band")
        np.testing.assert_allclose(np.asarray(band.gamma),
                                   np.asarray(dense.gamma), atol=1e-6)
        xs = np.asarray(dense.xi_sum)
        s = xs.shape[0]
        for d in range(MAX_BAND + 1):
            want = np.zeros(s)
            want[: s - d] = np.diagonal(xs, offset=-d)
            np.testing.assert_allclose(np.asarray(band.xi_sum)[d], want,
                                       atol=1e-6, err_msg=f"offset {d}")


# ---------------------------------------------------------------------------
# Banded forward-backward (ops.forward_backward.forward_backward_banded)
# ---------------------------------------------------------------------------


def _dense_vs_banded(g, bg, nll, nf, end_scores=None, atol=1e-5):
    from speech_recognition_jax.ops.forward_backward import (
        forward_backward_banded,
    )
    from speech_recognition_jax.ops.viterbi_banded import MAX_BAND

    eps_depth = getattr(g, "eps_depth", 1)
    kw = {}
    if end_scores is not None:
        kw["end_scores"] = jnp.asarray(end_scores)
    dense = forward_backward(
        jnp.asarray(nll), jnp.asarray(g.trans), jnp.asarray(g.init_cost),
        jnp.int32(nf), eps_trans=jnp.asarray(g.eps_trans),
        eps_depth=eps_depth, xi_mode="dense", **kw)
    band = forward_backward_banded(
        jnp.asarray(nll), bg, jnp.int32(nf), eps_depth=eps_depth, **kw)
    np.testing.assert_allclose(float(band.log_z), float(dense.log_z),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(band.gamma),
                               np.asarray(dense.gamma), atol=atol)
    xs = np.asarray(dense.xi_sum)
    s = xs.shape[0]
    # the dense oracle counts cross-arc edges in the same [S, S] matrix;
    # the banded pass reports them separately (xi_cross) — fold them back
    # onto whichever diagonal each cross edge happens to land on
    got = np.asarray(band.xi_sum).copy()
    if band.xi_cross is not None:
        cs = np.asarray(bg.cross_src)
        cc = np.asarray(bg.cross_cost)
        xc = np.asarray(band.xi_cross)
        for st in np.nonzero(cc < POS_INF / 2)[0]:
            d = st - cs[st]
            if 0 <= d <= MAX_BAND:
                got[d, cs[st]] += xc[st]
    for d in range(MAX_BAND + 1):
        want = np.zeros(s)
        want[: s - d] = np.diagonal(xs, offset=-d)
        np.testing.assert_allclose(got[d], want,
                                   atol=atol, err_msg=f"offset {d}")


def test_banded_fb_matches_dense_word_graphs(rng):
    """O(3S)/frame banded FB == dense O(S^2) FB on sausage / linear /
    loop graphs (round-2 VERDICT weak item 5: soft stats on composed
    graphs without the dense matrix)."""
    from speech_recognition_jax.models.graph import (
        build_loop_graph,
        build_word_graph,
    )
    from speech_recognition_jax.ops.viterbi_banded import banded_arrays

    def ltr(S):
        t = np.full((S, S), np.inf)
        for i in range(S):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < S:
                t[i + 1, i] = rng.uniform(0.1, 1)
            if i + 2 < S:
                t[i + 2, i] = rng.uniform(0.5, 2)
        return t

    cases = [
        ("sausage", build_word_graph([ltr(5) for _ in range(4)],
                                     [list(range(4))] * 3)),
        ("linear", build_word_graph([ltr(5) for _ in range(4)],
                                    [[2], [0], [3]])),
        ("loop", build_loop_graph([ltr(5) for _ in range(4)])),
    ]
    T = 23
    for name, g in cases:
        bg = banded_arrays(g)
        nll = rng.uniform(0, 3, (T, g.n_states)).astype(np.float32)
        for nf in (T, 13):
            _dense_vs_banded(g, bg, nll, nf)


def test_banded_fb_matches_dense_lexgraph(rng):
    """Cross-arc (lexical-tree) graphs: the banded FB's static-origin
    cross edges + segment-lse reversal equal the dense pass — the case
    the dense-matrix FB forecloses at scale."""
    from speech_recognition_jax.models.lexgraph import build_lex_graph
    from tests.test_lextree_decode import lex_to_dense, ltr, unit_emissions

    words = ["ab", "abc", "ad", "b", "ba"]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng) for _ in units]
    lexg = build_lex_graph(words, unit_trans, unit_ids,
                           word_insertion_cost=0.3)
    trans, eps, init = lex_to_dense(lexg)

    class DenseG:
        pass

    g = DenseG()
    g.trans, g.eps_trans, g.init_cost, g.eps_depth = trans, eps, init, 1

    T = 19
    e, su = unit_emissions(rng, T, unit_trans)
    nll = e[:, np.asarray(lexg.banded.bank_state)]
    # terminal mass restricted to word-end states, like real decodes
    ends = np.asarray(lexg.banded.end_states)
    end_scores = np.full((lexg.n_states,), -np.inf)
    end_scores[ends] = 0.0
    for nf in (T, 9):
        _dense_vs_banded(g, lexg.banded, nll, nf, end_scores=end_scores)
