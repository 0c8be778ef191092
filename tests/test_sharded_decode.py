"""State-sharded banded Viterbi on the 8-device virtual mesh must be
bit-identical to the single-device kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.models.graph import build_loop_graph, build_word_graph
from speech_recognition_jax.ops.viterbi_banded import (
    banded_arrays,
    banded_backtrace,
    viterbi_banded,
)
from speech_recognition_jax.parallel.mesh import make_mesh
from speech_recognition_jax.parallel.sharded_decode import (
    make_sharded_banded_viterbi,
    pad_banded_for_sharding,
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


@pytest.mark.parametrize("kind", ["sausage", "loop"])
def test_sharded_matches_single_device(rng, kind):
    if kind == "sausage":
        g = build_word_graph([ltr(5, rng) for _ in range(6)], [list(range(6))] * 3)
    else:
        g = build_loop_graph([ltr(5, rng) for _ in range(6)])
    bg = banded_arrays(g)

    mesh = make_mesh(shape=(1, 8))  # all 8 devices on the 'model' axis
    bgp, s_orig = pad_banded_for_sharding(bg, 8)
    s_pad = bgp.band.shape[1]

    T = 41
    nll = rng.uniform(0, 5, (T, s_orig)).astype(np.float32)
    nll_pad = np.zeros((T, s_pad), np.float32)
    nll_pad[:, :s_orig] = nll

    run = make_sharded_banded_viterbi(mesh, bgp, eps_depth=g.eps_depth)
    for nf in [T, 23]:
        fin_s, bp8_s, eps_u_s = run(jnp.asarray(nll_pad), nf)
        fin_1, bp8_1, eps_u_1 = viterbi_banded(
            jnp.asarray(nll), bg, jnp.int32(nf), eps_depth=g.eps_depth
        )
        np.testing.assert_allclose(
            np.asarray(fin_s)[:s_orig], np.asarray(fin_1), rtol=1e-6
        )
        np.testing.assert_array_equal(
            np.asarray(bp8_s)[:, :s_orig], np.asarray(bp8_1)
        )
        np.testing.assert_array_equal(np.asarray(eps_u_s), np.asarray(eps_u_1))
        # backtrace through the sharded backpointers
        end = int(g.end_states[-1])
        s1, f1 = banded_backtrace(bp8_1, eps_u_1, bg, jnp.int32(end),
                                  jnp.int32(nf), eps_depth=g.eps_depth)
        s2, f2 = banded_backtrace(jnp.asarray(np.asarray(bp8_s)[:, :s_orig]),
                                  eps_u_s, bg, jnp.int32(end), jnp.int32(nf),
                                  eps_depth=g.eps_depth)
        np.testing.assert_array_equal(np.asarray(s1)[:nf], np.asarray(s2)[:nf])


def test_sharded_lexgraph_matches_single_device(rng):
    """Cross-arc (lexical-tree) graphs: the state-sharded kernel
    all_gathers the frontier for the parent-end gather; output must
    stay bit-identical to the single-device kernel, including the
    _CROSS backpointer codes and the eps side plane."""
    from speech_recognition_jax.models.lexgraph import build_lex_graph

    words = ["aa", "ab", "abb", "ba", "b", "cab", "ca", "c"]
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    unit_trans = [ltr(3, rng, skip=(i % 2 == 0)) for i in range(len(units))]
    uni = rng.uniform(0.5, 3.0, len(words)).astype(np.float32)
    lexg = build_lex_graph(words, unit_trans, unit_ids, unigram_cost=uni,
                           word_insertion_cost=0.4)
    bg = lexg.banded
    s_orig = lexg.n_states

    mesh = make_mesh(shape=(1, 8))
    bgp, _ = pad_banded_for_sharding(bg, 8)
    s_pad = bgp.band.shape[1]

    T = 37
    e = rng.uniform(0, 5, (T, len(units) * 3)).astype(np.float32)
    nll = e[:, np.asarray(bg.bank_state)]
    nll_pad = np.zeros((T, s_pad), np.float32)
    nll_pad[:, :s_orig] = nll

    run = make_sharded_banded_viterbi(mesh, bgp, eps_depth=lexg.eps_depth)
    for nf in [T, 19]:
        fin_s, bp8_s, eps_u_s = run(jnp.asarray(nll_pad), nf)
        fin_1, bp8_1, eps_u_1 = viterbi_banded(jnp.asarray(nll), bg,
                                               jnp.int32(nf))
        np.testing.assert_array_equal(np.asarray(fin_s)[:s_orig],
                                      np.asarray(fin_1))
        np.testing.assert_array_equal(np.asarray(bp8_s)[:, :s_orig],
                                      np.asarray(bp8_1))
        np.testing.assert_array_equal(np.asarray(eps_u_s).astype(np.int32),
                                      np.asarray(eps_u_1).astype(np.int32))
        ends = np.asarray(bg.end_states)
        best = int(ends[np.argmin(np.asarray(fin_1)[ends])])
        s1, f1 = banded_backtrace(bp8_1, eps_u_1, bg, jnp.int32(best),
                                  jnp.int32(nf))
        s2, f2 = banded_backtrace(jnp.asarray(np.asarray(bp8_s)[:, :s_orig]),
                                  eps_u_s, bg, jnp.int32(best), jnp.int32(nf))
        np.testing.assert_array_equal(np.asarray(s1)[:nf], np.asarray(s2)[:nf])
        np.testing.assert_array_equal(np.asarray(f1)[:nf], np.asarray(f2)[:nf])


@pytest.mark.parametrize("beam", [7, 20])
def test_sharded_collective_beam_matches_single_device(rng, beam):
    """Global rank beam via all_gather of local top-k == the
    single-device threshold beam, bit for bit (costs and backpointers),
    including beams wider than one shard (beam > C = S/8)."""
    g = build_loop_graph([ltr(5, rng) for _ in range(6)])
    bg = banded_arrays(g)
    mesh = make_mesh(shape=(1, 8))
    bgp, s_orig = pad_banded_for_sharding(bg, 8)
    s_pad = bgp.band.shape[1]

    T = 29
    nll = rng.uniform(0, 5, (T, s_orig)).astype(np.float32)
    nll_pad = np.full((T, s_pad), 1e30, np.float32)
    nll_pad[:, :s_orig] = nll

    run = make_sharded_banded_viterbi(mesh, bgp, eps_depth=g.eps_depth,
                                      beam_width=beam)
    fin_s, bp8_s, eps_u_s = run(jnp.asarray(nll_pad), T)
    fin_1, bp8_1, eps_u_1 = viterbi_banded(
        jnp.asarray(nll), bg, jnp.int32(T), eps_depth=g.eps_depth,
        beam_width=beam)
    np.testing.assert_array_equal(np.asarray(fin_s)[:s_orig], np.asarray(fin_1))
    np.testing.assert_array_equal(np.asarray(bp8_s)[:, :s_orig],
                                  np.asarray(bp8_1))
    np.testing.assert_array_equal(np.asarray(eps_u_s), np.asarray(eps_u_1))
