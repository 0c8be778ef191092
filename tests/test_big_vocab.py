"""Stress: 100+-word vocabularies — banded and state-sharded kernels
stay bit-identical to the dense reference kernel, including
beyond the 127-word int8 limit (eps origins ride the int32 side
plane)."""

import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.graph import build_loop_graph
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
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


def test_100_word_loop_graph(rng):
    n_words, s = 100, 5
    trans = []
    for _ in range(n_words):
        t = np.full((s, s), np.inf)
        for i in range(s):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < s:
                t[i + 1, i] = rng.uniform(0.1, 1)
        trans.append(t)
    g = build_loop_graph(trans)
    assert g.n_states == 500
    bg = banded_arrays(g)

    T = 60
    nll = rng.uniform(0, 5, (T, g.n_states)).astype(np.float32)

    ref = viterbi(jnp.asarray(nll), jnp.asarray(g.trans), jnp.asarray(g.init_cost),
                  jnp.int32(T), eps_trans=jnp.asarray(g.eps_trans), eps_depth=1)
    fin_b, _, _ = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(T))
    np.testing.assert_allclose(np.asarray(fin_b), np.asarray(ref.final_cost), rtol=1e-6)

    mesh = make_mesh(shape=(1, 8))
    bgp, s_orig = pad_banded_for_sharding(bg, 8)
    nll_pad = np.zeros((T, bgp.band.shape[1]), np.float32)
    nll_pad[:, :s_orig] = nll
    run = make_sharded_banded_viterbi(mesh, bgp, eps_depth=1)
    fin_s, _, _ = run(jnp.asarray(nll_pad), T)
    np.testing.assert_allclose(np.asarray(fin_s)[:s_orig], np.asarray(ref.final_cost), rtol=1e-6)


def test_vocab_beyond_int8_cap(rng):
    """200-word loop graph — beyond the 127-word int8 cap.  The eps
    side plane widens to int32; costs, backtraced states and boundary
    flags stay bit-identical to the dense kernel, on both the vmapped
    and the state-major layouts."""
    from speech_recognition_jax.ops.viterbi_banded import (
        _eps_u_dtype,
        banded_backtrace_tb,
        viterbi_banded_tb,
    )

    n_words, s = 200, 3
    trans = []
    for _ in range(n_words):
        t = np.full((s, s), np.inf)
        for i in range(s):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < s:
                t[i + 1, i] = rng.uniform(0.1, 1)
        trans.append(t)
    g = build_loop_graph(trans)
    bg = banded_arrays(g)
    assert _eps_u_dtype(bg.word_ends.shape[0]) == jnp.int32

    T = 25
    nll = rng.uniform(0, 5, (T, g.n_states)).astype(np.float32)
    ref = viterbi(jnp.asarray(nll), jnp.asarray(g.trans),
                  jnp.asarray(g.init_cost), jnp.int32(T),
                  eps_trans=jnp.asarray(g.eps_trans), eps_depth=1)
    fin, bp8, eps_u = viterbi_banded(jnp.asarray(nll), bg, jnp.int32(T))
    np.testing.assert_allclose(np.asarray(fin), np.asarray(ref.final_cost),
                               rtol=1e-6)
    assert np.asarray(eps_u).dtype == np.int32

    end = int(g.end_states[np.argmin(np.asarray(fin)[g.end_states])])
    s_ref, f_ref = viterbi_backtrace(ref.bp, ref.eps_bp, jnp.int32(end),
                                     jnp.int32(T))
    s_b, f_b = banded_backtrace(bp8, eps_u, bg, jnp.int32(end), jnp.int32(T))
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_b))
    np.testing.assert_array_equal(np.asarray(f_ref), np.asarray(f_b))

    # state-major layout on the same graph (batch of 2: the full and a
    # truncated utterance)
    nfs = np.array([T, T - 7], np.int32)
    nll_tb = jnp.asarray(np.stack([nll, nll], axis=-1))
    f_tb, bp_tb, eu_tb = viterbi_banded_tb(nll_tb, bg, jnp.asarray(nfs))
    assert np.asarray(eu_tb).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(f_tb)[:, 0], np.asarray(fin))
    ref2 = viterbi(jnp.asarray(nll), jnp.asarray(g.trans),
                   jnp.asarray(g.init_cost), jnp.int32(nfs[1]),
                   eps_trans=jnp.asarray(g.eps_trans), eps_depth=1)
    np.testing.assert_allclose(np.asarray(f_tb)[:, 1],
                               np.asarray(ref2.final_cost), rtol=1e-6)
    end2 = int(g.end_states[np.argmin(np.asarray(ref2.final_cost)[g.end_states])])
    s_tb, f_tbf = banded_backtrace_tb(bp_tb, eu_tb, bg,
                                      jnp.asarray([end, end2], np.int32),
                                      jnp.asarray(nfs))
    s_ref2, f_ref2 = viterbi_backtrace(ref2.bp, ref2.eps_bp, jnp.int32(end2),
                                       jnp.int32(nfs[1]))
    np.testing.assert_array_equal(np.asarray(s_tb)[:, 0], np.asarray(s_ref))
    np.testing.assert_array_equal(np.asarray(f_tbf)[:, 0], np.asarray(f_ref))
    n2 = int(nfs[1])
    np.testing.assert_array_equal(np.asarray(s_tb)[:n2, 1],
                                  np.asarray(s_ref2)[:n2])
    np.testing.assert_array_equal(np.asarray(f_tbf)[:n2, 1],
                                  np.asarray(f_ref2)[:n2])
