"""Multi-device tests on the virtual 8-CPU mesh (SURVEY.md §4: the
reference offers no distributed prior art; we test sharding vs
single-device equivalence and the full dry run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.data.synthetic import random_gmm_hmm, sample_hmm_features
from speech_recognition_jax.models.graph import build_word_graph, pad_graphs
from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
from speech_recognition_jax.train.embedded_step import embedded_step
from speech_recognition_jax.utils.numerics import to_cost_matrix


def _bank_from_params(params):
    return HMMBank.stack(
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


@pytest.fixture(scope="module")
def embedded_fixture():
    # shared with the two-process workers (tests/embedded_case.py)
    from embedded_case import make_embedded_case

    bank, feats, n_frames, graph_np, eps_depth, labels = make_embedded_case()
    gdev = {k: jnp.asarray(v) for k, v in graph_np.items()}
    return bank, feats, n_frames, gdev, eps_depth, None, labels


def test_embedded_step_converges_and_decodes(embedded_fixture):
    """Viterbi-EM: total alignment cost decreases monotonically to a fixed
    point, and the trained bank decodes the training word sequences."""
    from speech_recognition_jax.decode.connected import (
        decode_connected,
    )
    from speech_recognition_jax.models.graph import build_loop_graph

    bank, feats, n_frames, gdev, eps_depth, true_params, labels = embedded_fixture
    costs = []
    b = bank
    for _ in range(8):
        b, stats = embedded_step(
            b, jnp.asarray(feats), jnp.asarray(n_frames), gdev, eps_depth=eps_depth,
            var_floor=1e-3,
        )
        costs.append(float(stats.total_cost))
    assert costs[-1] < costs[0], costs
    assert all(c2 <= c1 + 1e-2 for c1, c2 in zip(costs, costs[1:])), costs

    graph = build_loop_graph([np.asarray(b.trans_cost[i]) for i in range(b.n_models)])
    seqs, _ = decode_connected(b, graph, feats, n_frames)
    correct = sum(1 for s, l in zip(seqs, labels) if s == l)
    assert correct >= int(0.8 * len(labels)), (correct, len(labels), seqs[:4], labels[:4])


def test_sharded_step_matches_single_device(embedded_fixture):
    from speech_recognition_jax.parallel.mesh import make_mesh
    from speech_recognition_jax.parallel.trainer import (
        make_sharded_embedded_step,
        shard_embedded_inputs,
    )

    bank, feats, n_frames, gdev, eps_depth, _, _ = embedded_fixture
    single_bank, single_stats = embedded_step(
        bank, jnp.asarray(feats), jnp.asarray(n_frames), gdev, eps_depth=eps_depth
    )

    mesh = make_mesh(shape=(8, 1))
    step = make_sharded_embedded_step(mesh, eps_depth=eps_depth)
    graph_np = {k: np.asarray(v) for k, v in gdev.items()}
    b_s, f_s, n_s, g_s = shard_embedded_inputs(mesh, bank, feats, n_frames, graph_np)
    sharded_bank, sharded_stats = step(b_s, f_s, n_s, g_s)

    np.testing.assert_allclose(
        np.asarray(single_bank.means), np.asarray(sharded_bank.means), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        float(single_stats.total_cost), float(sharded_stats.total_cost), rtol=1e-5
    )


def test_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.all(np.isfinite(np.asarray(out[2])))


def test_soft_embedded_step_converges(embedded_fixture):
    """True Baum-Welch (sum-product) variant: NLL decreases, decode holds."""
    from speech_recognition_jax.models.graph import build_word_graph, pad_graphs
    from speech_recognition_jax.train.embedded_step import embedded_step_soft

    bank, feats, n_frames, _, _, _, labels = embedded_fixture
    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    graphs = [build_word_graph(trans_np, [[l] for l in ls]) for ls in labels]
    batch, eps_depth = pad_graphs(graphs)
    g = {
        k: jnp.asarray(v)
        for k, v in batch.items()
        if k in ("trans", "eps_trans", "init_cost", "end_states", "end_scores", "bank_state")
    }
    b = bank
    nlls = []
    for _ in range(5):
        b, stats = embedded_step_soft(
            b, jnp.asarray(feats), jnp.asarray(n_frames), g,
            eps_depth=eps_depth, var_floor=1e-3,
        )
        nlls.append(float(stats.total_cost))
    assert nlls[-1] < nlls[0], nlls
    assert all(n2 <= n1 + 1e-2 for n1, n2 in zip(nlls, nlls[1:])), nlls


def test_frame_chunked_stats_match_single_chunk(embedded_fixture):
    """frame_chunk streaming accumulation == the monolithic GEMM, for
    both the hard and the soft step (same stats up to fp association)."""
    from speech_recognition_jax.train.embedded_step import embedded_step_soft
    from speech_recognition_jax.models.graph import pad_graphs

    bank, feats, n_frames, gdev, eps_depth, _, labels = embedded_fixture
    big, _ = embedded_step(bank, jnp.asarray(feats), jnp.asarray(n_frames),
                           gdev, eps_depth=eps_depth)
    sm, _ = embedded_step(bank, jnp.asarray(feats), jnp.asarray(n_frames),
                          gdev, eps_depth=eps_depth, frame_chunk=128)
    np.testing.assert_allclose(np.asarray(big.means), np.asarray(sm.means),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(big.trans_cost),
                               np.asarray(sm.trans_cost), rtol=1e-4, atol=1e-5)

    # soft step needs end_scores in the graph batch
    from embedded_case import make_embedded_case
    bank2, feats2, nf2, graph_np, eps_d2, _ = make_embedded_case(seed=9, B=6)
    import numpy as _np
    from speech_recognition_jax.models.graph import build_word_graph
    # rebuild with end_scores included
    trans_np = [_np.asarray(bank2.trans_cost[i]) for i in range(bank2.n_models)]
    # reuse the padded batch from pad_graphs directly
    rng2 = _np.random.default_rng(9)
    gs = [build_word_graph(trans_np, [[int(rng2.integers(0, 4))] for _ in range(3)])
          for _ in range(6)]
    gb, depth = pad_graphs(gs)
    keys = ("trans", "eps_trans", "init_cost", "end_scores", "bank_state")
    gdev2 = {k: jnp.asarray(gb[k]) for k in keys}
    big_s, _ = embedded_step_soft(bank2, jnp.asarray(feats2), jnp.asarray(nf2),
                                  gdev2, eps_depth=depth)
    sm_s, _ = embedded_step_soft(bank2, jnp.asarray(feats2), jnp.asarray(nf2),
                                 gdev2, eps_depth=depth, frame_chunk=100)
    np.testing.assert_allclose(np.asarray(big_s.means), np.asarray(sm_s.means),
                               rtol=1e-4, atol=1e-5)


def test_soft_step_banded_matches_dense(embedded_fixture):
    """embedded_step_soft with the banded graph batch
    (pad_graphs_banded -> O(3S)/frame FB) == the dense [S, S] batch:
    same bank update and same total NLL."""
    from speech_recognition_jax.models.graph import (
        build_word_graph,
        pad_graphs,
        pad_graphs_banded,
    )
    from speech_recognition_jax.train.embedded_step import embedded_step_soft

    bank, feats, n_frames, _, _, _, labels = embedded_fixture
    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    graphs = [build_word_graph(trans_np, [[l] for l in ls]) for ls in labels]
    dense_b, depth = pad_graphs(graphs)
    band_b, depth_b = pad_graphs_banded(graphs)
    assert depth_b == depth
    gd = {k: jnp.asarray(dense_b[k]) for k in
          ("trans", "eps_trans", "init_cost", "end_scores", "bank_state")}
    gb = {k: jnp.asarray(v) for k, v in band_b.items()}

    b1, s1 = embedded_step_soft(bank, jnp.asarray(feats),
                                jnp.asarray(n_frames), gd, eps_depth=depth)
    b2, s2 = embedded_step_soft(bank, jnp.asarray(feats),
                                jnp.asarray(n_frames), gb, eps_depth=depth)
    np.testing.assert_allclose(float(s1.total_cost), float(s2.total_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(b1.means), np.asarray(b2.means),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(b1.log_vars),
                               np.asarray(b2.log_vars), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(b1.trans_cost),
                               np.asarray(b2.trans_cost), rtol=1e-4, atol=1e-4)


def test_pad_graphs_auto_selection():
    """pad_graphs_auto picks the dense dict for transcript-scale graphs
    (the round-3 soft-EM regression: banded FB machinery loses 4x at
    S ~ 30) and the banded dict past BANDED_FB_MIN_STATES."""
    from speech_recognition_jax.models.graph import (
        BANDED_FB_MIN_STATES,
        build_word_graph,
        pad_graphs_auto,
    )

    rng = np.random.default_rng(0)
    def ltr(S=5):
        t = np.full((S, S), np.inf)
        for i in range(S):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < S:
                t[i + 1, i] = rng.uniform(0.1, 1)
        return t

    trans_np = [ltr() for _ in range(5)]
    small = [build_word_graph(trans_np, [[l] for l in [0, 1, 2]])]
    gb_small, _ = pad_graphs_auto(small)
    assert "band" not in gb_small and "trans" in gb_small

    n_words = BANDED_FB_MIN_STATES // 5 + 2
    big = [build_word_graph(trans_np,
                            [[l % 5] for l in range(n_words)])]
    assert big[0].n_states >= BANDED_FB_MIN_STATES
    gb_big, _ = pad_graphs_auto(big)
    assert "band" in gb_big
