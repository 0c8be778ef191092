"""DP kernel parity vs the numpy reference-semantics oracle (SURVEY.md §4:
property tests for DP kernels against the obvious O(T*S^2) oracle)."""

import numpy as np
import pytest

from speech_recognition_jax.models.graph import build_word_graph
from speech_recognition_jax.models.hmm import linear_init_cost
from speech_recognition_jax.ops.viterbi import (
    viterbi,
    viterbi_backtrace,
    viterbi_path_cost,
)
from speech_recognition_jax.utils.numerics import POS_INF, to_cost_matrix
from tests.oracles.dp_ref import decode_hmm_states_oracle, dtw_oracle


def left_to_right_trans(S, rng, skip=True):
    t = np.full((S, S), np.inf)
    for i in range(S):
        t[i, i] = rng.uniform(0.1, 1.0)
        if i + 1 < S:
            t[i + 1, i] = rng.uniform(0.1, 1.0)
        if skip and i + 2 < S:
            t[i + 2, i] = rng.uniform(0.5, 2.0)
    return t


@pytest.mark.parametrize("T,S", [(20, 5), (37, 8), (5, 5)])
def test_linear_viterbi_matches_dtw_oracle(rng, T, S):
    emis = rng.uniform(0.0, 5.0, size=(T, S))
    trans = left_to_right_trans(S, rng)
    ref_costs, ref_path = dtw_oracle(emis, trans)

    res = viterbi(
        emis.astype(np.float32),
        to_cost_matrix(trans),
        linear_init_cost(S),
        np.int32(T),
    )
    np.testing.assert_allclose(res.final_cost[-1], ref_costs[-1, -1], rtol=1e-5)

    # per-frame state occupancy: oracle path covers frames 0..T-2 plus the
    # forced endpoint (S-1, T-1)
    states = np.asarray(
        viterbi_backtrace(res.bp, res.eps_bp, np.int32(S - 1), np.int32(T))[0]
    )
    ref_states = np.zeros(T, dtype=np.int64)
    ref_states[T - 1] = S - 1
    for i, j in ref_path:
        ref_states[j] = i
    np.testing.assert_array_equal(states, ref_states)


def test_masked_frames_ignored(rng):
    T, S, true_t = 30, 6, 19
    emis = rng.uniform(0.0, 5.0, size=(T, S)).astype(np.float32)
    trans = to_cost_matrix(left_to_right_trans(S, rng))
    full = viterbi(emis[:true_t], trans, linear_init_cost(S), np.int32(true_t))
    padded = viterbi(emis, trans, linear_init_cost(S), np.int32(true_t))
    np.testing.assert_allclose(full.final_cost, padded.final_cost, rtol=1e-6)
    s_full = viterbi_backtrace(full.bp, full.eps_bp, np.int32(S - 1), np.int32(true_t))[0]
    s_pad = viterbi_backtrace(padded.bp, padded.eps_bp, np.int32(S - 1), np.int32(true_t))[0]
    np.testing.assert_array_equal(np.asarray(s_full), np.asarray(s_pad)[:true_t])


def _sausage_fixture(rng, n_layers=3, n_words=2, S=3):
    """Small word sausage + the equivalent explicit-NES reference arrays."""
    model_trans = [left_to_right_trans(S, rng, skip=False) for _ in range(n_words)]
    label_matrix = [list(range(n_words)) for _ in range(n_layers)]
    g = build_word_graph(model_trans, label_matrix)

    # reference layout: NES0, layer0 words, NES1, layer1 words, ...
    n_ref = 1 + n_layers * (n_words * S + 1)
    ref_trans = np.full((n_ref, n_ref), np.inf)
    is_nes = np.zeros(n_ref, dtype=bool)
    is_nes[0] = True
    idx = 1
    nes_idx = [0]
    starts, ends = [], []
    emit_map = []  # ref emitting index -> graph emitting index
    for layer in range(n_layers):
        for w in range(n_words):
            starts.append((layer, idx))
            ends.append((layer, idx + S - 1))
            ref_trans[idx : idx + S, idx : idx + S] = model_trans[w]
            emit_map += list(range(idx, idx + S))
            idx += S
        is_nes[idx] = True
        nes_idx.append(idx)
        idx += 1
    for layer, s in starts:
        ref_trans[s, nes_idx[layer]] = 0.0
    for layer, e in ends:
        ref_trans[nes_idx[layer + 1], e] = 0.0
    end_points = [[e, -1] for layer, e in ends if layer == n_layers - 1]
    return g, ref_trans, is_nes, np.array(emit_map), end_points


def test_sausage_graph_matches_nes_oracle(rng):
    g, ref_trans, is_nes, emit_map, end_points = _sausage_fixture(rng)
    T = 25
    emis_graph = rng.uniform(0.0, 5.0, size=(T, g.n_states))
    emis_ref = np.zeros((T, ref_trans.shape[0]))
    emis_ref[:, emit_map] = emis_graph

    ref_costs, ref_path, ref_best = decode_hmm_states_oracle(
        emis_ref, ref_trans, is_nes, end_points
    )

    res = viterbi(
        emis_graph.astype(np.float32),
        g.trans,
        g.init_cost,
        np.int32(T),
        eps_trans=g.eps_trans,
        eps_depth=g.eps_depth,
    )
    best = np.min(np.asarray(res.final_cost)[g.end_states])
    np.testing.assert_allclose(best, ref_best, rtol=1e-5)

    # word sequence parity: dedupe consecutive slots on both sides
    end_state = g.end_states[int(np.argmin(np.asarray(res.final_cost)[g.end_states]))]
    states = np.asarray(
        viterbi_backtrace(
            res.bp, res.eps_bp, np.int32(end_state), np.int32(T), eps_depth=g.eps_depth
        )[0]
    )
    slots = g.slot[states]
    words = [g.slot_label[s] for s in _dedupe(slots)]

    # reference word sequence from path state ids (main.py:59-67 semantics):
    # map ref emitting states -> slots via graph enumeration order
    ref_state_seq = [p[0] for p in reversed(ref_path.tolist())]
    ref_emit_pos = {int(r): i for i, r in enumerate(emit_map)}
    ref_slots = []
    for r in ref_state_seq:
        if not is_nes[r]:
            ref_slots.append(int(g.slot[ref_emit_pos[r]]))
    # the backtrace excludes the endpoint state; append it
    best_end = min(end_points, key=lambda e: ref_costs[e[0], -1])
    ref_slots.append(int(g.slot[ref_emit_pos[best_end[0]]]))
    ref_words = [g.slot_label[s] for s in _dedupe(np.array(ref_slots))]
    assert words == ref_words


def _dedupe(seq):
    out = []
    for s in seq:
        if not out or out[-1] != s:
            out.append(int(s))
    return out


def test_path_cost_convenience(rng):
    T, S = 15, 5
    emis = rng.uniform(0.0, 3.0, size=(T, S)).astype(np.float32)
    trans = to_cost_matrix(left_to_right_trans(S, rng))
    c = viterbi_path_cost(emis, trans, linear_init_cost(S), np.int32(T))
    res = viterbi(emis, trans, linear_init_cost(S), np.int32(T))
    assert float(c) == float(res.final_cost[-1])


def test_beam_pruning_keeps_best_path_when_wide(rng):
    T, S = 20, 6
    emis = rng.uniform(0.0, 5.0, size=(T, S)).astype(np.float32)
    trans = to_cost_matrix(left_to_right_trans(S, rng))
    full = viterbi(emis, trans, linear_init_cost(S), np.int32(T))
    pruned = viterbi(emis, trans, linear_init_cost(S), np.int32(T), beam_width=S)
    np.testing.assert_allclose(full.final_cost, pruned.final_cost, rtol=1e-6)


def test_optional_layer_matches_nes_oracle(rng):
    """Skippable (optional) layers: NES->NES skip edges, closed through
    the same epsilon machinery, vs the explicit-NES reference oracle."""
    S = 3
    model_trans = [left_to_right_trans(S, rng, skip=False) for _ in range(2)]
    # layers: [w0] [w1 optional] [w0]
    g = build_word_graph(model_trans, [[0], [1], [0]], optional_layers={1})

    # explicit-NES construction with the extra NES1 -> NES2 edge
    n_ref = 1 + 3 * (S + 1)
    ref_trans = np.full((n_ref, n_ref), np.inf)
    is_nes = np.zeros(n_ref, dtype=bool)
    is_nes[0] = True
    idx, nes = 1, [0]
    starts, ends = [], []
    for layer, w in enumerate([0, 1, 0]):
        starts.append((layer, idx))
        ends.append((layer, idx + S - 1))
        ref_trans[idx : idx + S, idx : idx + S] = model_trans[w]
        idx += S
        is_nes[idx] = True
        nes.append(idx)
        idx += 1
    for layer, s in starts:
        ref_trans[s, nes[layer]] = 0.0
    for layer, e in ends:
        ref_trans[nes[layer + 1], e] = 0.0
    ref_trans[nes[2], nes[1]] = 0.0  # skip the optional layer

    T = 20
    emis_graph = rng.uniform(0, 5, (T, g.n_states))
    emis_ref = np.zeros((T, n_ref))
    emit_cols = [i for i in range(n_ref) if not is_nes[i]]
    emis_ref[:, emit_cols] = emis_graph
    end_points = [[e, -1] for layer, e in ends if layer == 2]

    ref_costs, ref_path, ref_best = decode_hmm_states_oracle(
        emis_ref, ref_trans, is_nes, end_points
    )
    res = viterbi(
        emis_graph.astype(np.float32), g.trans, g.init_cost, np.int32(T),
        eps_trans=g.eps_trans, eps_depth=g.eps_depth,
    )
    best = np.min(np.asarray(res.final_cost)[g.end_states])
    np.testing.assert_allclose(best, ref_best, rtol=1e-5)


def test_transcript_graph_with_silence_decodes(rng):
    """transcript_graph with skippable silence aligns word-only audio
    (silence layers skipped) and silence-padded audio (layers used)."""
    from speech_recognition_jax.models.graph import transcript_graph
    from speech_recognition_jax.ops.viterbi_banded import (
        banded_arrays,
        banded_backtrace,
        viterbi_banded,
    )
    import jax.numpy as jnp

    S = 3
    model_trans = [left_to_right_trans(S, rng, skip=False) for _ in range(3)]
    SIL = 2
    g = transcript_graph(model_trans, [0, 1], sil=SIL)
    bg = banded_arrays(g)

    # emissions preferring: sil(4) w0(5) sil(3) w1(5) sil(3)
    segs = [(SIL, 4), (0, 5), (SIL, 3), (1, 5), (SIL, 3)]
    # map (word occurrence order) -> graph slots: layers [sil][w0][sil][w1][sil]
    T = sum(n for _, n in segs)
    emis = np.full((T, g.n_states), 10.0, np.float32)
    t = 0
    layer_for_seg = [0, 1, 2, 3, 4]
    for (wid, n), layer in zip(segs, layer_for_seg):
        # favor the states of the slot in this layer
        slot_ids = [s for s in range(len(g.slot_label))
                    if g.slot_layer[s] == layer]
        state_ids = np.nonzero(np.isin(g.slot, slot_ids))[0]
        for k in range(n):
            emis[t + k, state_ids] = 0.1
        t += n
    fin, bp8, eps_u = viterbi_banded(jnp.asarray(emis), bg, jnp.int32(T),
                                     eps_depth=g.eps_depth)
    ends = np.asarray(bg.end_states)
    best = int(ends[np.argmin(np.asarray(fin)[ends])])
    states, flags = banded_backtrace(bp8, eps_u, bg, jnp.int32(best),
                                     jnp.int32(T), eps_depth=g.eps_depth)
    from speech_recognition_jax.decode.connected import states_to_words

    words = states_to_words(g, np.asarray(states), T, np.asarray(flags),
                            drop_labels={SIL})
    assert words == [0, 1]

    # word-only audio: the silence layers must be skipped
    segs2 = [(0, 6), (1, 6)]
    T2 = sum(n for _, n in segs2)
    emis2 = np.full((T2, g.n_states), 10.0, np.float32)
    t = 0
    for (wid, n), layer in zip(segs2, [1, 3]):
        slot_ids = [s for s in range(len(g.slot_label)) if g.slot_layer[s] == layer]
        state_ids = np.nonzero(np.isin(g.slot, slot_ids))[0]
        for k in range(n):
            emis2[t + k, state_ids] = 0.1
        t += n
    fin2, bp82, eps_u2 = viterbi_banded(jnp.asarray(emis2), bg, jnp.int32(T2),
                                        eps_depth=g.eps_depth)
    best2 = int(ends[np.argmin(np.asarray(fin2)[ends])])
    states2, flags2 = banded_backtrace(bp82, eps_u2, bg, jnp.int32(best2),
                                       jnp.int32(T2), eps_depth=g.eps_depth)
    words2 = states_to_words(g, np.asarray(states2), T2, np.asarray(flags2),
                             drop_labels={SIL})
    assert words2 == [0, 1]
