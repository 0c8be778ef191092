"""Deterministic embedded-training test case shared by the in-process
parallel tests and the two-process ``jax.distributed`` workers (which
must rebuild identical inputs in separate interpreters)."""

import numpy as np

from speech_recognition_jax.data.synthetic import random_gmm_hmm, sample_hmm_features
from speech_recognition_jax.models.graph import build_word_graph, pad_graphs
from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
from speech_recognition_jax.utils.numerics import to_cost_matrix


def make_embedded_case(seed: int = 5, n_words: int = 4, S: int = 3, M: int = 2,
                       D: int = 8, B: int = 16, T: int = 120):
    """Returns ``(bank, feats [B,T,D], n_frames [B], graph_np dict,
    eps_depth, labels)`` — all host numpy except the bank."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    true_params = [random_gmm_hmm(rng, S, M, D, sep=4.0) for _ in range(n_words)]
    labels = []
    feats = np.zeros((B, T, D), np.float32)
    n_frames = np.zeros((B,), np.int32)
    for b in range(B):
        seq = [int(rng.integers(0, n_words)) for _ in range(3)]
        labels.append(seq)
        fs = []
        for w in seq:
            f, _ = sample_hmm_features(true_params[w], rng, min_frames_per_state=2)
            fs.append(f)
        x = np.concatenate(fs)[:T]
        feats[b, : len(x)] = x
        n_frames[b] = len(x)

    init_params = [
        {
            "means": p["means"] + 0.5 * rng.standard_normal(p["means"].shape),
            "variances": p["variances"] * 1.5,
            "weights": p["weights"],
            "trans": p["trans"],
        }
        for p in true_params
    ]
    bank = HMMBank.stack(
        [
            GMMHMM(
                means=jnp.asarray(p["means"], jnp.float32),
                log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
                log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
                trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
            )
            for p in init_params
        ]
    )
    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(n_words)]
    graphs = [build_word_graph(trans_np, [[l] for l in ls]) for ls in labels]
    graph_batch, eps_depth = pad_graphs(graphs)
    graph_np = {k: np.asarray(v) for k, v in graph_batch.items()
                if k in ("trans", "eps_trans", "init_cost", "end_states",
                         "bank_state")}
    return bank, feats, n_frames, graph_np, eps_depth, labels
