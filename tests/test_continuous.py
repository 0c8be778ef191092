"""Embedded continuous training on synthetic connected-digit audio."""

import jax
import numpy as np
import pytest

from speech_recognition_jax.config import FrontendConfig, HMMConfig, TrainConfig
from speech_recognition_jax.data.synthetic import SyntheticDigits
from speech_recognition_jax.models.hmm import HMMBank
from speech_recognition_jax.ops.frontend import mfcc39, padded_length
from speech_recognition_jax.train.continuous import (
    continuous_train,
    harvest_state_ids,
)
from speech_recognition_jax.train.isolated import fit_hmm


def test_harvest_state_ids():
    ids = np.array([[0, 0, 1, 1, 1, 0, -1, -1], [2, 2, 2, 2, -1, -1, -1, -1]])
    frames, runs = harvest_state_ids(ids)
    np.testing.assert_array_equal(frames, [3, 3, 4])
    np.testing.assert_array_equal(runs, [2, 1, 1])


def test_continuous_training_improves_connected_decode():
    cfg = FrontendConfig()
    gen = SyntheticDigits(seed=3)
    hmm_cfg = HMMConfig(n_mix=2)
    train_cfg = TrainConfig(continuous_max_iters=3)

    iso = gen.isolated_corpus(5, tag="train")
    cont = gen.continuous_corpus(40, min_len=2, max_len=4, tag="cont")
    test = gen.continuous_corpus(6, min_len=2, max_len=4, tag="ctest")

    L = padded_length(cfg, 60000)

    def featurize(utts):
        feats, lens = [], []
        for u in utts:
            buf = np.zeros(L, np.float32)
            buf[: len(u.samples)] = u.samples
            f, nf = mfcc39(buf, np.int32(len(u.samples)), cfg)
            feats.append(np.asarray(f))
            lens.append(int(nf))
        return feats, lens

    iso_feats, iso_lens = featurize(iso)
    cont_feats, cont_lens = featurize(cont)
    test_feats, test_lens = featurize(test)

    # isolated bootstrap
    models = []
    pad_to = max(iso_lens)
    for d in range(11):
        idx = [i for i, u in enumerate(iso) if u.labels == [d]]
        temps = [iso_feats[i][: iso_lens[i]].astype(np.float64) for i in idx]
        models.append(
            fit_hmm(jax.random.PRNGKey(d), temps, hmm_cfg=hmm_cfg,
                    train_cfg=train_cfg, pad_to=pad_to)
        )
    bank = HMMBank.stack(models)

    def stack(feats, lens):
        tmax = max(lens)
        b = len(feats)
        fb = np.zeros((b, tmax, 39), np.float32)
        for i in range(b):
            fb[i, : lens[i]] = feats[i][: lens[i]]
        return fb, np.asarray(lens, np.int32)

    fb, nb = stack(cont_feats, cont_lens)
    labels = [u.labels for u in cont]
    trained = continuous_train(
        jax.random.PRNGKey(42), bank, fb, nb, labels,
        hmm_cfg=hmm_cfg, train_cfg=train_cfg,
    )

    # decode the held-out connected test set with per-utterance-length
    # sausages (known length, like the reference's fixed-slot decode)
    from speech_recognition_jax.decode.connected import (
        connected_graph_arrays,
        decode_connected,
    )

    tb, tn = stack(test_feats, test_lens)

    def wer_digits(b):
        errs = tot = 0
        from speech_recognition_jax.utils.metrics import edit_distance

        for i, u in enumerate(test):
            g = connected_graph_arrays(b, len(u.labels))
            seqs, _ = decode_connected(
                b, g, tb[i : i + 1], tn[i : i + 1]
            )
            hyp = seqs[0]
            errs += edit_distance(hyp, u.labels)
            tot += len(u.labels)
        return errs / tot

    wer_after = wer_digits(trained)
    assert wer_after <= 0.15, f"digit WER after embedded training {wer_after}"


def test_word_confidence_tracks_noise(rng):
    """Frame-posterior word confidence: clean decodes score near 1,
    noisy decodes score lower; values are valid posteriors."""
    import jax.numpy as jnp

    from speech_recognition_jax.decode.confidence import (
        path_posteriors,
        word_confidence,
    )
    from speech_recognition_jax.decode.connected import (
        _decode_banded_batch,
        decode_connected,
    )
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.graph import build_loop_graph
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.ops.viterbi_banded import banded_arrays
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    params = [random_gmm_hmm(rng, n_states=3, n_mix=1, dim=6, sep=6.0)
              for _ in range(4)]
    bank = HMMBank.stack([GMMHMM(
        means=jnp.asarray(p["means"], jnp.float32),
        log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
        log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
        trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
    ) for p in params])
    graph = build_loop_graph([p["trans"] for p in params])
    bg = banded_arrays(graph)

    def corpus(noise):
        seqs, xs, nfs = [], [], []
        for _ in range(6):
            seq = [int(rng.integers(0, 4)) for _ in range(4)]
            frames = []
            for w in seq:
                for s in range(3):
                    for _ in range(3):
                        frames.append(params[w]["means"][s, 0]
                                      + noise * rng.standard_normal(6))
            seqs.append(seq)
            xs.append(np.asarray(frames, np.float32))
            nfs.append(len(frames))
        t = max(nfs)
        fb = np.zeros((6, t, 6), np.float32)
        for i, x in enumerate(xs):
            fb[i, : len(x)] = x
        return seqs, jnp.asarray(fb), jnp.asarray(np.asarray(nfs, np.int32))

    def mean_conf(noise):
        seqs, fb, nfs = corpus(noise)
        states, eps_flags, costs = _decode_banded_batch(
            bank, fb, nfs, bg, eps_depth=graph.eps_depth)
        post = path_posteriors(bank, bg, fb, nfs, states,
                               eps_depth=graph.eps_depth)
        post_np = np.asarray(post)
        vals = []
        for i in range(fb.shape[0]):
            wc = word_confidence(graph, np.asarray(states)[i], 
                                 np.asarray(eps_flags)[i], post_np[i],
                                 int(nfs[i]))
            assert all(0.0 <= c <= 1.0 + 1e-6 for _, c in wc)
            vals.extend(c for _, c in wc)
        return float(np.mean(vals))

    clean = mean_conf(0.2)
    noisy = mean_conf(3.0)
    assert clean > 0.9, clean
    assert noisy < clean, (noisy, clean)
