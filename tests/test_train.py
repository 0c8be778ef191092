"""Trainer tests: EM/k-means recovery properties plus the end-to-end
minimum slice (SURVEY.md §7 gate: wav -> MFCC -> isolated 11-digit
GMM-HMM train -> decode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.config import DIGIT_NAMES, HMMConfig, TrainConfig
from speech_recognition_jax.train.em import em_fit
from speech_recognition_jax.train.kmeans import kmeans
from speech_recognition_jax.train.skmeans import calc_transition_costs, skmeans
from speech_recognition_jax.train.isolated import fit_hmm


def test_em_recovers_mixture(rng):
    n, d = 2000, 4
    true_means = np.array([[3.0] * d, [-3.0] * d])
    x = np.concatenate(
        [
            true_means[0] + rng.standard_normal((n // 2, d)),
            true_means[1] + 0.5 * rng.standard_normal((n // 2, d)),
        ]
    ).astype(np.float64)
    mask = np.ones(n, bool)
    m0 = np.array([[2.0] * d, [-2.0] * d])
    v0 = np.ones((2, d))
    w0 = np.array([0.5, 0.5])
    means, variances, w, iters = em_fit(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(m0), jnp.asarray(v0), jnp.asarray(w0)
    )
    means = np.asarray(means)
    order = np.argsort(means[:, 0])[::-1]
    np.testing.assert_allclose(means[order], true_means, atol=0.15)
    np.testing.assert_allclose(np.asarray(w), [0.5, 0.5], atol=0.05)
    np.testing.assert_allclose(np.asarray(variances)[order][1], 0.25, atol=0.08)
    assert int(iters) > 1


def test_em_masked_frames_do_not_contribute(rng):
    n, d = 500, 3
    x = rng.standard_normal((n, d))
    x_pad = np.concatenate([x, 100.0 * np.ones((100, d))])
    mask = np.concatenate([np.ones(n, bool), np.zeros(100, bool)])
    m0 = np.zeros((2, d)) + np.array([[1.0], [-1.0]])
    v0 = np.ones((2, d))
    w0 = np.array([0.5, 0.5])
    a = em_fit(jnp.asarray(x), jnp.ones(n, bool), jnp.asarray(m0), jnp.asarray(v0), jnp.asarray(w0))
    b = em_fit(jnp.asarray(x_pad), jnp.asarray(mask), jnp.asarray(m0), jnp.asarray(v0), jnp.asarray(w0))
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-8)


def test_kmeans_separates_blobs(rng):
    n, d = 600, 5
    blobs = np.concatenate(
        [c + 0.3 * rng.standard_normal((n // 3, d)) for c in ([5.0], [0.0], [-5.0])]
    )
    mask = np.ones(n, bool)
    c0 = np.array([[4.0] * d, [1.0] * d, [-4.0] * d])
    assign, centroids, variances, counts = kmeans(
        jax.random.PRNGKey(0), jnp.asarray(blobs), jnp.asarray(mask), jnp.asarray(c0), 3
    )
    c = np.sort(np.asarray(centroids)[:, 0])
    np.testing.assert_allclose(c, [-5.0, 0.0, 5.0], atol=0.2)
    assert np.all(np.asarray(counts) == n // 3)


def test_calc_transition_costs_basic():
    seg_lens = np.full((4, 5), 10, dtype=np.int64)  # 4 templates, 5 segs, 10 frames
    t = calc_transition_costs(4, seg_lens)
    # each non-final state: p_jump = 4/40 -> cost -log(0.1)
    np.testing.assert_allclose(np.diag(t)[:4], -np.log(0.9), rtol=1e-12)
    np.testing.assert_allclose([t[i + 1, i] for i in range(4)], -np.log(0.1), rtol=1e-12)
    assert t[4, 4] == 0.0  # final state: p_stay = 1
    assert np.isinf(t[0, 1])  # no backward transitions


def test_skmeans_recovers_ordered_states(rng):
    # 3 well-separated sequential "states", variable durations
    d, s = 4, 3
    centers = np.array([[6.0] * d, [0.0] * d, [-6.0] * d])
    temps = []
    for _ in range(6):
        frames = []
        for si in range(s):
            n = rng.integers(5, 12)
            frames.append(centers[si] + 0.3 * rng.standard_normal((n, d)))
        temps.append(np.concatenate(frames).astype(np.float64))
    means, variances, trans, states, _ = skmeans(temps, s)
    np.testing.assert_allclose(means, centers, atol=0.3)
    # alignment should be monotonically non-decreasing within each template
    for i, t in enumerate(temps):
        st = states[i][: t.shape[0]]
        assert np.all(np.diff(st) >= 0)


@pytest.fixture(scope="module")
def digit_setup():
    """Train 11 digit models on a small synthetic audio corpus."""
    import jax as _jax

    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.data.synthetic import SyntheticDigits
    from speech_recognition_jax.models.hmm import HMMBank
    from speech_recognition_jax.ops.frontend import mfcc39, padded_length, max_frames

    cfg = FrontendConfig()
    gen = SyntheticDigits(seed=7)
    n_train, n_test = 6, 3

    def featurize(utts):
        cap = 24000
        L = padded_length(cfg, cap)
        feats, lens = [], []
        for u in utts:
            buf = np.zeros(L, np.float32)
            buf[: len(u.samples)] = u.samples
            f, nf = mfcc39(buf, np.int32(len(u.samples)), cfg)
            feats.append(np.asarray(f))
            lens.append(int(nf))
        return feats, lens

    train = gen.isolated_corpus(n_train, tag="train")
    test = gen.isolated_corpus(n_test, tag="test")
    train_feats, train_lens = featurize(train)
    test_feats, test_lens = featurize(test)

    hmm_cfg = HMMConfig(n_mix=2)
    train_cfg = TrainConfig()
    models = []
    pad_to = max(train_lens)
    for d in range(11):
        idx = [i for i, u in enumerate(train) if u.labels == [d]]
        temps = [train_feats[i][: train_lens[i]].astype(np.float64) for i in idx]
        m = fit_hmm(
            _jax.random.PRNGKey(100 + d),
            temps,
            hmm_cfg=hmm_cfg,
            train_cfg=train_cfg,
            pad_to=pad_to,
        )
        models.append(m)
    bank = HMMBank.stack(models)
    return bank, test, test_feats, test_lens


def test_isolated_end_to_end_accuracy(digit_setup):
    from speech_recognition_jax.decode.isolated import classify_batch

    bank, test, test_feats, test_lens = digit_setup
    tmax = max(test_lens)
    b = len(test)
    feats = np.zeros((b, tmax, 39), np.float32)
    lens = np.zeros((b,), np.int32)
    labels = np.zeros((b,), np.int64)
    for i in range(b):
        feats[i, : test_lens[i]] = test_feats[i][: test_lens[i]]
        lens[i] = test_lens[i]
        labels[i] = test[i].labels[0]
    pred, costs = classify_batch(bank, jnp.asarray(feats), jnp.asarray(lens))
    acc = float(np.mean(np.asarray(pred) == labels))
    assert acc >= 0.9, f"isolated accuracy {acc}"


def test_connected_end_to_end(digit_setup):
    from speech_recognition_jax.data.synthetic import SyntheticDigits
    from speech_recognition_jax.decode.connected import (
        connected_graph_arrays,
        decode_connected,
    )
    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.ops.frontend import mfcc39, padded_length

    bank, *_ = digit_setup
    cfg = FrontendConfig()
    gen = SyntheticDigits(seed=7)
    n_slots = 3
    utts = [gen.utterance(t, speaker="ZQ") for t in ["123", "O5Z", "994"]]
    L = padded_length(cfg, 40000)
    feats, lens = [], []
    for u in utts:
        buf = np.zeros(L, np.float32)
        buf[: len(u.samples)] = u.samples
        f, nf = mfcc39(buf, np.int32(len(u.samples)), cfg)
        feats.append(np.asarray(f))
        lens.append(int(nf))
    tmax = max(lens)
    b = len(utts)
    fb = np.zeros((b, tmax, 39), np.float32)
    nb = np.asarray(lens, np.int32)
    for i in range(b):
        fb[i, : lens[i]] = feats[i][: lens[i]]

    graph = connected_graph_arrays(bank, n_slots)
    seqs, costs = decode_connected(bank, graph, fb, nb)
    correct = sum(1 for s, u in zip(seqs, utts) if s == u.labels)
    assert correct >= 2, f"decoded {seqs} vs {[u.labels for u in utts]}"


def test_dtw_template_classification(digit_setup):
    """Reference use_gmm=False path: skmeans templates + DTW argmin."""
    import jax.numpy as jnp

    from speech_recognition_jax.decode.dtw import (
        dtw_classify_batch,
        fit_template,
        stack_templates,
    )
    from speech_recognition_jax.data.synthetic import SyntheticDigits
    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.ops.frontend import mfcc39, padded_length

    cfg = FrontendConfig()
    gen = SyntheticDigits(seed=7)
    n_train, n_test = 6, 3

    def featurize(utts):
        L = padded_length(cfg, 24000)
        feats, lens = [], []
        for u in utts:
            buf = np.zeros(L, np.float32)
            buf[: len(u.samples)] = u.samples
            f, nf = mfcc39(buf, np.int32(len(u.samples)), cfg)
            feats.append(np.asarray(f))
            lens.append(int(nf))
        return feats, lens

    train = gen.isolated_corpus(n_train, tag="train")
    test = gen.isolated_corpus(n_test, tag="test")
    train_feats, train_lens = featurize(train)
    test_feats, test_lens = featurize(test)

    models = []
    for d in range(11):
        idx = [i for i, u in enumerate(train) if u.labels == [d]]
        temps = [train_feats[i][: train_lens[i]].astype(np.float64) for i in idx]
        models.append(fit_template(temps, 5, pad_to=max(train_lens)))
    bank = stack_templates(models)

    tmax = max(test_lens)
    b = len(test)
    fb = np.zeros((b, tmax, 39), np.float32)
    lens = np.zeros((b,), np.int32)
    labels = np.zeros((b,), np.int64)
    for i in range(b):
        fb[i, : test_lens[i]] = test_feats[i][: test_lens[i]]
        lens[i] = test_lens[i]
        labels[i] = test[i].labels[0]
    pred, costs = dtw_classify_batch(bank, jnp.asarray(fb), jnp.asarray(lens))
    acc = float(np.mean(np.asarray(pred) == labels))
    assert acc >= 0.85, f"DTW template accuracy {acc}"
