"""Reference-quirk compatibility modes (SURVEY.md §2.5): the framework
defaults to the fixed behavior but can replicate the quirks."""

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.config import HMMConfig
from speech_recognition_jax.train.isolated import align_states, fit_gmm_state
from speech_recognition_jax.train.kmeans import kmeans


def test_ref_compat_split_count():
    """Quirk §2.5-1: int(np.log(4)) = 1 split -> only 2 trained mixtures,
    but the model still carries 4 components."""
    ref = HMMConfig(n_mix=4, ref_compat_splits=True)
    fixed = HMMConfig(n_mix=4, ref_compat_splits=False)
    assert ref.n_splits == 1
    assert fixed.n_splits == 2


def test_ref_compat_fit_keeps_stale_components(rng):
    n, d = 400, 5
    x = jnp.asarray(
        np.concatenate([
            2.0 + 0.3 * rng.standard_normal((n // 2, d)),
            -2.0 + 0.3 * rng.standard_normal((n // 2, d)),
        ])
    )
    mask = jnp.ones(n, bool)
    mu0 = jnp.asarray(np.zeros(d) + 0.5)
    m, v, w = fit_gmm_state(
        jax.random.PRNGKey(0), x, mask, mu0, n_mix=4,
        hmm_cfg=HMMConfig(n_mix=4, ref_compat_splits=True),
    )
    assert m.shape == (4, d)
    # trained components moved to the blobs; stale components keep mu0
    np.testing.assert_allclose(np.asarray(m[2]), np.asarray(mu0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(m[3]), np.asarray(mu0), atol=1e-6)
    trained = np.sort(np.asarray(m[:2, 0]))
    np.testing.assert_allclose(trained, [-2.0, 2.0], atol=0.2)
    # stale weights are 1/N_data (hmm.py:108)
    np.testing.assert_allclose(np.asarray(w[2:]), 1.0 / n, rtol=1e-5)


def test_kmeans_shared_cov_quirk(rng):
    """Quirk §2.5-3: reference distances use cluster 0's covariance for
    every cluster and never update it."""
    n, d = 300, 4
    x = jnp.asarray(np.concatenate([
        3.0 + 0.5 * rng.standard_normal((n // 2, d)),
        -3.0 + 0.5 * rng.standard_normal((n // 2, d)),
    ]))
    mask = jnp.ones(n, bool)
    c0 = jnp.asarray(np.array([[2.5] * d, [-2.5] * d]))
    a = kmeans(jax.random.PRNGKey(0), x, mask, c0, 2, shared_cov_quirk=True)
    b = kmeans(jax.random.PRNGKey(0), x, mask, c0, 2, shared_cov_quirk=False)
    # both separate the blobs here, but the quirk variances are the
    # random-initial-assignment (approx. global) covariance for all clusters
    va, vb = np.asarray(a[2]), np.asarray(b[2])
    np.testing.assert_allclose(va[0], va[1], rtol=1e-6)  # shared
    assert np.all(va[0] > 5.0)  # ~global variance of the two-blob mixture
    assert np.all(vb < 1.0)  # per-cluster variances are tight


def test_align_states_monotone(rng):
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    p = random_gmm_hmm(rng, n_states=4, n_mix=1, dim=5, sep=5.0)
    model = GMMHMM(
        means=jnp.asarray(p["means"], jnp.float32),
        log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
        log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
        trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
    )
    from speech_recognition_jax.data.synthetic import sample_hmm_features

    feats, true_states = sample_hmm_features(p, rng, min_frames_per_state=3)
    fb = feats[None].astype(np.float32)
    states = np.asarray(align_states(model, fb, np.asarray([len(feats)], np.int32)))[0]
    assert np.all(np.diff(states[: len(feats)]) >= 0)
    # alignment should essentially recover the generating states
    agree = np.mean(states[: len(feats)] == true_states)
    assert agree > 0.8, agree
