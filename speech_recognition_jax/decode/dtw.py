"""DTW template matching — the reference's single-Gaussian model path.

With ``use_gmm=False`` the reference's ``HMM`` keeps only per-segment
means/variances from segmental K-means and evaluates inputs by DTW with
the mahalanobis distance (``/root/reference/sr/recognition/hmm.py:57-76,
126-135``: ``dtw(x, self.mu, mahalanobis, self.transitions,
self.sigma)`` and the cost is ``costs[-1, -1]``).  This module provides
that model family — templates are ``(means [S, D], variances [S, D],
trans [S, S])`` — with the distance matrix as one batched GEMM and the
DP through the shared ``lax.scan`` Viterbi kernel (DTW *is* Viterbi
with distances as emissions).
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.hmm import linear_init_cost
from speech_recognition_jax.ops.gmm import pairwise_gaussian_nll
from speech_recognition_jax.ops.viterbi import viterbi
from speech_recognition_jax.train.skmeans import skmeans
from speech_recognition_jax.utils.numerics import to_cost_matrix

__all__ = ["TemplateBank", "fit_template", "dtw_score_models", "dtw_classify_batch"]


class TemplateBank(NamedTuple):
    """Stack of single-Gaussian segment templates."""

    means: jnp.ndarray  # [N, S, D]
    variances: jnp.ndarray  # [N, S, D]
    trans_cost: jnp.ndarray  # [N, S, S]

    @property
    def n_models(self) -> int:
        return self.means.shape[0]

    @property
    def n_states(self) -> int:
        return self.means.shape[1]


def fit_template(templates: List[np.ndarray], n_segments: int = 5, **kw):
    """Segmental K-means only — the reference ``HMM.fit(use_gmm=False)``
    (``hmm.py:74-76``).  Returns (means, variances, trans) numpy."""
    means, variances, trans, _, _ = skmeans(templates, n_segments, **kw)
    return means, np.maximum(variances, 1e-3), to_cost_matrix(
        np.where(np.isfinite(trans), trans, np.inf).astype(np.float32)
    )


def stack_templates(models) -> TemplateBank:
    m, v, t = zip(*models)
    return TemplateBank(
        means=jnp.asarray(np.stack(m), jnp.float32),
        variances=jnp.asarray(np.stack(v), jnp.float32),
        trans_cost=jnp.asarray(np.stack(t), jnp.float32),
    )


@jax.jit
def dtw_score_models(bank: TemplateBank, feats, n_frames):
    """Per-model DTW cost of one utterance (``costs[-1, -1]``)."""
    n, s, d = bank.means.shape
    t = feats.shape[0]
    frame_mask = jnp.arange(t) < n_frames
    # [T, N*S] mahalanobis distances in one GEMM
    dists = pairwise_gaussian_nll(
        feats, bank.means.reshape(n * s, d), bank.variances.reshape(n * s, d)
    )
    dists = jnp.where(frame_mask[:, None], dists, 0.0)
    dists = dists.reshape(t, n, s).transpose(1, 0, 2)
    init = jnp.asarray(linear_init_cost(s))

    def one(dist_m, trans_m):
        return viterbi(dist_m, trans_m, init, n_frames).final_cost[-1]

    return jax.vmap(one)(dists, bank.trans_cost)


@jax.jit
def dtw_classify_batch(bank: TemplateBank, feats, n_frames):
    costs = jax.vmap(dtw_score_models, in_axes=(None, 0, 0))(bank, feats, n_frames)
    return jnp.argmin(costs, axis=1), costs
