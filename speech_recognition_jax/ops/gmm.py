"""Batched diagonal-GMM negative log-likelihoods as a single GEMM.

The reference evaluates Gaussians one frame, one state, one mixture at a
time in linear probability space
(``/root/reference/sr/recognition/hmm_state.py:36-45,114-120``), which
both underflows in 39 dims and serializes the FLOPs-dominant part of
decoding.  Here the per-mixture Gaussian NLL

    nll(x; mu, var) = 0.5*sum((x-mu)^2/var) + 0.5*log((2*pi)^D * prod(var))

is expanded into a quadratic form so a whole utterance x a whole bank of
mixtures is one matmul:

    nll = 0.5*sum(x^2/var) - sum(x*mu/var) + const
        = [x^2, x, 1] @ [0.5/var, -mu/var, const]^T

with shapes ``[T, 2D+1] @ [2D+1, S*M] -> [T, S*M]``, then a logsumexp
over mixtures (log-space — fixes quirk SURVEY.md §2.5-2 while agreeing
with the reference's linear-space sum whenever the latter does not
underflow).  The same quadratic form evaluates the reference's
``mahalanobis`` (``hmm_state.py:48-58``), which *is* the single-Gaussian
NLL.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.utils.numerics import MATMUL_PRECISION

__all__ = ["gmm_emission_weights", "gmm_neg_log_lik", "mahalanobis", "augment_features"]

_LOG_2PI = float(np.log(2.0 * np.pi))


def gmm_emission_weights(means, log_vars, log_weights):
    """Precompute the emission GEMM operand from GMM parameters.

    Args:
      means:       ``[..., M, D]`` mixture means.
      log_vars:    ``[..., M, D]`` log of diagonal variances.
      log_weights: ``[..., M]`` log mixture weights.

    Returns:
      ``(w [..., M, 2D+1], log_weights)`` where
      ``augment(x) @ w[..., m, :].T`` is the Gaussian NLL of mixture m.
    """
    inv_var = jnp.exp(-log_vars)
    d = means.shape[-1]
    const = 0.5 * (
        jnp.sum(means * means * inv_var, axis=-1)
        + jnp.sum(log_vars, axis=-1)
        + d * _LOG_2PI
    )
    w = jnp.concatenate(
        [0.5 * inv_var, -means * inv_var, const[..., None]], axis=-1
    )
    return w, log_weights


def augment_features(x):
    """``[..., D] -> [..., 2D+1]`` quadratic-form augmentation."""
    ones = jnp.ones(x.shape[:-1] + (1,), dtype=x.dtype)
    return jnp.concatenate([x * x, x, ones], axis=-1)


def gmm_neg_log_lik(x, w, log_weights, frame_mask=None):
    """GMM NLL for every (frame, state).

    Args:
      x:           ``[T, D]`` feature frames.
      w:           ``[S, M, 2D+1]`` from :func:`gmm_emission_weights`.
      log_weights: ``[S, M]`` log mixture weights.
      frame_mask:  optional ``[T]`` bool; masked frames get NLL 0 so they
        add nothing to a path cost.

    Returns:
      ``[T, S]`` float32 negative log likelihoods
      (``-log sum_m w_m N(x; mu_m, var_m)``), the cost-space emission
      matrix consumed by every DP kernel.
    """
    s, m, a = w.shape
    xa = augment_features(x)  # [T, 2D+1]
    per_mix = jnp.dot(xa, w.reshape(s * m, a).T, precision=MATMUL_PRECISION)
    per_mix = per_mix.reshape(x.shape[0], s, m)
    # -logsumexp(log_w - nll) over mixtures, stable.
    z = log_weights[None, :, :] - per_mix
    zmax = jnp.max(z, axis=-1, keepdims=True)
    nll = -(jnp.log(jnp.sum(jnp.exp(z - zmax), axis=-1)) + zmax[..., 0])
    if frame_mask is not None:
        nll = jnp.where(frame_mask[:, None], nll, 0.0)
    return nll


def mahalanobis(x, mu, var):
    """Reference ``mahalanobis`` (= diagonal-Gaussian NLL),
    ``/root/reference/sr/recognition/hmm_state.py:48-58``.  Broadcasts.
    """
    d = x.shape[-1]
    m = x - mu
    return 0.5 * (d * _LOG_2PI + jnp.sum(jnp.log(var), axis=-1)) + 0.5 * jnp.sum(
        m * m / var, axis=-1
    )


def pairwise_gaussian_nll(x, means, variances):
    """``[T, D] x [K, D] -> [T, K]`` single-Gaussian NLL matrix via the
    emission GEMM — used by k-means (mahalanobis distance,
    ``/root/reference/sr/recognition/kmeans.py:183``) and DTW.

    ``variances`` may be ``[K, D]`` or ``[D]`` (shared)."""
    variances = jnp.broadcast_to(variances, means.shape)
    w, _ = gmm_emission_weights(means, jnp.log(variances), jnp.zeros(means.shape[:-1]))
    return jnp.dot(augment_features(x), w.reshape(means.shape[0], -1).T,
                   precision=MATMUL_PRECISION)


def pairwise_sq_euclidean(x, y):
    """``[T, D] x [K, D] -> [T, K]`` squared L2, one GEMM + norms."""
    xn = jnp.sum(x * x, axis=-1, keepdims=True)
    yn = jnp.sum(y * y, axis=-1)
    xy = jnp.dot(x, y.T, precision=MATMUL_PRECISION)
    return jnp.maximum(xn + yn[None, :] - 2.0 * xy, 0.0)
