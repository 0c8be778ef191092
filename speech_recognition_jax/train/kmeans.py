"""K-means for mixture splitting, vectorized.

Replaces the reference's ``kmeans`` (``/root/reference/sr/recognition/
kmeans.py:167-194``) — an O(iters x N x k) Python loop — with a jitted
``lax.while_loop`` whose distance computation is the quadratic-form GEMM
from ``ops/gmm.py`` (mahalanobis = Gaussian NLL, the reference's
``dist_fun``).

Deliberate fixes of reference quirks (SURVEY.md §2.5-3), each gated:

* the reference seeds clusters with unseeded ``np.random.randint``; we
  take an explicit PRNG key,
* the reference computes all distances with cluster 0's covariance
  (``kmeans.py:183``) and never updates covariances inside the loop
  (the returned ``cov`` is from the *random initial* assignment);
  ``shared_cov_quirk=True`` replicates that, the default recomputes
  per-cluster covariances from the final assignment,
* empty clusters keep their previous centroid instead of going NaN
  (``cluster_centroids`` does ``np.mean`` over an empty slice).

Covariances use ddof=1 (``np.cov`` default, ``kmeans.py:6-12``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from speech_recognition_jax.ops.gmm import pairwise_gaussian_nll
from speech_recognition_jax.utils.numerics import MATMUL_PRECISION

__all__ = ["kmeans", "cluster_stats"]


def cluster_stats(x, mask, assign, k: int, var_floor: float = 1e-6):
    """Masked per-cluster (count, mean, ddof-1 variance) via one-hot matmuls."""
    onehot = (assign[:, None] == jnp.arange(k)[None, :]) & mask[:, None]
    onehot = onehot.astype(x.dtype)  # [N, k]
    counts = jnp.sum(onehot, axis=0)  # [k]
    denom = jnp.maximum(counts, 1.0)[:, None]
    means = jnp.dot(onehot.T, x, precision=MATMUL_PRECISION) / denom
    sq = jnp.dot(onehot.T, x * x, precision=MATMUL_PRECISION)
    var = (sq - counts[:, None] * means * means) / jnp.maximum(counts - 1.0, 1.0)[:, None]
    return counts, means, jnp.maximum(var, var_floor)


@functools.partial(jax.jit, static_argnames=("k", "max_iters", "shared_cov_quirk"))
def kmeans(
    key,
    x,
    mask,
    centroids0,
    k: int,
    max_iters: int = 100,
    shared_cov_quirk: bool = False,
    var_floor: float = 1e-6,
):
    """Mahalanobis k-means on masked data.

    Args:
      key: PRNG key for the random initial assignment (reference
        ``kmeans.py:171`` uses unseeded randint).
      x: ``[N, D]`` pooled frames (padded); ``mask [N]``.
      centroids0: ``[k, D]`` initial centroids (from mixture splitting).

    Returns ``(assign [N], centroids [k, D], variances [k, D], counts [k])``.
    """
    n = x.shape[0]
    init_assign = jax.random.randint(key, (n,), 0, k)
    _, _, init_var = cluster_stats(x, mask, init_assign, k, var_floor)

    def cond(carry):
        i, done, *_ = carry
        return (~done) & (i < max_iters)

    def body(carry):
        i, _, centroids, assign = carry
        if shared_cov_quirk:
            var = jnp.broadcast_to(init_var[0], centroids.shape)
        else:
            _, _, var = cluster_stats(x, mask, assign, k, var_floor)
        dists = pairwise_gaussian_nll(x, centroids, var)  # [N, k]
        new_assign = jnp.argmin(dists, axis=1)
        counts, means, _ = cluster_stats(x, mask, new_assign, k, var_floor)
        new_centroids = jnp.where(counts[:, None] > 0, means, centroids)
        done = jnp.all(jnp.abs(new_centroids - centroids) <= 1e-8 + 1e-5 * jnp.abs(centroids))
        return i + 1, done, new_centroids, new_assign

    _, _, centroids, assign = jax.lax.while_loop(
        cond, body, (0, jnp.array(False), centroids0, init_assign)
    )
    counts, _, variances = cluster_stats(x, mask, assign, k, var_floor)
    if shared_cov_quirk:
        variances = jnp.broadcast_to(init_var[0], centroids.shape)
    return assign, centroids, variances, counts
