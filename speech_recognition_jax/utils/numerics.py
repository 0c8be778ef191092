"""Numerics helpers shared by the kernels.

Everything in this framework is a *cost* — a negative log probability or
a distance — matching the reference convention (SURVEY.md preamble;
transition costs are ``-log p`` at
``/root/reference/sr/recognition/kmeans.py:93-94``, emissions are
negative log likelihoods at
``/root/reference/sr/recognition/hmm_state.py:114-118``).  All dynamic
programs are min-cost.

Unlike the reference, likelihood arithmetic is done in log space
(the reference's linear-space ``MultivariateNormal.pdf`` underflows in
39 dims — quirk SURVEY.md §2.5-2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Cost and statistics GEMMs run at HIGHEST, i.e. true float32: the
# default precision lets the backend use TF32 or bf16 passes on the GPU,
# and emission costs are compared exactly across decoders.
#
# SRT_MATMUL_PRECISION overrides (highest|high|default) — a measurement
# dial for precision experiments; the production default stays HIGHEST
# unless task-level invariance is demonstrated for a cheaper setting.
import os

import jax

MATMUL_PRECISION = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}[os.environ.get("SRT_MATMUL_PRECISION", "highest")]

# A finite stand-in for +inf cost.  Using a finite sentinel keeps
# min-plus arithmetic free of inf-inf NaN traps while being large enough
# that no real path can approach it.
POS_INF = 1e30
NEG_INF = -1e30


def masked_logsumexp(x, axis=-1, where=None):
    """logsumexp that tolerates fully-masked rows (returns NEG_INF)."""
    if where is not None:
        x = jnp.where(where, x, NEG_INF)
    m = jnp.max(x, axis=axis, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    out = jnp.log(jnp.sum(jnp.exp(x - m), axis=axis)) + jnp.squeeze(m, axis=axis)
    return out


def min_plus_step(prev_cost, trans_cost):
    """One min-plus relaxation: ``new[to] = min_from(prev[from] + T[to, from])``.

    ``trans_cost`` follows the reference convention ``T[to, from]``
    (``/root/reference/sr/recognition/decode.py:85-88``).  Returns
    ``(new_cost[to], argmin_from[to])``.

    This is the inner loop of every DP in the framework (DTW, Viterbi,
    forced alignment).  Expressed as a broadcast + reduce it lowers to a
    single fused elementwise pass.
    """
    scores = trans_cost + prev_cost[None, :]  # [to, from]
    return jnp.min(scores, axis=1), jnp.argmin(scores, axis=1).astype(jnp.int32)


def to_cost_matrix(trans: np.ndarray) -> np.ndarray:
    """Replace +-inf in a host-side transition matrix with finite sentinels."""
    t = np.asarray(trans, dtype=np.float32).copy()
    t[~np.isfinite(t)] = POS_INF
    return t
