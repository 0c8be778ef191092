"""Diagonal-GMM Expectation-Maximization, log-space, device-resident.

Replaces ``GMM.em`` (``/root/reference/sr/recognition/hmm_state.py:122-159``)
— a per-frame Python loop over linear-space pdfs with div-by-zero
patches — with a jitted ``lax.while_loop``: responsibilities via
logsumexp, sufficient statistics as masked matmuls, convergence by
``allclose`` on (mu, sigma, w) exactly like the reference.  The
sufficient statistics (``r_sum``, ``r@x``, ``r@x^2``) are plain sums
over the data axis, which is what makes multi-device EM a ``psum`` in
``parallel/`` — the update below is already written in that form.

Unlike the reference we floor variances (the reference can collapse a
component onto a single frame; quirk noted in SURVEY.md §5 failure
handling).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from speech_recognition_jax.ops.gmm import pairwise_gaussian_nll
from speech_recognition_jax.utils.numerics import MATMUL_PRECISION

__all__ = ["em_fit", "em_step_stats", "em_update_from_stats"]


def em_step_stats(x, mask, means, log_vars, log_w):
    """E-step responsibilities + sufficient statistics.

    Returns ``(r_sum [M], rx [M, D], rxx [M, D])`` — the per-shard
    statistics that a data-parallel trainer ``psum``s before the M-step.
    """
    lp = -pairwise_gaussian_nll(x, means, jnp.exp(log_vars)) + log_w[None, :]
    lse = jax.scipy.special.logsumexp(lp, axis=1, keepdims=True)
    resp = jnp.exp(lp - lse)
    resp = jnp.where(mask[:, None], resp, 0.0)
    r_sum = jnp.sum(resp, axis=0)
    rx = jnp.dot(resp.T, x, precision=MATMUL_PRECISION)
    rxx = jnp.dot(resp.T, x * x, precision=MATMUL_PRECISION)
    return r_sum, rx, rxx


def em_update_from_stats(r_sum, rx, rxx, n_valid, var_floor):
    """M-step from (possibly psum-reduced) sufficient statistics."""
    denom = jnp.maximum(r_sum, 1e-10)[:, None]
    means = rx / denom
    variances = rxx / denom - means * means
    variances = jnp.maximum(variances, var_floor)
    w = r_sum / jnp.maximum(n_valid, 1e-10)
    return means, variances, w


@functools.partial(jax.jit, static_argnames=("max_iters",))
def em_fit(
    x,
    mask,
    means0,
    variances0,
    weights0,
    max_iters: int = 100,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    var_floor: float = 1e-6,
):
    """Fit one GMM to masked data.

    Args:
      x: ``[N, D]`` frames (padded), ``mask [N]`` validity.
      means0/variances0/weights0: ``[M, D] / [M, D] / [M]`` initialization.

    Returns ``(means, variances, weights, n_iters)``.
    """
    n_valid = jnp.sum(mask.astype(x.dtype))

    def cond(carry):
        i, done, *_ = carry
        return (~done) & (i < max_iters)

    def body(carry):
        i, _, means, variances, w = carry
        r_sum, rx, rxx = em_step_stats(x, mask, means, jnp.log(variances), jnp.log(w))
        new_means, new_vars, new_w = em_update_from_stats(
            r_sum, rx, rxx, n_valid, var_floor
        )
        done = (
            _allclose(new_means, means, rtol, atol)
            & _allclose(new_vars, variances, rtol, atol)
            & _allclose(new_w, w, rtol, atol)
        )
        return i + 1, done, new_means, new_vars, new_w

    i, _, means, variances, w = jax.lax.while_loop(
        cond, body, (0, jnp.array(False), means0, variances0, weights0)
    )
    return means, variances, w, i


def _allclose(a, b, rtol, atol):
    return jnp.all(jnp.abs(a - b) <= atol + rtol * jnp.abs(b))
