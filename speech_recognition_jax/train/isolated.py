"""Isolated-word model training: segmental K-means baseline + binary
mixture splitting + EM.

Replaces ``HMM.fit`` / ``fit_GMM`` / ``_fit_GMM``
(``/root/reference/sr/recognition/hmm.py:57-124``): per HMM state, start
from the state mean, repeatedly perturb centroids by +-10%
(``hmm.py:109-111``), k-means to 2^i clusters, reweight by cluster
counts, optionally EM — with the intended ``log2(n_mix)`` split count
(the reference's ``int(np.log(n))`` quirk is available via
``HMMConfig.ref_compat_splits``, SURVEY.md §2.5-1).

All states train on the same flattened ``[B*T, D]`` frame buffer with
per-state masks — no gathers, no dynamic shapes, and the EM sufficient
statistics are ``psum``-ready for the data-parallel path.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.config import HMMConfig, TrainConfig
from speech_recognition_jax.models.hmm import GMMHMM
from speech_recognition_jax.train.em import em_fit
from speech_recognition_jax.train.kmeans import kmeans
from speech_recognition_jax.train.skmeans import skmeans

__all__ = ["fit_gmm_state", "fit_hmm", "align_states"]


def align_states(bank_model, feats_batch, n_frames):
    """Viterbi re-segmentation of templates against trained GMM states —
    the reference's ``align_gmm_states``
    (``/root/reference/sr/recognition/kmeans.py:196-205``), vmapped.

    Args:
      bank_model: a :class:`~speech_recognition_jax.models.hmm.GMMHMM`.
      feats_batch: ``[B, T, D]`` padded templates; ``n_frames [B]``.

    Returns ``[B, T]`` state alignments (int32).
    """
    from speech_recognition_jax.models.hmm import linear_init_cost
    from speech_recognition_jax.ops.gmm import gmm_emission_weights, gmm_neg_log_lik
    from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace

    s = bank_model.n_states
    w, lw = gmm_emission_weights(
        bank_model.means, bank_model.log_vars, bank_model.log_weights
    )
    init = jnp.asarray(linear_init_cost(s))
    t = feats_batch.shape[1]

    def one(x, nf):
        mask = jnp.arange(t) < nf
        nll = gmm_neg_log_lik(x, w, lw, mask)
        res = viterbi(nll, bank_model.trans_cost, init, nf)
        return viterbi_backtrace(res.bp, res.eps_bp, jnp.int32(s - 1), nf)[0]

    return jax.vmap(one)(jnp.asarray(feats_batch, jnp.float32), jnp.asarray(n_frames))


def fit_gmm_state(
    key,
    x,
    mask,
    mu0,
    n_mix: int,
    use_em: bool = True,
    train_cfg: TrainConfig = TrainConfig(),
    hmm_cfg: HMMConfig = HMMConfig(),
):
    """Binary mixture splitting for one state's pooled frames.

    Args:
      x: ``[N, D]`` frames (padded); ``mask [N]`` marks this state's frames.
      mu0: ``[D]`` the state's single-Gaussian mean (split seed).

    Returns ``(means [n_mix, D], variances [n_mix, D], weights [n_mix])``.
    """
    n_splits = hmm_cfg.n_splits
    n_trained = 2 ** n_splits
    n_valid = jnp.sum(mask.astype(x.dtype))

    def _masked_var(data):
        mu = jnp.sum(jnp.where(mask[:, None], data, 0.0), axis=0) / jnp.maximum(n_valid, 1.0)
        sq = jnp.sum(jnp.where(mask[:, None], (data - mu) ** 2, 0.0), axis=0)
        return jnp.maximum(sq / jnp.maximum(n_valid, 1.0), hmm_cfg.var_floor)

    centroids = mu0[None, :]
    # n_splits can be 0 (n_mix=1, or the ref-compat quirk where
    # int(ln 4)=1 means n_mix=2 trains zero splits): fall back to the
    # single-Gaussian masked ML fit, optionally EM-refined below.
    variances = _masked_var(x)[None, :]
    weights = jnp.ones((1,))
    if n_splits == 0 and use_em:
        centroids, variances, weights, _ = em_fit(
            x, mask, centroids, variances, weights,
            max_iters=train_cfg.em_max_iters, rtol=train_cfg.rtol,
            atol=train_cfg.atol, var_floor=hmm_cfg.var_floor,
        )
    for i in range(n_splits):
        k = 2 ** (i + 1)
        pert = train_cfg.split_perturbation
        centroids = jnp.concatenate(
            [centroids * (1.0 - pert), centroids * (1.0 + pert)], axis=0
        )
        key, sub = jax.random.split(key)
        _, centroids, variances, counts = kmeans(
            sub, x, mask, centroids, k, max_iters=train_cfg.kmeans_max_iters
        )
        weights = counts / jnp.maximum(n_valid, 1.0)
        if use_em:
            centroids, variances, weights, _ = em_fit(
                x,
                mask,
                centroids,
                variances,
                weights,
                max_iters=train_cfg.em_max_iters,
                rtol=train_cfg.rtol,
                atol=train_cfg.atol,
                var_floor=hmm_cfg.var_floor,
            )

    if n_trained < n_mix:
        # ref-compat split-count quirk: untrained components keep the
        # split seed with weight 1/N (hmm.py:108,  hmm_state.py:108-112),
        # and evaluation sums over all n_mix components.
        extra = n_mix - n_trained
        glob_var = jnp.broadcast_to(_masked_var(x), (extra, x.shape[1]))
        centroids = jnp.concatenate([centroids, jnp.tile(mu0, (extra, 1))])
        variances = jnp.concatenate([variances, glob_var])
        weights = jnp.concatenate(
            [weights, jnp.full((extra,), 1.0 / jnp.maximum(n_valid, 1.0))]
        )
    return centroids, variances, weights


def fit_hmm(
    key,
    templates: List[np.ndarray],
    use_em: bool = True,
    train_cfg: TrainConfig = TrainConfig(),
    hmm_cfg: HMMConfig = HMMConfig(),
    pad_to: int = None,
) -> GMMHMM:
    """Train one word model from its templates (reference ``HMM.fit`` with
    ``use_gmm=True``).

    The transition matrix comes from segmental K-means and is *not*
    re-estimated after GMM training, matching the reference (its
    ``align_gmm_states`` re-cut only updates stored segments, never the
    parameters — ``hmm.py:95``)."""
    s = hmm_cfg.n_states
    means0, vars0, trans, states, (x, n_frames) = skmeans(
        templates,
        s,
        max_iters=train_cfg.skmeans_max_iters,
        rtol=train_cfg.rtol,
        atol=train_cfg.atol,
        pad_to=pad_to,
    )
    b, tmax, d = x.shape
    flat_x = jnp.asarray(x.reshape(b * tmax, d))
    frame_mask = (np.arange(tmax)[None, :] < n_frames[:, None]).reshape(-1)

    all_means, all_vars, all_w = [], [], []
    for si in range(s):
        key, sub = jax.random.split(key)
        state_mask = jnp.asarray((states.reshape(-1) == si) & frame_mask)
        m, v, w = fit_gmm_state(
            sub,
            flat_x,
            state_mask,
            jnp.asarray(means0[si]),
            hmm_cfg.n_mix,
            use_em=use_em,
            train_cfg=train_cfg,
            hmm_cfg=hmm_cfg,
        )
        all_means.append(m)
        all_vars.append(v)
        all_w.append(w)

    means = jnp.stack(all_means)
    variances = jnp.maximum(jnp.stack(all_vars), hmm_cfg.var_floor)
    weights = jnp.maximum(jnp.stack(all_w), 1e-10)
    trans_f = np.where(np.isfinite(trans), trans, np.inf).astype(np.float32)
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    return GMMHMM(
        means=means.astype(jnp.float32),
        log_vars=jnp.log(variances).astype(jnp.float32),
        log_weights=jnp.log(weights / jnp.sum(weights, axis=1, keepdims=True)).astype(
            jnp.float32
        ),
        trans_cost=jnp.asarray(to_cost_matrix(trans_f)),
    )
