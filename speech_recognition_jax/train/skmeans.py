"""Segmental K-means over batched, masked templates.

Replaces ``skmeans`` (``/root/reference/sr/recognition/kmeans.py:111-155``):
uniform time-split init, then iterate [transition costs from segment
lengths -> DTW-align every template to the segment means -> re-cut
segments from path occupancy -> recompute means/vars] until the means
stop moving (``allclose``).  Differences from the reference, by design:

* All templates align in one vmapped ``lax.scan`` Viterbi instead of a
  per-template Python DTW (the reference's hot loop, SURVEY.md §3.1).
* Segment statistics come from masked one-hot matmuls over the padded
  ``[B, T]`` state-occupancy matrix — numerically identical to the
  reference's cut-by-counts (paths are monotonic, so occupancy blocks
  are contiguous), and the form that data-parallelizes with ``psum``.
* The reference never updates ``seg_lens`` inside its loop, so its
  transition costs are forever those of the *uniform initial* cut
  (``kmeans.py:126-139``); ``update_seg_lens=False`` replicates that,
  the default re-estimates costs from the current alignment.

``calc_transition_costs`` is a faithful port of ``kmeans.py:53-95``
including the skip-over-empty-segments jump logic (max_jump_dist=2).
Distances are unsquared Euclidean — the reference's default
``dist_fun=np.linalg.norm`` (``kmeans.py:111``).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.hmm import linear_init_cost
from speech_recognition_jax.ops.gmm import pairwise_sq_euclidean
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.utils.numerics import MATMUL_PRECISION, POS_INF

__all__ = ["skmeans", "calc_transition_costs", "pad_templates", "segment_stats"]


def pad_templates(templates: List[np.ndarray], pad_to: int = None):
    """Stack variable-length [T_i, D] templates into ([B, T, D], [B]).

    ``pad_to`` fixes the padded length so different calls share one
    compiled program shape."""
    b = len(templates)
    tmax = pad_to or max(t.shape[0] for t in templates)
    d = templates[0].shape[1]
    x = np.zeros((b, tmax, d), dtype=np.float32)
    n = np.zeros((b,), dtype=np.int32)
    for i, t in enumerate(templates):
        x[i, : t.shape[0]] = t
        n[i] = t.shape[0]
    return x, n


def calc_transition_costs(
    n_temps: int, seg_lens: np.ndarray, max_jump_dist: int = 2
) -> np.ndarray:
    """Port of ``/root/reference/sr/recognition/kmeans.py:53-95``.

    seg_lens: ``[n_temps, n_segments]`` frames per segment per template.
    Returns ``[S, S]`` cost matrix, T[to, from], np.inf where absent.
    """
    n_segments = seg_lens.shape[1]
    empty_segs = seg_lens == 0
    res = np.full((n_segments, n_segments), np.inf)
    with np.errstate(divide="ignore"):
        for i in range(n_segments):
            jump_dist = 1
            n_jump = 0 if i == n_segments - 1 else n_temps
            s = i + 1
            while s < n_segments - 1:
                if np.sum(empty_segs[:, s + 1]) == 0:
                    break
                jump_dist += 1
                if jump_dist > max_jump_dist:
                    break
                s += 1
            n_all = int(np.sum(seg_lens[:, i]))
            if n_all == 0:
                # degenerate: the reference divides by zero here
                # (kmeans.py:90-92); keep the state enterable.
                res[i, i] = np.inf
                if i + jump_dist < n_segments:
                    res[i + jump_dist, i] = 0.0
                continue
            n_stay = n_all - n_jump
            p_stay = n_stay / n_all
            p_jump = n_jump / n_all
            if n_jump:
                res[i + jump_dist, i] = -np.log(p_jump)
            res[i, i] = -np.log(p_stay)
    return res


@functools.partial(jax.jit, static_argnames=("n_segments",))
def _align_batch(x, n_frames, means, trans, n_segments: int):
    """DTW-align every template to the segment means; returns [B, T] states."""
    dists = jnp.sqrt(
        jnp.maximum(pairwise_sq_euclidean(x.reshape(-1, x.shape[-1]), means), 1e-24)
    ).reshape(x.shape[0], x.shape[1], n_segments)
    init = jnp.asarray(linear_init_cost(n_segments))

    def one(d, nf):
        res = viterbi(d, trans, init, nf)
        return viterbi_backtrace(res.bp, res.eps_bp, jnp.int32(n_segments - 1), nf)[0]

    return jax.vmap(one)(dists, n_frames)


@functools.partial(jax.jit, static_argnames=("n_segments",))
def segment_stats(x, n_frames, states, n_segments: int):
    """Masked pooled per-segment (count, mean, ddof-1 var) + per-template
    segment lengths."""
    b, t, d = x.shape
    frame_mask = jnp.arange(t)[None, :] < n_frames[:, None]
    onehot = (states[:, :, None] == jnp.arange(n_segments)[None, None, :]) & frame_mask[
        :, :, None
    ]
    onehot = onehot.astype(x.dtype)  # [B, T, S]
    seg_lens = jnp.sum(onehot, axis=1)  # [B, S]
    counts = jnp.sum(seg_lens, axis=0)  # [S]
    flat_oh = onehot.reshape(b * t, n_segments)
    flat_x = x.reshape(b * t, d)
    denom = jnp.maximum(counts, 1.0)[:, None]
    means = jnp.dot(flat_oh.T, flat_x, precision=MATMUL_PRECISION) / denom
    sq = jnp.dot(flat_oh.T, flat_x * flat_x, precision=MATMUL_PRECISION)
    var = (sq - counts[:, None] * means * means) / jnp.maximum(counts - 1.0, 1.0)[
        :, None
    ]
    return counts, means, jnp.maximum(var, 1e-12), seg_lens


def skmeans(
    templates: List[np.ndarray],
    n_segments: int,
    max_iters: int = 100,
    update_seg_lens: bool = True,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    pad_to: int = None,
):
    """Segmental K-means.

    Returns ``(means [S, D], variances [S, D], trans [S, S] np.inf-style,
    states [B, T] final alignment, (x, n_frames) padded batch)``.
    """
    for t in templates:
        if t.shape[0] < n_segments:
            raise ValueError(
                "template is too small, cannot do dtw on it"
            )  # reference kmeans.py:142-143
    x, n_frames = pad_templates(templates, pad_to)
    b, tmax, d = x.shape

    # Uniform initial cut: seg_len = T // S, last segment to end
    # (kmeans.py:126-132 + segment_data 'to end' semantics).
    seg_len0 = n_frames // n_segments
    t_idx = np.arange(tmax)[None, :]
    states = np.minimum(t_idx // np.maximum(seg_len0[:, None], 1), n_segments - 1)
    states = states.astype(np.int32)

    x_dev = jnp.asarray(x)
    nf_dev = jnp.asarray(n_frames)
    counts, means, variances, seg_lens = segment_stats(
        x_dev, nf_dev, jnp.asarray(states), n_segments
    )
    seg_lens_np = np.asarray(seg_lens, dtype=np.int64)
    trans = calc_transition_costs(b, seg_lens_np)

    for _ in range(max_iters):
        trans_dev = jnp.where(jnp.isfinite(jnp.asarray(trans, jnp.float32)),
                              jnp.asarray(trans, jnp.float32), POS_INF)
        states = _align_batch(x_dev, nf_dev, means, trans_dev, n_segments)
        counts, new_means, variances, seg_lens = segment_stats(
            x_dev, nf_dev, states, n_segments
        )
        if update_seg_lens:
            seg_lens_np = np.asarray(seg_lens, dtype=np.int64)
        trans = calc_transition_costs(b, seg_lens_np)
        if np.allclose(np.asarray(new_means), np.asarray(means), rtol=rtol, atol=atol):
            means = new_means
            break
        means = new_means

    return (
        np.asarray(means),
        np.asarray(variances),
        trans,
        np.asarray(states),
        (x, n_frames),
    )
