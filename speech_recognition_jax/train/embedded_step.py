"""One fully-jittable embedded-training (Viterbi-EM) step.

This is the production trainer and the unit of distribution.  The
reference's continuous training
(``/root/reference/sr/recognition/continuous_speech.py:56-179``)
re-runs mixture splitting + full EM from scratch per state per
iteration in host Python; here one iteration is a single compiled
program:

  1. batched forced alignment against per-utterance transcript graphs
     (``lax.scan`` Viterbi, emissions from one bank GEMM),
  2. soft mixture responsibilities *within* each aligned state
     (HTK-style embedded re-estimation — a strict upgrade over the
     reference's from-scratch refit, with identical fixed points),
  3. sufficient statistics as two weighted GEMMs
     ``W[BT, NS*M].T @ x`` — plain sums over the frame axis, so under
     ``pjit`` with the batch sharded on the 'data' mesh axis XLA turns
     them into ``psum``s (SURVEY.md §2.2 DP row),
  4. M-step + transition re-estimation (``p_jump = runs / frames``,
     ``continuous_speech.py:146-164``) vectorized over all states.

States with no aligned frames keep their previous parameters
(reference warns and skips, ``continuous_speech.py:149-152``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from speech_recognition_jax.models.hmm import HMMBank
from speech_recognition_jax.ops.gmm import (
    augment_features,
    gmm_emission_weights,
    gmm_neg_log_lik,
)
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.utils.numerics import MATMUL_PRECISION, POS_INF

__all__ = ["embedded_step", "embedded_step_soft", "EmbeddedStats"]


class EmbeddedStats(NamedTuple):
    r_sum: jnp.ndarray  # [NS, M] responsibility mass
    rx: jnp.ndarray  # [NS, M, D]
    rxx: jnp.ndarray  # [NS, M, D]
    frame_counts: jnp.ndarray  # [NS]
    run_counts: jnp.ndarray  # [NS]
    total_cost: jnp.ndarray  # [] sum of alignment costs


def _align_ids(bank, feats, n_frames, g, eps_depth):
    """vmapped forced alignment -> per-frame global state ids (-1 pad)."""
    b, t, d = feats.shape
    n, s = bank.n_models, bank.n_states
    w, lw = gmm_emission_weights(*bank.flat_states())

    def one(x, nf, tr, eps, init, ends, bstate):
        frame_mask = jnp.arange(t) < nf
        nll = gmm_neg_log_lik(x, w, lw, frame_mask)[:, bstate]
        res = viterbi(nll, tr, init, nf, eps_trans=eps, eps_depth=eps_depth)
        end_costs = res.final_cost[ends]
        best = jnp.argmin(end_costs)
        states, _ = viterbi_backtrace(res.bp, res.eps_bp, ends[best], nf, eps_depth=eps_depth)
        ids = jnp.where(frame_mask, bstate[states], -1)
        return ids, end_costs[best]

    return jax.vmap(one)(
        feats, n_frames, g["trans"], g["eps_trans"], g["init_cost"],
        g["end_states"], g["bank_state"],
    )


@functools.partial(jax.jit,
                   static_argnames=("eps_depth", "var_floor", "lr",
                                    "frame_chunk"))
def embedded_step(
    bank: HMMBank,
    feats,
    n_frames,
    graph_batch,
    eps_depth: int = 1,
    var_floor: float = 1e-2,
    lr: float = 1.0,
    frame_chunk: int = 65536,
):
    """One Viterbi-EM iteration.

    Args:
      bank: current models.
      feats: ``[B, T, D]`` padded features (shard on 'data').
      n_frames: ``[B]``.
      graph_batch: dict from :func:`models.graph.pad_graphs` as device
        arrays (``trans/eps_trans/init_cost/end_states/bank_state``),
        one graph per utterance (shard on 'data').
      lr: interpolation toward the re-estimated parameters (1 = replace).
      frame_chunk: statistics are accumulated over frame chunks of this
        size, so peak memory is O(chunk x NS x M) regardless of B x T —
        the round-1 form materialized the full [B·T, NS·M] weight
        tensor (~GB-scale at the pod demo's 10k x 300 shapes).  Small
        batches (B·T <= frame_chunk) run as a single chunk, identical
        to the unchunked program.

    Returns ``(new_bank, EmbeddedStats)``.
    """
    b, t, d = feats.shape
    n, s = bank.n_models, bank.n_states
    ns = n * s
    m = bank.n_mix

    ids, costs = _align_ids(bank, feats, n_frames, graph_batch, eps_depth)

    # run starts (the reference's per-state segment count n_temps) need
    # the per-utterance predecessor, so flag them before flattening
    prev_ids = jnp.concatenate([jnp.full((b, 1), -2, ids.dtype), ids[:, :-1]], axis=1)
    starts = (ids >= 0) & (ids != prev_ids)

    w, lw = gmm_emission_weights(*bank.flat_states())
    a = w.shape[-1]
    w_flat_t = w.reshape(ns * m, a).T

    bt = b * t
    c = min(frame_chunk, bt)
    n_chunks = (bt + c - 1) // c
    pad = n_chunks * c - bt

    def pad_flat(x, fill):
        x = x.reshape((bt,) + x.shape[2:] if x.ndim > 2 else (bt,))
        if pad:
            width = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
            x = jnp.pad(x, width, constant_values=fill)
        return x.reshape((n_chunks, c) + x.shape[1:])

    ids_ck = pad_flat(ids, -1)
    x_ck = pad_flat(feats, 0.0)
    starts_ck = pad_flat(starts, False)

    def chunk_stats(carry, inputs):
        frame_counts, run_counts, r_sum, rx, rxx = carry
        ids_c, x_c, starts_c = inputs
        valid = ids_c >= 0
        onehot_f = ((ids_c[:, None] == jnp.arange(ns)[None, :])
                    & valid[:, None]).astype(x_c.dtype)
        frame_counts = frame_counts + jnp.sum(onehot_f, axis=0)
        starts_oh = onehot_f * starts_c[:, None].astype(x_c.dtype)
        run_counts = run_counts + jnp.sum(starts_oh, axis=0)

        # mixture responsibilities within the aligned state
        xa = augment_features(x_c)
        per_mix = jnp.dot(xa, w_flat_t,
                          precision=MATMUL_PRECISION).reshape(c, ns, m)
        own = jnp.take_along_axis(
            per_mix, jnp.maximum(ids_c, 0)[:, None, None], axis=1
        )[:, 0, :]  # [C, M] Gaussian NLL under the frame's own state
        lp = lw[jnp.maximum(ids_c, 0)] - own
        lp_max = jnp.max(lp, axis=-1, keepdims=True)
        resp = jnp.exp(lp - lp_max)
        resp = resp / jnp.sum(resp, axis=-1, keepdims=True)
        resp = jnp.where(valid[:, None], resp, 0.0)

        # weighted one-hot [C, NS*M] -> stats via two GEMMs
        wts2 = (onehot_f[:, :, None] * resp[:, None, :]).reshape(c, ns * m)
        r_sum = r_sum + jnp.sum(wts2, axis=0)
        rx = rx + jnp.dot(wts2.T, x_c, precision=MATMUL_PRECISION)
        rxx = rxx + jnp.dot(wts2.T, x_c * x_c, precision=MATMUL_PRECISION)
        return (frame_counts, run_counts, r_sum, rx, rxx), None

    init = (jnp.zeros((ns,), feats.dtype), jnp.zeros((ns,), feats.dtype),
            jnp.zeros((ns * m,), feats.dtype), jnp.zeros((ns * m, d), feats.dtype),
            jnp.zeros((ns * m, d), feats.dtype))
    if n_chunks == 1:  # small batches: no scan machinery at all
        (frame_counts, run_counts, r_sum, rx, rxx), _ = chunk_stats(
            init, (ids_ck[0], x_ck[0], starts_ck[0]))
    else:
        (frame_counts, run_counts, r_sum, rx, rxx), _ = jax.lax.scan(
            chunk_stats, init, (ids_ck, x_ck, starts_ck))
    r_sum = r_sum.reshape(ns, m)
    rx = rx.reshape(ns, m, d)
    rxx = rxx.reshape(ns, m, d)

    # M-step
    denom = jnp.maximum(r_sum, 1e-6)[..., None]
    new_means = rx / denom
    new_vars = jnp.maximum(rxx / denom - new_means * new_means, var_floor)
    new_w = r_sum / jnp.maximum(frame_counts.reshape(ns, 1), 1e-6)
    new_w = jnp.maximum(new_w, 1e-8)
    new_w = new_w / jnp.sum(new_w, axis=-1, keepdims=True)

    has_data = (frame_counts > 0).reshape(n, s)
    hd = has_data[..., None, None]
    means = jnp.where(hd, new_means.reshape(n, s, m, d), bank.means)
    log_vars = jnp.where(hd, jnp.log(new_vars).reshape(n, s, m, d), bank.log_vars)
    log_w = jnp.where(hd[..., 0], jnp.log(new_w).reshape(n, s, m), bank.log_weights)

    if lr != 1.0:
        means = bank.means + lr * (means - bank.means)
        log_vars = bank.log_vars + lr * (log_vars - bank.log_vars)
        log_w = bank.log_weights + lr * (log_w - bank.log_weights)

    # transition re-estimation: p_jump = runs / frames per (model, state)
    p_jump = (run_counts / jnp.maximum(frame_counts, 1.0)).reshape(n, s)
    exit_cost = jnp.where(p_jump > 0, -jnp.log(jnp.maximum(p_jump, 1e-30)), POS_INF)
    self_cost = jnp.where(p_jump < 1, -jnp.log(jnp.maximum(1 - p_jump, 1e-30)), POS_INF)
    eye = jnp.eye(s, dtype=bool)
    sub = jnp.eye(s, k=-1, dtype=bool)  # sub[i+1, i] edge j->j+1
    trans = bank.trans_cost
    hd_t = has_data.reshape(n, 1, s)  # broadcast over 'to' index, keyed by origin state
    trans = jnp.where(eye[None] & hd_t, self_cost[:, None, :], trans)
    trans = jnp.where(sub[None] & hd_t, exit_cost[:, None, :], trans)
    trans = jnp.minimum(trans, POS_INF)

    new_bank = HMMBank(means=means, log_vars=log_vars, log_weights=log_w, trans_cost=trans)
    stats = EmbeddedStats(
        r_sum=r_sum,
        rx=rx,
        rxx=rxx,
        frame_counts=frame_counts,
        run_counts=run_counts,
        total_cost=jnp.sum(costs),
    )
    return new_bank, stats


@functools.partial(jax.jit,
                   static_argnames=("eps_depth", "var_floor", "frame_chunk"))
def embedded_step_soft(
    bank: HMMBank,
    feats,
    n_frames,
    graph_batch,
    eps_depth: int = 1,
    var_floor: float = 1e-2,
    frame_chunk: int = 65536,
):
    """One true Baum-Welch iteration (sum-product).

    Same interface as :func:`embedded_step` but state occupancy is the
    forward-backward posterior ``gamma`` instead of the hard Viterbi
    one-hot — the log-space forward-backward EM upgrade SURVEY.md §3.3
    names as the north star (graph_batch must include ``end_scores``
    from :func:`models.graph.pad_graphs`).  Transitions use expected
    counts ``a_vu = xi_vu / gamma_u`` restricted to the self/step band,
    matching the reference's self/exit parametrization.

    ``stats.total_cost`` is ``-sum log Z`` (total NLL), comparable to the
    Viterbi alignment cost up to the usual sum-vs-max gap.

    ``graph_batch`` may be either the dense dict from
    :func:`models.graph.pad_graphs` or the banded dict from
    :func:`models.graph.pad_graphs_banded` (detected by the ``band``
    key) — the banded form runs the O(3S)/frame
    :func:`ops.forward_backward.forward_backward_banded` pass, which is
    the production path at pod scale.
    """
    from speech_recognition_jax.ops.forward_backward import (
        forward_backward,
        forward_backward_banded,
    )
    from speech_recognition_jax.ops.gmm import gmm_neg_log_lik

    b, t, d = feats.shape
    n, s = bank.n_models, bank.n_states
    ns = n * s
    m = bank.n_mix

    w, lw = gmm_emission_weights(*bank.flat_states())
    a = w.shape[-1]
    banded_mode = "band" in graph_batch

    def finish(res, x, bstate):
        # map graph-state gamma onto bank states: [T, Sg] @ [Sg, NS]
        onehot_bank = (bstate[:, None] == jnp.arange(ns)[None, :]).astype(x.dtype)
        gamma_bank = jnp.dot(res.gamma, onehot_bank, precision=MATMUL_PRECISION)
        # banded expected transition counts per graph state: the fb pass
        # accumulates only the self/step/skip band ([3, Sg]), O(S)/frame
        self_counts = res.xi_sum[0] @ onehot_bank  # [NS]
        exit_counts = res.xi_sum[1] @ onehot_bank
        return gamma_bank, self_counts, exit_counts, -res.log_z

    def one(x, nf, tr, eps, init, ends_scores, bstate):
        frame_mask = jnp.arange(t) < nf
        nll_bank = gmm_neg_log_lik(x, w, lw, frame_mask)
        nll = nll_bank[:, bstate]
        res = forward_backward(
            nll, tr, init, nf, eps_trans=eps, eps_depth=eps_depth,
            end_scores=ends_scores, xi_mode="band",
        )
        return finish(res, x, bstate)

    def one_banded(x, nf, band, init, blk, starts, ends, spos, istart,
                   ends_scores, bstate):
        from speech_recognition_jax.ops.viterbi_banded import BandedGraph

        frame_mask = jnp.arange(t) < nf
        nll_bank = gmm_neg_log_lik(x, w, lw, frame_mask)
        nll = nll_bank[:, bstate]
        bg = BandedGraph(
            band=band, init_cost=init, word_starts=starts, word_ends=ends,
            eps_block=blk, start_pos=spos, is_start=istart,
            end_states=starts[:1], end_bonus=jnp.zeros((1,)),
            bank_state=bstate)
        res = forward_backward_banded(
            nll, bg, nf, eps_depth=eps_depth, end_scores=ends_scores)
        return finish(res, x, bstate)

    g = graph_batch
    if banded_mode:
        gamma_b, self_c, exit_c, nlls = jax.vmap(one_banded)(
            feats, n_frames, g["band"], g["init_cost"], g["eps_block"],
            g["word_starts"], g["word_ends"], g["start_pos"], g["is_start"],
            g["end_scores"], g["bank_state"],
        )
    else:
        gamma_b, self_c, exit_c, nlls = jax.vmap(one)(
            feats, n_frames, g["trans"], g["eps_trans"], g["init_cost"],
            g["end_scores"], g["bank_state"],
        )
    self_counts = jnp.sum(self_c, axis=0)
    exit_counts = jnp.sum(exit_c, axis=0)
    frame_counts = jnp.sum(gamma_b.reshape(b * t, ns), axis=0)  # soft occupancy

    # mixture responsibilities within each state, weighted by gamma —
    # accumulated over frame chunks (peak memory O(chunk x NS x M), not
    # O(B·T x NS·M))
    bt = b * t
    c = min(frame_chunk, bt)
    n_chunks = (bt + c - 1) // c
    pad = n_chunks * c - bt

    def pad_flat(x):
        x = x.reshape((bt,) + x.shape[2:])
        if pad:
            x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
        return x.reshape((n_chunks, c) + x.shape[1:])

    w_flat_t = w.reshape(ns * m, a).T

    def chunk_stats(carry, inputs):
        r_sum, rx, rxx = carry
        x_c, gamma_c = inputs
        xa = augment_features(x_c)
        per_mix = jnp.dot(xa, w_flat_t,
                          precision=MATMUL_PRECISION).reshape(c, ns, m)
        lp = lw[None] - per_mix  # [C, NS, M]
        lp_max = jnp.max(lp, axis=-1, keepdims=True)
        resp = jnp.exp(lp - lp_max)
        resp = resp / jnp.maximum(jnp.sum(resp, axis=-1, keepdims=True), 1e-30)
        wts2 = (gamma_c[:, :, None] * resp).reshape(c, ns * m)
        r_sum = r_sum + jnp.sum(wts2, axis=0)
        rx = rx + jnp.dot(wts2.T, x_c, precision=MATMUL_PRECISION)
        rxx = rxx + jnp.dot(wts2.T, x_c * x_c, precision=MATMUL_PRECISION)
        return (r_sum, rx, rxx), None

    init = (jnp.zeros((ns * m,), feats.dtype),
            jnp.zeros((ns * m, d), feats.dtype),
            jnp.zeros((ns * m, d), feats.dtype))
    if n_chunks == 1:  # small batches: no scan machinery at all
        (r_sum, rx, rxx), _ = chunk_stats(
            init, (pad_flat(feats)[0], pad_flat(gamma_b)[0]))
    else:
        (r_sum, rx, rxx), _ = jax.lax.scan(
            chunk_stats, init, (pad_flat(feats), pad_flat(gamma_b)))
    r_sum = r_sum.reshape(ns, m)
    rx = rx.reshape(ns, m, d)
    rxx = rxx.reshape(ns, m, d)

    denom = jnp.maximum(r_sum, 1e-6)[..., None]
    new_means = rx / denom
    new_vars = jnp.maximum(rxx / denom - new_means * new_means, var_floor)
    new_w = r_sum / jnp.maximum(frame_counts.reshape(ns, 1), 1e-6)
    new_w = jnp.maximum(new_w, 1e-8)
    new_w = new_w / jnp.sum(new_w, axis=-1, keepdims=True)

    has_data = (frame_counts > 1e-3).reshape(n, s)
    hd = has_data[..., None, None]
    means = jnp.where(hd, new_means.reshape(n, s, m, d), bank.means)
    log_vars = jnp.where(hd, jnp.log(new_vars).reshape(n, s, m, d), bank.log_vars)
    log_w = jnp.where(hd[..., 0], jnp.log(new_w).reshape(n, s, m), bank.log_weights)

    # Baum-Welch transition update on the self/step band
    denom_t = jnp.maximum(self_counts + exit_counts, 1e-6)
    p_stay = (self_counts / denom_t).reshape(n, s)
    p_jump = (exit_counts / denom_t).reshape(n, s)
    exit_cost = jnp.where(p_jump > 0, -jnp.log(jnp.maximum(p_jump, 1e-30)), POS_INF)
    self_cost = jnp.where(p_stay > 0, -jnp.log(jnp.maximum(p_stay, 1e-30)), POS_INF)
    eye = jnp.eye(s, dtype=bool)
    sub = jnp.eye(s, k=-1, dtype=bool)
    trans = bank.trans_cost
    hd_t = has_data.reshape(n, 1, s)
    trans = jnp.where(eye[None] & hd_t, self_cost[:, None, :], trans)
    trans = jnp.where(sub[None] & hd_t, exit_cost[:, None, :], trans)
    trans = jnp.minimum(trans, POS_INF)

    new_bank = HMMBank(means=means, log_vars=log_vars, log_weights=log_w, trans_cost=trans)
    stats = EmbeddedStats(
        r_sum=r_sum,
        rx=rx,
        rxx=rxx,
        frame_counts=frame_counts,
        run_counts=exit_counts,
        total_cost=jnp.sum(nlls),
    )
    return new_bank, stats
