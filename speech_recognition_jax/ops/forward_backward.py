"""Log-space forward-backward over epsilon-closed decoding graphs.

The reference only ever trains with hard Viterbi alignments
(``continuous_speech.py:89`` — SURVEY.md §3.3 explicitly notes it is
"Viterbi training (hard EM), not forward-backward/Baum-Welch; the north
star upgrades it to log-space forward-backward EM").  This module is
that upgrade: sum-product alpha/beta passes as ``lax.scan``s over the
same graph arrays the min-cost decoder uses — score space is negated
cost (``log p = -cost``), the frame recursion is a logsumexp-plus
matmul, and same-column epsilon moves are depth-bounded logaddexp
passes mirroring the Viterbi epsilon relaxation (including the
reference's boundary double-emission semantics).

Outputs: per-frame state posteriors ``gamma``, expected transition
counts ``xi_sum``, and the evidence ``log Z`` — everything soft-EM
needs; the statistics are plain sums over frames, so they psum across
a data-sharded mesh exactly like the hard-EM path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from speech_recognition_jax.utils.numerics import NEG_INF, POS_INF

__all__ = ["forward_backward", "forward_backward_banded", "FBResult",
           "costs_to_scores"]


class FBResult(NamedTuple):
    gamma: jnp.ndarray  # [T, S] posterior state occupancy (prob space)
    # expected frame-edge transition counts: [S, S] (xi_mode="dense") or
    # [MAX_BAND+1, S] with xi_sum[d, u] = count of edge u -> u+d
    # (xi_mode="band" — the production form; the M-step only consumes
    # the self/step band)
    xi_sum: jnp.ndarray
    log_z: jnp.ndarray  # [] total log evidence
    # [S] expected counts of the static cross-arc frame edges
    # (destination-indexed: xi_cross[s] = count of cross_src[s] -> s);
    # banded pass on cross-arc graphs only, None elsewhere
    xi_cross: jnp.ndarray = None


def costs_to_scores(cost_mat):
    """Cost (POS_INF-padded) -> log-prob score (NEG_INF-padded)."""
    return jnp.where(cost_mat >= POS_INF / 2, NEG_INF, -cost_mat)


def _lse_mv(log_a, x):
    """logsumexp over 'from': [S(to), S(from)] + [S(from)] -> [S(to)]."""
    z = log_a + x[None, :]
    m = jnp.max(z, axis=1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = jnp.log(jnp.sum(jnp.exp(z - m_safe[:, None]), axis=1)) + m_safe
    return jnp.where(jnp.isfinite(m), out, NEG_INF)


@functools.partial(jax.jit, static_argnames=("eps_depth", "xi_mode"))
def forward_backward(
    nll,
    trans_cost,
    init_cost,
    n_frames,
    eps_trans=None,
    eps_depth: int = 1,
    end_scores=None,
    xi_mode: str = "dense",
):
    """Sum-product pass over one utterance.

    Args:
      nll: ``[T, S]`` emission costs.
      trans_cost / eps_trans / init_cost: graph arrays as for
        :func:`ops.viterbi.viterbi` (cost space).
      end_scores: ``[S]`` terminal log-probs (NEG_INF for non-final
        states); default: uniform over all states at the last frame.
      xi_mode: "dense" accumulates the full ``[S, S]`` expected
        transition counts (oracle/testing); "band" accumulates only the
        ``[MAX_BAND+1, S]`` banded counts the M-step consumes — O(S)
        per frame instead of O(S^2) (off-band frame edges, which
        composed word graphs never have, are ignored in this mode).

    Returns :class:`FBResult`.
    """
    t_len, s = nll.shape
    log_e = -jnp.minimum(nll, POS_INF)  # emission log-prob (un-normalized)
    log_t = costs_to_scores(trans_cost)
    log_init = costs_to_scores(init_cost)
    log_eps = costs_to_scores(eps_trans) if eps_trans is not None else None
    if end_scores is None:
        end_scores = jnp.zeros((s,))

    def eps_fwd(alpha, emis):
        if log_eps is None:
            return alpha
        for _ in range(eps_depth):
            alpha = jnp.logaddexp(alpha, _lse_mv(log_eps, alpha) + emis)
        return alpha

    alpha0 = eps_fwd(log_init + log_e[0], log_e[0])

    def fwd(carry, inputs):
        alpha_prev = carry
        t, emis = inputs
        alpha = _lse_mv(log_t, alpha_prev) + emis
        alpha = eps_fwd(alpha, emis)
        alpha = jnp.where(t < n_frames, alpha, alpha_prev)
        return alpha, alpha

    ts = jnp.arange(1, t_len)
    _, alphas = jax.lax.scan(fwd, alpha0, (ts, log_e[1:]))
    alphas = jnp.concatenate([alpha0[None], alphas], axis=0)  # [T, S]

    # terminal: the forward scan freezes alpha past n_frames, so the
    # last row IS the last valid frame's alpha (no dynamic gather)
    log_z = jax.scipy.special.logsumexp(alphas[-1] + end_scores)

    # backward pass.  beta[t, s] = log P(emissions t+1.. | state s at t).
    def eps_bwd(beta, emis):
        # reverse of eps_fwd: a state can also leave by an eps hop whose
        # destination re-emits the same frame
        if log_eps is None:
            return beta
        for _ in range(eps_depth):
            beta = jnp.logaddexp(beta, _lse_mv(log_eps.T, beta + emis))
        return beta

    beta_last = end_scores

    def bwd(carry, inputs):
        beta_next = carry
        t, emis_next = inputs
        # beta at frame t from frame t+1: through frame edges
        b_eps = eps_bwd(beta_next, emis_next)
        beta = _lse_mv(log_t.T, b_eps + emis_next)
        is_last = t == n_frames - 1
        beta = jnp.where(is_last, end_scores, beta)
        beta = jnp.where(t < n_frames, beta, beta_next)
        return beta, beta

    ts_rev = jnp.arange(t_len - 2, -1, -1)
    _, betas_rev = jax.lax.scan(bwd, beta_last, (ts_rev, log_e[::-1][: t_len - 1]))
    betas = jnp.concatenate([betas_rev[::-1], beta_last[None]], axis=0)
    # fix the final valid frame's beta (scan handles interior frames)
    frame_idx = jnp.arange(t_len)
    betas = jnp.where((frame_idx == n_frames - 1)[:, None], end_scores[None], betas)

    log_gamma = alphas + betas - log_z
    valid = (frame_idx < n_frames)[:, None]
    gamma = jnp.where(valid, jnp.exp(jnp.minimum(log_gamma, 50.0)), 0.0)

    # expected frame-edge transition counts:
    # xi[t][v,u] = alpha[t-1,u] + logT[v,u] + emis[t,v] + beta[t,v] - logZ
    # The per-frame alpha/beta rows ride the scan as xs (streamed
    # slices), never as dynamic gathers by a traced t.
    xs = (ts, log_e[1:], alphas[:-1], betas[1:])
    if xi_mode == "dense":
        def xi_step(acc, inputs):
            t, emis, a_prev, beta_t = inputs
            m = a_prev[None, :] + log_t + (emis + beta_t)[:, None] - log_z
            acc = acc + jnp.where(t < n_frames,
                                  jnp.exp(jnp.minimum(m, 50.0)), 0.0)
            return acc, None

        xi_sum, _ = jax.lax.scan(xi_step, jnp.zeros((s, s)), xs)
    elif xi_mode == "band":
        from speech_recognition_jax.ops.viterbi_banded import MAX_BAND

        # static band diagonals of logT: band_logt[d][u] = logT[u+d, u]
        band_logt = jnp.stack([
            jnp.concatenate([
                jnp.diagonal(log_t, offset=-d),
                jnp.full((d,), NEG_INF)]) if d else jnp.diagonal(log_t)
            for d in range(MAX_BAND + 1)
        ])

        def xi_step(acc, inputs):
            t, emis, a_prev, beta_t = inputs
            eb = emis + beta_t
            rows = []
            for d in range(MAX_BAND + 1):
                eb_d = eb if d == 0 else jnp.concatenate(
                    [eb[d:], jnp.full((d,), NEG_INF)])  # eb[u+d]
                rows.append(a_prev + band_logt[d] + eb_d - log_z)
            m = jnp.stack(rows)
            acc = acc + jnp.where(t < n_frames,
                                  jnp.exp(jnp.minimum(m, 50.0)), 0.0)
            return acc, None

        xi_sum, _ = jax.lax.scan(xi_step, jnp.zeros((MAX_BAND + 1, s)), xs)
    else:
        raise ValueError(f"unknown xi_mode {xi_mode!r}")

    return FBResult(gamma=gamma, xi_sum=xi_sum, log_z=log_z)


# ---------------------------------------------------------------------------
# Banded forward-backward: the sum-product twin of ops.viterbi_banded.
#
# The dense pass above multiplies the full [S, S] score matrix every
# frame (O(S^2)); every graph this framework composes is banded —
# offsets 0..MAX_BAND within an arc, one static-origin cross edge per
# state (trie parent-end -> child-start), and an [R, L] epsilon block
# between arc boundaries.  This pass is the same logsumexp recursion
# restricted to that structure: three shifted adds + a constant-index
# gather + the small boundary block, O(3S + RL) per frame, so soft
# (Baum-Welch) statistics run on loop/sausage/lexical-tree graphs at
# the same asymptotics as the min-plus decoder (round-2 VERDICT weak
# item 5).  Matches :func:`forward_backward` on the equivalent dense
# graph to float tolerance (asserted in tests/test_forward_backward.py).
# ---------------------------------------------------------------------------


def _lse2(a, b):
    return jnp.logaddexp(a, b)


def _shift_scores(x, d):
    """x[s-d] along the last axis, NEG_INF fill (score-space shift)."""
    if d == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (d,), NEG_INF, x.dtype)
    return jnp.concatenate([pad, x[..., :-d]], axis=-1)


def _unshift_scores(x, d):
    """x[s+d] along the last axis, NEG_INF fill."""
    if d == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (d,), NEG_INF, x.dtype)
    return jnp.concatenate([x[..., d:], pad], axis=-1)


def _lse_rows(z):
    """logsumexp over axis 0 of ``z [K, S]`` with NEG_INF safety."""
    m = jnp.max(z, axis=0)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = jnp.log(jnp.sum(jnp.exp(z - m_safe[None]), axis=0)) + m_safe
    return jnp.where(jnp.isfinite(m), out, NEG_INF)


def _segment_lse(vals, segs, num_segments):
    """logsumexp of ``vals`` grouped by ``segs`` (reverse of a gather):
    out[u] = LSE_{i: segs[i]=u} vals[i].  NEG_INF-safe."""
    m = jax.ops.segment_max(vals, segs, num_segments=num_segments)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    e = jnp.where(jnp.isfinite(vals), jnp.exp(vals - m_safe[segs]), 0.0)
    tot = jax.ops.segment_sum(e, segs, num_segments=num_segments)
    return jnp.where(tot > 0, jnp.log(jnp.maximum(tot, 1e-300)) + m_safe,
                     NEG_INF)


@functools.partial(jax.jit, static_argnames=("eps_depth",))
def forward_backward_banded(
    nll,
    g,
    n_frames,
    eps_depth: int = 1,
    end_scores=None,
):
    """Sum-product pass over one utterance on a :class:`BandedGraph`.

    Args:
      nll: ``[T, S]`` emission costs (graph-state order).
      g: ``ops.viterbi_banded.BandedGraph`` — band ``[MAX_BAND+1, S]``
        (``band[d, s]`` = cost of the frame edge ``s-d -> s``), optional
        static cross edges (``cross_src``/``cross_cost``), and the
        ``[R, L]`` epsilon block between ``word_ends``/``word_starts``.
      n_frames: valid frame count (static shapes + masks).
      end_scores: ``[S]`` terminal log-probs; default uniform.

    Returns :class:`FBResult` with ``xi_sum`` in band form
    ``[MAX_BAND+1, S]`` (``xi_sum[d, u]`` = expected count of the frame
    edge ``u -> u+d`` — what the M-step consumes).
    """
    t_len, s = nll.shape
    n_band = g.band.shape[0]
    log_e = -jnp.minimum(nll, POS_INF)
    log_band = costs_to_scores(g.band)  # [D, S]: edge (s-d) -> s
    log_eps_blk = costs_to_scores(g.eps_block)  # [R, L]
    has_cross = g.cross_src is not None
    if has_cross:
        log_cross = costs_to_scores(g.cross_cost)  # [S]
    if end_scores is None:
        end_scores = jnp.zeros((s,))
    log_init = costs_to_scores(g.init_cost)

    # membership maps for the gather-only eps re-entry / exit
    is_end = jnp.zeros((s,), bool).at[g.word_ends].set(True)
    end_pos = jnp.zeros((s,), jnp.int32).at[g.word_ends].set(
        jnp.arange(g.word_ends.shape[0], dtype=jnp.int32))

    def eps_fwd(alpha, emis):
        for _ in range(eps_depth):
            end_vals = alpha[..., g.word_ends]  # [L]
            base = _lse_rows(log_eps_blk.T + end_vals[:, None])  # [R]
            cand = base + emis[..., g.word_starts]
            dense = jnp.where(g.is_start, cand[..., g.start_pos], NEG_INF)
            alpha = _lse2(alpha, dense)
        return alpha

    alpha0 = eps_fwd(log_init + log_e[0], log_e[0])

    def band_fwd(alpha_prev):
        z = jnp.stack([log_band[d] + _shift_scores(alpha_prev, d)
                       for d in range(n_band)])
        base = _lse_rows(z)
        if has_cross:
            base = _lse2(base, alpha_prev[g.cross_src] + log_cross)
        return base

    def fwd(carry, inputs):
        alpha_prev = carry
        t, emis = inputs
        alpha = band_fwd(alpha_prev) + emis
        alpha = eps_fwd(alpha, emis)
        alpha = jnp.where(t < n_frames, alpha, alpha_prev)
        return alpha, alpha

    ts = jnp.arange(1, t_len)
    _, alphas = jax.lax.scan(fwd, alpha0, (ts, log_e[1:]))
    alphas = jnp.concatenate([alpha0[None], alphas], axis=0)
    log_z = jax.scipy.special.logsumexp(alphas[-1] + end_scores)

    def eps_bwd(beta, emis):
        # reverse of eps_fwd: arc-end states also leave by an eps hop
        # whose destination re-emits the same frame
        for _ in range(eps_depth):
            sv = beta[..., g.word_starts] + emis[..., g.word_starts]  # [R]
            contrib_l = _lse_rows(log_eps_blk + sv[:, None])  # [L]
            dense = jnp.where(is_end, contrib_l[..., end_pos], NEG_INF)
            beta = _lse2(beta, dense)
        return beta

    def band_bwd(y):
        """y[v] = beta-side score at destination v; returns the
        band/cross pullback onto origins u."""
        z = jnp.stack([_unshift_scores(log_band[d] + y, d)
                       for d in range(n_band)])
        out = _lse_rows(z)
        if has_cross:
            out = _lse2(out, _segment_lse(log_cross + y, g.cross_src, s))
        return out

    beta_last = end_scores

    def bwd(carry, inputs):
        beta_next = carry
        t, emis_next = inputs
        b_eps = eps_bwd(beta_next, emis_next)
        beta = band_bwd(b_eps + emis_next)
        is_last = t == n_frames - 1
        beta = jnp.where(is_last, end_scores, beta)
        beta = jnp.where(t < n_frames, beta, beta_next)
        return beta, beta

    ts_rev = jnp.arange(t_len - 2, -1, -1)
    _, betas_rev = jax.lax.scan(bwd, beta_last,
                                (ts_rev, log_e[::-1][: t_len - 1]))
    betas = jnp.concatenate([betas_rev[::-1], beta_last[None]], axis=0)
    frame_idx = jnp.arange(t_len)
    betas = jnp.where((frame_idx == n_frames - 1)[:, None],
                      end_scores[None], betas)

    log_gamma = alphas + betas - log_z
    valid = (frame_idx < n_frames)[:, None]
    gamma = jnp.where(valid, jnp.exp(jnp.minimum(log_gamma, 50.0)), 0.0)

    # banded expected transition counts: xi[d, u] += exp(alpha[t-1, u]
    # + log_band[d, u+d] + (emis + beta)[t, u+d] - log_z); cross-edge
    # counts ride the same scan, destination-indexed.
    log_band_from = jnp.stack([_unshift_scores(log_band[d], d)
                               for d in range(n_band)])  # [D, S]: u -> u+d

    def xi_step(acc, inputs):
        acc_band, acc_cross = acc
        t, emis, a_prev, beta_t = inputs
        eb = emis + beta_t
        m = jnp.stack([a_prev + log_band_from[d] + _unshift_scores(eb, d)
                       for d in range(n_band)]) - log_z
        live = t < n_frames
        acc_band = acc_band + jnp.where(
            live, jnp.exp(jnp.minimum(m, 50.0)), 0.0)
        if has_cross:
            mc = a_prev[g.cross_src] + log_cross + eb - log_z
            acc_cross = acc_cross + jnp.where(
                live, jnp.exp(jnp.minimum(mc, 50.0)), 0.0)
        return (acc_band, acc_cross), None

    xs = (ts, log_e[1:], alphas[:-1], betas[1:])
    (xi_sum, xi_cross), _ = jax.lax.scan(
        xi_step, (jnp.zeros((n_band, s)), jnp.zeros((s,))), xs)
    return FBResult(gamma=gamma, xi_sum=xi_sum, log_z=log_z,
                    xi_cross=xi_cross if has_cross else None)
