"""Min-cost Viterbi / DTW as a ``lax.scan`` over frames.

This one kernel replaces both reference DPs — ``dtw``
(``/root/reference/sr/recognition/decode.py:7-77``) and
``decode_hmm_states`` (``decode.py:80-146``) — whose inner loops are
per-(frame, state) Python loops.  Here the whole state dimension is
relaxed at once: one frame step is a broadcast min-plus product
``new[to] = min_from(T[to,from] + prev[from]) + nll[t,to]`` which XLA
fuses into a single elementwise pass, and the frame loop is a
``lax.scan`` so the
program compiles once for a static max length and handles true lengths
with masks.

Non-emitting (NES) states are *eliminated offline*: graph composition
(``models/graph.py``) epsilon-closes every NES-mediated path into a
same-column emitting->emitting transition matrix ``eps_trans``, because
the reference's rule — a transition touching an NES consumes no frame
(``decode.py:108-114``) — is inherently same-column-sequential.  The
runtime step applies the frame-edge relaxation followed by
``eps_depth`` same-column relaxations (each re-adding the destination's
emission, reproducing the reference's boundary-frame double emission
where the word-end and the next word-start both emit the same frame).

Tie-breaking matches the reference: ``argmin`` picks the lowest origin
index (``decode.py:115``, numpy argmin-first semantics).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["viterbi", "viterbi_backtrace", "viterbi_path_cost", "ViterbiResult"]


class ViterbiResult(NamedTuple):
    final_cost: jnp.ndarray  # [S] costs at the last *valid* frame
    bp: jnp.ndarray  # [T, S] int32 frame-edge backpointers (-1 at t=0)
    eps_bp: jnp.ndarray  # [T, S] int32 same-column origin, -1 if none
    costs: Optional[jnp.ndarray]  # [T, S] full cost matrix (None unless kept)


def _relax(prev_cost, trans_cost):
    scores = trans_cost + prev_cost[None, :]
    return jnp.min(scores, axis=1), jnp.argmin(scores, axis=1).astype(jnp.int32)


def _beam_prune(cost, beam_width: int):
    """Rank-based beam: keep the ``beam_width`` lowest costs, set the rest
    to +inf (reference ``dtw`` beam, ``decode.py:62-68``; threshold form,
    so exact ties with the k-th best survive)."""
    thresh = jnp.sort(cost)[beam_width - 1]
    return jnp.where(cost <= thresh, cost, POS_INF)


@functools.partial(
    jax.jit, static_argnames=("eps_depth", "beam_width", "keep_costs")
)
def viterbi(
    nll,
    trans_cost,
    init_cost,
    n_frames,
    eps_trans=None,
    eps_depth: int = 1,
    beam_width: int = 0,
    keep_costs: bool = False,
) -> ViterbiResult:
    """Run min-cost Viterbi over one utterance.

    Args:
      nll:        ``[T, S]`` emission costs (negative log likelihoods, or
                  any distance for DTW).  Frames >= ``n_frames`` are ignored.
      trans_cost: ``[S, S]`` frame-consuming transition costs, reference
                  convention ``T[to, from]``, ``POS_INF`` where absent.
      init_cost:  ``[S]`` cost of starting in each state *before* the first
                  emission (0 for the entry state, eps-closure costs for
                  states reachable from the initial NES, else ``POS_INF``).
      n_frames:   true frame count (dynamic).
      eps_trans:  optional ``[S, S]`` same-column (epsilon) transition
                  costs between emitting states, NES chains pre-closed.
      eps_depth:  static number of same-column relaxation passes (max
                  epsilon hops through *emitting* states per column; 1
                  for word-sausage/linear graphs).
      beam_width: static; if > 0, rank-based pruning per frame.

    Returns:
      :class:`ViterbiResult`.  ``final_cost[s]`` is the path cost ending
      at state ``s`` at frame ``n_frames - 1``.
    """
    T, S = nll.shape
    nll = jnp.minimum(nll, POS_INF)

    def column(base_cost, emis):
        """Finish one column given frame-edge arrivals."""
        cost = jnp.minimum(base_cost + emis, POS_INF)
        eps_bp = jnp.full((S,), -1, jnp.int32)
        if eps_trans is not None:
            for _ in range(eps_depth):
                cand_base, cand_bp = _relax(cost, eps_trans)
                cand = jnp.minimum(cand_base + emis, POS_INF)
                better = cand < cost
                cost = jnp.where(better, cand, cost)
                eps_bp = jnp.where(better, cand_bp, eps_bp)
        return cost, eps_bp

    # Column 0: init_cost plays the role of frame-edge arrivals.
    cost0, eps_bp0 = column(init_cost, nll[0])
    if beam_width:
        cost0 = _beam_prune(cost0, beam_width)

    def step(carry, inputs):
        prev_cost, final_cost = carry
        t, emis = inputs
        base, bp = _relax(prev_cost, trans_cost)
        cost, eps_bp = column(base, emis)
        if beam_width:
            cost = _beam_prune(cost, beam_width)
        active = t < n_frames
        cost = jnp.where(active, cost, prev_cost)
        final_cost = jnp.where(t == n_frames - 1, cost, final_cost)
        return (cost, final_cost), (bp, eps_bp, cost if keep_costs else None)

    ts = jnp.arange(1, T)
    (last, final_cost), (bps, eps_bps, costs) = jax.lax.scan(
        step, (cost0, jnp.where(n_frames == 1, cost0, POS_INF)), (ts, nll[1:])
    )
    bp = jnp.concatenate([jnp.full((1, S), -1, jnp.int32), bps], axis=0)
    eps_bp = jnp.concatenate([eps_bp0[None], eps_bps], axis=0)
    if keep_costs:
        costs = jnp.concatenate([cost0[None], costs], axis=0)
    return ViterbiResult(final_cost, bp, eps_bp, costs if keep_costs else None)


@functools.partial(jax.jit, static_argnames=("eps_depth",))
def viterbi_backtrace(bp, eps_bp, end_state, n_frames, eps_depth: int = 1):
    """Recover the per-frame state assignment from backpointers.

    Walks backwards from ``(end_state, n_frames - 1)``.  At each column
    the *last* state of the column (after same-column epsilon hops) is
    recorded as that frame's state; epsilon chains are then unwound and
    the frame edge followed.  Equivalent to the reference backtrace
    (``decode.py:142-146``) with NES visits dropped — at a word boundary
    the reference assigns the shared frame to both the old word-end and
    the new word-start (double emission); we keep the later state, so
    consecutive-deduped word sequences agree.

    Returns ``(states [T] int32, eps_entered [T] bool)``.  ``eps_entered[t]``
    marks that the path crossed a word-boundary epsilon edge *at* frame t
    (a new word starts there) — this is what separates repeated words in
    loop graphs, where slot labels alone cannot split \"9 9\".  Entries
    >= n_frames repeat the end state / False.
    """
    T, S = bp.shape

    def step(s, t):
        rec = s
        s_eps = s
        used_eps = jnp.array(False)
        for _ in range(eps_depth):
            origin = eps_bp[t, s_eps]
            used_eps = used_eps | (origin >= 0)
            s_eps = jnp.where(origin >= 0, origin, s_eps)
        prev = bp[t, s_eps]
        active = (t > 0) & (t < n_frames)
        return jnp.where(active, prev, s), (rec, used_eps & (t < n_frames))

    ts = jnp.arange(T - 1, -1, -1)
    _, (states_rev, eps_rev) = jax.lax.scan(step, end_state.astype(jnp.int32), ts)
    return states_rev[::-1], eps_rev[::-1]


def viterbi_path_cost(nll, trans_cost, init_cost, n_frames, end_state=None, **kw):
    """Convenience: best-path cost only (reference ``HMM.evaluate``
    semantics, ``/root/reference/sr/recognition/hmm.py:126-135`` — cost at
    the last state, last frame)."""
    res = viterbi(nll, trans_cost, init_cost, n_frames, **kw)
    if end_state is None:
        return res.final_cost[-1]
    return res.final_cost[end_state]
