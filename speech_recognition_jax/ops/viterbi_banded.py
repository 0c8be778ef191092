"""Banded min-cost Viterbi — the fast path for word graphs and lextrees.

Every graph this framework composes (isolated word chains, transcript
linears, sausages, loop graphs, lexical prefix trees) has structure the
dense O(S^2) relaxation ignores:

* frame-consuming edges exist mostly *within* an arc, at state offsets
  0 (self), +1 (step), +2 (skip) — the reference's ``max_jump_dist=2``
  (``/root/reference/sr/recognition/kmeans.py:53``), and arc states
  are enumerated consecutively;
* lexical trees add one extra frame edge per arc — parent-arc-end ->
  child-arc-start — whose origin is *static per state* (every trie arc
  has exactly one parent), so it is a constant-index gather of the
  previous frontier, not a matmul (``cross_src`` / ``cross_cost``);
* every same-column epsilon edge runs between the L designated
  arc-end and R arc-start states (word boundaries; LM costs live
  here).

One frame step is therefore three shifted adds of the ``[B, S]`` cost
frontier, an optional [S] gather, plus a small dense ``[R, L]``
boundary block — O(3S + RL) instead of O(S^2), in elementwise form:

* no scatters: the epsilon update re-enters the frontier through a
  constant-index gather (``start_pos``/``is_start`` maps);
* compact backpointers: one int8 per (frame, state) — band offset
  0..2, ``_CROSS`` (=3) for the static cross-arc edge, ``_EPS`` (=4)
  for an epsilon arrival.  Epsilon *origins* stream to a separate
  ``[T, R]`` side plane (int8 while L <= 127, int32 beyond), so the
  vocabulary is unbounded while the main plane's memory traffic stays
  1 byte per (frame, state).

Results are bit-identical to :func:`ops.viterbi.viterbi` on the
equivalent dense graph (asserted in tests), including argmin
tie-breaking.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.utils.numerics import POS_INF

__all__ = [
    "BandedGraph",
    "banded_arrays",
    "viterbi_banded",
    "viterbi_banded_tb",
    "banded_backtrace",
    "banded_backtrace_tb",
]

MAX_BAND = 2  # reference max_jump_dist
_CROSS = MAX_BAND + 1  # bp8 code: cross-arc frame edge (origin = cross_src[s])
_EPS = MAX_BAND + 2  # bp8 code: eps arrival; origin u in the eps_u side plane

# Production scan-unroll factor.  The per-frame step is small next to
# the fixed cost of a while-loop iteration, which unrolling amortizes;
# 1 until measured otherwise on the GPU.
DEFAULT_UNROLL = 1


class BandedGraph(NamedTuple):
    """Device-ready banded form of a WordGraph or LexGraph.

    ``word_starts [R]`` / ``word_ends [L]`` are the epsilon re-entry /
    exit states; ``eps_block [R, L]`` the same-column costs between
    them (square with R == L == V for composed word graphs; R = root
    arcs, L = leaves for lexical trees).  ``cross_src`` / ``cross_cost``
    (None for plain word graphs) add per-state frame edges with a
    static origin — the parent-end -> child-start edges of a trie.
    """

    band: jnp.ndarray  # [MAX_BAND+1, S] cost of arriving from state v-d
    init_cost: jnp.ndarray  # [S]
    word_starts: jnp.ndarray  # [R] eps re-entry states
    word_ends: jnp.ndarray  # [L] eps exit states
    eps_block: jnp.ndarray  # [R, L] eps cost end[u] -> start[r]
    start_pos: jnp.ndarray  # [S] slot r if state is starts[r] else 0
    is_start: jnp.ndarray  # [S] bool
    end_states: jnp.ndarray  # [E]
    end_bonus: jnp.ndarray  # [E]
    bank_state: jnp.ndarray  # [S]
    cross_src: Optional[jnp.ndarray] = None  # [S] int32 static frame-edge origin
    cross_cost: Optional[jnp.ndarray] = None  # [S] f32 (POS_INF where absent)

    @property
    def n_words(self) -> int:
        return self.word_starts.shape[0]

    @property
    def n_ends(self) -> int:
        return self.word_ends.shape[0]


def _eps_u_dtype(n_ends: int):
    """Side-plane dtype for epsilon origins: int8 packs vocabularies up
    to 128 ends; larger lexicons widen to int32 (the side plane is
    [T, R], a small fraction of the [T, S] main plane)."""
    return jnp.int8 if n_ends <= 127 else jnp.int32


def banded_arrays(graph) -> BandedGraph:
    """Extract the banded form; raises ValueError if the graph is not
    banded (callers fall back to the dense kernel)."""
    s = graph.n_states
    trans = np.asarray(graph.trans)
    band = np.full((MAX_BAND + 1, s), POS_INF, dtype=np.float32)
    covered = np.zeros_like(trans, dtype=bool)
    for d in range(MAX_BAND + 1):
        idx = np.arange(d, s)
        band[d, idx] = trans[idx, idx - d]
        covered[idx, idx - d] = True
    if ((trans < POS_INF / 2) & ~covered).any():
        raise ValueError("graph has frame edges outside the +0..+2 band")

    slot = np.asarray(graph.slot)
    starts = np.flatnonzero(np.r_[True, slot[1:] != slot[:-1]])
    ends = np.r_[starts[1:] - 1, s - 1]
    for d in range(1, MAX_BAND + 1):
        idx = np.arange(d, s)
        crosses = slot[idx] != slot[idx - d]
        if np.any((band[d, idx] < POS_INF / 2) & crosses):
            raise ValueError("band edge crosses a word boundary")

    v = len(starts)

    eps = np.asarray(graph.eps_trans)
    eps_block = eps[np.ix_(starts, ends)].astype(np.float32)
    covered_eps = np.zeros_like(eps, dtype=bool)
    covered_eps[np.ix_(starts, ends)] = True
    if ((eps < POS_INF / 2) & ~covered_eps).any():
        raise ValueError("epsilon edge outside end->start structure")

    start_pos = np.zeros(s, dtype=np.int32)
    start_pos[starts] = np.arange(v)
    is_start = np.zeros(s, dtype=bool)
    is_start[starts] = True

    return BandedGraph(
        band=jnp.asarray(band),
        init_cost=jnp.asarray(graph.init_cost),
        word_starts=jnp.asarray(starts.astype(np.int32)),
        word_ends=jnp.asarray(ends.astype(np.int32)),
        eps_block=jnp.asarray(eps_block),
        start_pos=jnp.asarray(start_pos),
        is_start=jnp.asarray(is_start),
        end_states=jnp.asarray(graph.end_states),
        end_bonus=jnp.asarray(graph.end_bonus),
        bank_state=jnp.asarray(graph.bank_state),
    )


def _eps_base(end_vals, g: BandedGraph):
    """min-plus product of the eps block with the arc-end costs.

    ``end_vals [..., L]`` -> ``(base [..., R], origin [..., R] int32)``
    where ``base[r] = min_u eps[r,u] + end_vals[u]`` and ``origin`` is
    the first-minimum u (dense argmin tie-break)."""
    scores = g.eps_block + end_vals[..., None, :]
    return jnp.min(scores, axis=-1), jnp.argmin(scores, axis=-1).astype(jnp.int32)


def _eps_base_tb(end_vals, g: BandedGraph):
    """State-major twin of :func:`_eps_base`: ``end_vals [L, B]`` ->
    ``(base [R, B], origin [R, B] int32)``."""
    scores = g.eps_block[:, :, None] + end_vals[None, :, :]
    return jnp.min(scores, axis=1), jnp.argmin(scores, axis=1).astype(jnp.int32)


def _shift(x, d):
    """x[v-d] with POS_INF fill (last axis)."""
    if d == 0:
        return x
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (d,), POS_INF, x.dtype), x[..., :-d]], axis=-1
    )


def _select_band(cands):
    """Tie-break selection shared by every layout: dense-argmin
    tie-break = smallest origin index = largest d, so iterate d
    ascending and replace on <=.  ``cands[d]`` is the cost of arriving
    via band offset d."""
    best = jnp.full(cands[0].shape, POS_INF)
    d_sel = jnp.zeros(cands[0].shape, jnp.int8)
    for d, cand in enumerate(cands):
        take = cand <= best
        best = jnp.where(take, cand, best)
        d_sel = jnp.where(take, jnp.int8(d), d_sel)
    return jnp.minimum(best, POS_INF), d_sel


def _band_relax(prev, band):
    """frontier [..., S] -> (base cost, band offset d int8)."""
    return _select_band(
        [band[d] + _shift(prev, d) for d in range(MAX_BAND + 1)])


def _cross_relax(base, d_sel, prev, g: BandedGraph):
    """Static-origin cross-arc frame edges (trie parent-end ->
    child-start): one constant-index gather of the previous frontier.
    Ties go to the cross edge — its origin (``cross_src[s]``, always an
    earlier state in preorder) is below every band origin that can be
    finite at the same state, matching dense argmin-first semantics."""
    if g.cross_src is None:
        return base, d_sel
    cand = jnp.minimum(prev[..., g.cross_src] + g.cross_cost, POS_INF)
    take = cand <= base
    return (jnp.where(take, cand, base),
            jnp.where(take, jnp.int8(_CROSS), d_sel))


def _eps_relax(cost, emis, g: BandedGraph):
    """One same-column pass, gather-only.  Returns
    ``(cost, better [S] bool, better_r [R] bool, origin_u [R] int32)``:
    ``better`` marks improved start states (bp8 code ``_EPS``);
    ``origin_u``/``better_r`` feed the eps side plane."""
    end_vals = cost[..., g.word_ends]  # [L] constant-index gather
    base, origin_u = _eps_base(end_vals, g)
    cand = jnp.minimum(base + emis[..., g.word_starts], POS_INF)
    # dense re-entry via gather
    cand_dense = cand[..., g.start_pos]
    better = g.is_start & (cand_dense < cost)
    cost = jnp.where(better, cand_dense, cost)
    better_r = better[..., g.word_starts]
    return cost, better, better_r, origin_u


@functools.partial(jax.jit,
                   static_argnames=("eps_depth", "need_bp", "beam_width", "unroll"))
def viterbi_banded(nll, g: BandedGraph, n_frames, eps_depth: int = 1,
                   need_bp: bool = True, beam_width: int = 0,
                   unroll: int = 1):
    """Banded Viterbi for one utterance.

    Returns ``(final_cost [S], bp8 [T, S] int8, eps_u [T, R])`` —
    decode with :func:`banded_backtrace`.  With ``need_bp=False`` both
    backpointer planes are skipped entirely (isolated scoring /
    likelihood only).  ``beam_width > 0`` enables rank-based frontier
    pruning per frame (threshold form, exact ties with the k-th best
    survive — the reference's ``dtw`` beam semantics,
    ``decode.py:62-68``).  ``unroll`` is passed to the frame scan: the
    step is small next to the loop's per-iteration cost, which
    unrolling amortizes.
    """
    t_len, s = nll.shape
    r = g.word_starts.shape[0]
    u_dtype = _eps_u_dtype(g.word_ends.shape[0])
    nll = jnp.minimum(nll, POS_INF)

    def column(base_cost, d_sel, emis):
        cost = jnp.minimum(base_cost + emis, POS_INF)
        bp8 = d_sel
        eps_u = jnp.zeros((r,), u_dtype)
        for _ in range(eps_depth):
            cost, better, better_r, origin_u = _eps_relax(cost, emis, g)
            bp8 = jnp.where(better, jnp.int8(_EPS), bp8)
            eps_u = jnp.where(better_r, origin_u.astype(u_dtype), eps_u)
        if beam_width:
            thresh = -jax.lax.top_k(-cost, beam_width)[0][-1]
            cost = jnp.where(cost <= thresh, cost, POS_INF)
        return cost, bp8, eps_u

    cost0, bp0, eps_u0 = column(g.init_cost, jnp.zeros((s,), jnp.int8), nll[0])

    def step(carry, inputs):
        prev, final = carry
        t, emis = inputs
        base, d_sel = _band_relax(prev, g.band)
        base, d_sel = _cross_relax(base, d_sel, prev, g)
        cost, bp8, eps_u = column(base, d_sel, emis)
        active = t < n_frames
        cost = jnp.where(active, cost, prev)
        final = jnp.where(t == n_frames - 1, cost, final)
        out = (bp8, eps_u) if need_bp else None
        return (cost, final), out

    ts = jnp.arange(1, t_len)
    init_final = jnp.where(n_frames == 1, cost0, POS_INF)
    (last, final), outs = jax.lax.scan(step, (cost0, init_final), (ts, nll[1:]),
                                       unroll=unroll)
    if need_bp:
        bps, eps_us = outs
        bp8 = jnp.concatenate([bp0[None], bps], axis=0)
        eps_u = jnp.concatenate([eps_u0[None], eps_us], axis=0)
    else:
        bp8 = jnp.zeros((0, s), jnp.int8)
        eps_u = jnp.zeros((0, r), u_dtype)
    return final, bp8, eps_u


@functools.partial(jax.jit, static_argnames=("eps_depth", "unroll"))
def viterbi_banded_tb(nll_tb, g: BandedGraph, n_frames, eps_depth: int = 1,
                      unroll: int = 1):
    """State-major batched banded Viterbi: ``nll_tb [T, S, B]``,
    ``n_frames [B]`` -> ``(final [S, B], bp8 [T, S, B],
    eps_u [T, R, B])``.

    Bit-identical to ``vmap(viterbi_banded)`` (asserted in tests) but
    with the batch on the minor axis, so every per-frame op is
    contiguous over the batch.  Beam pruning needs a per-item top-k
    along S, which this layout does not offer; callers wanting a beam
    use the vmapped kernel.
    """
    t_len, s, b = nll_tb.shape
    r = g.word_starts.shape[0]
    u_dtype = _eps_u_dtype(g.word_ends.shape[0])
    nll_tb = jnp.minimum(nll_tb, POS_INF)

    def shift_s(x, d):
        if d == 0:
            return x
        pad = jnp.full((d, x.shape[-1]), POS_INF, x.dtype)
        return jnp.concatenate([pad, x[:-d, :]], axis=0)

    def band_relax(prev):
        return _select_band(
            [g.band[d][:, None] + shift_s(prev, d)
             for d in range(MAX_BAND + 1)])

    def cross_relax(base, d_sel, prev):
        if g.cross_src is None:
            return base, d_sel
        cand = jnp.minimum(prev[g.cross_src, :] + g.cross_cost[:, None], POS_INF)
        take = cand <= base
        return (jnp.where(take, cand, base),
                jnp.where(take, jnp.int8(_CROSS), d_sel))

    def eps_relax(cost, emis):
        end_vals = cost[g.word_ends, :]  # [L, B]
        base, origin_u = _eps_base_tb(end_vals, g)
        cand = jnp.minimum(base + emis[g.word_starts, :], POS_INF)
        cand_dense = cand[g.start_pos, :]
        better = g.is_start[:, None] & (cand_dense < cost)
        cost = jnp.where(better, cand_dense, cost)
        better_r = better[g.word_starts, :]
        return cost, better, better_r, origin_u

    def column(base_cost, d_sel, emis):
        cost = jnp.minimum(base_cost + emis, POS_INF)
        bp8 = d_sel
        eps_u = jnp.zeros((r, b), u_dtype)
        for _ in range(eps_depth):
            cost, better, better_r, origin_u = eps_relax(cost, emis)
            bp8 = jnp.where(better, jnp.int8(_EPS), bp8)
            eps_u = jnp.where(better_r, origin_u.astype(u_dtype), eps_u)
        return cost, bp8, eps_u

    init = jnp.broadcast_to(g.init_cost[:, None], (s, b))
    cost0, bp0, eps_u0 = column(init, jnp.zeros((s, b), jnp.int8), nll_tb[0])

    def step(carry, inputs):
        prev, final = carry
        t, emis = inputs
        base, d_sel = band_relax(prev)
        base, d_sel = cross_relax(base, d_sel, prev)
        cost, bp8, eps_u = column(base, d_sel, emis)
        active = t < n_frames  # [B]
        cost = jnp.where(active[None, :], cost, prev)
        final = jnp.where((t == n_frames - 1)[None, :], cost, final)
        return (cost, final), (bp8, eps_u)

    ts = jnp.arange(1, t_len)
    init_final = jnp.where((n_frames == 1)[None, :], cost0, POS_INF)
    (_, final), (bps, eps_us) = jax.lax.scan(
        step, (cost0, init_final), (ts, nll_tb[1:]), unroll=unroll)
    bp8 = jnp.concatenate([bp0[None], bps], axis=0)
    eps_u = jnp.concatenate([eps_u0[None], eps_us], axis=0)
    return final, bp8, eps_u


@functools.partial(jax.jit, static_argnames=("eps_depth", "unroll"))
def banded_backtrace_tb(bp8, eps_u, g: BandedGraph, end_state, n_frames,
                        eps_depth: int = 1, unroll: int = 1):
    """Batched backtrace for the state-major layout: ``bp8 [T, S, B]``,
    ``eps_u [T, R, B]``, ``end_state [B]``, ``n_frames [B]`` ->
    ``(states [T, B], eps_entered [T, B])`` with
    :func:`banded_backtrace` semantics."""
    t_len, s, b = bp8.shape

    def take(plane, idx):
        return jnp.take_along_axis(plane, idx[None, :], axis=0)[0]

    def step(carry, t):
        rec = carry  # [B]
        st = carry
        plane = bp8[t]  # [S, B]
        code = take(plane, st)
        # eps unwind: origin from the side plane at this state's slot
        used_eps = jnp.zeros((b,), bool)
        eps_plane = eps_u[t]  # [R, B]
        for _ in range(eps_depth):
            is_eps = code == _EPS
            used_eps = used_eps | is_eps
            u = take(eps_plane, g.start_pos[st]).astype(jnp.int32)
            st = jnp.where(is_eps, g.word_ends[u], st)
            code = jnp.where(is_eps, take(plane, st), code)
        if g.cross_src is not None:
            prev = jnp.where(code == _CROSS, g.cross_src[st],
                             st - jnp.minimum(code, MAX_BAND).astype(jnp.int32))
        else:
            prev = st - code.astype(jnp.int32)
        active = (t > 0) & (t < n_frames)
        return jnp.where(active, prev, rec), (rec, used_eps & (t < n_frames))

    ts = jnp.arange(t_len - 1, -1, -1)
    _, (states_rev, eps_rev) = jax.lax.scan(step, end_state.astype(jnp.int32), ts,
                                            unroll=unroll)
    return states_rev[::-1], eps_rev[::-1]


@functools.partial(jax.jit, static_argnames=("eps_depth", "unroll"))
def banded_backtrace(bp8, eps_u, g: BandedGraph, end_state, n_frames,
                     eps_depth: int = 1, unroll: int = 1):
    """Decode banded backpointers to (states [T], eps_entered [T]) with
    the same semantics as :func:`ops.viterbi.viterbi_backtrace`."""
    t_len, s = bp8.shape

    def step(carry, t):
        rec = carry  # recorded state for frame t (pre-unwind, like dense)
        st = carry
        code = bp8[t, st]
        used_eps = jnp.array(False)
        for _ in range(eps_depth):
            is_eps = code == _EPS
            used_eps = used_eps | is_eps
            u = eps_u[t, g.start_pos[st]].astype(jnp.int32)
            st = jnp.where(is_eps, g.word_ends[u], st)
            code = jnp.where(is_eps, bp8[t, st], code)
        if g.cross_src is not None:
            prev = jnp.where(code == _CROSS, g.cross_src[st],
                             st - jnp.minimum(code, MAX_BAND).astype(jnp.int32))
        else:
            prev = st - code.astype(jnp.int32)
        active = (t > 0) & (t < n_frames)
        return jnp.where(active, prev, rec), (rec, used_eps & (t < n_frames))

    ts = jnp.arange(t_len - 1, -1, -1)
    _, (states_rev, eps_rev) = jax.lax.scan(step, end_state.astype(jnp.int32), ts,
                                            unroll=unroll)
    return states_rev[::-1], eps_rev[::-1]
