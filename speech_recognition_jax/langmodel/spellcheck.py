"""Text Viterbi over a lexical tree + working spell checker.

Vectorized re-design of ``text_viterbi``
(``/root/reference/sr/langmodel/spellchecker.py:15-135``) — an
edit-distance Viterbi of an input string against the flattened trie
with the reference's cost model: deletion 1, substitution 1 (match 0),
insertion 1, space 0, word-end -> root loop 1.  The reference fills the
(nodes x chars) cost matrix with a per-cell Python loop and rebuilds
transitions via ``nodes.index`` (its own "cache misses" FIXME,
``spellchecker.py:24``); here each input character is one vectorized
relaxation over all trie nodes inside ``lax.scan``, with the
same-column insertion chain handled by ``max_depth`` bounded passes
(the trie analog of the decoder's epsilon closure).

``SpellChecker`` implements the fit/spell_check API the reference left
as TODO stubs (``spellchecker.py:138-149``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.langmodel.lextree import LexTree, lextree_from_words
from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["text_viterbi", "text_viterbi_batch", "SpellChecker"]

# cost model, spellchecker.py:27-32
DELETION_COST = 1.0
INSERTION_COST = 1.0
MATCH_COST = 0.0
SPACE_COST = 0.0
LOOP_COST = 1.0

# backpointer move kinds
_MOVE_DEL = 0  # (r, c-1)
_MOVE_MATCH = 1  # (parent, c-1)
_MOVE_INS = 2  # (parent, c) same column
_MOVE_LOOP = 3  # (word_end/space, c-1)


@functools.partial(jax.jit, static_argnames=("max_depth", "need_bp"))
def _text_viterbi_device(
    codes,  # [C] int32 input char codes, codes[0] = '*'
    val,  # [N] int32 node codes; val[N-1] = ' ' (synthetic space node)
    parent,  # [N] int32; -1 root, space node parent -1
    is_root_child,  # [N] bool
    is_word_end,  # [N] bool (real word ends)
    max_depth: int,
    need_bp: bool = True,
):
    n = val.shape[0]
    c_len = codes.shape[0]
    space_idx = n - 1
    has_parent = parent >= 0
    parent_c = jnp.maximum(parent, 0)

    # Column 0 (the '*' sentinel): only the insertion chain from the root
    # is live (reference: deletion/match need c > 0, and root children get
    # cost via insertion from costs[0, 0] = 0 — spellchecker.py:84-92).
    init_costs = jnp.full((n,), POS_INF).at[0].set(0.0)
    node_dist0 = (codes[0] != val).astype(jnp.float32)
    for _ in range(max_depth):
        i_cost = init_costs[parent_c] + INSERTION_COST + node_dist0
        init_costs = jnp.where(has_parent & (i_cost < init_costs), i_cost, init_costs)

    def col(prev_costs, code):
        node_dist = (code != val).astype(jnp.float32)

        # deletion: stay on the node, consume one input char (the root and
        # the space node have no deletion branch — the reference gives
        # them only loop/space transitions, spellchecker.py:78-100)
        cost = prev_costs + DELETION_COST + node_dist
        cost = cost.at[0].set(POS_INF).at[space_idx].set(POS_INF)
        bp_r = jnp.arange(n, dtype=jnp.int32)
        bp_kind = jnp.full((n,), _MOVE_DEL, jnp.int32)

        # match: from parent, consume one input char (normal nodes only —
        # the reference gives root children no match branch,
        # spellchecker.py:86-92)
        m_cost = prev_costs[parent_c] + MATCH_COST + node_dist
        m_ok = has_parent & ~is_root_child
        better = m_ok & (m_cost < cost)
        cost = jnp.where(better, m_cost, cost)
        bp_r = jnp.where(better, parent_c, bp_r)
        bp_kind = jnp.where(better, _MOVE_MATCH, bp_kind)

        # space node: from any word end, consume one char, cost SPACE_COST
        we_prev = jnp.where(is_word_end, prev_costs, POS_INF)
        best_we = jnp.argmin(we_prev).astype(jnp.int32)
        sp_cost = we_prev[best_we] + SPACE_COST + node_dist[space_idx]
        sp_better = sp_cost < cost[space_idx]
        cost = cost.at[space_idx].set(jnp.where(sp_better, sp_cost, cost[space_idx]))
        bp_r = bp_r.at[space_idx].set(jnp.where(sp_better, best_we, bp_r[space_idx]))
        bp_kind = bp_kind.at[space_idx].set(
            jnp.where(sp_better, _MOVE_LOOP, bp_kind[space_idx])
        )

        # root: loop restart from any word end or the space node
        loop_prev = jnp.where(is_word_end, prev_costs, POS_INF)
        loop_prev = loop_prev.at[space_idx].set(prev_costs[space_idx])
        best_loop = jnp.argmin(loop_prev).astype(jnp.int32)
        lp_cost = loop_prev[best_loop] + LOOP_COST + node_dist[0]
        lp_better = lp_cost < cost[0]
        cost = cost.at[0].set(jnp.where(lp_better, lp_cost, cost[0]))
        bp_r = bp_r.at[0].set(jnp.where(lp_better, best_loop, bp_r[0]))
        bp_kind = bp_kind.at[0].set(jnp.where(lp_better, _MOVE_LOOP, bp_kind[0]))

        # insertion: from parent in the SAME column — bounded depth passes
        for _ in range(max_depth):
            i_cost = cost[parent_c] + INSERTION_COST + node_dist
            better = has_parent & (i_cost < cost)
            cost = jnp.where(better, i_cost, cost)
            bp_r = jnp.where(better, parent_c, bp_r)
            bp_kind = jnp.where(better, _MOVE_INS, bp_kind)

        return cost, ((cost, bp_r, bp_kind) if need_bp else None)

    if not need_bp:  # costs-only (scoring): no [C, N] planes in memory
        final, _ = jax.lax.scan(col, init_costs, codes[1:])
        return final
    _, (costs, bp_r, bp_kind) = jax.lax.scan(col, init_costs, codes[1:])
    return costs, bp_r, bp_kind


# ---------------------------------------------------------------------------
# Batched kernel: depth-level sweep in a state-major [N, B] layout.
#
# The per-string kernel above is the straight vectorization of the
# reference DP: ~(max_depth + 1) dynamic [N] gathers per input char.
# This kernel applies the repo's decoder playbook to text:
#
# * nodes are DEPTH-SORTED so each trie level is a contiguous row
#   slice: the insertion chain (parent -> child, same column) closes
#   exactly in ONE ordered sweep over levels (it is acyclic), instead
#   of max_depth full-width relaxation passes — the epsilon-closure
#   trick from the speech decoder applied to text;
# * batch rides the minor axis ([N, B]), so every gather/update
#   amortizes over B texts;
# * per-level updates are static row-slice writes (concat semantics,
#   no scatter); origins need no [C, N, B] index plane — deletion
#   origin is the node itself, match/insertion origin is the static
#   parent map, and the word-end -> space/root loop origins stream to
#   two tiny [C, B] side planes (the decoder's eps side-plane trick).
#
# Costs are bit-equal to the reference DP (asserted in tests); path
# tie-breaking can differ only between exact-cost ties.
# ---------------------------------------------------------------------------


class _LevelPlan:
    """Host-side depth-sorted arrays for the level-sweep kernel."""

    def __init__(self, tree: LexTree):
        n_real = tree.n_nodes
        depth = np.asarray(tree.depth)
        perm = np.argsort(depth, kind="stable")  # root first
        self.perm = np.concatenate([perm, [n_real]])  # + space node last
        self.inv = np.empty(n_real + 1, np.int64)
        self.inv[self.perm] = np.arange(n_real + 1)
        self.n = n_real + 1
        self.space = n_real  # sorted index of the space node (last row)

        val = np.zeros(self.n, np.int32)
        val[:n_real] = np.asarray(tree.val)[perm]
        val[self.space] = ord(" ")
        par_orig = np.concatenate([np.asarray(tree.parent), [-1]])
        par_sorted = par_orig[self.perm]
        self.parent = np.where(par_sorted >= 0,
                               self.inv[np.maximum(par_sorted, 0)],
                               -1).astype(np.int32)
        self.val = val
        self.is_word_end = np.zeros(self.n, bool)
        self.is_word_end[:n_real] = (np.asarray(tree.prop)[perm] == 2)
        self.is_root_child = self.parent == 0
        d_sorted = np.concatenate([depth[perm], [0]])
        self.max_depth = int(depth.max())
        # level d slice = [off[d], off[d+1]) over the real-node prefix
        self.off = tuple(
            int(np.searchsorted(d_sorted[:n_real], d))
            for d in range(self.max_depth + 2))

    def device_args(self):
        return (jnp.asarray(self.val), jnp.asarray(self.parent),
                jnp.asarray(self.is_root_child),
                jnp.asarray(self.is_word_end))


@functools.partial(jax.jit, static_argnames=("off", "need_bp"))
def _text_viterbi_levels(
    codes,  # [C, B] int32, codes[0] = '*'
    val,  # [N] sorted node codes (space node last)
    parent,  # [N] int32 sorted-coord parents (-1 root/space)
    is_root_child,  # [N] bool
    is_word_end,  # [N] bool
    off,  # tuple level offsets into the real-node prefix
    need_bp: bool = True,
):
    n = val.shape[0]
    b = codes.shape[1]
    space = n - 1
    par_c = jnp.maximum(parent, 0)
    valc = val[:, None]  # [N, 1]
    row = jnp.arange(n)[:, None]
    can_del = (row != 0) & (row != space)
    can_match = ((parent >= 0) & ~is_root_child)[:, None]
    we_col = is_word_end[:, None]
    n_levels = len(off) - 1

    def sweep(cost, dist, kind=None):
        """Exact insertion closure: one ordered pass over levels."""
        for d in range(1, n_levels):
            lo, hi = off[d], off[d + 1]
            if lo >= hi:
                continue
            cand = cost[par_c[lo:hi]] + INSERTION_COST + dist[lo:hi]
            take = cand < cost[lo:hi]
            cost = cost.at[lo:hi].set(jnp.where(take, cand, cost[lo:hi]))
            if kind is not None:
                kind = kind.at[lo:hi].set(
                    jnp.where(take, jnp.int8(_MOVE_INS), kind[lo:hi]))
        return cost, kind

    dist0 = (codes[0][None, :] != valc).astype(jnp.float32)
    init = jnp.full((n, b), POS_INF).at[0, :].set(0.0)
    init, _ = sweep(init, dist0)

    def col(prev, code):
        dist = (code[None, :] != valc).astype(jnp.float32)

        # deletion (root/space have no deletion branch)
        cost = jnp.where(can_del, prev + DELETION_COST + dist, POS_INF)
        kind = jnp.full((n, b), _MOVE_DEL, jnp.int8)

        # match from parent (root children excluded)
        cand = prev[par_c] + MATCH_COST + dist
        take = can_match & (cand < cost)
        cost = jnp.where(take, cand, cost)
        kind = jnp.where(take, jnp.int8(_MOVE_MATCH), kind)

        # space node from the best word end; root from the best of
        # (word ends, space) — loop restart
        we_prev = jnp.where(we_col, prev, POS_INF)
        best_we = jnp.argmin(we_prev, axis=0).astype(jnp.int32)  # [B]
        we_min = jnp.min(we_prev, axis=0)
        sp_cand = we_min + SPACE_COST + dist[space]
        take_sp = sp_cand < cost[space]
        cost = cost.at[space].set(jnp.where(take_sp, sp_cand, cost[space]))
        kind = kind.at[space].set(
            jnp.where(take_sp, jnp.int8(_MOVE_LOOP), kind[space]))

        loop_prev = we_prev.at[space].set(prev[space])
        best_loop = jnp.argmin(loop_prev, axis=0).astype(jnp.int32)
        lp_cand = jnp.min(loop_prev, axis=0) + LOOP_COST + dist[0]
        take_lp = lp_cand < cost[0]
        cost = cost.at[0].set(jnp.where(take_lp, lp_cand, cost[0]))
        kind = kind.at[0].set(
            jnp.where(take_lp, jnp.int8(_MOVE_LOOP), kind[0]))

        cost, kind = sweep(cost, dist, kind)

        # endpoint side plane: each stream reads its OWN last column,
        # so the best (word-end | space) cost/row streams out per column
        end_masked = jnp.where(we_col | (row == space), cost, POS_INF)
        ends_arg = jnp.argmin(end_masked, axis=0).astype(jnp.int32)  # [B]
        ends_min = jnp.min(end_masked, axis=0)
        out = ((ends_min, ends_arg, kind, best_we, best_loop) if need_bp
               else (ends_min,))
        return cost, out

    if need_bp:
        _, (ends_min, ends_arg, kinds, we_src, loop_src) = jax.lax.scan(
            col, init, codes[1:])
        return ends_min, ends_arg, kinds, we_src, loop_src
    _, (ends_min,) = jax.lax.scan(col, init, codes[1:])
    return ends_min


def text_viterbi_batch(texts, tree: LexTree, plan: "_LevelPlan" = None):
    """Batched :func:`text_viterbi`: corrects B texts in one device
    program (costs equal to the per-string reference DP — asserted in
    tests; between exact-cost ties the chosen path may differ).  Texts
    pad to a common length with '*' sentinel columns; each stream's
    endpoint reads its own last real column from the per-column
    end-cost side plane, so pad columns never contribute.

    Returns ``[(best_cost, matched_string), ...]``."""
    if plan is None:
        plan = _LevelPlan(tree)
    lens = [len(t) for t in texts]
    c_max = max(lens) + 1
    codes = np.full((c_max, len(texts)), ord("*"), np.int32)
    for i, t in enumerate(texts):
        codes[1 : 1 + len(t), i] = np.frombuffer(
            t.encode("latin-1"), np.uint8)
    ends_min, ends_arg, kinds, we_src, loop_src = (
        np.asarray(a) for a in _text_viterbi_levels(
            jnp.asarray(codes), *plan.device_args(), off=plan.off))

    parent = plan.parent
    val = plan.val
    out = []
    for i, li in enumerate(lens):
        c = li - 1  # kinds[c] <-> input char c+1 ('*' sentinel at 0)
        r = int(ends_arg[c, i])
        cost = float(ends_min[c, i])
        visited = []
        while c >= 0:
            if r != 0:
                visited.append(r)
            k = int(kinds[c, r, i])
            if k == _MOVE_INS:
                r = int(parent[r])  # same column
            elif k == _MOVE_LOOP:
                r = int(loop_src[c, i]) if r == 0 else int(we_src[c, i])
                c -= 1
            elif k == _MOVE_MATCH:
                r = int(parent[r])
                c -= 1
            else:  # _MOVE_DEL
                c -= 1
        visited.reverse()
        out.append((cost, "".join(chr(val[r]) for r in visited)))
    return out


def _viterbi_path(x: str, tree: LexTree) -> Tuple[float, list, np.ndarray]:
    """Shared DP + backtrace.  Returns ``(best_cost, visited_nodes,
    val)`` where ``visited_nodes`` is the forward-order sequence of trie
    node indices on the best path (insertion hops included, root
    excluded) — exactly the nodes whose chars the reference's backtrace
    concatenates (``spellchecker.py:126-135``)."""
    n = tree.n_nodes + 1  # + synthetic space node (spellchecker.py:37)
    val = np.zeros(n, dtype=np.int32)
    val[:-1] = tree.val
    val[-1] = ord(" ")
    parent = np.full(n, -1, dtype=np.int32)
    parent[: n - 1] = tree.parent
    is_root_child = np.zeros(n, dtype=bool)
    is_root_child[: n - 1] = tree.parent == 0
    is_word_end = np.zeros(n, dtype=bool)
    is_word_end[: n - 1] = tree.prop == 2

    codes = np.frombuffer(("*" + x).encode("latin-1"), dtype=np.uint8).astype(np.int32)

    costs, bp_r, bp_kind = _text_viterbi_device(
        jnp.asarray(codes),
        jnp.asarray(val),
        jnp.asarray(parent),
        jnp.asarray(is_root_child),
        jnp.asarray(is_word_end),
        max_depth=tree.max_depth,
    )
    costs = np.asarray(costs)
    bp_r = np.asarray(bp_r)
    bp_kind = np.asarray(bp_kind)

    # endpoint: best word end (incl. space node) at the last column
    ends = np.concatenate([np.nonzero(is_word_end)[0], [n - 1]])
    last = costs[-1]
    best_end = int(ends[np.argmin(last[ends])])
    best_cost = float(last[best_end])

    # host backtrace (columns are bp rows; column c corresponds to input
    # char c+1 because codes[0] is the '*' sentinel)
    visited = []
    r, c = best_end, len(codes) - 2
    while c >= 0:
        if r != 0:
            visited.append(r)
        kind = bp_kind[c, r]
        r_prev = int(bp_r[c, r])
        if kind == _MOVE_INS:
            r = r_prev  # same column
        else:
            r = r_prev
            c -= 1
    visited.reverse()
    return best_cost, visited, val


def text_viterbi(x: str, tree: LexTree) -> Tuple[float, str]:
    """Best dictionary match for an input string.

    Returns ``(best_cost, matched_string)`` like the reference
    (``spellchecker.py:15-135``) — ``matched_string`` is the
    concatenation of the chars of the trie nodes on the best path
    (bit-identical to the reference, including its quirk that an
    insertion-chain entry shows only the suffix of the first word's
    nodes actually visited: 'aple' -> 'pple' in both).
    """
    cost, visited, val = _viterbi_path(x, tree)
    return cost, "".join(chr(val[r]) for r in visited)


class SpellChecker:
    """Working implementation of the reference's stub
    (``spellchecker.py:138-149``): fit on a dictionary, then correct
    text word-by-word (or as one continuous string via the loop arc)."""

    def __init__(self, beam: int = 0):
        self.beam = beam
        self.tree: LexTree = None

    def fit(self, dictionary) -> "SpellChecker":
        self.tree = lextree_from_words(list(dictionary))
        return self

    def spell_check(self, text: str) -> str:
        """Correct ``text`` to a sequence of complete dictionary words.

        Unlike :func:`text_viterbi` (reference-exact, can emit a word
        *suffix* when the best path enters mid-word via an insertion
        chain), this reconstructs each word from the word-end leaf the
        path crosses — every leaf identifies exactly one dictionary
        word (``lextree.py:42-48``)."""
        if self.tree is None:
            raise ValueError("call fit() first")
        _, visited, _ = _viterbi_path(text, self.tree)
        ends = set(int(e) for e in self.tree.word_ends)
        words, prev = [], -1
        for r in visited:
            if r in ends and r != prev:
                words.append(self.tree.word_of(r))
            prev = r
        return " ".join(words)
