"""State-sharded decoding: the graph itself distributed over the mesh.

For graphs too large for one chip (big vocabularies, many sausage
slots), the banded Viterbi shards its *state axis* over the mesh's
'model' axis under ``shard_map``.  Per frame each device relaxes its
local frontier chunk and the cross-device structure costs exactly two
small collectives (SURVEY.md §2.2's "collective beam merge at frame
boundaries" made concrete):

* a ``ppermute`` halo of the MAX_BAND (=2) frontier values on the left
  shard edge — the within-word band never spans more than 2 states;
* a ``pmin`` all-reduce of the ``[V]`` word-end values feeding the
  epsilon boundary block — a few hundred bytes regardless of graph
  size.

Backpointers come out as the same int8 packing as the single-device
kernel, reassembled to ``[T, S]`` by the out-sharding, so
``banded_backtrace`` works unchanged.  Sharded output is bit-identical
to :func:`ops.viterbi_banded.viterbi_banded` (asserted in tests on the
8-device virtual mesh).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from speech_recognition_jax.ops.viterbi_banded import (
    _EPS,
    MAX_BAND,
    BandedGraph,
    _eps_u_dtype,
)
from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["pad_banded_for_sharding", "make_sharded_banded_viterbi"]


def pad_banded_for_sharding(g: BandedGraph, n_shards: int) -> Tuple[BandedGraph, int]:
    """Pad the state axis so it divides the shard count; padding states
    are unreachable (POS_INF band/init, not starts)."""
    s = g.band.shape[1]
    s_pad = ((s + n_shards - 1) // n_shards) * n_shards
    pad = s_pad - s
    if pad == 0:
        return g, s
    return (
        BandedGraph(
            band=jnp.pad(g.band, ((0, 0), (0, pad)), constant_values=POS_INF),
            init_cost=jnp.pad(g.init_cost, (0, pad), constant_values=POS_INF),
            word_starts=g.word_starts,
            word_ends=g.word_ends,
            eps_block=g.eps_block,
            start_pos=jnp.pad(g.start_pos, (0, pad)),
            is_start=jnp.pad(g.is_start, (0, pad)),
            end_states=g.end_states,
            end_bonus=g.end_bonus,
            bank_state=jnp.pad(g.bank_state, (0, pad)),
            cross_src=None if g.cross_src is None
            else jnp.pad(g.cross_src, (0, pad)),
            cross_cost=None if g.cross_cost is None
            else jnp.pad(g.cross_cost, (0, pad), constant_values=POS_INF),
        ),
        s,
    )


def make_sharded_banded_viterbi(
    mesh: Mesh, g: BandedGraph, eps_depth: int = 1, axis: str = "model",
    beam_width: int = 0,
):
    """Build a jitted state-sharded Viterbi over the given mesh.

    Returns ``run(nll [T, S_pad], n_frames) -> (final_cost [S_pad],
    bp8 [T, S_pad], eps_u [T, R])`` with the state axis sharded over
    ``axis`` and the small eps side plane replicated.  The graph must
    be padded with :func:`pad_banded_for_sharding`.

    ``beam_width > 0`` applies the *global* rank beam per frame with a
    collective merge: every global top-k cost is in the union of the
    shards' local top-k, so each shard contributes its local top-k
    (``min(k, C)`` values), an ``all_gather`` over the mesh axis (a few
    hundred bytes) yields the exact global k-th best, and local
    frontiers mask against that threshold — bit-identical to the
    single-device ``viterbi_banded(beam_width=k)`` (asserted in tests).
    SURVEY.md §2.2's "collective beam merge at frame boundaries".
    """
    from jax import shard_map

    n = mesh.shape[axis]
    has_cross = g.cross_src is not None
    s_pad = g.band.shape[1]
    assert s_pad % n == 0, "pad the graph first"
    c = s_pad // n
    r_arcs = int(g.word_starts.shape[0])
    u_dtype = _eps_u_dtype(int(g.word_ends.shape[0]))
    perm = [(i, (i + 1) % n) for i in range(n)]

    def kernel(nll_l, band_l, init_l, is_start_l, start_pos_l,
               ends, word_starts, eps_block, n_frames, cross_src_l,
               cross_cost_l):
        d = jax.lax.axis_index(axis)
        offset = d * c

        def cross_relax(base, d_sel, prev):
            """Trie cross edges: sources are arbitrary global states, so
            the frontier is all_gathered once per frame — [S_pad] floats
            over the mesh axis, small next to the ICI budget (the lex
            Pallas kernel owns the single-chip fast path; this kernel
            exists for graphs larger than one chip's HBM)."""
            if not has_cross:
                return base, d_sel
            prev_full = jax.lax.all_gather(prev, axis, tiled=True)  # [S_pad]
            cand = jnp.minimum(prev_full[cross_src_l] + cross_cost_l,
                               POS_INF)
            take = cand <= base
            return (jnp.where(take, cand, base),
                    jnp.where(take, jnp.int8(MAX_BAND + 1), d_sel))

        def eps_pass(cost, emis_l, side):
            # collective word-end gather: local contributions + pmin
            local_pos = ends - offset
            valid = (local_pos >= 0) & (local_pos < c)
            ev = jnp.where(valid, cost[jnp.clip(local_pos, 0, c - 1)], POS_INF)
            end_vals = jax.lax.pmin(ev, axis)  # [L] replicated
            scores = eps_block + end_vals[None, :]
            base = jnp.min(scores, axis=-1)
            origin_u = jnp.argmin(scores, axis=-1).astype(u_dtype)  # replicated
            cand = jnp.minimum(base + _gather_starts(emis_l, cost, end_vals), POS_INF)
            # ^ emis at the start states: handled below via dense gather
            cand_dense = cand[start_pos_l]
            better = is_start_l & (cand_dense < cost)
            cost = jnp.where(better, cand_dense, cost)
            # which arcs improved lives on the shard owning the start
            # state: pmax the local verdicts (a few bytes) so the
            # replicated side plane is bit-identical to the
            # single-device kernel's
            starts = word_starts - offset
            sv = (starts >= 0) & (starts < c)
            br = sv & better[jnp.clip(starts, 0, c - 1)]
            br = jax.lax.pmax(br.astype(jnp.int32), axis) > 0
            side = jnp.where(br, origin_u, side)
            bp_upd = jnp.where(better, jnp.int8(_EPS), jnp.int8(-1))
            return cost, bp_upd, side

        def _gather_starts(emis_l, cost, end_vals):
            # emission at each start state, as a [R] vector: local starts
            # contribute their emission, others POS_INF, then pmin.
            starts = word_starts - offset
            valid = (starts >= 0) & (starts < c)
            e = jnp.where(valid, emis_l[jnp.clip(starts, 0, c - 1)], POS_INF)
            return jax.lax.pmin(e, axis)

        def band_relax(prev):
            halo = jax.lax.ppermute(prev[-MAX_BAND:], axis, perm)
            ext = jnp.concatenate([halo, prev])  # [MAX_BAND + C]
            best = jnp.full((c,), POS_INF)
            d_sel = jnp.zeros((c,), jnp.int8)
            for k in range(MAX_BAND + 1):
                cand = band_l[k] + ext[MAX_BAND - k : MAX_BAND - k + c]
                take = cand <= best
                best = jnp.where(take, cand, best)
                d_sel = jnp.where(take, jnp.int8(k), d_sel)
            return jnp.minimum(best, POS_INF), d_sel

        def column(base, d_sel, emis_l):
            cost = jnp.minimum(base + emis_l, POS_INF)
            bp8 = d_sel
            side = jnp.zeros((r_arcs,), u_dtype)
            for _ in range(eps_depth):
                cost, upd, side = eps_pass(cost, emis_l, side)
                bp8 = jnp.where(upd >= 0, upd, bp8)
            if beam_width:
                # exact global top-k threshold from the union of local
                # top-k contributions (collective beam merge)
                kk = min(beam_width, c)
                local = -jax.lax.top_k(-cost, kk)[0]  # kk smallest costs
                gathered = jax.lax.all_gather(local, axis).reshape(-1)
                thresh = -jax.lax.top_k(-gathered, beam_width)[0][-1]
                cost = jnp.where(cost <= thresh, cost, POS_INF)
            return cost, bp8, side

        cost0, bp0, side0 = column(init_l, jnp.zeros((c,), jnp.int8), nll_l[0])

        def step(carry, inputs):
            prev, final = carry
            t, emis_l = inputs
            base, d_sel = band_relax(prev)
            base, d_sel = cross_relax(base, d_sel, prev)
            cost, bp8, side = column(base, d_sel, emis_l)
            active = t < n_frames
            cost = jnp.where(active, cost, prev)
            final = jnp.where(t == n_frames - 1, cost, final)
            return (cost, final), (bp8, side)

        t_len = nll_l.shape[0]
        ts = jnp.arange(1, t_len)
        init_final = jnp.where(n_frames == 1, cost0, POS_INF)
        (_, final), (bps, sides) = jax.lax.scan(
            step, (cost0, init_final), (ts, nll_l[1:]))
        bp8 = jnp.concatenate([bp0[None], bps], axis=0)
        eps_u = jnp.concatenate([side0[None], sides], axis=0)
        return final, bp8, eps_u

    sm = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            P(None, axis),  # nll [T, S]
            P(None, axis),  # band [3, S]
            P(axis),  # init [S]
            P(axis),  # is_start
            P(axis),  # start_pos
            P(),  # word ends (replicated)
            P(),  # word starts (replicated)
            P(),  # eps block (replicated)
            P(),  # n_frames
            P(axis),  # cross_src [S]
            P(axis),  # cross_cost [S]
        ),
        out_specs=(P(axis), P(None, axis), P(None, None)),
        check_vma=False,
    )

    if has_cross:
        cross_src, cross_cost = g.cross_src, g.cross_cost
    else:  # dummies with the right sharded shape
        cross_src = jnp.zeros((s_pad,), jnp.int32)
        cross_cost = jnp.full((s_pad,), POS_INF, jnp.float32)

    @jax.jit
    def run(nll, n_frames):
        return sm(nll, g.band, g.init_cost, g.is_start, g.start_pos,
                  g.word_ends, g.word_starts, g.eps_block,
                  jnp.int32(n_frames), cross_src, cross_cost)

    return run
