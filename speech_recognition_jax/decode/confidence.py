"""Word-level confidence from forward-backward posteriors.

A serving feature the reference has no analog for: the banded
forward-backward pass (``ops.forward_backward.forward_backward_banded``
— O(3S)/frame, cross-arc capable) yields per-frame state posteriors
``gamma`` over the DECODING graph; the confidence of a decoded word is
the mean posterior of the Viterbi path's states across the word's
frame segment — the classical frame-posterior confidence measure.
Well-separated decodes score near 1; competing hypotheses pull the
posterior mass apart and the score drops, so downstream consumers can
threshold or re-ask.

Everything device-side except the final per-word averaging (one small
[B, T] fetch shared with word recovery).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.hmm import HMMBank, bank_nll
from speech_recognition_jax.ops.forward_backward import forward_backward_banded
from speech_recognition_jax.ops.viterbi_banded import BandedGraph

__all__ = ["path_posteriors", "word_confidence"]


def path_posteriors(bank: HMMBank, g: BandedGraph, feats, n_frames, states,
                    eps_depth: int = 1):
    """Per-frame posterior of the decoded state path.

    ``feats [B, T, D]``, ``states [B, T]`` (the Viterbi path) ->
    ``[B, T]`` with ``gamma[t, states[t]]`` for valid frames, 0 beyond.
    """
    b, t, d = feats.shape
    ends = jnp.asarray(g.end_states)
    end_scores = jnp.full((g.init_cost.shape[0],), -jnp.inf).at[ends].set(0.0)

    def one(x, nf, path):
        nll = bank_nll(bank, x, jnp.arange(t) < nf)[:, g.bank_state]
        res = forward_backward_banded(nll, g, nf, eps_depth=eps_depth,
                                      end_scores=end_scores)
        p = jnp.take_along_axis(res.gamma, path[:, None], axis=1)[:, 0]
        # fp epsilon can push exp(alpha+beta-logZ) a hair past 1
        return jnp.where(jnp.arange(t) < nf, jnp.clip(p, 0.0, 1.0), 0.0)

    return jax.vmap(one)(feats, jnp.asarray(n_frames),
                         jnp.asarray(states, jnp.int32))


def word_confidence(graph, states: np.ndarray, eps_flags: np.ndarray,
                    post: np.ndarray, n_frames: int) -> List[Tuple[int, float]]:
    """Split the path into word segments (same boundary rule as
    ``states_to_words``) and average the frame posterior per word.

    Returns ``[(word_id, confidence), ...]``."""
    slots = np.asarray(graph.slot)[np.asarray(states)[:n_frames]]
    post = np.asarray(post)[:n_frames]
    out: List[Tuple[int, float]] = []
    seg_start, prev = 0, -1
    for t, s in enumerate(slots):
        boundary = s != prev or (eps_flags is not None and t > 0
                                 and eps_flags[t])
        if boundary:
            if t > seg_start:
                out[-1] = (out[-1][0], float(post[seg_start:t].mean()))
            out.append((int(np.asarray(graph.slot_label)[s]), 0.0))
            seg_start = t
            prev = s
    if out:
        out[-1] = (out[-1][0], float(post[seg_start:n_frames].mean()))
    return out
