"""Isolated-word classification: argmin path cost over the model bank.

Replaces the reference's test loop (``/root/reference/sr/core.py:63-94``:
per file, per model, a full Python Viterbi — 11 x T x 5 ``GMM.evaluate``
calls per utterance) with one batched program: a single emission GEMM
against the whole bank ``[T, D] -> [T, N*S]``, then a vmapped Viterbi
over models, then vmapped again over the utterance batch.  The cost of
one utterance is ``costs[-1, -1]`` per model (``hmm.py:126-135``), and
the decision is the argmin over models (``sr/core.py:80-91``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from speech_recognition_jax.models.hmm import HMMBank, bank_nll
from speech_recognition_jax.utils.numerics import POS_INF
from speech_recognition_jax.ops.viterbi import viterbi

__all__ = ["score_models", "classify_batch"]


@jax.jit
def score_models(bank: HMMBank, feats, n_frames):
    """Path cost of one utterance under every model.

    Args:
      feats: ``[T, D]``; n_frames: true length.
    Returns ``[N]`` costs.
    """
    n, s = bank.n_models, bank.n_states
    t = feats.shape[0]
    frame_mask = jnp.arange(t) < n_frames
    nll = bank_nll(bank, feats, frame_mask)  # [T, N*S]
    nll = nll.reshape(t, n, s).transpose(1, 0, 2)  # [N, T, S]

    init = jnp.full((s,), POS_INF).at[0].set(0.0)

    def one_model(nll_m, trans_m):
        return viterbi(nll_m, trans_m, init, n_frames).final_cost[-1]

    return jax.vmap(one_model)(nll, bank.trans_cost)


@jax.jit
def classify_batch(bank: HMMBank, feats, n_frames):
    """Batched classification.

    Args:
      feats: ``[B, T, D]``; n_frames ``[B]``.
    Returns ``(pred [B], costs [B, N])``.
    """
    costs = jax.vmap(score_models, in_axes=(None, 0, 0))(bank, feats, n_frames)
    return jnp.argmin(costs, axis=1), costs
