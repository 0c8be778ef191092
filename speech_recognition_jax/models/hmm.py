"""Flat-array GMM-HMM model parameters.

The reference's object graph — ``HMM`` holding a list of ``GMM`` state
objects, each holding ``MultivariateNormal`` objects, identity via uuids
(``/root/reference/sr/recognition/hmm.py:8``, ``hmm_state.py:61-68``) —
becomes parameter pytrees with identity by index (SURVEY.md §7
architecture note):

  ``GMMHMM``  — one word model: means [S, M, D], log_vars [S, M, D],
                log_weights [S, M], trans_cost [S, S] (T[to, from],
                POS_INF where absent; diagonal/forward/skip structure
                from segmental K-means).
  ``HMMBank`` — all word models stacked on a leading model axis, the
                unit the emission GEMM consumes and the unit sharded
                over the 'model' mesh axis at scale.

Everything is a valid JAX pytree, so banks ride through jit/vmap/pjit
and checkpoint as plain arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.ops.gmm import gmm_emission_weights, gmm_neg_log_lik
from speech_recognition_jax.utils.numerics import POS_INF


class GMMHMM(NamedTuple):
    """One left-to-right word HMM with diagonal-GMM emissions."""

    means: jnp.ndarray  # [S, M, D]
    log_vars: jnp.ndarray  # [S, M, D]
    log_weights: jnp.ndarray  # [S, M]
    trans_cost: jnp.ndarray  # [S, S]  T[to, from]

    @property
    def n_states(self) -> int:
        return self.means.shape[0]

    @property
    def n_mix(self) -> int:
        return self.means.shape[1]

    @property
    def feature_dim(self) -> int:
        return self.means.shape[2]


class HMMBank(NamedTuple):
    """A stack of word models: every field gains a leading [N] axis."""

    means: jnp.ndarray  # [N, S, M, D]
    log_vars: jnp.ndarray  # [N, S, M, D]
    log_weights: jnp.ndarray  # [N, S, M]
    trans_cost: jnp.ndarray  # [N, S, S]

    @property
    def n_models(self) -> int:
        return self.means.shape[0]

    @property
    def n_states(self) -> int:
        return self.means.shape[1]

    @property
    def n_mix(self) -> int:
        return self.means.shape[2]

    @property
    def feature_dim(self) -> int:
        return self.means.shape[3]

    @classmethod
    def stack(cls, models) -> "HMMBank":
        return cls(*[jnp.stack([getattr(m, f) for m in models]) for f in GMMHMM._fields])

    def model(self, i: int) -> GMMHMM:
        return GMMHMM(*[f[i] for f in self])

    def flat_states(self):
        """Collapse (model, state) -> bank-state axis [N*S, ...]."""
        n, s, m, d = self.means.shape
        return (
            self.means.reshape(n * s, m, d),
            self.log_vars.reshape(n * s, m, d),
            self.log_weights.reshape(n * s, m),
        )


def bank_nll(bank: HMMBank, x, frame_mask=None):
    """Emission costs of every frame against every (model, state) in the
    bank — one GEMM: ``[T, D] -> [T, N*S]``.

    This is the batched replacement for the reference's per-frame
    ``GMM.evaluate`` calls (T x S x N of them per utterance,
    ``/root/reference/sr/recognition/decode.py:100,123``).
    """
    means, log_vars, log_weights = bank.flat_states()
    w, lw = gmm_emission_weights(means, log_vars, log_weights)
    return gmm_neg_log_lik(x, w, lw, frame_mask)


def uniform_left_to_right_trans(n_states: int, self_loop_cost: float = 0.6931472,
                                step_cost: float = 0.6931472) -> np.ndarray:
    """A generic initial left-to-right transition matrix (-log 0.5 each),
    used before segmental K-means estimates real costs."""
    t = np.full((n_states, n_states), POS_INF, dtype=np.float32)
    for i in range(n_states):
        t[i, i] = self_loop_cost
        if i + 1 < n_states:
            t[i + 1, i] = step_cost
    t[n_states - 1, n_states - 1] = 0.0  # final state absorbs (p_stay -> 1)
    return t


def linear_init_cost(n_states: int) -> np.ndarray:
    """Entry in state 0 only — reference isolated-decode initialization
    (``decode.py:97-101``: only (0, 0) is seeded)."""
    init = np.full((n_states,), POS_INF, dtype=np.float32)
    init[0] = 0.0
    return init
