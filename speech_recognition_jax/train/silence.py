"""Optional silence model.

The reference has no silence model: its decoder forces every frame
into digit states, so inter-word and leading/trailing silence is
absorbed by word-edge states (SURVEY.md §1 note; verified to cost real
WER when training audio is endpoint-trimmed but decode audio is not —
see ``.claude/skills/verify/SKILL.md``).  This module adds one as an
extra word in the bank:

* silence frames are harvested from the training wavs themselves — the
  complement of the energy endpointer's speech region;
* silence is acoustically stationary, so a single GMM is fit to the
  pooled frames and replicated across the model's states with
  self-loop-heavy transitions (states exist only so the model can live
  in the fixed-[N, S] bank and satisfy minimum-duration dynamics);
* the decoder includes it in the word loop and drops it from the word
  output (``states_to_words(..., drop_labels={sil})``).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.config import EndpointConfig, HMMConfig, TrainConfig
from speech_recognition_jax.data.endpoint import endpoint_signal
from speech_recognition_jax.models.hmm import GMMHMM
from speech_recognition_jax.train.isolated import fit_gmm_state
from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["harvest_silence_samples", "fit_silence_hmm"]


def harvest_silence_samples(
    wavs: List[np.ndarray], cfg: EndpointConfig = EndpointConfig(), margin_ms: float = 50.0
) -> List[np.ndarray]:
    """Sample regions outside each wav's endpointed speech span."""
    margin = int(margin_ms / 1000 * cfg.sample_rate)
    out = []
    for w in wavs:
        s, e = endpoint_signal(w, cfg)
        if s is None:
            # endpointer found no speech: this is a training utterance
            # that *does* contain speech, so skip it rather than pollute
            # the silence pool with a whole spoken digit
            continue
        lead = np.asarray(w[: max(s - margin, 0)])
        tail = np.asarray(w[e + margin :])
        for seg in (lead, tail):
            if len(seg) >= cfg.samples_per_frame * 5:
                out.append(seg)
    return out


def fit_silence_hmm(
    key,
    silence_frames: np.ndarray,
    n_states: int = 5,
    n_mix: int = 2,
    hmm_cfg: HMMConfig = HMMConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    p_stay: float = 0.9,
) -> GMMHMM:
    """Fit one GMM on pooled silence feature frames and replicate it
    over ``n_states`` states with a self-loop-heavy chain."""
    x = jnp.asarray(silence_frames, jnp.float32)
    mask = jnp.ones((x.shape[0],), bool)
    mu0 = jnp.mean(x, axis=0)
    m, v, w = fit_gmm_state(
        key, x, mask, mu0, n_mix, train_cfg=train_cfg,
        hmm_cfg=HMMConfig(n_states=n_states, n_mix=n_mix,
                          var_floor=hmm_cfg.var_floor),
    )
    means = jnp.tile(m[None], (n_states, 1, 1))
    log_vars = jnp.tile(jnp.log(jnp.maximum(v, hmm_cfg.var_floor))[None], (n_states, 1, 1))
    w = jnp.maximum(w, 1e-8)
    log_w = jnp.tile(jnp.log(w / jnp.sum(w))[None], (n_states, 1))

    trans = np.full((n_states, n_states), POS_INF, dtype=np.float32)
    for i in range(n_states):
        trans[i, i] = -np.log(p_stay)
        if i + 1 < n_states:
            trans[i + 1, i] = -np.log(1.0 - p_stay)
    trans[n_states - 1, n_states - 1] = 0.0
    return GMMHMM(
        means=means.astype(jnp.float32),
        log_vars=log_vars.astype(jnp.float32),
        log_weights=log_w.astype(jnp.float32),
        trans_cost=jnp.asarray(trans),
    )
