"""Classical-ASR framework in JAX.

A JAX/XLA implementation with the capabilities of the
reference repo ``tjysdsg/speech-recognition`` (pure-numpy GMM-HMM digit
recognizer): MFCC frontend, diagonal-GMM acoustic models, segmental
K-means / EM training, Viterbi & DTW decoding (isolated and connected),
lexical-tree language modelling and spell checking — re-designed
array-first for an accelerator (static shapes, ``lax.scan`` DP, min-plus
relaxation, mesh sharding for scale-out).

Layer map (mirrors reference layers, see SURVEY.md §1):
  config        — typed configuration           (ref: config.py, cli.py flags)
  ops           — compute kernels: frontend, GMM log-lik, DP scans
  models        — flat-array model params + graph composition
  train         — segmental K-means, mixture splitting, EM, embedded training
  decode        — isolated / connected / beam decoders
  langmodel     — lexical tree, bigram LM, text Viterbi spell checker
  data          — wav IO, Aurora filename parsing, synthetic corpus, endpointing
  parallel      — device mesh, shardings, collectives for EM stats & beam merge
  utils         — numerics, metrics (WER), checkpointing, profiling
"""

__version__ = "0.1.0"

from speech_recognition_jax.config import (
    DIGIT_NAMES,
    FILENAME_INDEX_MAP,
    FrontendConfig,
    HMMConfig,
    TrainConfig,
    DecodeConfig,
    EndpointConfig,
)
