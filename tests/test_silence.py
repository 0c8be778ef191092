"""Silence model: recovers the WER lost to train/decode endpointing
mismatch (the finding from the round-1 verification drive)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_jax.config import FrontendConfig, HMMConfig, TrainConfig
from speech_recognition_jax.data.endpoint import endpoint_signal
from speech_recognition_jax.data.synthetic import SyntheticDigits
from speech_recognition_jax.decode.connected import decode_connected
from speech_recognition_jax.models.graph import build_loop_graph
from speech_recognition_jax.models.hmm import HMMBank
from speech_recognition_jax.ops.frontend import apply_cmvn, cmvn_stats, mfcc39, padded_length
from speech_recognition_jax.train.isolated import fit_hmm
from speech_recognition_jax.train.silence import (
    fit_silence_hmm,
    harvest_silence_samples,
)
from speech_recognition_jax.utils.metrics import wer


def test_silence_model_recovers_endpoint_mismatch():
    cfg = FrontendConfig()
    gen = SyntheticDigits(seed=21)
    hmm_cfg = HMMConfig(n_mix=2)
    train_cfg = TrainConfig()
    L = padded_length(cfg, 60000)

    def feat_raw(sig):
        buf = np.zeros(L, np.float32)
        buf[: len(sig)] = sig
        f, nf = mfcc39(buf, np.int32(len(sig)), cfg, norm="none")
        return np.asarray(f), int(nf)

    # train on ENDPOINT-TRIMMED isolated audio (the mismatch scenario),
    # with corpus-level CMVN so normalization is consistent across the
    # trim mismatch (per-utterance z-norm would itself be distorted)
    train = gen.isolated_corpus(6, tag="train")
    raw = []
    for u in train:
        s, e = endpoint_signal(u.samples)
        sig = u.samples[s:e] if s is not None else u.samples
        raw.append(feat_raw(sig))
    tmax_tr = max(nf for _, nf in raw)
    fb_tr = np.zeros((len(raw), tmax_tr, 39), np.float32)
    for i, (f, nf) in enumerate(raw):
        fb_tr[i, :nf] = f[:nf]
    n_tr = np.asarray([nf for _, nf in raw], np.int32)
    gmean, gstd = cmvn_stats(fb_tr, n_tr)
    fb_tr = np.asarray(apply_cmvn(fb_tr, n_tr, gmean, gstd))

    by_digit = {d: [] for d in range(11)}
    for i, u in enumerate(train):
        by_digit[u.labels[0]].append(fb_tr[i, : n_tr[i]].astype(np.float64))
    models = [
        fit_hmm(jax.random.PRNGKey(d), by_digit[d], hmm_cfg=hmm_cfg,
                train_cfg=train_cfg)
        for d in range(11)
    ]

    # silence model from the trimmed-away regions of the same wavs
    sil_samples = harvest_silence_samples([u.samples for u in train])
    sil_frames = []
    for seg in sil_samples:
        f, nf = feat_raw(seg)
        sil_frames.append(np.asarray(apply_cmvn(f, np.int32(nf), gmean, gstd))[:nf])
    sil_frames = np.concatenate(sil_frames)
    sil = fit_silence_hmm(jax.random.PRNGKey(99), sil_frames,
                          n_states=hmm_cfg.n_states, n_mix=2, hmm_cfg=hmm_cfg)

    bank11 = HMMBank.stack(models)
    bank12 = HMMBank.stack(models + [sil])
    SIL = 11

    # decode RAW (untrimmed) connected audio
    test = gen.continuous_corpus(12, min_len=2, max_len=4, tag="ctest")
    feats, lens, refs = [], [], []
    for u in test:
        f, nf = feat_raw(u.samples)
        feats.append(np.asarray(apply_cmvn(f, np.int32(nf), gmean, gstd)))
        lens.append(nf)
        refs.append(u.labels)
    tmax = max(lens)
    fb = np.zeros((len(test), tmax, 39), np.float32)
    for i in range(len(test)):
        fb[i, : lens[i]] = feats[i][: lens[i]]
    nb = np.asarray(lens, np.int32)

    trans11 = [np.asarray(bank11.trans_cost[i]) for i in range(11)]
    g_plain = build_loop_graph(trans11)
    hyp_plain, _ = decode_connected(bank11, g_plain, fb, nb)

    trans12 = [np.asarray(bank12.trans_cost[i]) for i in range(12)]
    g_sil = build_loop_graph(trans12)
    hyp_sil, _ = decode_connected(bank12, g_sil, fb, nb, drop_labels={SIL})

    wer_plain = wer(hyp_plain, refs)
    wer_sil = wer(hyp_sil, refs)
    assert wer_sil <= wer_plain, (wer_plain, wer_sil)
    assert wer_sil <= 0.15, f"with silence model: WER {wer_sil} (plain {wer_plain})"
