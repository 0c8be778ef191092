"""MFCC frontend golden tests vs the float64 numpy oracle.

Replaces the reference's visual-only MFCC check
(``/root/reference/tests/test_mfcc.py:6-24``, which plt.show()s two
spectrograms with no asserts) with allclose assertions — the BASELINE.md
MFCC-parity gate.
"""

import numpy as np
import pytest

from speech_recognition_jax.config import FrontendConfig
from speech_recognition_jax.ops.frontend import (
    mfcc,
    mfcc39,
    mfcc39_batch,
    max_frames,
    padded_length,
)
from tests.oracles.frontend_ref import (
    delta_feature_oracle,
    load_wav_as_mfcc_oracle,
    mfcc_psf_oracle,
    mfcc_scratch_oracle,
)

PSF = FrontendConfig()
SCRATCH = FrontendConfig(variant="scratch")  # preemph/low_freq variant defaults


def synth_signal(rng, n, sample_rate=16000):
    """Speech-ish test signal: a few tones + noise, int16 range."""
    t = np.arange(n) / sample_rate
    sig = (
        4000 * np.sin(2 * np.pi * 350 * t)
        + 2500 * np.sin(2 * np.pi * 1200 * t + 0.7)
        + 1000 * np.sin(2 * np.pi * 2400 * t + 1.1)
        + 400 * rng.standard_normal(n)
    )
    env = np.minimum(1.0, np.arange(n) / 800.0) * np.minimum(1.0, (n - np.arange(n)) / 800.0)
    return np.round(sig * env).astype(np.int16)


def _run_padded(cfg, sig, cap_len, dtype=np.float64):
    L = padded_length(cfg, cap_len)
    buf = np.zeros(L, dtype)
    buf[: len(sig)] = sig
    return buf, len(sig)


@pytest.mark.parametrize("n", [7000, 7321, 16000])
def test_psf_mfcc_matches_oracle(rng, n):
    sig = synth_signal(rng, n)
    buf, length = _run_padded(PSF, sig, 16000)
    ceps, nf = mfcc(buf, length, PSF)
    ref = mfcc_psf_oracle(sig)
    assert int(nf) == ref.shape[0]
    np.testing.assert_allclose(np.asarray(ceps)[: ref.shape[0]], ref, rtol=1e-9, atol=1e-9)
    # masked frames are exact zeros
    assert np.all(np.asarray(ceps)[ref.shape[0] :] == 0)


@pytest.mark.parametrize("n", [7000, 9999])
def test_scratch_mfcc_matches_oracle(rng, n):
    sig = synth_signal(rng, n)
    buf, length = _run_padded(SCRATCH, sig, 16000)
    ceps, nf = mfcc(buf, length, SCRATCH)
    ref = mfcc_scratch_oracle(sig)
    assert int(nf) == ref.shape[0]
    np.testing.assert_allclose(np.asarray(ceps)[: ref.shape[0]], ref, rtol=1e-9, atol=1e-9)


def test_full_39dim_path_matches_reference(rng):
    sig = synth_signal(rng, 12000)
    buf, length = _run_padded(PSF, sig, 16000)
    feats, nf = mfcc39(buf, length, PSF)
    ref = load_wav_as_mfcc_oracle(sig)
    assert int(nf) == ref.shape[0]
    np.testing.assert_allclose(np.asarray(feats)[: ref.shape[0]], ref, rtol=1e-8, atol=1e-9)


def test_dft_gemm_equals_fft(rng):
    sig = synth_signal(rng, 8000)
    cfg_fft = FrontendConfig(dft_as_gemm=False)
    buf, length = _run_padded(PSF, sig, 8000)
    a, _ = mfcc(buf, length, PSF)
    b, _ = mfcc(buf, length, cfg_fft)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-9)


def test_staged_fft_matches_ndft(rng):
    """The decimation-in-frequency staged GEMM FFT (dft_stage='staged')
    agrees with the dense NDFT and jnp.fft.rfft to f32 reassociation
    tolerance, on both frontend variants."""
    import dataclasses

    sig = synth_signal(rng, 9000)
    for variant in ("psf", "scratch"):
        base = dataclasses.replace(PSF, variant=variant)
        buf, length = _run_padded(base, sig, 9000)
        a, _ = mfcc(buf, length, base)
        b, _ = mfcc(buf, length, dataclasses.replace(base,
                                                     dft_stage="staged"))
        c, _ = mfcc(buf, length, dataclasses.replace(base,
                                                     dft_as_gemm=False))
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(np.asarray(b), np.asarray(c),
                                   rtol=1e-4, atol=2e-3)


def test_padding_invariance(rng):
    """Extra zero padding beyond padded_length must not change features."""
    sig = synth_signal(rng, 7000)
    buf1, length = _run_padded(PSF, sig, 7000)
    f1, nf1 = mfcc39(buf1, length, PSF)
    buf2 = np.zeros(padded_length(PSF, 20000), np.float32)
    buf2[:7000] = sig
    f2, nf2 = mfcc39(buf2, length, PSF)
    assert int(nf1) == int(nf2)
    # f32 buffers: different padded shapes change matmul reduction order,
    # so allow float32-level slack.
    np.testing.assert_allclose(
        np.asarray(f1)[: int(nf1)], np.asarray(f2)[: int(nf1)], rtol=1e-4, atol=1e-4
    )


def test_max_frames_consistency():
    for n in [400, 401, 7000, 7321]:
        cap = max_frames(PSF, n)
        sig = np.ones(n, np.float32)
        buf = np.zeros(padded_length(PSF, n), np.float32)
        buf[:n] = sig
        _, nf = mfcc(buf, np.int32(n), PSF)
        assert int(nf) <= cap


def test_float32_precision_bounded(rng):
    """Production f32 path stays close to the f64 oracle: standardized
    features are O(1), so an absolute tolerance is meaningful."""
    sig = synth_signal(rng, 12000)
    buf, length = _run_padded(PSF, sig, 16000, dtype=np.float32)
    feats, nf = mfcc39(buf, length, PSF)
    assert feats.dtype == np.float32
    ref = load_wav_as_mfcc_oracle(sig)
    np.testing.assert_allclose(
        np.asarray(feats)[: ref.shape[0]], ref, rtol=0, atol=5e-2
    )


def _batch(rng, lens, cap, dtype):
    sigs = np.zeros((len(lens), padded_length(PSF, cap)), dtype)
    raw = []
    for i, n in enumerate(lens):
        raw.append(synth_signal(rng, n))
        sigs[i, :n] = raw[-1]
    return sigs, np.asarray(lens, np.int32), raw


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-8),
                                        (np.float32, 5e-2)])
def test_batch_varlen_matches_oracle(rng, dtype, atol):
    """The production batched frontend on variable-length utterances vs
    the float64 oracle, per utterance; frames past each length are
    exact zeros.  float32 is held to the f32 bound above."""
    lens = [16000, 7321, 7000, 12345, 9000]
    sigs, lengths, raw = _batch(rng, lens, 16000, dtype)
    feats, nf = mfcc39_batch(sigs, lengths, PSF)
    feats = np.asarray(feats)
    for i, s in enumerate(raw):
        ref = load_wav_as_mfcc_oracle(s)
        assert int(nf[i]) == ref.shape[0]
        np.testing.assert_allclose(feats[i, : ref.shape[0]], ref,
                                   rtol=atol, atol=atol)
        assert np.all(feats[i, ref.shape[0]:] == 0.0)


def test_batch_single_short_frame(rng):
    """length <= frame_len -> exactly one frame (psf framing rule); the
    raw cepstra match the oracle (the reference's delta cannot run on a
    1-frame utterance, so the 39-dim oracle does not apply)."""
    sigs, lengths, raw = _batch(rng, [300], 16000, np.float64)
    feats, nf = mfcc39_batch(sigs, lengths, PSF, norm="none")
    assert int(nf[0]) == 1
    np.testing.assert_allclose(np.asarray(feats)[0, :1, :13],
                               mfcc_psf_oracle(raw[0]), rtol=1e-8, atol=1e-8)


def test_batch_norm_none_raw_deltas(rng):
    """norm='none' returns raw [ceps | delta | delta-delta] (for corpus
    CMVN), each block equal to the oracle's."""
    sigs, lengths, raw = _batch(rng, [8000, 6000], 8000, np.float64)
    feats, nf = mfcc39_batch(sigs, lengths, PSF, norm="none")
    for i, s in enumerate(raw):
        c = mfcc_psf_oracle(s)
        d1 = delta_feature_oracle(c)
        d2 = delta_feature_oracle(d1)
        n = int(nf[i])
        assert n == c.shape[0]
        f = np.asarray(feats)[i, :n]
        for got, want in ((f[:, :13], c), (f[:, 13:26], d1), (f[:, 26:], d2)):
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


def test_batch_equals_per_utterance(rng):
    """mfcc39_batch is mfcc39 applied per row (batched GEMMs may
    reduce in another order: float32 rounding apart)."""
    sigs, lengths, _ = _batch(rng, [8000, 5321, 4000], 8000, np.float32)
    fb, nb = mfcc39_batch(sigs, lengths, PSF)
    for i in range(len(lengths)):
        f1, n1 = mfcc39(sigs[i], lengths[i], PSF)
        assert int(nb[i]) == int(n1)
        np.testing.assert_allclose(np.asarray(fb)[i], np.asarray(f1),
                                   rtol=1e-4, atol=1e-4)
