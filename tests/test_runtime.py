"""Native C++ wav loader: build, parity with scipy, threading."""

import os
import time

import numpy as np
import pytest

from speech_recognition_jax.data.synthetic import SyntheticDigits
from speech_recognition_jax.data.wav import write_wav
from speech_recognition_jax.runtime.loader import load_wav_batch, native_available


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    gen = SyntheticDigits(seed=1)
    utts = gen.isolated_corpus(2, tag="rt") + gen.continuous_corpus(4, tag="rt")
    paths = []
    for u in utts:
        p = os.path.join(d, u.name)
        write_wav(p, u.samples)
        paths.append(p)
    return paths


def test_native_builds():
    assert native_available(), "g++ build of the native loader failed"


def test_batch_matches_scipy(wav_dir):
    from scipy.io import wavfile

    cap = 60000
    out, lengths, rates = load_wav_batch(wav_dir, cap)
    assert out.shape == (len(wav_dir), cap)
    for i, p in enumerate(wav_dir):
        rate, sig = wavfile.read(p)
        assert rates[i] == rate
        assert lengths[i] == min(len(sig), cap)
        np.testing.assert_array_equal(out[i, : lengths[i]], sig[: lengths[i]].astype(np.float32))
        assert np.all(out[i, lengths[i] :] == 0)


def test_truncation(wav_dir):
    out, lengths, _ = load_wav_batch(wav_dir[:1], 1000)
    assert lengths[0] == 1000
    assert out.shape == (1, 1000)


def test_bad_file_raises(tmp_path):
    bad = os.path.join(tmp_path, "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav file at all")
    if native_available():
        with pytest.raises(IOError):
            load_wav_batch([bad], 1000)


def test_multithreaded_same_result(wav_dir):
    a = load_wav_batch(wav_dir, 30000, n_threads=1)
    b = load_wav_batch(wav_dir, 30000, n_threads=8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_prefetch_batches_match_single_batch(tmp_path):
    """PrefetchWavBatches (lookahead thread) == one monolithic
    load_wav_batch, chunk for chunk."""
    from speech_recognition_jax.data.wav import write_wav
    from speech_recognition_jax.runtime.loader import PrefetchWavBatches

    rng = np.random.default_rng(4)
    paths = []
    for i in range(11):
        sig = (rng.standard_normal(int(rng.integers(100, 900)))
               * 3000).astype(np.int16)
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), sig, 8000)
        paths.append(str(p))

    cap = 1024
    whole, wl, wr = load_wav_batch(paths, cap)
    got_paths = []
    i = 0
    for chunk, samples, lengths, rates in PrefetchWavBatches(paths, 4, cap):
        got_paths.extend(chunk)
        n = len(chunk)
        np.testing.assert_array_equal(samples, whole[i : i + n])
        np.testing.assert_array_equal(lengths, wl[i : i + n])
        np.testing.assert_array_equal(rates, wr[i : i + n])
        i += n
    assert got_paths == paths


def test_cli_featurize_prefetch_chunks_match_monolithic(tmp_path):
    """_featurize_files through the prefetching chunked pipeline ==
    the single-batch path (features and lengths identical)."""
    from speech_recognition_jax.cli import _featurize_files
    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.data.synthetic import SyntheticDigits
    from speech_recognition_jax.data.wav import write_wav

    gen = SyntheticDigits(seed=6)
    paths = []
    for i, u in enumerate(gen.isolated_corpus(1)[:9]):
        p = tmp_path / f"{i}_{u.name}"
        write_wav(str(p), u.samples, 16000)
        paths.append(str(p))

    cfg = FrontendConfig()
    cap = max(os.path.getsize(p) for p in paths)  # generous cap
    f1, l1 = _featurize_files(paths, cfg, cap, chunk=10 ** 9)
    f2, l2 = _featurize_files(paths, cfg, cap, chunk=4)
    assert l1 == l2
    for a, b in zip(f1, f2):
        np.testing.assert_array_equal(a, b)
