"""Deterministic synthetic Aurora-style digit corpus.

The reference's datasets are private (``/root/reference/README.md:6``:
"the dataset is not open source so it is not included"), so train /
decode integration tests and benchmarks run on a reconstructed corpus
(SURVEY.md §4, BASELINE.md): each digit word is rendered as a sequence
of quasi-phoneme segments with digit-specific formant pairs (harmonic
stacks + noise + amplitude envelope), concatenated with silence for
connected-digit strings.  Filenames follow the Aurora convention
(``<SPEAKER>_<digits>A.wav``) so the same regex-driven pipeline code
paths are exercised (``/root/reference/cli.py:27``,
``sr/core.py:114``).

A feature-space sampler (``sample_hmm_features``) draws frames directly
from known GMM-HMM parameters for exact recovery tests of the trainers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from speech_recognition_jax.config import DIGIT_NAMES


@dataclasses.dataclass
class Utterance:
    name: str
    transcript: str
    samples: np.ndarray  # int16
    labels: List[int]


class SyntheticDigits:
    """Seeded generator for digit audio."""

    def __init__(self, seed: int = 0, sample_rate: int = 16000, noise: float = 0.05):
        self.sample_rate = sample_rate
        self.seed = seed
        self.noise = noise  # in-word noise amplitude (signal partials are O(1))
        base = np.random.default_rng(seed)
        # Per (digit, sub-segment) formant targets, fixed per generator:
        # well-separated grid so digits are acoustically distinct.
        self.n_segs = 3
        self.f1 = 250.0 + 55.0 * base.permutation(11)[:, None] + 35.0 * np.arange(self.n_segs)[None, :]
        self.f2 = 900.0 + 140.0 * base.permutation(11)[:, None] + 90.0 * ((np.arange(self.n_segs)[None, :] + 1) % self.n_segs)
        self.f3 = 2200.0 + 120.0 * base.permutation(11)[:, None] + 60.0 * np.arange(self.n_segs)[None, :]

    def _rng(self, *key_parts) -> np.random.Generator:
        # zlib.crc32 is stable across processes (unlike str hash).
        import zlib

        keys = [zlib.crc32(str(k).encode()) for k in key_parts]
        return np.random.default_rng([self.seed, *keys])

    def digit_samples(self, digit: int, rng: np.random.Generator) -> np.ndarray:
        """Render one spoken digit (~0.25-0.45 s)."""
        sr = self.sample_rate
        chunks = []
        for seg in range(self.n_segs):
            dur = rng.uniform(0.07, 0.15)
            n = int(dur * sr)
            t = np.arange(n) / sr
            jitter = rng.uniform(0.97, 1.03)
            sig = (
                1.0 * np.sin(2 * np.pi * self.f1[digit, seg] * jitter * t + rng.uniform(0, 6.28))
                + 0.6 * np.sin(2 * np.pi * self.f2[digit, seg] * jitter * t + rng.uniform(0, 6.28))
                + 0.3 * np.sin(2 * np.pi * self.f3[digit, seg] * jitter * t + rng.uniform(0, 6.28))
                + self.noise * rng.standard_normal(n)
            )
            ramp = min(n // 4, 160)
            env = np.ones(n)
            env[:ramp] = np.linspace(0.3, 1.0, ramp)
            env[-ramp:] = np.linspace(1.0, 0.3, ramp)
            chunks.append(sig * env)
        out = np.concatenate(chunks)
        return out * rng.uniform(0.6, 1.0)

    def silence(self, dur_s: float, rng: np.random.Generator) -> np.ndarray:
        n = int(dur_s * self.sample_rate)
        return 0.004 * rng.standard_normal(n)

    def utterance(self, transcript: str, speaker: str = "AA") -> Utterance:
        """Render a digit string with inter-word silences."""
        from speech_recognition_jax.config import FILENAME_INDEX_MAP

        rng = self._rng("utt", speaker, transcript)
        labels = [FILENAME_INDEX_MAP[c] for c in transcript]
        parts = [self.silence(rng.uniform(0.05, 0.12), rng)]
        for l in labels:
            parts.append(self.digit_samples(l, rng))
            parts.append(self.silence(rng.uniform(0.04, 0.1), rng))
        sig = np.concatenate(parts)
        sig = sig / (np.max(np.abs(sig)) + 1e-9)
        samples = np.round(sig * 12000).astype(np.int16)
        return Utterance(
            name=f"{speaker}_{transcript}A.wav",
            transcript=transcript,
            samples=samples,
            labels=labels,
        )

    def isolated_corpus(self, n_per_digit: int, tag: str = "train") -> List[Utterance]:
        """n_per_digit single-digit utterances for each of the 11 models."""
        utts = []
        for d, name in enumerate(DIGIT_NAMES):
            for i in range(n_per_digit):
                speaker = f"{_speaker(self._rng(tag, name, i))}"
                utts.append(self.utterance(name, speaker=speaker))
        return utts

    def continuous_corpus(
        self, n: int, min_len: int = 2, max_len: int = 7, tag: str = "train",
        markov: float = 0.0,
    ) -> List[Utterance]:
        """``markov`` > 0 makes transcripts follow a sticky +1-cycle
        structure (next digit = prev+1 mod 11 with that probability) so a
        bigram LM has real signal to exploit."""
        utts = []
        for i in range(n):
            rng = self._rng(tag, "cont", i)
            length = int(rng.integers(min_len, max_len + 1))
            digits = [int(rng.integers(0, 11))]
            for _ in range(length - 1):
                if rng.uniform() < markov:
                    digits.append((digits[-1] + 1) % 11)
                else:
                    digits.append(int(rng.integers(0, 11)))
            chars = [DIGIT_NAMES[d] for d in digits]
            speaker = _speaker(rng)
            utts.append(self.utterance("".join(chars), speaker=speaker))
        return utts


def _speaker(rng: np.random.Generator) -> str:
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return "".join(letters[int(rng.integers(0, 26))] for _ in range(2))


# ---------------------------------------------------------------------------
# Feature-space sampling from known GMM-HMM parameters
# ---------------------------------------------------------------------------


def random_gmm_hmm(
    rng: np.random.Generator, n_states=5, n_mix=2, dim=8, sep=4.0
) -> Dict[str, np.ndarray]:
    """A well-separated random GMM-HMM parameter dict (numpy)."""
    means = sep * rng.standard_normal((n_states, n_mix, dim))
    variances = rng.uniform(0.3, 1.0, size=(n_states, n_mix, dim))
    w = rng.uniform(0.5, 1.5, size=(n_states, n_mix))
    w /= w.sum(axis=1, keepdims=True)
    p_stay = rng.uniform(0.5, 0.9, size=n_states)
    trans = np.full((n_states, n_states), np.inf)
    for i in range(n_states):
        if i + 1 < n_states:
            trans[i, i] = -np.log(p_stay[i])
            trans[i + 1, i] = -np.log(1 - p_stay[i])
        else:
            trans[i, i] = 0.0
    return {"means": means, "variances": variances, "weights": w, "trans": trans}


def sample_hmm_features(
    params: Dict[str, np.ndarray], rng: np.random.Generator, min_frames_per_state: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample a frame sequence (and its state alignment) from one model."""
    n_states, n_mix, dim = params["means"].shape
    frames, states = [], []
    for s in range(n_states):
        p_stay = float(np.exp(-params["trans"][s, s])) if s + 1 < n_states else 0.0
        n = min_frames_per_state
        while rng.uniform() < p_stay and n < 50:
            n += 1
        for _ in range(n):
            m = rng.choice(n_mix, p=params["weights"][s])
            frames.append(
                params["means"][s, m]
                + np.sqrt(params["variances"][s, m]) * rng.standard_normal(dim)
            )
            states.append(s)
    return np.asarray(frames), np.asarray(states)
