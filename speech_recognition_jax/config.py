"""Typed configuration.

Replaces the reference's constants module + argparse + call-site
hyperparameters (``/root/reference/config.py:2-17``,
``/root/reference/cli.py:6-19``, hard-coded ``n_segs=5`` at
``cli.py:29``, ``n_gaussians=4`` at ``sr/core.py:53``, 7 decode slots at
``main.py:35``) with frozen dataclasses that are hashable, so they can be
passed as static arguments to jitted functions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The 11 digit models: '1'..'9' plus two pronunciations of zero
# ("oh" = O and "zero" = Z).  Reference: /root/reference/config.py:3.
DIGIT_NAMES: Tuple[str, ...] = ("1", "2", "3", "4", "5", "6", "7", "8", "9", "O", "Z")

# Aurora filename transcript character -> model index.
# Reference: /root/reference/config.py:5-17.
FILENAME_INDEX_MAP = {
    "1": 0, "2": 1, "3": 2, "4": 3, "5": 4, "6": 5, "7": 6, "8": 7, "9": 8,
    "O": 9, "Z": 10,
}

# Spoken words for each digit model — used by the lexical-tree decoder and
# the bigram LM (the reference's empty sr/langmodel/langmodel.py:1 north
# star).  "O" and "Z" are the two zero variants.
DIGIT_WORDS: Tuple[str, ...] = (
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "oh", "zero",
)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """MFCC frontend parameters.

    Defaults reproduce the reference's *production* feature path —
    ``python_speech_features.mfcc(nfilt=40, preemph=0.95,
    appendEnergy=False, winfunc=np.hamming)`` at
    ``/root/reference/sr/core.py:40`` — which keeps cepstral coefficient
    c0 and applies a sinusoidal lifter (psf defaults numcep=13,
    ceplifter=22, lowfreq=0, highfreq=Nyquist, nfft=512 for 16 kHz).

    ``variant='scratch'`` instead reproduces the from-scratch path
    (``/root/reference/sr/feature/feature.py:43-83``): preemph 0.97,
    centre-zero-padded 512-sample frames with a 512-point Hamming window,
    low_freq 80 Hz, log10 filterbanks, DCT coefficients 1..13 (drops c0),
    no lifter.
    """

    sample_rate: int = 16000
    frame_len_s: float = 0.025
    frame_step_s: float = 0.01
    n_fft: int = 512
    n_mels: int = 40
    n_ceps: int = 13
    # None -> variant default (0.95 for 'psf', 0.97 for 'scratch')
    preemph: Optional[float] = None
    low_freq: float = 0.0
    high_freq: Optional[float] = None  # None -> Nyquist
    cep_lifter: int = 22
    variant: str = "psf"  # 'psf' (production) | 'scratch'
    # Use the GEMM-native DFT (two matmuls) instead of jnp.fft.rfft.
    # Identical results up to float rounding.
    dft_as_gemm: bool = True
    # GEMM DFT factorization: 'ndft' = one dense [frame_len, 2*bins]
    # basis GEMM; 'staged' = a radix-4 decimation-in-frequency split
    # into three GEMMs that each contract over n_fft/4 (about half the
    # NDFT's MACs, with a shallower accumulation chain).
    dft_stage: str = "ndft"
    # Matmul precision for the spectral chain (DFT/mel/DCT GEMMs):
    # 'highest' is true float32; 'high' and 'default' let the backend
    # use fewer-bit passes (TF32 or bf16 on the GPU), which the log
    # stage amplifies on quiet mel channels.
    spectral_precision: str = "highest"
    # Per-stage overrides ('' = inherit spectral_precision).
    dft_precision: str = ""
    mel_precision: str = ""
    dct_precision: str = ""

    @property
    def effective_preemph(self) -> float:
        if self.preemph is not None:
            return self.preemph
        return 0.97 if self.variant == "scratch" else 0.95

    @property
    def frame_len(self) -> int:
        return int(round(self.frame_len_s * self.sample_rate))

    @property
    def frame_step(self) -> int:
        return int(round(self.frame_step_s * self.sample_rate))

    @property
    def feature_dim(self) -> int:
        """Output dim after [mfcc, delta, delta-delta] stacking."""
        return 3 * self.n_ceps


@dataclasses.dataclass(frozen=True)
class HMMConfig:
    """Acoustic-model topology.

    Reference: 5-state left-to-right word HMMs (``n_segs=5``,
    ``/root/reference/cli.py:29``) with 4-mixture diagonal GMM emissions
    (``n_gaussians=4``, ``/root/reference/sr/core.py:53``).

    ``ref_compat_splits``: the reference computes the number of binary
    mixture splits as ``int(np.log(n_gaussians))`` — natural log, so
    "4 gaussians" trains only 2 components while evaluation sums over 4
    never-updated extras (quirk SURVEY.md §2.5-1;
    ``/root/reference/sr/recognition/hmm.py:104``).  We default to the
    intended ``log2`` behaviour; set True to replicate the quirk.
    """

    n_states: int = 5
    n_mix: int = 4
    feature_dim: int = 39
    ref_compat_splits: bool = False
    var_floor: float = 1e-2

    @property
    def n_splits(self) -> int:
        import math

        if self.ref_compat_splits:
            return int(math.log(self.n_mix))
        return int(math.log2(self.n_mix))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop parameters.

    Reference defaults: skmeans max 1000 iters
    (``/root/reference/sr/recognition/kmeans.py:111``), k-means max 1000
    (``kmeans.py:167``), EM max 10000 (``hmm_state.py:122``), continuous
    max 1000 (``continuous_speech.py:58``), mixture-split perturbation
    ±10% (``hmm.py:109-111``).
    """

    skmeans_max_iters: int = 100
    kmeans_max_iters: int = 100
    em_max_iters: int = 100
    continuous_max_iters: int = 20
    split_perturbation: float = 0.1
    max_jump_dist: int = 2  # transition skip distance, kmeans.py:53
    seed: int = 0
    # convergence tolerances (reference uses np.allclose defaults)
    rtol: float = 1e-5
    atol: float = 1e-8


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoder parameters.

    ``n_slots`` is only used by the reference-parity fixed-slot sausage
    decoder (``/root/reference/main.py:35`` hard-codes 7); the lextree
    beam decoder handles variable-length strings natively.
    """

    n_slots: int = 7
    beam_width: int = 0  # 0 -> no pruning (reference default np.inf, decode.py:7)
    word_insertion_cost: float = 0.0
    lm_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class EndpointConfig:
    """Energy-based endpointing, same algorithm as the reference's
    streaming recorder (``/root/reference/sr/audio_capture/record.py:57-74``)
    recast as a pure function over sample arrays.

    Time-valued fields are in the same units as the reference config
    dict: seconds for frame geometry, milliseconds for the thresholds.
    """

    sample_rate: int = 16000
    frame_time_s: float = 0.02
    frame_stride_s: float = 0.01
    forget_factor: float = 1.0
    adjustment: float = 0.01
    onset_threshold_db: float = 3.0
    offset_threshold_db: float = 0.2
    silence_threshold_ms: float = 500.0
    speech_threshold_ms: float = 250.0
    start_boundary_ms: float = 200.0
    end_boundary_ms: float = 0.0

    @property
    def samples_per_frame(self) -> int:
        return int(self.frame_time_s * self.sample_rate)

    @property
    def frame_stride(self) -> int:
        return int(self.frame_stride_s * self.sample_rate)
