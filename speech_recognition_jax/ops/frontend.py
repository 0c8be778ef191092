"""MFCC feature frontend.

Replaces the reference's two feature paths with batched, statically
shaped JAX — every stage is a GEMM or a fused elementwise op, so the
whole chain (framing -> window -> DFT -> mel -> log -> DCT -> lifter ->
deltas -> standardize) runs on the device with no host round-trips:

* ``variant='psf'`` — the production path: semantics of
  ``python_speech_features.mfcc(nfilt=40, preemph=0.95,
  appendEnergy=False, winfunc=np.hamming)`` exactly as invoked at
  ``/root/reference/sr/core.py:34-45`` (13 ceps *including* c0,
  sinusoidal lifter L=22, natural-log filterbanks, lowfreq 0).
* ``variant='scratch'`` — the reference's from-scratch implementation
  ``/root/reference/sr/feature/feature.py:43-83`` (preemph 0.97, frame
  count ``ceil(len/160)``, centre-zero-pad to 512 then a 512-point
  Hamming window, lowfreq 80, log10 filterbanks, ceps 1..13, no lifter).

The DFT is computed as two real matmuls against precomputed
cos/sin bases ([frame_len, n_fft//2+1]) — the GEMM-native NDFT
formulation.  ``jnp.fft.rfft`` remains available behind
``dft_as_gemm=False``; which of the two is faster on the GPU is not
measured yet.

Variable-length utterances are handled with static max shapes plus
frame masks; masked frames are exact zeros and never contribute to the
per-utterance standardization (``/root/reference/sr/feature/feature.py:85-88``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.config import FrontendConfig


_PREC = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def _spectral_precision(cfg: FrontendConfig, stage: str = ""):
    """Matmul precision for the DFT/mel/DCT chain, per stage.

    The error a reduced precision causes is stage-dependent (the power
    spectrum spans ~10 decades into the mel sum, and log amplifies
    floor-level bins), so each GEMM gets its own dial:
    ``dft_precision`` / ``mel_precision`` / ``dct_precision`` override
    ``spectral_precision`` when set."""
    name = getattr(cfg, f"{stage}_precision", "") if stage else ""
    if not name:
        name = getattr(cfg, "spectral_precision", "highest")
    return _PREC[name]

__all__ = [
    "padded_length",
    "max_frames",
    "mfcc",
    "mfcc39",
    "mfcc39_batch",
    "delta_feature",
    "standardize",
    "cmvn_stats",
    "apply_cmvn",
]


# ---------------------------------------------------------------------------
# Host-side constant builders (numpy float64, cached per config)
# ---------------------------------------------------------------------------


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def _mel_filterbank(
    n_mels: int, n_fft: int, sample_rate: int, low_freq: float, high_freq: float
) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1] with integral bin
    boundaries, matching both reference implementations
    (``/root/reference/sr/feature/feature.py:58-76`` and psf
    ``get_filterbanks``): bins are ``floor((n_fft+1) * hz / rate)`` and the
    triangles are evaluated at integer FFT bins against the *floored*
    boundary values."""
    low_mel, high_mel = _hz2mel(low_freq), _hz2mel(high_freq)
    mel_points = np.linspace(low_mel, high_mel, n_mels + 2)
    hz_points = _mel2hz(mel_points)
    bins = np.floor((n_fft + 1) * hz_points / sample_rate)

    fbank = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    for m in range(1, n_mels + 1):
        f_lo, f_c, f_hi = int(bins[m - 1]), int(bins[m]), int(bins[m + 1])
        for k in range(f_lo, f_c):
            fbank[m - 1, k] = (k - bins[m - 1]) / (bins[m] - bins[m - 1])
        for k in range(f_c, f_hi):
            fbank[m - 1, k] = (bins[m + 1] - k) / (bins[m + 1] - bins[m])
    return fbank


def _dct2_ortho_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] matrix computing scipy ``dct(x, type=2, norm='ortho')``
    truncated to the first ``n_out`` coefficients, as a right-multiply."""
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    basis = 2.0 * np.cos(np.pi * k[None, :] * (2.0 * n[:, None] + 1.0) / (2.0 * n_in))
    scale = np.where(k == 0, np.sqrt(1.0 / (4.0 * n_in)), np.sqrt(1.0 / (2.0 * n_in)))
    return basis * scale[None, :]


def _dft_power_bases(window: np.ndarray, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin DFT bases with the analysis window folded in.

    Returns ``(C, S)`` each ``[frame_len, n_fft//2+1]`` such that for a
    frame ``f`` (un-windowed), ``re = f @ C`` and ``im = f @ S`` satisfy
    ``re**2 + im**2 == |rfft(f * window, n_fft)|**2``.
    """
    frame_len = window.shape[0]
    n_bins = n_fft // 2 + 1
    n = np.arange(frame_len, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(n, k) / n_fft
    c = np.cos(phase) * window[:, None]
    s = np.sin(phase) * window[:, None]
    return c, s


@functools.lru_cache(maxsize=8)
def _frontend_constants(cfg: FrontendConfig):
    """All constant matrices for one config, as float32 numpy arrays."""
    rate = cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq is not None else rate / 2.0
    if cfg.variant == "psf":
        window = np.hamming(cfg.frame_len)
        fbank = _mel_filterbank(cfg.n_mels, cfg.n_fft, rate, cfg.low_freq, high)
        lift_n = np.arange(cfg.n_ceps, dtype=np.float64)
        lifter = (
            1.0 + (cfg.cep_lifter / 2.0) * np.sin(np.pi * lift_n / cfg.cep_lifter)
            if cfg.cep_lifter > 0
            else np.ones(cfg.n_ceps)
        )
        dct_m = _dct2_ortho_matrix(cfg.n_mels, cfg.n_ceps)
    elif cfg.variant == "scratch":
        # The scratch path centre-zero-pads 400-sample frames to 512 and
        # applies a 512-point Hamming window
        # (/root/reference/sr/feature/feature.py:25-52); the effective
        # window on the original samples is the centre slice, and the
        # zero-pad placement only shifts DFT phase, which the power
        # spectrum discards.
        pad_left = (cfg.n_fft - cfg.frame_len) // 2
        window = np.hamming(cfg.n_fft)[pad_left : pad_left + cfg.frame_len]
        low = cfg.low_freq if cfg.low_freq else 80.0
        fbank = _mel_filterbank(cfg.n_mels, cfg.n_fft, rate, low, high)
        lifter = np.ones(cfg.n_ceps)
        # log10 fbanks + DCT keeping coefficients 1..n_ceps (drops c0),
        # /root/reference/sr/feature/feature.py:78-82.
        dct_m = _dct2_ortho_matrix(cfg.n_mels, cfg.n_ceps + 1)[:, 1:]
    else:
        raise ValueError(f"unknown frontend variant {cfg.variant!r}")

    dft_cos, dft_sin = _dft_power_bases(window, cfg.n_fft)
    # one [fl, 2*bins] GEMM per frame block instead of two half-size
    # launches (same FLOPs)
    dft_cs = np.concatenate([dft_cos, dft_sin], axis=1)
    # Stored float64; cast to the compute dtype at trace time.
    out = {
        "window": window,
        "dft_cos": dft_cos,
        "dft_sin": dft_sin,
        "dft_cs": dft_cs,
        "mel_w": fbank.T.copy(),  # [n_bins, n_mels]
        "dct_m": dct_m,  # [n_mels, n_ceps]
        "lifter": lifter,
    }
    if cfg.n_fft % 8 == 0:
        # staged GEMM FFT (dft_stage='staged'), decimation in
        # FREQUENCY: n = N2*n1 + n2 (n1 < 4), k = 4*k2 + r.  An exact
        # radix-4 butterfly over n1 runs first (+-1/+-i twiddles, pure
        # adds on [F, N2] lanes), then one GEMM per residue r with the
        # W^{n2 (4 k2 + r)} twiddle FOLDED INTO the DFT basis — every
        # GEMM contracts over N2 >= 128 in natural layout.  Real input:
        # u0, u2 are real and r = 0..3 covers bins 0..n_fft/2 exactly
        # once, so total MACs ~ n_fft/2 * (3*N2) ~ half the NDFT's
        # frame_len * (n_fft + 2).
        nfft = cfg.n_fft
        n2 = nfft // 4
        nn = np.arange(n2, dtype=np.float64)

        def basis(r, n_k):
            k2 = np.arange(n_k, dtype=np.float64)
            ph = 2.0 * np.pi * np.outer(nn, 4.0 * k2 + r) / nfft
            return np.cos(ph), np.sin(ph)

        c0, s0 = basis(0, n2 // 2 + 1)
        out["fftd_r0"] = np.concatenate([c0, -s0], axis=1)
        c2, s2 = basis(2, n2 // 2)
        out["fftd_r2"] = np.concatenate([c2, -s2], axis=1)
        # u1 = b - i d, u3 = b + i d (b = g0 - g2, d = g1 - g3):
        # X_r = [b d] @ M_r with the complex product expanded
        c1, s1 = basis(1, n2 // 2)
        c3, s3 = basis(3, n2 // 2)
        m1 = np.concatenate([np.concatenate([c1, -s1], axis=0),
                             np.concatenate([-s1, -c1], axis=0)], axis=1)
        m3 = np.concatenate([np.concatenate([c3, s3], axis=0),
                             np.concatenate([-s3, c3], axis=0)], axis=1)
        out["fftd_r13"] = np.concatenate([m1, m3], axis=1)  # [2*N2, 2*N2]
        # mel weights with columns permuted to the r-major bin order the
        # staged path emits: [r=0 bins, r=1, r=2, r=3]
        bins_r_major = np.concatenate(
            [np.arange(0, nfft // 2 + 1, 4),
             np.arange(1, nfft // 2, 4),
             np.arange(2, nfft // 2, 4),
             np.arange(3, nfft // 2, 4)])
        out["mel_w_rmajor"] = out["mel_w"][bins_r_major].copy()
    return out


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------


def max_frames(cfg: FrontendConfig, max_signal_len: int) -> int:
    """Static frame capacity for signals up to ``max_signal_len`` samples."""
    fl, fs = cfg.frame_len, cfg.frame_step
    if cfg.variant == "psf":
        if max_signal_len <= fl:
            return 1
        return 1 + int(np.ceil((max_signal_len - fl) / fs))
    # scratch: num_frames = ceil(len / step) (feature.py:11-13)
    return int(np.ceil(max_signal_len / fs))


def padded_length(cfg: FrontendConfig, max_signal_len: int) -> int:
    """Buffer length needed so every frame slice is in bounds."""
    nf = max_frames(cfg, max_signal_len)
    return (nf - 1) * cfg.frame_step + cfg.frame_len


# ---------------------------------------------------------------------------
# Core jnp pipeline
# ---------------------------------------------------------------------------


def _frame_signal(emph, F: int, fl: int, fs: int):
    """[L] -> [F, fl] overlapping frames via static strided slices.

    With g = gcd(fl, fs) the signal splits into g-sample blocks; frame f
    is blocks [f*fs/g .. f*fs/g + fl/g), so each of the fl/g block
    positions is one static strided slice — XLA-native, no gathers."""
    import math

    g = math.gcd(fl, fs)
    nb, sb = fl // g, fs // g
    need = (F - 1) * sb + nb
    x = emph[: need * g].reshape(need, g)
    parts = [x[j : j + (F - 1) * sb + 1 : sb] for j in range(nb)]
    return jnp.concatenate(parts, axis=1)


def _num_frames(cfg: FrontendConfig, length):
    fl, fs = cfg.frame_len, cfg.frame_step
    if cfg.variant == "psf":
        # psf framesig: 1 frame if slen <= frame_len else 1+ceil((slen-fl)/fs)
        extra = jnp.maximum(length - fl, 0)
        return jnp.where(length <= fl, 1, 1 + (extra + fs - 1) // fs)
    # scratch segment(): ceil(slen / fs) — the reference compares slen
    # against the *float seconds* frame length so the 1-frame branch never
    # triggers for real audio (feature.py:11-13).
    return (length + fs - 1) // fs


def _staged_fft_power(frames, consts, cfg, prec):
    """Power spectrum ``|rfft(frames * window, n_fft)|^2 / n_fft`` via
    the decimation-in-frequency staged GEMM FFT (``dft_stage='staged'``),
    returned in R-MAJOR bin order (pair with ``mel_w_rmajor``).

    With n = N2*n1 + n2 (n1 < 4) and k = 4*k2 + r::

        u_r[n2] = sum_n1 g[N2 n1 + n2] e^{-2 pi i n1 r / 4}   (butterfly)
        X[4 k2 + r] = sum_n2 u_r[n2] W_N^{n2 (4 k2 + r)}      (GEMM per r)

    The butterfly twiddles are exactly +-1/+-i (pure adds on
    [F, N2]); the residue twiddle folds into the per-r DFT basis, so the
    whole spectrum is 3 GEMMs that each contract over N2 >= 128 in
    natural layout — ~2x fewer MACs than the dense NDFT with a
    4x-shallower accumulation chain.
    """
    n_fft = cfg.n_fft
    n2 = n_fft // 4
    hh = n2 // 2  # bins per residue (r=0 has hh+1, including Nyquist)
    fcap, fl = frames.shape
    wf = frames * consts["window"][None, :]
    if fl < n_fft:
        wf = jnp.pad(wf, ((0, 0), (0, n_fft - fl)))
    g = wf.reshape(fcap, 4, n2)
    a = g[:, 0] + g[:, 2]
    c = g[:, 1] + g[:, 3]
    b_ = g[:, 0] - g[:, 2]
    d_ = g[:, 1] - g[:, 3]
    u0 = a + c
    u2 = a - c

    def dot(x, m):
        return jax.lax.dot_general(x, m, (((1,), (0,)), ((), ())),
                                   precision=prec)

    y0 = dot(u0, consts["fftd_r0"])  # [F, 2*(hh+1)] = re | im
    y2 = dot(u2, consts["fftd_r2"])  # [F, 2*hh]
    y13 = dot(jnp.concatenate([b_, d_], axis=1),
              consts["fftd_r13"])  # [F, 4*hh] = re1 | im1 | re3 | im3
    p0 = (y0[:, : hh + 1] * y0[:, : hh + 1]
          + y0[:, hh + 1 :] * y0[:, hh + 1 :])
    p2 = y2[:, :hh] * y2[:, :hh] + y2[:, hh:] * y2[:, hh:]
    p1 = (y13[:, :hh] * y13[:, :hh]
          + y13[:, hh : 2 * hh] * y13[:, hh : 2 * hh])
    p3 = (y13[:, 2 * hh : 3 * hh] * y13[:, 2 * hh : 3 * hh]
          + y13[:, 3 * hh :] * y13[:, 3 * hh :])
    return (jnp.concatenate([p0, p1, p2, p3], axis=-1) * (1.0 / n_fft))


@functools.partial(jax.jit, static_argnames=("cfg", "n_frames_cap"))
def mfcc(signal, length, cfg: FrontendConfig = FrontendConfig(), n_frames_cap: int = None):
    """MFCC for one utterance.

    Args:
      signal: float32 ``[L]`` sample buffer, zero-padded past ``length``.
        ``L`` must be at least ``padded_length(cfg, length)``.
      length: int32 true sample count.
      cfg: frontend configuration (static).
      n_frames_cap: optional static cap on output frames (defaults to the
        capacity implied by ``L``).

    Returns:
      ``(ceps [F, n_ceps], n_frames int32)`` where ``F`` is static and
      frames >= n_frames are exact zeros.
    """
    fl, fs = cfg.frame_len, cfg.frame_step
    L = signal.shape[0]
    F = n_frames_cap or (1 + max(0, (L - fl) // fs))

    if not jnp.issubdtype(signal.dtype, jnp.floating):
        signal = signal.astype(jnp.float32)
    dt = signal.dtype
    consts = {k: jnp.asarray(v, dtype=dt) for k, v in _frontend_constants(cfg).items()}
    # Pre-emphasis then re-zero the padding: the reference pre-emphasizes
    # before padding (psf sigproc / feature.py:45-46), so padded samples
    # must be exact zeros, not -preemph * last_sample.
    emph = jnp.concatenate(
        [signal[:1], signal[1:] - cfg.effective_preemph * signal[:-1]]
    )
    idx = jnp.arange(L)
    emph = jnp.where(idx < length, emph, 0.0)

    # Clamp to the buffer's frame capacity: callers must pad signals to
    # padded_length(cfg, max_len); if they under-pad, clamping keeps the
    # frame count consistent with the rows that actually exist instead of
    # silently normalizing over missing frames.
    nf = jnp.minimum(_num_frames(cfg, length), F)
    frame_mask = jnp.arange(F) < nf

    # Framing with static strided slices only (no gathers, no convs):
    # split the signal into gcd(fl, fs)-sample blocks and concatenate
    # block slices, then one [F, fl] x [fl, bins] GEMM per cos/sin
    # basis.
    frames = _frame_signal(emph, F, fl, fs)

    # Windowed power spectrum.
    mel_w = consts["mel_w"]
    if (cfg.dft_as_gemm and cfg.n_fft % 8 == 0
            and getattr(cfg, "dft_stage", "ndft") == "staged"):
        power = _staged_fft_power(frames, consts, cfg,
                                  _spectral_precision(cfg, "dft"))
        mel_w = consts["mel_w_rmajor"]  # bins in r-major order
    elif cfg.dft_as_gemm:
        prec_dft = _spectral_precision(cfg, "dft")
        reim = jnp.dot(frames, consts["dft_cs"], precision=prec_dft)
        nb = consts["dft_cos"].shape[1]
        # power via a [F, 2, bins] reshape view (lane slices re/im
        # would materialize two copies of the 2x-bins GEMM output)
        sq = (reim * reim).reshape(reim.shape[0], 2, nb)
        power = (sq[:, 0, :] + sq[:, 1, :]) * (1.0 / cfg.n_fft)
    else:
        spec = jnp.fft.rfft(frames * consts["window"][None, :], cfg.n_fft)
        power = (jnp.abs(spec) ** 2) * (1.0 / cfg.n_fft)

    # Mel energies -> log -> DCT -> lifter.
    mel = jnp.dot(power, mel_w,
                  precision=_spectral_precision(cfg, "mel"))
    # reference floors exact zeros to float64 eps (cast so f32 stays f32)
    eps = jnp.asarray(np.finfo(np.float64).eps, dtype=dt)
    mel = jnp.where(mel <= 0.0, eps, mel)
    log_mel = jnp.log(mel) if cfg.variant == "psf" else jnp.log10(mel)
    ceps = jnp.dot(log_mel, consts["dct_m"],
                   precision=_spectral_precision(cfg, "dct"))
    ceps = ceps * consts["lifter"][None, :]
    ceps = jnp.where(frame_mask[:, None], ceps, 0.0)
    return ceps, nf


def delta_feature(feat, n_frames):
    """Symmetric +-1-frame difference with one-sided ends, masked.

    Matches ``/root/reference/sr/core.py:13-22``: ``d[0]=f[1]-f[0]``,
    ``d[n-1]=f[n-1]-f[n-2]``, else ``d[i]=f[i+1]-f[i-1]`` — via static
    shifted slices plus a masked fix-up row at the dynamic boundary
    (no dynamic gathers).
    """
    F = feat.shape[0]
    i = jnp.arange(F)[:, None]
    fwd = jnp.concatenate([feat[1:], feat[-1:]], axis=0)  # f[i+1]
    bwd = jnp.concatenate([feat[:1], feat[:-1]], axis=0)  # f[i-1] (clamped at 0)
    d = fwd - bwd  # row 0 = f[1]-f[0], interior = f[i+1]-f[i-1]
    e = feat - bwd  # f[i]-f[i-1]: the one-sided last-row form
    d = jnp.where(i == n_frames - 1, e, d)
    return jnp.where(i < n_frames, d, 0.0)


def standardize(feat, n_frames):
    """Per-utterance mean/variance normalization over valid frames.

    Matches ``/root/reference/sr/feature/feature.py:85-88`` (population
    std, per-dimension) restricted to the true frames.
    """
    F = feat.shape[0]
    mask = (jnp.arange(F) < n_frames)[:, None]
    denom = jnp.maximum(n_frames, 1).astype(feat.dtype)
    mean = jnp.sum(jnp.where(mask, feat, 0.0), axis=0) / denom
    centered = jnp.where(mask, feat - mean[None, :], 0.0)
    var = jnp.sum(centered * centered, axis=0) / denom
    out = centered / jnp.sqrt(jnp.maximum(var, 1e-20))[None, :]
    return jnp.where(mask, out, 0.0)


@functools.partial(jax.jit, static_argnames=("cfg", "n_frames_cap", "norm"))
def mfcc39(signal, length, cfg: FrontendConfig = FrontendConfig(),
           n_frames_cap: int = None, norm: str = "utterance"):
    """Full production feature path: [mfcc, delta, delta-delta], normalized.

    The reference's ``load_wav_as_mfcc`` (``/root/reference/sr/core.py:34-45``)
    for ``variant='psf'``; ``load_wav_as_mfcc1`` (``sr/core.py:25-31``) for
    ``variant='scratch'``.

    ``norm``: 'utterance' (reference parity — per-utterance mean/var over
    valid frames) or 'none' (raw features, for corpus-level CMVN via
    :func:`cmvn_stats` / :func:`apply_cmvn`; per-utterance normalization
    is distorted when training audio is endpoint-trimmed but decode
    audio is not).

    Returns ``(features [F, 3*n_ceps], n_frames)``.
    """
    ceps, nf = mfcc(signal, length, cfg, n_frames_cap)
    d1 = delta_feature(ceps, nf)
    d2 = delta_feature(d1, nf)
    feats = jnp.concatenate([ceps, d1, d2], axis=1)
    if norm == "utterance":
        feats = standardize(feats, nf)
    return feats, nf


def cmvn_stats(feats, n_frames):
    """Corpus-level cepstral mean/variance from ``[B, T, D]`` raw
    features (masked).  Returns ``(mean [D], std [D])``."""
    feats = jnp.asarray(feats)
    t = feats.shape[1]
    mask = (jnp.arange(t)[None, :] < jnp.asarray(n_frames)[:, None])[..., None]
    total = jnp.sum(jnp.asarray(n_frames))
    mean = jnp.sum(jnp.where(mask, feats, 0.0), axis=(0, 1)) / total
    var = jnp.sum(jnp.where(mask, (feats - mean) ** 2, 0.0), axis=(0, 1)) / total
    return mean, jnp.sqrt(jnp.maximum(var, 1e-12))


def apply_cmvn(feats, n_frames, mean, std):
    """Apply corpus CMVN to ``[T, D]`` or ``[B, T, D]`` features, masked."""
    feats = jnp.asarray(feats)
    t = feats.shape[-2]
    out = (feats - mean) / std
    if feats.ndim == 2:
        m = (jnp.arange(t) < n_frames)[:, None]
    else:
        m = (jnp.arange(t)[None, :] < jnp.asarray(n_frames)[:, None])[..., None]
    return jnp.where(m, out, 0.0)


@functools.partial(jax.jit, static_argnames=("cfg", "n_frames_cap", "norm"))
def mfcc39_batch(signals, lengths, cfg: FrontendConfig = FrontendConfig(),
                 n_frames_cap: int = None, norm: str = "utterance"):
    """Batched ``mfcc39``: ``[B, L] -> ([B, F, 3*n_ceps], [B])``."""
    return jax.vmap(lambda s, l: mfcc39(s, l, cfg, n_frames_cap, norm))(signals, lengths)
