"""Native feature extraction: log-mel filterbanks (fbank) and MFCCs
with upstream-Kaldi featbin semantics.

The reference consumes 40-dim log-fbank features produced by upstream
Kaldi's compute-fbank-feats (google/README.md's pipeline assumes
feats.scp already exists; the bundled paper specifies "40-dimensional
log-filterbank", 25 ms windows / 10 ms shift —
google/papers/2014-icassp-google-LSTM-ASR.pdf §3.1). This module makes
the framework standalone: wav in, Kaldi-compatible feature matrices
out, matching upstream src/feat/ behavior:

* framing: snip_edges=True keeps only fully-contained frames
  (num_frames = 1 + (n - frame_length) // frame_shift);
  snip_edges=False centers frame t at sample t*shift + shift/2 and
  reflects at the edges.
* per frame, in upstream order: dither -> DC-offset removal -> raw
  log-energy capture -> preemphasis (x[0] scaled by 1-coeff) ->
  window (povey = hann^0.85 default) -> zero-pad to the next power of
  two -> power spectrum.
* mel filter bank: mel(f) = 1127 ln(1 + f/700); num_bins triangular
  filters linear in mel between low_freq (20) and high_freq (nyquist
  when <= 0), computed over FFT bins 0..nfft/2-1 (nyquist excluded).
* fbank = log(max(mel_energy, FLT_EPSILON)); mfcc = orthogonal DCT-II
  of the log-mel energies, num_ceps kept, sinusoidal liftering
  (1 + Q/2 sin(pi i / Q)), C0 replaced by raw log-energy when
  use_energy (the upstream mfcc default).

All computation is vectorized numpy over [num_frames, ...]; feature
extraction is host-side I/O work (the card's path starts at the CMVN
transform, models/components.py AddShift/Rescale).

This package's copy of ``kaldi_lstm_tpu.feats.fbank``: the same numpy,
op for op, so the features are bit-identical to the JAX package's. It
imports neither torch nor jax. Pass an explicit ``dither_rng`` (the
tools pass one ``RandomState(--seed)``); without one, dither draws from
the module's own ``_DITHER_RNG``, as the JAX module does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FLT_EPSILON = float(np.finfo(np.float32).eps)


@dataclass
class FrameOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"   # povey|hamming|hanning|rectangular|blackman
    blackman_coeff: float = 0.42
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        n = self.window_size
        if not self.round_to_power_of_two:
            return n
        p = 1
        while p < n:
            p *= 2
        return p


@dataclass
class MelOptions:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0   # <= 0: nyquist + high_freq


@dataclass
class FbankOptions:
    frame_opts: FrameOptions = field(default_factory=FrameOptions)
    mel_opts: MelOptions = field(default_factory=MelOptions)
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True


@dataclass
class MfccOptions:
    frame_opts: FrameOptions = field(default_factory=FrameOptions)
    mel_opts: MelOptions = field(default_factory=MelOptions)
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


def num_frames(num_samples: int, opts: FrameOptions) -> int:
    n, length, shift = num_samples, opts.window_size, opts.window_shift
    if opts.snip_edges:
        return 0 if n < length else 1 + (n - length) // shift
    return (n + shift // 2) // shift


def _window(opts: FrameOptions) -> np.ndarray:
    n = opts.window_size
    a = 2.0 * np.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if opts.window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if opts.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if opts.window_type == "rectangular":
        return np.ones(n)
    if opts.window_type == "blackman":
        b = opts.blackman_coeff
        return (b - 0.5 * np.cos(a * i)
                + (0.5 - b) * np.cos(2 * a * i))
    raise ValueError(f"unknown window type {opts.window_type!r}")


def _extract_frames(wave: np.ndarray, opts: FrameOptions) -> np.ndarray:
    """[num_frames, window_size] float64 raw sample frames."""
    wave = np.asarray(wave, np.float64)
    nf = num_frames(len(wave), opts)
    length, shift = opts.window_size, opts.window_shift
    if nf <= 0:
        return np.zeros((0, length))
    if opts.snip_edges:
        idx = (np.arange(nf)[:, None] * shift
               + np.arange(length)[None, :])
    else:
        # frame t covers [t*shift + shift/2 - length/2, ...); samples
        # beyond the waveform reflect (upstream feature-window.cc)
        start = (np.arange(nf) * shift + shift // 2
                 - length // 2)
        idx = start[:, None] + np.arange(length)[None, :]
        n = len(wave)
        # upstream mirrors around the half-sample boundaries
        # (feature-window.cc): -1 -> 0, -2 -> 1 and n -> n-1, n+1 -> n-2
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
        idx = np.clip(idx, 0, n - 1)
    return wave[idx]


# default dither stream: module-level so successive utterances get
# DIFFERENT noise (upstream's RNG advances across calls); a per-call
# RandomState(0) would correlate the dither of every utterance
_DITHER_RNG = np.random.RandomState(0)


def _process_frames(frames: np.ndarray, opts: FrameOptions,
                    dither_rng=None):
    """dither -> DC removal -> raw energy -> preemphasis -> window.
    Returns (processed [nf, window], raw log-energy [nf])."""
    x = frames.copy()
    if opts.dither != 0.0:
        rng = dither_rng if dither_rng is not None else _DITHER_RNG
        x += opts.dither * rng.standard_normal(x.shape)
    if opts.remove_dc_offset:
        x -= x.mean(axis=1, keepdims=True)
    log_energy = np.log(np.maximum((x * x).sum(axis=1), FLT_EPSILON))
    if opts.preemph_coeff != 0.0:
        c = opts.preemph_coeff
        x[:, 1:] -= c * x[:, :-1]
        x[:, 0] -= c * x[:, 0]
    return x * _window(opts)[None, :], log_energy


def mel_banks(frame_opts: FrameOptions,
              mel_opts: MelOptions) -> np.ndarray:
    """[num_bins, nfft//2] triangular filter matrix over FFT bins
    (bin k at frequency k * samp_freq / nfft; nyquist excluded)."""
    nfft = frame_opts.padded_window_size
    nyquist = 0.5 * frame_opts.samp_freq
    high = mel_opts.high_freq if mel_opts.high_freq > 0 \
        else nyquist + mel_opts.high_freq
    low = mel_opts.low_freq
    if not 0.0 <= low < nyquist or not low < high <= nyquist:
        raise ValueError(f"bad mel frequency range [{low}, {high}] "
                         f"at nyquist {nyquist}")

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    nbins = mel_opts.num_bins
    mel_low, mel_high = mel(low), mel(high)
    delta = (mel_high - mel_low) / (nbins + 1)
    left = mel_low + np.arange(nbins) * delta            # [nbins]
    center = left + delta
    right = center + delta
    freqs = np.arange(nfft // 2) * (frame_opts.samp_freq / nfft)
    m = mel(freqs)[None, :]                              # [1, nfft/2]
    up = (m - left[:, None]) / delta
    down = (right[:, None] - m) / delta
    return np.maximum(0.0, np.minimum(up, down))


def _power_spectrum(windowed: np.ndarray, opts: FrameOptions,
                    use_power: bool) -> np.ndarray:
    """[nf, nfft//2] spectrum over the mel-relevant bins."""
    nfft = opts.padded_window_size
    spec = np.fft.rfft(windowed, n=nfft, axis=1)[:, :nfft // 2]
    p = (spec.real ** 2 + spec.imag ** 2)
    return p if use_power else np.sqrt(p)


def compute_fbank(wave: np.ndarray, opts: FbankOptions | None = None,
                  dither_rng=None) -> np.ndarray:
    """[num_frames, num_bins(+1)] float32 log-mel filterbank features
    from a 1-D waveform (raw sample scale, i.e. int16 range)."""
    opts = opts or FbankOptions()
    frames = _extract_frames(wave, opts.frame_opts)
    if frames.shape[0] == 0:
        ncol = opts.mel_opts.num_bins + (1 if opts.use_energy else 0)
        return np.zeros((0, ncol), np.float32)
    win, log_e = _process_frames(frames, opts.frame_opts, dither_rng)
    if opts.use_energy and not opts.raw_energy:
        log_e = np.log(np.maximum((win * win).sum(axis=1), FLT_EPSILON))
    power = _power_spectrum(win, opts.frame_opts, opts.use_power)
    banks = mel_banks(opts.frame_opts, opts.mel_opts)
    feat = power @ banks.T
    if opts.use_log_fbank:
        feat = np.log(np.maximum(feat, FLT_EPSILON))
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_e = np.maximum(log_e, np.log(opts.energy_floor))
        feat = np.concatenate([log_e[:, None], feat], axis=1)
    return feat.astype(np.float32)


def _dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthogonal DCT-II rows (upstream ComputeDctMatrix)."""
    j = np.arange(num_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    m = np.sqrt(2.0 / num_bins) * np.cos(
        np.pi / num_bins * k * (j[None, :] + 0.5))
    m[0, :] = 1.0 / np.sqrt(num_bins)
    return m


def compute_mfcc(wave: np.ndarray, opts: MfccOptions | None = None,
                 dither_rng=None) -> np.ndarray:
    """[num_frames, num_ceps] float32 MFCCs (upstream
    compute-mfcc-feats semantics; C0 = raw log-energy when
    use_energy, the default)."""
    opts = opts or MfccOptions()
    frames = _extract_frames(wave, opts.frame_opts)
    if frames.shape[0] == 0:
        return np.zeros((0, opts.num_ceps), np.float32)
    win, log_e = _process_frames(frames, opts.frame_opts, dither_rng)
    if opts.use_energy and not opts.raw_energy:
        log_e = np.log(np.maximum((win * win).sum(axis=1), FLT_EPSILON))
    power = _power_spectrum(win, opts.frame_opts, use_power=True)
    banks = mel_banks(opts.frame_opts, opts.mel_opts)
    logmel = np.log(np.maximum(power @ banks.T, FLT_EPSILON))
    feat = logmel @ _dct_matrix(opts.num_ceps,
                                opts.mel_opts.num_bins).T
    if opts.cepstral_lifter != 0.0:
        q = opts.cepstral_lifter
        lift = 1.0 + 0.5 * q * np.sin(
            np.pi * np.arange(opts.num_ceps) / q)
        feat = feat * lift[None, :]
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_e = np.maximum(log_e, np.log(opts.energy_floor))
        feat[:, 0] = log_e
    return feat.astype(np.float32)
