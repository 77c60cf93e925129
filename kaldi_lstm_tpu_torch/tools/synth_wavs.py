"""Render transition-id alignments as audio: each pdf gets a fixed
random log-amplitude profile over the mel-bin center frequencies, and
every 10 ms frame is the corresponding mixture of sinusoids. fbank of
the result is then a (leaky) linear mixture of per-pdf log-amplitude
vectors — separable at thousands of senones — so the synthetic corpus
can be driven through the REAL front end (wav -> fbank -> CMVN) instead
of sampling Gaussian features directly, completing the reference's
workflow shape (wav.scp in, train_lstm_streams.sh upstream of
google/run.sh) at flagship dims.

    python -m kaldi_lstm_tpu_torch.tools.synth_wavs <model> <ali-rspecifier> \\
        <wav-dir> [--num-mel-bins 40] [--samp-freq 16000] ...

Writes <wav-dir>/uttN.wav + <wav-dir>/wav.scp. Frame k of the alignment
occupies samples [k*160, (k+1)*160) with the amplitude envelope shifted
so the analysis window CENTER (25 ms window, 10 ms shift) lands on the
frame it is labeled with; num_samples = 160*T + 240 makes fbank produce
exactly T frames (feats/fbank.py num_frames).

This package's copy of ``kaldi_lstm_tpu.tools.synth_wavs``: host numpy
on the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import io as _io
import os
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    _open_rspecifier,
    _read_key,
    _read_value_header,
    read_int_vector,
)
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.io.wav import write_wav
from kaldi_lstm_tpu_torch.utils import LOG


def mel_center_freqs(num_bins: int, samp_freq: float,
                     low_freq: float = 20.0) -> np.ndarray:
    """Triangular-filter center frequencies of feats/fbank.py mel_banks
    (mel(f) = 1127 ln(1 + f/700), linear in mel from low to nyquist)."""
    high = samp_freq / 2.0

    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f) / 700.0)

    delta = (mel(high) - mel(low_freq)) / (num_bins + 1)
    centers_mel = mel(low_freq) + (np.arange(num_bins) + 1) * delta
    return 700.0 * (np.expm1(centers_mel / 1127.0))


def synth_utterance(pdfs: np.ndarray, amps: np.ndarray,
                    carriers_fn, shift: int, win: int,
                    noise_rms: float, rng) -> np.ndarray:
    """[T] pdf ids -> float waveform of 160*T + 240 samples."""
    T = len(pdfs)
    n_samp = shift * T + (win - shift)
    env = amps[pdfs]                                  # [T, B]
    # window CENTER for fbank frame k is at k*shift + win/2; label the
    # envelope so that center sample falls in frame k's segment
    offset = win // 2 - shift // 2
    idx = np.clip((np.arange(n_samp) - offset) // shift, 0, T - 1)
    x = np.einsum("nb,bn->n", env[idx], carriers_fn(n_samp))
    if noise_rms > 0:
        x = x + rng.randn(n_samp) * noise_rms
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Synthesize wavs from "
                                            "alignments (per-pdf mel "
                                            "sinusoid mixtures)")
    p.add_argument("model_in")
    p.add_argument("ali_rspecifier")
    p.add_argument("wav_dir")
    p.add_argument("--num-mel-bins", type=int, default=40)
    p.add_argument("--samp-freq", type=float, default=16000.0)
    p.add_argument("--log-amp-stddev", type=float, default=1.0,
                   help="stddev of per-(pdf,bin) log amplitudes")
    p.add_argument("--noise-rms", type=float, default=1.0,
                   help="additive white noise (waveform units; carrier "
                        "scale is --scale)")
    p.add_argument("--scale", type=float, default=250.0,
                   help="global waveform scale (int16 range)")
    p.add_argument("--mean-seed", type=int, default=42,
                   help="seed of the per-pdf amplitude table")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-speakers", type=int, default=0,
                   help="speaker variation: each utterance is rendered "
                        "through one of K speaker transforms (spectral "
                        "tilt + gain + per-bin jitter on the amplitude "
                        "profiles); writes utt2spk. 0 = off")
    p.add_argument("--speaker-tilt-stddev", type=float, default=0.5,
                   help="stddev of the per-speaker log-amplitude tilt "
                        "across mel bins (vocal-tract analogue)")
    p.add_argument("--speaker-gain-stddev", type=float, default=0.3,
                   help="stddev of the per-speaker overall log gain")
    p.add_argument("--speaker-jitter-stddev", type=float, default=0.15,
                   help="stddev of per-(speaker,bin) log jitter")
    p.add_argument("--speaker-seed", type=int, default=1234)
    args = p.parse_args(argv)

    tm = TransitionModel.load(args.model_in)
    os.makedirs(args.wav_dir, exist_ok=True)
    fs = args.samp_freq
    shift, win = int(fs * 0.010), int(fs * 0.025)
    B = args.num_mel_bins
    freqs = mel_center_freqs(B, fs)
    mean_rng = np.random.RandomState(args.mean_seed)
    # fixed per-bin phases + per-(pdf,bin) log-normal amplitudes
    phases = mean_rng.uniform(0, 2 * np.pi, B)
    amps = np.exp(mean_rng.randn(tm.num_pdfs, B)
                  * args.log_amp_stddev).astype(np.float32)
    rng = np.random.RandomState(args.seed)

    # speaker transforms: per-speaker multiplicative log-amplitude
    # field = tilt * linspace(-1,1,B) + gain + per-bin jitter — a crude
    # vocal-tract/loudness analogue. Deterministic in --speaker-seed;
    # speaker of utterance i = i mod K (utt2spk records it).
    K = max(args.num_speakers, 0)
    spk_amps = None
    if K > 0:
        srng = np.random.RandomState(args.speaker_seed)
        ramp = np.linspace(-1.0, 1.0, B, dtype=np.float32)
        fields = (srng.randn(K, 1) * args.speaker_tilt_stddev * ramp
                  + srng.randn(K, 1) * args.speaker_gain_stddev
                  + srng.randn(K, B) * args.speaker_jitter_stddev)
        spk_amps = (amps[None] * np.exp(fields.astype(np.float32))
                    [:, None, :])                     # [K, num_pdfs, B]

    # small FIFO cache: utterance lengths interleave, so keep several
    # carrier tables instead of thrashing one slot per length change
    carrier_cache: dict = {}

    def carriers(n_samp):
        if n_samp not in carrier_cache:
            if len(carrier_cache) >= 16:
                carrier_cache.pop(next(iter(carrier_cache)))
            t = np.arange(n_samp) / fs
            carrier_cache[n_samp] = np.sin(
                2 * np.pi * freqs[:, None] * t[None, :]
                + phases[:, None]).astype(np.float32)
        return carrier_cache[n_samp]

    kind, stream = _open_rspecifier(args.ali_rspecifier)
    if kind != "ark":
        print("synth_wavs: only ark: alignment input supported",
              file=sys.stderr)
        return 1
    buffered = stream if isinstance(stream, _io.BufferedReader) \
        else _io.BufferedReader(stream)
    n = 0
    u2s = (open(os.path.join(args.wav_dir, "utt2spk"), "w")
           if K > 0 else None)
    with open(os.path.join(args.wav_dir, "wav.scp"), "w") as scp:
        while True:
            key = _read_key(buffered)
            if key is None:
                break
            tids = read_int_vector(_read_value_header(buffered))
            pdfs = tm.transition_ids_to_pdfs(tids)
            a = amps if spk_amps is None else spk_amps[n % K]
            x = synth_utterance(pdfs, a, carriers, shift, win,
                                args.noise_rms, rng)
            x = np.clip(x * args.scale, -32000, 32000)
            path = os.path.join(args.wav_dir, f"{key}.wav")
            write_wav(path, int(fs), x)
            scp.write(f"{key} {path}\n")
            if u2s is not None:
                u2s.write(f"{key} spk{n % K:03d}\n")
            n += 1
    if u2s is not None:
        u2s.close()
    LOG(f"synthesized {n} wav files ({tm.num_pdfs} pdf profiles, "
        f"{B} mel carriers"
        + (f", {K} speakers" if K else "") + f") in {args.wav_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
