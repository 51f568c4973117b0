"""TF-compatible audio feature ops: AudioSpectrogram and Mfcc.

The reference's speech-command golden (tests/nnstreamer_filter_tensorflow:
conv_actions_frozen.pb on yes.wav) runs DecodeWav → AudioSpectrogram →
Mfcc inside the TF graph.  These are faithful implementations of the
TF kernels (tensorflow/core/kernels/spectrogram.cc,
mfcc_mel_filterbank.cc, mfcc_dct.cc) so the whole feature front-end jits
into the same forward (one CUDA graph) as the conv net:

- spectrogram: periodic Hann window, FFT length = next pow2(window),
  frame step = stride, |FFT|² (magnitude_squared) over the first
  fft/2+1 bins;
- mel filterbank: TF's linear-interpolation weights over FFT bins mapped
  to mel (1127·ln(1+f/700)) between lower/upper limits, applied to the
  MAGNITUDE (sqrt of the squared spectrogram) — precomputed as one
  (channels, bins) matrix so it runs as a single matmul;
- log floor 1e-12, then TF's DCT-II (scale sqrt(2/N), no orthonormal
  special case for k=0).

The filterbank matrix depends on the sample rate; it is built host-side
(numpy) for a STATIC rate — fine for real pipelines, where a stream's
rate is fixed (DecodeWav's desired_samples pins it in the graphs that use
these ops).

The port of ``nnstreamer_tpu/ops/audio.py``: the same math in torch
(``torch.fft.rfft``).  The host-built tables (window, frame indices,
filterbank, DCT) are staged on the device once per shape and device
(:func:`_device_table`), so a forward captured into a CUDA graph copies
nothing from the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

#: (table name, shape parameters, device) -> the table on that device
_TABLES: Dict[Tuple, torch.Tensor] = {}


def _device_table(key: Tuple, device, build: Callable[[], np.ndarray]
            ) -> torch.Tensor:
    """A host-built constant table on ``device``, built and copied once:
    the eager run that precedes a CUDA graph capture stages it, the
    capture and every replay read it in place."""
    key = key + (str(device),)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.as_tensor(build(), device=device)
    return table


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def audio_spectrogram(audio, window_size: int, stride: int,
                      magnitude_squared: bool):
    """TF AudioSpectrogram: (samples, channels) f32 →
    (channels, frames, fft//2+1)."""
    samples = audio.shape[0]
    fft_len = _next_pow2(window_size)
    n_frames = 1 + (samples - window_size) // stride
    if n_frames < 1:
        raise ValueError(
            f"audio_spectrogram: {samples} samples < window {window_size}")
    window = _device_table(("hann", window_size), audio.device, lambda: (
        0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(window_size)
                           / window_size)).astype(np.float32))
    idx = _device_table(("frames", n_frames, stride, window_size), audio.device,
                  lambda: (np.arange(n_frames)[:, None] * stride
                           + np.arange(window_size)[None, :]))
    frames = audio.transpose(0, 1)[:, idx]          # (ch, frames, win)
    spec = torch.fft.rfft(frames * window, n=fft_len)
    mag2 = spec.real * spec.real + spec.imag * spec.imag
    return mag2 if magnitude_squared else torch.sqrt(mag2)


def mel_filterbank_matrix(sample_rate: float, input_length: int,
                          channel_count: int, lower_limit: float,
                          upper_limit: float) -> np.ndarray:
    """TF MfccMelFilterbank weights as a dense (channels, bins) matrix
    (mfcc_mel_filterbank.cc Initialize/Compute, including its band
    mapping and interpolation conventions)."""
    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)

    mel_lo = mel(lower_limit)
    mel_hi = mel(upper_limit)
    mel_span = mel_hi - mel_lo
    mel_spacing = mel_span / (channel_count + 1)
    center = mel_lo + mel_spacing * np.arange(1, channel_count + 2)

    hz_per_sbin = 0.5 * sample_rate / (input_length - 1)
    start_index = int(1.5 + lower_limit / hz_per_sbin)
    end_index = int(upper_limit / hz_per_sbin)

    band_mapper = np.full(input_length, -2, np.int64)
    channel = 0
    for i in range(input_length):
        melf = mel(i * hz_per_sbin)
        if start_index <= i <= end_index:
            while (channel < channel_count
                   and center[channel] < melf):
                channel += 1
            band_mapper[i] = channel - 1

    weights = np.zeros(input_length, np.float64)
    for i in range(input_length):
        ch = band_mapper[i]
        if start_index <= i <= end_index:
            melf = mel(i * hz_per_sbin)
            if ch >= 0:
                weights[i] = ((center[ch + 1] - melf)
                              / (center[ch + 1] - center[ch]))
            else:
                weights[i] = (center[0] - melf) / (center[0] - mel_lo)

    mat = np.zeros((channel_count, input_length), np.float64)
    for i in range(input_length):
        ch = band_mapper[i]
        if start_index <= i <= end_index:
            if ch >= 0:
                mat[ch, i] += weights[i]
            if ch + 1 < channel_count:
                mat[ch + 1, i] += 1.0 - weights[i]
    return mat.astype(np.float32)


def dct_matrix(input_length: int, coefficient_count: int) -> np.ndarray:
    """TF MfccDct cosine table (mfcc_dct.cc): DCT-II scaled sqrt(2/N)."""
    fnorm = np.sqrt(2.0 / input_length)
    arg = np.pi / input_length
    n = np.arange(input_length)
    k = np.arange(coefficient_count)[:, None]
    return (fnorm * np.cos(k * arg * (n + 0.5))).astype(np.float32)


def mfcc(spectrogram_sq, sample_rate: float, channel_count: int = 40,
         lower_limit: float = 20.0, upper_limit: float = 4000.0,
         dct_count: int = 13):
    """TF Mfcc: squared-magnitude spectrogram (ch, frames, bins) →
    (ch, frames, dct_count)."""
    bins = spectrogram_sq.shape[-1]
    dev = spectrogram_sq.device
    fb = _device_table(("mel", float(sample_rate), bins, channel_count,
                  float(lower_limit), float(upper_limit)), dev,
                 lambda: mel_filterbank_matrix(sample_rate, bins,
                                               channel_count, lower_limit,
                                               upper_limit))
    dct = _device_table(("dct", channel_count, dct_count), dev,
                  lambda: dct_matrix(channel_count, dct_count))
    mag = torch.sqrt(spectrogram_sq)
    energies = torch.einsum("cfb,kb->cfk", mag, fb)
    logged = torch.log(torch.clamp(energies, min=1e-12))
    return torch.einsum("cfk,dk->cfd", logged, dct)
