"""Kaldi-compatible log-mel filterbank front end in PyTorch (batched), the
port of `emoasr_tpu/frontend/fbank.py`.

Replaces the reference's `torchaudio.compliance.kaldi.fbank(
window_type="hamming", htk_compat=True, sample_frequency=16000,
num_mel_bins=80, use_energy=False)` (emoASR `corpora/utils/
wav_to_feats.py:26-33`, the caller scaling by 2^15).  The kaldi pipeline
with its defaults: 25 ms frames every 10 ms, snip_edges, per-frame DC
removal, pre-emphasis 0.97 (the first sample against itself), the
non-periodic hamming window, a 512-point power spectrum
(`torch.fft.rfft`), 80 triangular mel bins between 20 Hz and Nyquist, log
with the float32-epsilon floor.  Frames, spectrum and mel product are
computed in float64 and the log-mel returned in float32: with a float32
FFT the low-energy bins of a 1 s random signal came 5.1e-4 from a float64
kaldi implementation, above the 3e-4 that tests/test_frontend_golden.py
holds the JAX fbank to (the JAX package asks for `Precision.HIGHEST` in
its mel product for the same reason).  The work runs on the device of the
waveforms; `corpora/prep.py` puts them on the card unless asked for the
CPU.
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME_LEN = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
FFT_SIZE = 512
EPS = 1.1920928955078125e-07  # float32 epsilon (kaldi's log floor)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(num_bins: int = 80, low_freq: float = 20.0, high_freq: float = 0.0,
              sample_rate: int = SAMPLE_RATE, fft_size: int = FFT_SIZE) -> np.ndarray:
    """(num_fft_bins + 1, num_mel_bins) triangular weights, kaldi-style."""
    nyquist = sample_rate / 2.0
    if high_freq <= 0:
        high_freq = nyquist + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_fft_bins + 1, num_bins), np.float32)
    for m in range(num_bins):
        left = mel_low + m * mel_delta
        center = mel_low + (m + 1) * mel_delta
        right = mel_low + (m + 2) * mel_delta
        for k in range(num_fft_bins + 1):
            mel = mel_scale(fft_bin_width * k)
            if left < mel < right:
                if mel <= center:
                    bins[k, m] = (mel - left) / (center - left)
                else:
                    bins[k, m] = (right - mel) / (right - center)
    return bins


def _hamming(n: int) -> np.ndarray:
    # kaldi "hamming": 0.54 - 0.46 cos(2 pi i / (N-1))
    i = np.arange(n)
    return (0.54 - 0.46 * np.cos(2 * np.pi * i / (n - 1))).astype(np.float32)


def num_frames(num_samples: torch.Tensor) -> torch.Tensor:
    """snip_edges frame count: 1 + (N - 400) // 160 (0 if too short)."""
    return ((num_samples - FRAME_LEN) // FRAME_SHIFT + 1).clamp(min=0)


def log_mel_fbank(wav: torch.Tensor, wav_lens: Optional[torch.Tensor] = None, num_bins: int = 80,
                  max_frames: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) int16-scaled waveforms -> ((B, T, num_bins) log-mel float32,
    (B,) int32 frame counts), on the waveforms' device.  Frames past each
    utterance's length are zero."""
    if wav.dim() == 1:
        wav = wav[None]
    B, N = wav.shape
    dev = wav.device
    if wav_lens is None:
        wav_lens = torch.full((B,), N, dtype=torch.int64, device=dev)
    wav_lens = torch.as_tensor(wav_lens, device=dev).to(torch.int64)
    T = max_frames or max(int((N - FRAME_LEN) // FRAME_SHIFT + 1), 1)

    idx = torch.arange(T, device=dev)[:, None] * FRAME_SHIFT + torch.arange(FRAME_LEN, device=dev)[None, :]
    f64 = torch.float64
    frames = wav[:, idx.clamp(0, N - 1)].to(torch.float32).to(f64)  # (B, T, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)  # DC offset
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * prev  # pre-emphasis
    frames = frames * torch.from_numpy(_hamming(FRAME_LEN)).to(dev, f64)

    spec = torch.fft.rfft(frames, n=FFT_SIZE, dim=-1)  # (B, T, 257)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.from_numpy(mel_banks(num_bins)).to(dev, f64)
    feats = torch.log(mel.clamp(min=EPS)).to(torch.float32)

    flens = num_frames(wav_lens).clamp(max=T).to(torch.int32)
    mask = (torch.arange(T, device=dev)[None, :] < flens[:, None])[:, :, None]
    return torch.where(mask, feats, torch.zeros_like(feats)), flens


def load_wav(path: str) -> np.ndarray:
    """A 16 kHz PCM16 WAV as float32 samples with the kaldi int16 scaling
    (stdlib only; the first channel of a multichannel file)."""
    with wave.open(path, "rb") as w:
        assert w.getframerate() == SAMPLE_RATE, w.getframerate()
        assert w.getsampwidth() == 2, "PCM16 expected"
        data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels())[:, 0]
    return data.astype(np.float32)
