"""WAV read/write and resampling, as ``samplernn_pase_tpu.ops.audio_io``
(16 kHz is the default rate; int16 PCM is the interchange format).

The reference reads and writes through ``scipy.io.wavfile`` and resamples
with ``scipy.signal.resample_poly``; the port imports neither.  Reading
is a small RIFF parser in numpy (PCM 8/16/24/32/64-bit and IEEE float
32/64, plain or WAVE_FORMAT_EXTENSIBLE, any channel count), with the
reference's scaling per sample type and its downmix after scaling.
``resample`` designs the same Kaiser-windowed FIR (``firwin`` with beta
5.0 and half-length 10 * max(up, down)) and pads and phases its output as
``resample_poly`` does, in float64.  Writing goes through the standard
library's ``wave``.
"""

from __future__ import annotations

import struct
import wave
from math import gcd

import numpy as np

DEFAULT_SAMPLE_RATE = 16_000

_PCM, _FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE


def _riff_chunks(data: bytes):
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        yield cid, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _wav_samples(path) -> tuple[np.ndarray, int]:
    """(samples as stored: [frames] or [frames, channels], sample rate),
    with the sample types scipy.io.wavfile.read returns."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, payload = None, None
    for cid, body in _riff_chunks(data):
        if cid == b"fmt ":
            tag, channels, rate, _, align, bits = struct.unpack(
                "<HHIIHH", body[:16])
            if tag == _EXTENSIBLE and len(body) >= 26:
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, channels, rate, align, bits)
        elif cid == b"data" and payload is None:
            payload = body
    if fmt is None or payload is None:
        raise ValueError(f"{path}: no fmt or data chunk")
    tag, channels, rate, align, bits = fmt
    width = bits // 8
    if channels < 1 or align != channels * width:
        raise ValueError(f"{path}: block align {align} does not match "
                         f"{channels} channels of {bits} bits")
    raw = payload[:len(payload) // align * align]
    if tag == _PCM and bits == 8:
        x = np.frombuffer(raw, np.uint8)
    elif tag == _PCM and bits in (16, 32, 64):
        x = np.frombuffer(raw, f"<i{width}")
    elif tag == _PCM and bits == 24:
        # three bytes little-endian, left-justified into int32
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.uint32)
        x = ((b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)).view(
            np.int32)
    elif tag == _FLOAT and bits in (32, 64):
        x = np.frombuffer(raw, f"<f{width}")
    else:
        raise ValueError(f"{path}: unsupported format tag {tag}, "
                         f"{bits} bits")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, int(rate)


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    data, sr = _wav_samples(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float wav
        x = data.astype(np.float32)
    if x.ndim == 2:  # downmix to mono after scaling (dtype-dependent)
        x = x.mean(axis=1)
    return np.clip(x, -1.0, 1.0), sr


def _kaiser_lowpass(numtaps: int, f_c: float, beta: float = 5.0):
    """firwin(numtaps, f_c, window=('kaiser', beta)): a windowed sinc of
    cutoff f_c (relative to Nyquist), scaled to unit gain at DC."""
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = f_c * np.sinc(f_c * m)
    h = h * np.kaiser(numtaps, beta)
    return h / np.sum(h)


def _output_len(len_h: int, n_in: int, up: int, down: int) -> int:
    return ((n_in - 1) * up + len_h - 1) // down + 1


def _resample_poly(x: np.ndarray, up: int, down: int,
                   block: int = 16_384) -> np.ndarray:
    """scipy.signal.resample_poly(x, up, down) for 1-D float64 x, with
    its default window and zero padding."""
    g = gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x.copy()
    n_in = len(x)
    n_out = -(-n_in * up // down)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = _kaiser_lowpass(2 * half_len + 1, 1.0 / max_rate) * up
    # zero-pad the filter to put the output samples at its centre
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _output_len(len(h) + n_pre_pad + n_post_pad, n_in, up,
                      down) < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    len_h = len(h)
    # polyphase: y[n] = sum_k x[k] h[n * down - k * up]
    taps = np.arange(-(-len_h // up))
    out = np.empty(n_out)
    for s in range(0, n_out, block):
        n = np.arange(n_pre_remove + s, n_pre_remove + min(s + block, n_out))
        j = n * down
        k0 = j // up
        k = k0[:, None] - taps[None, :]
        idx = (j - k0 * up)[:, None] + up * taps[None, :]
        ok = (k >= 0) & (k < n_in) & (idx < len_h)
        vals = x[np.clip(k, 0, n_in - 1)] * h[np.minimum(idx, len_h - 1)]
        out[s:s + len(n)] = np.where(ok, vals, 0.0).sum(axis=1)
    return out


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample a mono float waveform sr_in -> sr_out (the
    reference assumes a 16 kHz corpus; a file at another rate is resampled
    on load rather than trained at the wrong rate)."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    g = gcd(int(sr_in), int(sr_out))
    y = _resample_poly(np.asarray(x, np.float64), int(sr_out) // g,
                       int(sr_in) // g)
    return np.clip(y, -1.0, 1.0).astype(np.float32)


def write_wav(path, x: np.ndarray,
              sample_rate: int = DEFAULT_SAMPLE_RATE) -> None:
    """Write a float waveform in [-1, 1] ([T] or [T, channels]) as int16
    PCM."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())
