"""Audio file reading for the port: 16-bit PCM WAV through Python's `wave`.

The subset of `gsoc_wav2vec2_tpu/data/native_io.py::read_sound` that greedy
transcription needs: same scaling (x / 32768, as `tf.audio.decode_wav`) and
the same first-channel rule for multi-channel files.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """RIFF PCM16 -> (float32 in [-1, 1), sample_rate), first channel."""
    with wave.open(path, "rb") as f:
        if f.getsampwidth() != 2 or f.getcomptype() != "NONE":
            raise ValueError(f"{path}: only 16-bit PCM WAV is supported")
        channels = f.getnchannels()
        rate = f.getframerate()
        raw = f.readframes(f.getnframes())
    pcm = np.frombuffer(raw, dtype="<i2").reshape(-1, channels)[:, 0]
    return pcm.astype(np.float32) / 32768.0, rate


def read_sound(path: str) -> Tuple[np.ndarray, int]:
    """Dispatch on extension (.wav; .flac waits for the data-plane slice)."""
    low = path.lower()
    if low.endswith(".wav"):
        return read_wav(path)
    if low.endswith(".flac"):
        raise NotImplementedError(
            f"{path}: FLAC decoding is not ported yet; it arrives with the "
            "data-plane slice (the native codec wrapper). Convert to 16-bit "
            "PCM WAV for now."
        )
    raise ValueError(f"unsupported audio format: {path}")
