"""Audio file reading for the port: `read_sound` is the native codec's
(`native_io.read_sound`: 16-bit PCM WAV and FLAC, first channel, x / 32768),
so that transcription, evaluation and the loaders decode through one reader.
"""

from .native_io import read_sound

__all__ = ["read_sound"]
