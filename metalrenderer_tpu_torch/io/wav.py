"""WAV ingestion: the host-side replacement for the live microphone tap
(AudioInputLayer.{hpp,mm}); the audio-reactive scene is driven from files
or arrays. The port's own copy of ``metalrenderer_tpu.io.wav``."""
from __future__ import annotations

import wave

import numpy as np


def read_wav(path):
    """Read a PCM WAV -> (f32[C, N] in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        frames = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        # Could be int32 PCM or float32; the wave module gives no format
        # code for floats, assume int32 PCM.
        data = np.frombuffer(frames, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(frames, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        raw = np.frombuffer(frames, np.uint8).reshape(-1, 3)
        ints = (raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width}")
    data = data.reshape(-1, channels).T
    return np.ascontiguousarray(data), rate


def write_wav(path, data, sample_rate):
    """data: f32[C, N] or f32[N] in [-1, 1] -> 16-bit PCM WAV."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    pcm = np.clip(np.rint(data * 32767.0), -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.T.tobytes())
