"""Minimal RIFF/WAVE PCM writer (a copy of ``claxon_tpu.utils.wav``).

Plays the role of the ``hound`` crate in the reference's examples
(`examples/decode.rs:4,41-46`): integer PCM, 8/16/24/32-bit, interleaved.
"""

import struct

import numpy as np

__all__ = ["write_wav"]


def write_wav(path_or_file, pcm, sample_rate, bits_per_sample):
    """Write interleaved PCM (numpy int array, shape (n, channels) or
    (n,)) as a WAV file. 8-bit is written unsigned per the WAV spec."""
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape
    nbytes = (bits_per_sample + 7) // 8
    if nbytes not in (1, 2, 3, 4):
        raise ValueError(f"unsupported bits per sample: {bits_per_sample}")

    if nbytes == 1:
        payload = (pcm.astype(np.int16) + 128).astype(np.uint8).tobytes()
    elif nbytes == 2:
        payload = pcm.astype("<i2").tobytes()
    elif nbytes == 4:
        payload = pcm.astype("<i4").tobytes()
    else:  # 24-bit: low 3 bytes of little-endian int32
        as32 = np.ascontiguousarray(pcm.astype("<i4"))
        raw = np.frombuffer(as32.tobytes(), np.uint8).reshape(-1, 4)
        payload = np.ascontiguousarray(raw[:, :3]).tobytes()

    byte_rate = sample_rate * channels * nbytes
    block_align = channels * nbytes
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    fmt = struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, channels, sample_rate,
                      byte_rate, block_align, nbytes * 8)
    data_hdr = struct.pack("<4sI", b"data", len(payload))

    if hasattr(path_or_file, "write"):
        f = path_or_file
        f.write(header + fmt + data_hdr + payload)
    else:
        with open(path_or_file, "wb") as f:
            f.write(header + fmt + data_hdr + payload)
