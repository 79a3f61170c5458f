"""Test and smoke utilities of the port (a copy of ``claxon_tpu.testing``'s
encoder, container muxers and MD5 helper). Not part of the decoder API
surface.

``flacgen`` is a spec-derived FLAC *encoder* that generates corpora with
known PCM and a genuine STREAMINFO MD5, so a decode that reproduces the
MD5 is bit-exact.
"""

from .containers_gen import mux_mp4_flac, mux_ogg_flac, split_flac
from .flacgen import encode_flac, synth_music


def pcm_md5(samples_interleaved, bits_per_sample):
    """MD5 of the unencoded audio data, as stored in STREAMINFO: samples
    interleaved, little-endian, ceil(bps/8) bytes each (reference
    `src/lib.rs` STREAMINFO semantics)."""
    import hashlib

    import numpy as np

    nbytes = (bits_per_sample + 7) // 8
    raw = np.ascontiguousarray(samples_interleaved, dtype="<i4").tobytes()
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 4)[:, :nbytes]
    return hashlib.md5(arr.tobytes()).digest()


__all__ = ["encode_flac", "synth_music", "pcm_md5", "split_flac",
           "mux_ogg_flac", "mux_mp4_flac"]
