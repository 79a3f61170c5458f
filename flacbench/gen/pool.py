"""A configuration's pool of encoded frames, built once per checkout.

Encoding a seed's tracks on every run would take minutes (the encoder is
Python), so the first run encodes a fixed pool of distinct frames from
fixed seeds and caches it under ``build/flacbench/``; every run then
assembles its seed's tracks from pool frames (``assemble``). The plain
reference decodes every pool frame when the pool is built; its PCM is
kept with the pool, and the build fails unless it equals the audio that
was encoded.

The cache file is named by a hash of the pool's settings and of the
sources of the encoder and the reference, so a change to either builds a
new pool; a pool is written under a temporary name and renamed.
"""

import hashlib
import json
import multiprocessing
import os
import pathlib

import numpy as np

from . import crc
from .flacgen import encode_frame, synth_music

__all__ = ["Pool", "load_pool", "pool_path"]

_HERE = pathlib.Path(__file__).resolve().parent
ROOT = _HERE.parent.parent
CACHE_DIR = ROOT / "build" / "flacbench"
#: the configuration keys that shape a pool.
POOL_KEYS = ("sample_rate", "bits_per_sample", "channels", "block_size",
             "max_lpc_order", "max_partition_order", "pool_frames",
             "pool_segment_frames", "pool_seed")


#: the sources a pool depends on: the encoder, the checksums, this file
#: and the reference that decodes the pool.
_SOURCES = (_HERE / "flacgen.py", _HERE / "crc.py", _HERE / "pool.py",
            _HERE.parent / "reference" / "flac.py")


def _sources():
    h = hashlib.sha256()
    for p in _SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def pool_path(config):
    key = json.dumps({k: config[k] for k in POOL_KEYS}, sort_keys=True)
    digest = hashlib.sha256((key + _sources()).encode()).hexdigest()[:16]
    return CACHE_DIR / f"pool-{config['name']}-{digest}.npz"


class Pool:
    """The frames of a pool, split at the frame number: every frame is
    ``prefix`` (4 bytes: sync, block size and rate codes, channel
    assignment and depth), its number, ``tail`` (block size or rate
    bytes the codes leave out; the same for every frame), the CRC-8,
    ``body`` (the subframes), the CRC-16."""

    def __init__(self, arrays, config):
        self.config = config
        self.prefix = arrays["prefix"]          # (N, 4) uint8
        self.tail = arrays["tail"]              # (t,) uint8
        self.body = arrays["body"]              # all bodies, uint8
        self.body_off = arrays["body_off"]      # (N + 1,) int64
        self.body_crc = arrays["body_crc"]      # (N,) CRC-16 of each body
        self.carry = arrays["carry"]            # (N, 16) crc16_carry basis
        self.pcm = arrays["pcm"]                # (N, bs, ch) int32
        #: (N,) each frame's longest Rice code in bits, by the reference
        self.longest_code = arrays["longest_code"]

    def __len__(self):
        return len(self.prefix)


def _split(frame):
    """(prefix, tail, body) of a frame numbered 0 (one number byte)."""
    bs_code, sr_code = frame[2] >> 4, frame[2] & 15
    tail_len = {6: 1, 7: 2}.get(bs_code, 0) + {12: 1, 13: 2, 14: 2}.get(
        sr_code, 0)
    head = 4 + 1 + tail_len
    return frame[:4], frame[5:head], frame[head + 1:-2]


def _encode_segment(args):
    """Encode one segment of the pool: (frames, pcm)."""
    config, index = args
    bs, ch = config["block_size"], config["channels"]
    n = config["pool_segment_frames"]
    pcm = synth_music(n * bs, ch, config["bits_per_sample"],
                      seed=config["pool_seed"] + index,
                      sample_rate=config["sample_rate"])
    frames = [encode_frame(pcm[i * bs:(i + 1) * bs], config["sample_rate"],
                           config["bits_per_sample"], 0,
                           config["max_lpc_order"],
                           config["max_partition_order"])
              for i in range(n)]
    return frames, pcm.reshape(n, bs, ch)


def _decode_frames(frames):
    """[(pcm, longest Rice code), ...] of ``frames`` by the reference."""
    from ..reference.flac import decode_frame

    out = []
    for f in frames:
        stats = {}
        out.append((decode_frame(f, stats=stats)[0], stats["longest_code"]))
    return out


def _workers(n_tasks):
    return max(1, min(n_tasks, os.cpu_count() or 1, 8))


def build_pool(config, workers=None):
    """Encode the pool, decode it with the plain reference, and return the
    arrays of a :class:`Pool`."""
    n_seg = config["pool_frames"] // config["pool_segment_frames"]
    if n_seg * config["pool_segment_frames"] != config["pool_frames"]:
        raise ValueError("pool_frames must be a multiple of "
                         "pool_segment_frames")
    tasks = [(config, i) for i in range(n_seg)]
    workers = workers or _workers(n_seg)
    if workers > 1:
        mp = multiprocessing.get_context("spawn").Pool(workers)
        try:
            parts = mp.map(_encode_segment, tasks)
            decoded = mp.map(_decode_frames, [p[0] for p in parts])
            mp.close()
        finally:
            mp.terminate()
            mp.join()
    else:
        parts = [_encode_segment(t) for t in tasks]
        decoded = [_decode_frames(p[0]) for p in parts]
    frames = [f for p, _ in parts for f in p]
    pcm = np.concatenate([p for _, p in parts])
    ref = np.stack([d for part in decoded for d, _ in part])
    if not np.array_equal(ref, pcm):
        raise AssertionError("the plain reference does not decode the pool "
                             "to the audio that was encoded")
    splits = [_split(f) for f in frames]
    bodies = [b for _, _, b in splits]
    lengths = np.array([len(b) for b in bodies], np.int64)
    body_crc = np.array([crc.crc16(b) for b in bodies], np.uint32)
    return {
        "prefix": np.frombuffer(b"".join(p for p, _, _ in splits),
                                np.uint8).reshape(-1, 4),
        "tail": np.frombuffer(splits[0][1], np.uint8),
        "body": np.frombuffer(b"".join(bodies), np.uint8),
        "body_off": np.concatenate([[0], np.cumsum(lengths)]),
        "body_crc": body_crc,
        "carry": crc.crc16_carry_basis(lengths),
        "pcm": ref.astype(np.int32),
        "longest_code": np.array([c for part in decoded for _, c in part],
                                 np.int32),
    }


def load_pool(config, log=None):
    """The configuration's pool: from the cache, or built and cached.
    Returns (Pool, seconds spent building, 0 when it was cached)."""
    import time

    path = pool_path(config)
    built = 0.0
    if not path.exists():
        t0 = time.perf_counter()
        if log:
            log(f"building the pool of {config['name']} ({path.name})")
        arrays = build_pool(config)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        built = time.perf_counter() - t0
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return Pool(arrays, config), built
