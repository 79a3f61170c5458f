"""A seed's tracks, assembled from a configuration's pool of frames.

Every seed gets the same set of track lengths (an even grid over the
configuration's range), dealt into the mix's batches the same way, so a
seed changes which pool frames a track holds and the order of the
batches, never the amount of work. A track is the pool frames in the
order drawn from the seed (successive permutations of the pool), each
renumbered, with its CRC-8 and CRC-16 rewritten, behind a STREAMINFO that
holds the frame sizes, the sample count and the MD5 of the PCM, a
VORBIS_COMMENT and 8 KiB of padding (as ``flac`` writes by default).
Nothing of a seed is written to disk.
"""

import hashlib
import struct
from dataclasses import dataclass

import numpy as np

from . import crc

__all__ = ["Track", "track_frames", "assemble_track", "seed_batches",
           "utf8_rows"]

_VENDOR = b"flacbench"
_PADDING = 8192


@dataclass
class Track:
    data: bytes
    #: the pool frame of each of the track's frames.
    order: np.ndarray
    #: decoded samples, counting each channel (the PCM's size).
    samples: int


def track_frames(config, n_tracks):
    """The frame count of each of ``n_tracks`` tracks: lengths on an even
    grid over ``track_seconds`` (both ends included), longest first."""
    lo, hi = config["track_seconds"]
    secs = np.linspace(hi, lo, n_tracks) if n_tracks > 1 else \
        np.array([(lo + hi) / 2])
    return [int(round(s * config["sample_rate"] / config["block_size"]))
            for s in secs]


def _deal(n_tracks, n_batches):
    """Track indices (longest first) dealt back and forth over the
    batches, so the batches' lengths come out close."""
    batches = [[] for _ in range(n_batches)]
    for i in range(n_tracks):
        r, k = divmod(i, n_batches)
        batches[k if r % 2 == 0 else n_batches - 1 - k].append(i)
    return batches


def utf8_rows(values):
    """(n, 6) uint8: each value's UTF-8-like frame number, right-aligned
    (values below 2**31), and each one's length."""
    v = np.asarray(values, np.int64)
    if (v < 0).any() or (v >= 1 << 31).any():
        raise ValueError("frame numbers must lie in [0, 2**31)")
    lens = 1 + (v >= 0x80) + (v >= 0x800) + (v >= 0x10000) \
        + (v >= 0x200000) + (v >= 0x4000000)
    rows = np.zeros((len(v), 6), np.uint8)
    for i in range(5):  # continuation bytes, last first
        use = lens > i + 1
        rows[use, 5 - i] = 0x80 | ((v[use] >> (6 * i)) & 0x3F)
    first_shift = 6 * (lens - 1)
    marker = np.where(lens > 1, (0xFF << (8 - lens)) & 0xFF, 0)
    rows[np.arange(len(v)), 6 - lens] = marker | (v >> first_shift)
    return rows, lens


def _streaminfo(config, frame_lens, n_samples, md5):
    bs = config["block_size"]
    si = struct.pack(">HH", bs, bs)
    si += int(frame_lens.min()).to_bytes(3, "big")
    si += int(frame_lens.max()).to_bytes(3, "big")
    packed = (config["sample_rate"] << 44) | ((config["channels"] - 1) << 41) \
        | ((config["bits_per_sample"] - 1) << 36) | n_samples
    return si + packed.to_bytes(8, "big") + md5


def pcm_md5(pcm, bps):
    """MD5 of interleaved little-endian PCM, ceil(bps / 8) bytes a
    sample, as STREAMINFO stores it."""
    nbytes = (bps + 7) // 8
    raw = np.ascontiguousarray(pcm, "<i4").reshape(-1).view(np.uint8)
    if nbytes < 4:
        raw = np.ascontiguousarray(raw.reshape(-1, 4)[:, :nbytes])
    return hashlib.md5(raw).digest()


def assemble_track(pool, order):
    """The FLAC stream of pool frames ``order``, numbered from 0."""
    config = pool.config
    order = np.asarray(order, np.int64)
    n = len(order)
    nums, num_lens = utf8_rows(np.arange(n))
    tail = pool.tail
    # Headers right-aligned in W columns; the zeros on their left leave
    # both CRCs as they are.
    t = len(tail)
    hl = 4 + num_lens + t
    W = 4 + 6 + t + 1
    head = np.zeros((n, W), np.uint8)
    head[:, W - 1 - t:W - 1] = tail
    # The numbers end where the tail starts; the prefix goes in after
    # them, over the zeros on the left of a short number.
    head[:, W - 7 - t:W - 1 - t] = nums
    rows = np.arange(n)
    for j in range(4):
        head[rows, W - 1 - hl + j] = pool.prefix[order, j]
    head[:, W - 1] = crc.crc8_rows(head[:, :W - 1])
    crc16 = crc.crc16_carry(crc.crc16_rows(head), pool.carry[order]) \
        ^ pool.body_crc[order]
    blen = pool.body_off[order + 1] - pool.body_off[order]
    frame_lens = hl + 1 + blen + 2

    pcm = pool.pcm[order]
    n_samples = n * config["block_size"]
    md5 = pcm_md5(pcm, config["bits_per_sample"])
    si = _streaminfo(config, frame_lens, n_samples, md5)
    vc = struct.pack("<I", len(_VENDOR)) + _VENDOR + struct.pack("<I", 0)
    meta = b"fLaC" + bytes([0]) + len(si).to_bytes(3, "big") + si \
        + bytes([4]) + len(vc).to_bytes(3, "big") + vc \
        + bytes([0x81]) + _PADDING.to_bytes(3, "big") + bytes(_PADDING)

    out = np.empty(len(meta) + int(frame_lens.sum()), np.uint8)
    out[:len(meta)] = np.frombuffer(meta, np.uint8)
    pos = len(meta)
    crc_hi, crc_lo = (crc16 >> 8).astype(np.uint8), (crc16 & 0xFF).astype(
        np.uint8)
    body, body_off = pool.body, pool.body_off
    for i in range(n):
        h = int(hl[i]) + 1
        out[pos:pos + h] = head[i, W - h:]
        pos += h
        a, b = int(body_off[order[i]]), int(body_off[order[i] + 1])
        out[pos:pos + b - a] = body[a:b]
        pos += b - a
        out[pos] = crc_hi[i]
        out[pos + 1] = crc_lo[i]
        pos += 2
    return Track(out.tobytes(), order, n_samples * config["channels"])


def seed_batches(pool, mix, seed):
    """The mix's distinct batches for ``seed``: [[Track, ...], ...]."""
    config = pool.config
    n_batches, per = mix["distinct_batches"], mix["tracks_per_call"]
    lengths = track_frames(config, n_batches * per)
    rng = np.random.default_rng(seed)
    need = sum(lengths)
    reps = -(-need // len(pool))
    stream = np.concatenate([rng.permutation(len(pool)) for _ in range(reps)])
    starts = np.concatenate([[0], np.cumsum(lengths)])
    tracks = [assemble_track(pool, stream[starts[i]:starts[i + 1]])
              for i in range(len(lengths))]
    batches = [[tracks[i] for i in idx] for idx in _deal(len(lengths),
                                                         n_batches)]
    return [batches[i] for i in rng.permutation(n_batches)]
