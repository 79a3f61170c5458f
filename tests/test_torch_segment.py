"""K5, the port's sync scan (claxon_tpu_torch.ops.segment), in its plain
PyTorch form against the JAX package's ``find_frame_headers`` on the same
stream words. Tolerance 0: positions, validity, the count (which may
exceed the capacity) and every window byte are equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from claxon_tpu import native
from claxon_tpu.ops.segment import find_frame_headers as jax_find
from claxon_tpu.testing import encode_flac, synth_music

from claxon_tpu_torch.ops import seg_parse, segment

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")


def _words(payload):
    buf = np.frombuffer(bytes(payload), np.uint8)
    pad = np.zeros((-len(buf)) % 4, np.uint8)
    return np.concatenate([buf, pad]).view(">i4").astype(np.int32)


def _payload(data):
    from claxon_tpu.native.binding import _read_metadata

    return data[_read_metadata(data)[1]:]


def _assert_same(words, n_bytes, C):
    want = jax_find(jnp.asarray(words), n_bytes, C)
    got = segment.find_frame_headers(torch.from_numpy(words), n_bytes, C)
    for name, a, b in zip(("positions", "valid", "count", "win"), want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), name
        assert np.array_equal(a, b.numpy()), name
    return int(got[2])


def _saturated(n, seed):
    """n bytes of 0xFF and 0xF8, half each: a sync hit at every FF F8."""
    rng = np.random.default_rng(seed)
    return bytes(np.where(rng.random(n) < 0.5, 0xFF, 0xF8)
                 .astype(np.uint8))


@pytest.mark.parametrize("case", ["stream", "stream_overflow", "saturated",
                                  "noise_short_nbytes"])
def test_sync_scan_matches_jax(case):
    if case.startswith("stream"):
        pcm = synth_music(2500, channels=2, bps=16, seed=21)
        payload = _payload(encode_flac(pcm, 44100, 16, block_size=576,
                                       stereo="left_side"))
        C = 3 if case == "stream_overflow" else 64
        count = _assert_same(_words(payload), len(payload), C)
        assert count >= 5
        if case == "stream_overflow":
            assert count > C  # the count reports every hit past C
    elif case == "saturated":
        payload = _saturated(3000, 3)
        count = _assert_same(_words(payload), len(payload), 1024)
        assert count > 500
    else:
        rng = np.random.default_rng(8)
        words = rng.integers(-(1 << 31), 1 << 31, 400, dtype=np.int64) \
            .astype(np.int32)
        words[::5] = np.int32(-0x00070001)  # 0xFFF8FFFF
        # n_bytes below the upload: hits in the tail must not count.
        _assert_same(words, 4 * 400 - 37, 128)


@pytest.mark.parametrize("payload, n_bytes", [
    (b"", 0), (b"\xff", 1), (b"\xff\xf8", 2), (b"\xff\xf8\xff", 3),
    (b"\x00\xff\xf8\x00\xff\xf9", 6)])
def test_sync_scan_empty_and_tiny_streams(payload, n_bytes):
    words = _words(payload) if payload else np.zeros(0, np.int32)
    _assert_same(words, n_bytes, 8)


def test_bswap_plain_matches_numpy():
    rng = np.random.default_rng(9)
    words = rng.integers(-(1 << 31), 1 << 31, 1000, dtype=np.int64) \
        .astype(np.int32)
    got = seg_parse.bswap_words_plain(torch.from_numpy(words)).numpy()
    assert np.array_equal(got, words.byteswap())
