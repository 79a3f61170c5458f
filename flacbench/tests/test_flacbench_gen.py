"""The frozen encoder, the pool and the per-seed assembler (CPU)."""

import hashlib

import numpy as np
import pytest

from flacbench.gen import assemble, crc, flacgen, pool
from flacbench.reference import flac
from flacbench.tests.tiny import TINY


@pytest.fixture(scope="module")
def tiny_pool():
    config = dict(TINY, name="tiny")
    return pool.Pool(pool.build_pool(config, workers=1), config)


def test_assembled_stream_checks_and_decodes_to_the_pool(tiny_pool):
    order = np.array([3, 1, 0, 7, 7, 2, 5, 6, 4] * 17)
    track = assemble.assemble_track(tiny_pool, order)
    info, pcm = flac.decode_stream(track.data)  # checks CRC-8 and CRC-16
    want = tiny_pool.pcm[order].reshape(-1, 2)
    assert np.array_equal(pcm, want)
    assert info["samples"] == len(want) and track.samples == want.size
    raw = want.astype("<i2").tobytes()
    assert info["md5"] == hashlib.md5(raw).digest()
    assert info["min_block"] == info["max_block"] == 1024


def test_frame_numbers_past_one_byte(tiny_pool):
    # Numbers from 128 take two bytes, from 2048 three.
    order = np.arange(2100) % len(tiny_pool)
    track = assemble.assemble_track(tiny_pool, order)
    info, pos = flac.read_streaminfo(track.data)
    mv = memoryview(track.data)
    numbers = []
    for _ in range(len(order)):
        _pcm, n, number = flac.decode_frame(mv[pos:], 16, info["max_frame"])
        numbers.append(number)
        pos += n
    assert numbers == list(range(len(order))) and pos == len(track.data)


def test_seeds_change_bytes_not_work(tiny_pool):
    mix = {"distinct_batches": 2, "tracks_per_call": 2}
    a = assemble.seed_batches(tiny_pool, mix, 2**31 + 5)
    b = assemble.seed_batches(tiny_pool, mix, 2**31 + 6)
    assert [t.data for x in a for t in x] != [t.data for x in b for t in x]
    assert sorted(t.samples for x in a for t in x) == \
        sorted(t.samples for x in b for t in x)
    again = assemble.seed_batches(tiny_pool, mix, 2**31 + 5)
    assert [t.data for x in a for t in x] == [t.data for x in again
                                             for t in x]


def test_batches_are_dealt_evenly():
    config = {"track_seconds": [180, 300], "sample_rate": 44100,
              "block_size": 4096}
    lengths = assemble.track_frames(config, 12)
    sums = [sum(lengths[i] for i in b) for b in assemble._deal(12, 3)]
    assert max(sums) - min(sums) <= 2
    assert lengths[0] == round(300 * 44100 / 4096)
    assert lengths[-1] == round(180 * 44100 / 4096)


def test_stream_past_2_27_bytes_is_assembled_whole(tiny_pool):
    per = float(np.diff(tiny_pool.body_off).mean()) + 10
    n = int((1 << 27) / per) + 200
    order = np.arange(n) % len(tiny_pool)
    track = assemble.assemble_track(tiny_pool, order)
    assert len(track.data) > 1 << 27
    info, pos = flac.read_streaminfo(track.data)
    assert info["samples"] == n * 1024
    lens = np.diff(tiny_pool.body_off)[order] + 4 + 1 + 2 \
        + assemble.utf8_rows(np.arange(n))[1]
    assert pos + int(lens.sum()) == len(track.data)
    mv = memoryview(track.data)
    last = pos + int(lens[:-1].sum())
    pcm, size, number = flac.decode_frame(mv[last:], 16, info["max_frame"])
    assert number == n - 1 and last + size == len(track.data)
    assert np.array_equal(pcm, tiny_pool.pcm[order[-1]])


def test_utf8_rows_match_the_encoder():
    values = [0, 1, 127, 128, 2047, 2048, 65535, 65536, 2**21 - 1, 2**21,
              2**26 - 1, 2**26, 2**31 - 1]
    rows, lens = assemble.utf8_rows(values)
    for v, row, n in zip(values, rows, lens):
        assert bytes(row[6 - n:]) == flacgen.utf8_number(v)


def test_crc16_carry_composes():
    rng = np.random.default_rng(3)
    heads = rng.integers(0, 256, (5, 9), dtype=np.uint8)
    bodies = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 17, 300, 4099)]
    basis = crc.crc16_carry_basis([len(b) for b in bodies])
    got = crc.crc16_carry(crc.crc16_rows(heads), basis) \
        ^ np.array([crc.crc16(b) for b in bodies], np.uint32)
    want = [crc.crc16(h.tobytes() + b) for h, b in zip(heads, bodies)]
    assert got.tolist() == want
    assert crc.crc8_rows(heads).tolist() == [crc.crc8(h.tobytes())
                                             for h in heads]


def test_hi_res_residuals_take_rice2():
    # 24-bit noise needs Rice parameters above 14: libFLAC codes them as
    # RICE2, and so does the frozen encoder.
    pcm = flacgen.synth_music(4096, 2, 24, seed=1, sample_rate=96000)
    frame = flacgen.encode_frame(pcm, 96000, 24, 0, 12, 6)
    decoded, size, _ = flac.decode_frame(frame)
    assert size == len(frame) and np.array_equal(decoded, pcm)
    po, params, rice2 = flacgen._plan_residual(np.diff(pcm[:, 0]), 4096,
                                               1, 6)
    assert rice2 and max(params) > 14
