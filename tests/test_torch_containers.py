"""The port's container layer (claxon_tpu_torch.containers and
claxon_tpu_torch.testing.containers_gen, device="cpu") against the JAX
package's: muxed bytes, demux results, decoded PCM with frame times and
sizes, and the errors of malformed containers by class name and message.
Equality is exact.

One stream at one block size serves the Ogg and the MP4 cases, so the JAX
side compiles its bucket program once for the file.
"""

import inspect
import struct

import numpy as np
import pytest

import claxon_tpu.containers as jc
from claxon_tpu import native as jnative
from claxon_tpu import testing as jtesting
from claxon_tpu.error import Error as RefError

import claxon_tpu_torch as ct
import claxon_tpu_torch.containers as tc
import claxon_tpu_torch.pipeline_bits as tpb
from claxon_tpu_torch import native as tnative
from claxon_tpu_torch import testing as ttesting
from claxon_tpu_torch.ops import epilogue as tepilogue
from claxon_tpu_torch.testing.containers_gen import _box

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="native core not built")


def _flac(n=9000, seed=77):
    pcm = jtesting.synth_music(n, channels=2, bps=16, seed=seed)
    return encode(pcm)


def encode(pcm):
    return jtesting.encode_flac(pcm, 44100, 16, block_size=1024,
                                tags=(("TITLE", "t"), ("ARTIST", "a")))


def _same(got, ref):
    assert np.array_equal(got.pcm, ref.pcm)
    assert got.frame_times == ref.frame_times
    assert got.frame_sizes == ref.frame_sizes
    assert got.streaminfo.md5sum == ref.streaminfo.md5sum


def _slack_mp4(flac):
    """An MP4 with 17 bytes of 0xEE after each chunk of 3 frames (the
    layout of tests/test_containers.py's slack case)."""
    blocks, frames = ttesting.split_flac(flac)
    chunks = [b"".join(frames[i:i + 3]) for i in range(0, len(frames), 3)]
    dfla = _box(b"dfLa", b"\x00\x00\x00\x00" + b"".join(blocks))
    entry = _box(b"fLaC", b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 8 +
                 struct.pack(">HHHHI", 2, 16, 0, 0, 44100 << 16) + dfla)
    stsd = _box(b"stsd", struct.pack(">II", 0, 1) + entry)
    entries = [(1, 3, 1)]
    if len(frames) % 3:
        entries.append((len(chunks), len(frames) % 3, 1))
    stsc = _box(b"stsc", struct.pack(">II", 0, len(entries)) +
                b"".join(struct.pack(">III", *e) for e in entries))
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2")

    def moov(offs):
        stco = _box(b"stco", struct.pack(">II", 0, len(offs)) +
                    b"".join(struct.pack(">I", o) for o in offs))
        return _box(b"moov", _box(b"trak", _box(b"mdia", _box(
            b"minf", _box(b"stbl", stsd + stsc + stco)))))

    payload, offs = bytearray(), []
    base = len(ftyp) + len(moov([0] * len(chunks))) + 8
    for c in chunks:
        offs.append(base + len(payload))
        payload += c + b"\xEE" * 17
    return ftyp + moov(offs) + _box(b"mdat", bytes(payload))


@pytest.mark.parametrize("case", ["split", "ogg", "mp4_1", "mp4_3"])
def test_muxers_are_byte_identical(case):
    """The port's muxers take their frame spans from the C++ walk, not
    from a Python frame reader, and write the same bytes."""
    flac = _flac()
    if case == "split":
        blocks, frames = ttesting.split_flac(flac)
        assert (blocks, frames) == jtesting.split_flac(flac)
        assert b"fLaC" + b"".join(blocks) + b"".join(frames) == flac
    elif case == "ogg":
        assert ttesting.mux_ogg_flac(flac) == jtesting.mux_ogg_flac(flac)
    else:
        k = int(case[-1])
        assert ttesting.mux_mp4_flac(flac, frames_per_chunk=k) == \
            jtesting.mux_mp4_flac(flac, frames_per_chunk=k)


def test_decode_ogg_matches_jax():
    flac = _flac()
    ogg = ttesting.mux_ogg_flac(flac)
    got = ct.decode_ogg_stream(ogg, device="cpu")
    _same(got, jc.decode_ogg_stream(ogg))
    assert np.array_equal(got.pcm, tnative.decode_stream_scalar(flac)[1])
    assert ttesting.pcm_md5(got.pcm, 16) == got.streaminfo.md5sum
    # Page CRCs unverified, and a file-like input: the same result.
    import io
    _same(tc.decode_ogg_stream(io.BytesIO(ogg), verify_crc=False,
                               device="cpu"), got)


@pytest.mark.parametrize("layout", ["chunks_of_1", "chunks_of_3", "slack"])
def test_decode_mp4_matches_jax(layout):
    flac = _flac()
    mp4 = _slack_mp4(flac) if layout == "slack" else ttesting.mux_mp4_flac(
        flac, frames_per_chunk=int(layout[-1]))
    got = ct.decode_mp4_stream(mp4, device="cpu")
    _same(got, jc.decode_mp4_stream(mp4))
    assert np.array_equal(got.pcm, tnative.decode_stream_scalar(flac)[1])


def _patch_u32(data, tag, at, value):
    """``data`` with the big-endian u32 ``at`` bytes after box ``tag``'s
    type field replaced."""
    i = data.index(tag) + 4 + at
    return data[:i] + struct.pack(">I", value) + data[i + 4:]


def _ogg_page_crc_corrupt():
    ogg = bytearray(ttesting.mux_ogg_flac(_flac(n=2000)))
    ogg[len(ogg) // 2] ^= 0xFF
    return "ogg", bytes(ogg)


def _ogg_empty():
    return "ogg", b""


def _ogg_truncated_page():
    return "ogg", b"OggS" + b"\x00" * 23


def _ogg_missing_header_packets():
    from claxon_tpu_torch.testing.containers_gen import _ogg_pages

    blocks, _frames = ttesting.split_flac(_flac(n=2000))
    id_packet = (bytes([0x7F]) + b"FLAC" + bytes([1, 0]) +
                 struct.pack(">H", 3) + b"fLaC" + blocks[0])
    return "ogg", b"".join(_ogg_pages([id_packet]))


def _ogg_frame_crc_corrupt():
    """A stored frame CRC-16 flipped inside an intact page (the page CRC
    recomputed by the muxer): only the device CRC check can see it."""
    flac = bytearray(_flac(n=3000))
    flac[-1] ^= 0xFF
    return "ogg", ttesting.mux_ogg_flac(bytes(flac))


def _mp4_empty():
    return "mp4", b""


def _mp4_bad_box_size():
    return "mp4", _box(b"ftyp", b"isomAAAA") + b"\x00\x00\x00\x01moov\xff\xff"


def _mp4_stsc_count_overruns():
    return "mp4", _box(b"ftyp", b"isomAAAA") + _box(b"moov", _box(
        b"trak", _box(b"mdia", _box(b"minf", _box(
            b"stbl",
            _box(b"stsd", struct.pack(">II", 0, 1) + _box(
                b"fLaC", b"\x00" * 28 + _box(b"dfLa", b"\x00" * 4))) +
            _box(b"stsc", struct.pack(">II", 0, 0xFFFFFFF0)) +
            _box(b"stco", struct.pack(">II", 0, 1)
                 + struct.pack(">I", 0)))))))


def _mp4_no_flac_track():
    return "mp4", b"\x00\x00\x00\x10ftypisom\x00\x00\x02\x00"


def _mp4_short_chunk():
    """Every chunk declares 4 frames and holds 3."""
    mp4 = ttesting.mux_mp4_flac(_flac(), frames_per_chunk=3)
    return "mp4", _patch_u32(mp4, b"stsc", 12, 4)


def _mp4_bad_chunk_offset():
    mp4 = ttesting.mux_mp4_flac(_flac(), frames_per_chunk=3)
    return "mp4", _patch_u32(mp4, b"stco", 8 + 4, 0xFFFFFFF0)


def _mp4_crc_before_truncated_chunk():
    """A CRC-corrupt frame in chunk 0 and a file truncated inside the last
    chunk: the sequential reference hits the CRC failure first."""
    mp4 = bytearray(ttesting.mux_mp4_flac(_flac(), frames_per_chunk=2))
    track = tc.read_flac_from_mp4(bytes(mp4))
    off0 = track.chunk_offsets[0]
    used = []
    tnative.extract_frames_bits(memoryview(bytes(mp4))[off0:],
                                emit_slots=False, max_frames=1,
                                consumed=used)
    mp4[off0 + used[0] - 1] ^= 0xFF
    return "mp4", bytes(mp4[:max(track.chunk_offsets) + 4])


def _mp4_crc_before_bad_offset():
    """A CRC-corrupt frame in chunk 0 and an invalid offset for chunk 1."""
    mp4 = bytearray(ttesting.mux_mp4_flac(_flac(), frames_per_chunk=3))
    mp4[tc.read_flac_from_mp4(bytes(mp4)).chunk_offsets[1] - 1] ^= 0xFF
    return "mp4", _patch_u32(bytes(mp4), b"stco", 8 + 4, 0xFFFFFFF0)


MALFORMED = [_ogg_page_crc_corrupt, _ogg_empty, _ogg_truncated_page,
             _ogg_missing_header_packets, _ogg_frame_crc_corrupt, _mp4_empty,
             _mp4_bad_box_size, _mp4_stsc_count_overruns, _mp4_no_flac_track,
             _mp4_short_chunk, _mp4_bad_chunk_offset,
             _mp4_crc_before_truncated_chunk, _mp4_crc_before_bad_offset]
EXPECT = {"_ogg_page_crc_corrupt": "Ogg page CRC mismatch",
          "_ogg_missing_header_packets": "header packets",
          "_ogg_frame_crc_corrupt": "frame CRC mismatch",
          "_mp4_short_chunk": "MP4 chunk ends before its declared frame "
                              "count",
          "_mp4_bad_chunk_offset": "invalid MP4 chunk offset",
          "_mp4_crc_before_truncated_chunk": "frame CRC mismatch",
          "_mp4_crc_before_bad_offset": "frame CRC mismatch"}


@pytest.mark.parametrize("make", MALFORMED, ids=lambda f: f.__name__[1:])
def test_malformed_containers_raise_the_same_errors(make):
    """Each malformed container raises in the port an error of the JAX
    package's class name with its message, the deferred frame CRC check
    winning over a later chunk's error as in sequential decode."""
    fmt, data = make()
    jfn, tfn = ((jc.decode_ogg_stream, tc.decode_ogg_stream) if fmt == "ogg"
                else (jc.decode_mp4_stream, tc.decode_mp4_stream))
    with pytest.raises(RefError) as ref:
        jfn(data)
    with pytest.raises(ct.Error) as got:
        tfn(data, device="cpu")
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)
    assert EXPECT.get(make.__name__, "") in str(got.value)


@pytest.mark.parametrize("fmt", ["ogg", "mp4_3", "mp4_one_chunk"])
def test_payload_above_the_byte_limit_decodes(monkeypatch, fmt):
    """A frame section of MAX_BATCH_BYTES or more decodes in walk units
    below the limit, equal to the unsplit decode: an Ogg payload walks in
    chunks of frames, an MP4's chunks group into units, and one MP4 chunk
    that large walks in chunks itself. No warning: no path is switched."""
    import warnings

    flac = _flac()
    if fmt == "ogg":
        data, fn = ttesting.mux_ogg_flac(flac), tc.decode_ogg_stream
    else:
        k = 3 if fmt == "mp4_3" else 100
        data, fn = ttesting.mux_mp4_flac(flac, frames_per_chunk=k), \
            tc.decode_mp4_stream
    whole = fn(data, device="cpu")
    monkeypatch.setattr(tpb, "MAX_BATCH_BYTES", len(flac) // 4)
    runs = []
    decode = tpb.decode_raw_bits_device
    monkeypatch.setattr(tpb, "decode_raw_bits_device",
                        lambda *a, **kw: runs.append(1) or decode(*a, **kw))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = fn(data, device="cpu")
    assert len(runs) >= 4
    _same(got, whole)
    assert np.array_equal(got.pcm, tnative.decode_stream_scalar(flac)[1])

    # A corrupted stored CRC in a late unit still raises.
    bad = bytearray(flac)
    bad[-1] ^= 0xFF
    bad = ttesting.mux_ogg_flac(bytes(bad)) if fmt == "ogg" else \
        ttesting.mux_mp4_flac(bytes(bad), frames_per_chunk=k)
    with pytest.raises(ct.FormatError, match="frame CRC mismatch"):
        fn(bad, device="cpu")


@pytest.mark.parametrize("name", ["decode_ogg_stream", "decode_mp4_stream"])
def test_entry_point_contract(name):
    """Exported at the package root, on the card by default, the Python
    extractor route (use_native=False) decoding the same PCM, and the
    fetch going through K3b's plain form on the CPU (no kernel launch is
    counted)."""
    fn = getattr(ct, name)
    assert fn is getattr(tc, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    flac = _flac(n=2000)
    data = ttesting.mux_ogg_flac(flac) if "ogg" in name else \
        ttesting.mux_mp4_flac(flac)
    assert np.array_equal(fn(data, use_native=False, device="cpu").pcm,
                          tnative.decode_stream_scalar(flac)[1])
    before = (tepilogue.pack_int16_pairs.launches,
              tepilogue.unpack_int16_pairs.launches)
    dec = fn(data, device="cpu")
    assert np.array_equal(dec.pcm, tnative.decode_stream_scalar(flac)[1])
    assert (tepilogue.pack_int16_pairs.launches,
            tepilogue.unpack_int16_pairs.launches) == before
