"""The port's own copy of the host layer (``claxon_tpu_torch.native``,
``metadata``, ``containers``, ``error`` and ``testing``) against the JAX
package's originals: the C++ boundary walk field by field, the scalar
decoder, the reader's single-frame decode, the bulk CRC-16 and the
metadata parse on the generated corpus and encoded streams; the tag
iterators and seek-table types; the batch merge and the container
demuxers field by field; the encoder byte for byte; and the errors of
malformed inputs by class name and message. Equality is exact. (The
reader API, the Python extractor and the FrameDesc dispatch are held to
theirs in tests/test_torch_reader.py and tests/test_torch_extract.py.)"""

import dataclasses
import pathlib

import numpy as np
import pytest

from claxon_tpu import native as jnative
from claxon_tpu import testing as jtesting
from claxon_tpu.error import Error as RefError
from claxon_tpu.native.binding import _read_metadata as j_read_metadata

import claxon_tpu_torch as ct
from claxon_tpu_torch import native as tnative
from claxon_tpu_torch import testing as ttesting
from claxon_tpu_torch.native.binding import _read_metadata as t_read_metadata

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="native core not built")

GENERATED = pathlib.Path(__file__).resolve().parents[1] / "testsamples" / \
    "generated"
ENCODED = {
    "encoded_lpc12_1152": dict(block_size=1152, max_lpc_order=12,
                               partition_order=4),
    "encoded_fixed_rice2": dict(block_size=4096, force_subframe="fixed",
                                rice2=True, partition_order=3),
}
STREAMS = sorted(p.name for p in GENERATED.glob("*.flac")) + sorted(ENCODED)


def _stream(name):
    if name in ENCODED:
        pcm = jtesting.synth_music(6000, channels=2, bps=16,
                                   seed=len(name))
        return jtesting.encode_flac(pcm, 44100, 16, **ENCODED[name])
    return (GENERATED / name).read_bytes()


@pytest.mark.parametrize("name", STREAMS)
def test_boundary_walk_matches_jax(name):
    """extract_stream_bits, as the port calls it and with the defaults:
    every frame and subframe record, the Rice parameters, the code
    lengths, the chunk bases and the samples of fallback frames are
    equal. (The slot words are not compared here: the core leaves the
    words past each chunk's codes unwritten. The words that hold codes
    are compared in the delta planner's uploads,
    tests/test_torch_pipeline.py::test_planner_uploads_are_byte_identical.)
    """
    data = _stream(name)
    for kw in (dict(emit_slots=False, defer_crc=True), {}):
        jsi, jbb = jnative.extract_stream_bits(data, **kw)
        tsi, tbb = tnative.extract_stream_bits(data, **kw)
        assert dataclasses.astuple(jsi) == dataclasses.astuple(tsi)
        assert jbb.bframes.dtype == tbb.bframes.dtype
        assert jbb.bsubs.dtype == tbb.bsubs.dtype
        for field in ("bframes", "bsubs", "ks", "bases", "deltas",
                      "samples"):
            assert np.array_equal(getattr(jbb, field),
                                  getattr(tbb, field)), field
        assert bytes(jbb.payload) == bytes(tbb.payload)


@pytest.mark.parametrize("name", STREAMS)
def test_scalar_decode_and_metadata_match_jax(name):
    data = _stream(name)
    jsi, jpos = j_read_metadata(data)
    tsi, tpos = t_read_metadata(data)
    assert jpos == tpos
    assert dataclasses.astuple(jsi) == dataclasses.astuple(tsi)
    _jsi, jpcm = jnative.decode_stream_scalar(data)
    _tsi, tpcm = tnative.decode_stream_scalar(data)
    assert np.array_equal(jpcm, tpcm)
    if tsi.md5sum != b"\x00" * 16:
        assert ttesting.pcm_md5(tpcm, tsi.bits_per_sample) == tsi.md5sum


@pytest.mark.parametrize("name", STREAMS)
def test_decode_frames_limited_matches_jax(name):
    """The FrameReader fast path's entry: one, three and every frame from
    the first frame on, and a window cut mid-frame, whose IoError (the
    reader's "read more" signal) is the same."""
    from claxon_tpu.error import Error as JError

    data = _stream(name)
    _si, pos = t_read_metadata(data)
    section = memoryview(data)[pos:]
    for window, n in ((section, 1), (section, 3), (section, 1 << 30),
                      (section[:len(section) // 2], 1 << 30)):
        try:
            want = jnative.decode_frames_limited(window, n)
        except JError as e:
            with pytest.raises(ct.Error) as got:
                tnative.decode_frames_limited(window, n)
            assert (type(got.value).__name__, str(got.value)) == \
                (type(e).__name__, str(e))
            continue
        got = tnative.decode_frames_limited(window, n)
        assert got[0] == want[0]
        assert got[1].dtype == want[1].dtype
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])


def test_tag_iterators_and_seek_types_match_jax():
    """Tags and GetTag over raw comments (ASCII-only case folding: the
    Kelvin sign never matches 'k'), and SeekPoint / SeekTable."""
    from claxon_tpu import metadata as jm

    from claxon_tpu_torch import metadata as tm

    raw = [("ARTIST=Queen", 6), ("artist=Bowie", 6), ("TITLE=x", 5),
           ("KEY=v", 3), ("\u212aey=w", 3), ("=empty", 0)]
    assert list(tm.Tags(raw)) == list(jm.Tags(raw))
    assert len(tm.Tags(raw)) == len(jm.Tags(raw)) == 6
    for needle in ("artist", "Artist", "key", "\u212aey", "", "TITLE",
                   "missing"):
        assert list(tm.GetTag(raw, needle)) == list(jm.GetTag(raw, needle))
        assert tm._eq_ignore_ascii_case(needle, "KEY") == \
            jm._eq_ignore_ascii_case(needle, "KEY")
    assert list(tm.GetTag(raw, "key")) == ["v"]
    point = tm.SeekPoint(sample=1, offset=2, samples=3)
    assert dataclasses.astuple(point) == dataclasses.astuple(
        jm.SeekPoint(sample=1, offset=2, samples=3))
    assert tm.SeekTable().seekpoints == jm.SeekTable().seekpoints == []
    assert set(jm.__all__) <= set(tm.__all__)


def test_pack_coefficients_matches_jax():
    from claxon_tpu.ops.predict import pack_coefficients as j_pack

    from claxon_tpu_torch.ops.predict import pack_coefficients as t_pack

    rng = np.random.default_rng(31)
    lists = [rng.integers(-2**15, 2**15, n).astype(np.int32)
             for n in (0, 1, 4, 12, 32)] + [[], [3, -4]]
    got, want = t_pack(lists), j_pack(lists)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_host_header_fields_matches_jax():
    """``pipeline_seg.host_header_fields``, the port's numpy copy, equals
    the JAX package's on every frame start of the generated corpus, on
    random buffers at random positions, and at the last 20 positions of
    a buffer, where its 16-byte window clamps to the last byte."""
    import claxon_tpu.pipeline_seg as jseg

    import claxon_tpu_torch.pipeline_seg as tseg

    rng = np.random.default_rng(17)
    cases = []
    for name in STREAMS[:4]:
        data = _stream(name)
        si, bb = jnative.extract_stream_bits(data, emit_slots=False)
        payload = np.frombuffer(data, np.uint8)[j_read_metadata(data)[1]:]
        cases.append((payload, bb.bframes["byte0"]))
    for n in (1, 17, 300):
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        buf[rng.integers(0, n, max(1, n // 10))] = 0xFF  # sync-like bytes
        cases.append((buf, rng.integers(0, n, 64)))
        cases.append((buf, np.arange(max(0, n - 20), n)))
    cases.append((np.zeros(8, np.uint8), np.zeros(0, np.int64)))
    for buf, pos in cases:
        want = jseg.host_header_fields(buf, pos)
        got = tseg.host_header_fields(buf, pos)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), key
    assert "host_header_fields" in tseg.__all__


def test_native_build_knobs_match_jax(monkeypatch, tmp_path):
    """``CLAXON_TPU_NO_BUILD`` and ``CLAXON_TPU_UBSAN`` in the port's
    ``native/build.py`` as in the JAX package's: with NO_BUILD an existing
    library loads and a missing one gives None, never a build; UBSAN
    selects ``libclaxon_demux_ubsan.so``, built with the same g++ flags as
    the JAX package's sanitizer build."""
    import subprocess

    from claxon_tpu.native import build as jbuild

    from claxon_tpu_torch.native import build as tbuild

    assert tbuild.LIB_UBSAN.name == jbuild.LIB_UBSAN.name
    commands = {}

    def fake_run(cmd, **_kw):
        commands.setdefault(mod, []).append(cmd)
        pathlib.Path(cmd[-1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    for mod in (jbuild, tbuild):
        monkeypatch.setattr(mod, "LIB", tmp_path / f"{mod.__name__}.so")
        monkeypatch.setattr(mod, "LIB_UBSAN",
                            tmp_path / f"{mod.__name__}_ubsan.so")
        for ubsan in (False, True):
            assert mod.build(verbose=False, ubsan=ubsan) == \
                (mod.LIB_UBSAN if ubsan else mod.LIB)
    flags = {m: [c[1:-3] for c in cmds] for m, cmds in commands.items()}
    assert flags[tbuild] == flags[jbuild]
    assert "-fsanitize=undefined" in flags[tbuild][-1]

    monkeypatch.setenv("CLAXON_TPU_NO_BUILD", "1")
    for ubsan in ("", "1"):
        monkeypatch.setenv("CLAXON_TPU_UBSAN", ubsan)
        for mod in (jbuild, tbuild):
            lib = mod.LIB_UBSAN if ubsan else mod.LIB
            assert mod.ensure_built() == lib
            lib.unlink()
            n = len(commands[mod])
            assert mod.ensure_built() is None
            assert len(commands[mod]) == n  # nothing was built
    monkeypatch.delenv("CLAXON_TPU_NO_BUILD")
    monkeypatch.setenv("CLAXON_TPU_UBSAN", "1")
    for mod in (jbuild, tbuild):
        assert mod.ensure_built() == mod.LIB_UBSAN
        assert "-fsanitize=undefined" in commands[mod][-1]


def test_crc16_bytes_matches_jax():
    rng = np.random.default_rng(12)
    for n in (0, 1, 7, 8, 9, 100, 4099):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tnative.crc16_bytes(raw) == jnative.crc16_bytes(raw)


def test_pack_bits_be_matches_jax():
    """The port's copy of rice_decode's host helper."""
    from claxon_tpu.ops.rice import pack_bits_be as j_pack

    from claxon_tpu_torch.ops.rice import pack_bits_be as t_pack

    rng = np.random.default_rng(29)
    for n in range(10):
        for _ in range(3):
            raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            got, want = t_pack(raw), j_pack(raw)
            assert got.dtype == want.dtype == np.int32
            assert np.array_equal(got, want)


def test_route_tables_match_jax():
    """The port's copies of the tables and knob readers of the entropy
    routes: the segmented path's SA and P classes, the delta-mode meta
    width, and the modes each knob value selects."""
    import os

    import claxon_tpu.pipeline as jpipe
    import claxon_tpu.pipeline_bits as jpb
    import claxon_tpu.pipeline_seg as jseg

    import claxon_tpu_torch.pipeline as tpipe
    import claxon_tpu_torch.pipeline_bits as tpb
    import claxon_tpu_torch.pipeline_seg as tseg

    assert tseg._SA_CLASSES == jseg._SA_CLASSES
    assert tpb._P_CLASSES == jpb._P_CLASSES
    assert [tseg._sa_class(s) for s in range(-1, 80)] == \
        [jseg._sa_class(s) for s in range(-1, 80)]
    assert tpb._META_W == jpb._META_W
    saved = {k: os.environ.get(k) for k in
             ("CLAXON_TPU_ENTROPY", "CLAXON_TPU_SEG_ENTROPY")}
    try:
        for value in ("values", "delta", "scan", "stream", "x", ""):
            os.environ["CLAXON_TPU_ENTROPY"] = value
            os.environ["CLAXON_TPU_SEG_ENTROPY"] = value
            assert tseg._seg_mode() == jseg._seg_mode()
            assert tpipe._walk_options()[0] == \
                jpipe.extract_streams_bits([], jnative)[1]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_crc16_combine_matrices_match_jax():
    """The port's copy of the GF(2) shift matrices (K4's kernel tables)."""
    from claxon_tpu.crc import crc16_combine_matrices as jmats
    from claxon_tpu_torch.crc import crc16_combine_matrices as tmats

    for n in (24, 28, 31):
        assert np.array_equal(tmats(n), jmats(n))
    assert np.array_equal(tmats(), jmats())


SPECS = [
    dict(n=3000, channels=2, bps=16, seed=1, kw=dict(block_size=1152)),
    dict(n=2500, channels=1, bps=24, seed=2,
         kw=dict(block_size=576, max_lpc_order=12, partition_order=3,
                 rice2=True, tags=[("TITLE", "x")])),
    dict(n=2000, channels=6, bps=8, seed=3,
         kw=dict(block_size=1000, force_subframe="fixed",
                 variable_blocking=True, padding=7)),
]


@pytest.mark.parametrize("spec", SPECS, ids=["stereo16", "mono24",
                                             "six8_variable"])
def test_encoder_is_byte_identical(spec):
    jpcm = jtesting.synth_music(spec["n"], channels=spec["channels"],
                                bps=spec["bps"], seed=spec["seed"])
    tpcm = ttesting.synth_music(spec["n"], channels=spec["channels"],
                                bps=spec["bps"], seed=spec["seed"])
    assert np.array_equal(jpcm, tpcm)
    jdata = jtesting.encode_flac(jpcm, 44100, spec["bps"], **spec["kw"])
    tdata = ttesting.encode_flac(tpcm, 44100, spec["bps"], **spec["kw"])
    assert jdata == tdata
    assert ttesting.pcm_md5(tpcm, spec["bps"]) == \
        jtesting.pcm_md5(jpcm, spec["bps"])


def _valid():
    return _stream("encoded_lpc12_1152")


def _bad_magic():
    return b"garbage!" + _valid()[8:]


def _id3_prefix():
    return b"ID3\x03\x00\x00\x00\x00\x00\x00" + _valid()


def _truncated_streaminfo():
    return _valid()[:20]


def _bad_block_size():
    data = bytearray(_valid())
    data[8:10] = (8).to_bytes(2, "big")  # STREAMINFO min block size 8
    return bytes(data)


def _corrupt_frame_crc():
    data = _valid()
    _si, bb = jnative.extract_stream_bits(data, emit_slots=False)
    bad = bytearray(data)
    bad[j_read_metadata(data)[1] + int(bb.bframes[1]["byte1"]) - 1] ^= 0xFF
    return bytes(bad)


MALFORMED = [_bad_magic, _id3_prefix, _truncated_streaminfo, _bad_block_size,
             _corrupt_frame_crc]


@pytest.mark.parametrize("make", MALFORMED, ids=lambda f: f.__name__[1:])
def test_malformed_inputs_raise_the_same_errors(make):
    """The port's scalar decoder and its device path (on the CPU) raise
    an error of the JAX package's class name, with its message."""
    data = make()
    with pytest.raises(RefError) as ref:
        jnative.decode_stream_scalar(data)
    with pytest.raises(ct.Error) as scalar:
        tnative.decode_stream_scalar(data)
    with pytest.raises(ct.Error) as device:
        ct.decode_streams_device([data], device="cpu").to_host()
    for got in (scalar.value, device.value):
        assert type(got).__name__ == type(ref.value).__name__
        assert str(got) == str(ref.value)


@pytest.mark.parametrize("split", [(3,), (1, 2, 5)], ids=["two", "four"])
def test_merge_bits_batches_matches_jax(split):
    """A frame section walked in bounded pieces and merged: every array of
    the port's merged batch equals the JAX package's, and the single-walk
    arrays apart from the rebased positions."""
    data = _stream("encoded_lpc12_1152")
    pos = t_read_metadata(data)[1]
    section = memoryview(data)[pos:]

    def pieces(mod):
        out, off = [], 0
        for n in split + (None,):
            used = []
            bb = mod.extract_frames_bits(section[off:], emit_slots=False,
                                         max_frames=n, consumed=used,
                                         defer_crc=True)
            bb.payload = section[off:off + used[0]]
            out.append(bb)
            off += used[0]
        return out

    jbb = jnative.merge_bits_batches(pieces(jnative))
    tbb = tnative.merge_bits_batches(pieces(tnative))
    whole = tnative.extract_frames_bits(section, emit_slots=False,
                                        defer_crc=True)
    for field in ("bframes", "bsubs", "ks", "bases", "deltas", "samples"):
        assert np.array_equal(getattr(jbb, field), getattr(tbb, field)), field
        assert np.array_equal(getattr(whole, field),
                              getattr(tbb, field)), field
    assert bytes(jbb.payload) == bytes(tbb.payload) == bytes(section)
    one = pieces(tnative)[:1]
    assert tnative.merge_bits_batches(one) is one[0]


def test_container_demuxers_match_jax():
    """read_metadata_block_with_header, read_flac_from_ogg and
    read_flac_from_mp4: the copies parse what the originals parse."""
    import io

    from claxon_tpu import containers as jc
    from claxon_tpu.io.readers import MemReader as JMemReader
    from claxon_tpu.metadata import read_metadata_block_with_header as jread

    from claxon_tpu_torch import containers as tc
    from claxon_tpu_torch.io import MemReader
    from claxon_tpu_torch.metadata import \
        read_metadata_block_with_header as tread

    pcm = jtesting.synth_music(5000, channels=2, bps=16, seed=9)
    flac = jtesting.encode_flac(pcm, 44100, 16, block_size=1024,
                                tags=[("TITLE", "x"), ("ARTIST", "y")],
                                padding=9)
    blocks, _frames = jtesting.split_flac(flac)
    assert len(blocks) >= 3
    for raw in blocks:
        jb, tb = jread(JMemReader(raw)), tread(MemReader(raw))
        assert jb.kind == tb.kind
        if jb.kind == "streaminfo":
            assert dataclasses.astuple(jb.streaminfo) == \
                dataclasses.astuple(tb.streaminfo)
    with pytest.raises(RefError) as ref:
        jread(JMemReader(blocks[0][:9]))  # a truncated STREAMINFO block
    with pytest.raises(ct.Error) as got:
        tread(MemReader(blocks[0][:9]))
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)

    ogg = jtesting.mux_ogg_flac(flac)
    jsi, jhead, jaudio = jc.read_flac_from_ogg(io.BytesIO(ogg))
    tsi, thead, taudio = tc.read_flac_from_ogg(io.BytesIO(ogg))
    assert dataclasses.astuple(jsi) == dataclasses.astuple(tsi)
    assert list(jhead) == list(thead) == blocks[1:]
    assert list(jaudio) == list(taudio)
    assert list(jc.OggPacketReader(io.BytesIO(ogg))) == \
        list(tc.OggPacketReader(io.BytesIO(ogg)))

    mp4 = jtesting.mux_mp4_flac(flac, frames_per_chunk=2)
    jt, tt = jc.read_flac_from_mp4(mp4), tc.read_flac_from_mp4(mp4)
    assert jt.flac_specific == tt.flac_specific
    assert dataclasses.astuple(jt.streaminfo) == \
        dataclasses.astuple(tt.streaminfo)
    assert jt.chunk_offsets == tt.chunk_offsets
    assert jt.samples_per_chunk == tt.samples_per_chunk == [2, 2, 1]
