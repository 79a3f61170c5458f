"""The port's scalar host layer and reader API (``claxon_tpu_torch.io``,
``subframe``, ``frame``, ``reader``, ``metadata``' tag iterators and
``utils``) against the JAX package's originals, with tolerance 0: the
bitstream at every width, the byte and CRC readers, the subframe and frame
units (the vectors of tests/test_subframe.py and tests/test_frame.py run
through both packages), ``FlacReader`` on the generated corpus and streams
encoded by the port's own encoder, on both reader routes (the native
single-frame fast path and ``CLAXON_TPU_NO_NATIVE_READER=1``) and at
buffer sizes 1, 4096 and 65536, and malformed inputs, whose errors are
compared by class name and message (each package has its own classes)."""

import io
import pathlib

import numpy as np
import pytest

import claxon_tpu as jt
from claxon_tpu import frame as jframe
from claxon_tpu import native as jnative
from claxon_tpu import subframe as jsub
from claxon_tpu.io import bits as jbits
from claxon_tpu.io import readers as jreaders
from claxon_tpu.metadata import read_flac_metadata as j_read_flac_metadata
from claxon_tpu.reader import read_stream_header as j_read_stream_header
from claxon_tpu.utils import write_wav as j_write_wav

import claxon_tpu_torch as ct
from claxon_tpu_torch import crc as tcrc
from claxon_tpu_torch import frame as tframe
from claxon_tpu_torch import native as tnative
from claxon_tpu_torch import subframe as tsub
from claxon_tpu_torch import testing as ttesting
from claxon_tpu_torch.io import bits as tbits
from claxon_tpu_torch.io import readers as treaders
from claxon_tpu_torch.metadata import (read_flac_metadata as
                                       t_read_flac_metadata,
                                       read_stream_header as
                                       t_read_stream_header)
from claxon_tpu_torch.utils import write_wav as t_write_wav

GENERATED = pathlib.Path(__file__).resolve().parents[1] / "testsamples" / \
    "generated"
#: Streams of the port's own encoder (tags and vendor included).
ENCODED = {
    "encoded_lpc12_1152": dict(block_size=1152, max_lpc_order=12,
                               partition_order=4,
                               tags=(("ARTIST", "Queen"), ("artist", "Bowie"),
                                     ("TITLE", "x"), ("KEY", "ascii"))),
    "encoded_fixed_rice2_mono": dict(block_size=576, force_subframe="fixed",
                                     rice2=True, partition_order=3,
                                     channels=1),
    "encoded_midside_verbatim": dict(block_size=192, stereo="mid_side",
                                     force_subframe="verbatim", vendor=None),
}
STREAMS = sorted(p.name for p in GENERATED.glob("*.flac")) + sorted(ENCODED)
ROUTES = ["native", "python"]
BUFFER_SIZES = [1, 4096, 65536]

def _stream(name):
    if name in ENCODED:
        kw = dict(ENCODED[name])
        channels = kw.pop("channels", 2)
        pcm = ttesting.synth_music(3000, channels=channels, bps=16,
                                   seed=len(name))
        return ttesting.encode_flac(pcm, 44100, 16, **kw)
    return (GENERATED / name).read_bytes()


@pytest.fixture
def route(request, monkeypatch):
    """Pin the reader route: the native fast path, or the Python one
    (``CLAXON_TPU_NO_NATIVE_READER``), read when a FrameReader is made."""
    if request.param == "python":
        monkeypatch.setenv("CLAXON_TPU_NO_NATIVE_READER", "1")
    else:
        monkeypatch.delenv("CLAXON_TPU_NO_NATIVE_READER", raising=False)
        if not (jnative.available() and tnative.available()):
            pytest.skip("native core not built")
    return request.param


def _outcome(fn):
    """fn()'s result, or its error as (class name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- compared across packages
        return ("error", type(e).__name__, str(e))


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


# -- io: the bitstream and the byte readers ---------------------------------

def _bit_ops(seed, n=400):
    """A seeded sequence of Bitstream reads covering every width: bits,
    unary codes, and reads of 0-8, 9-16, 0-16 and 0-32 bits."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        kind = int(rng.integers(0, 6))
        width = i % 33
        if kind == 0:
            ops.append(("read_bit",))
        elif kind == 1:
            ops.append(("read_unary",))
        elif kind == 2:
            ops.append(("read_leq_u8", width % 9))
        elif kind == 3:
            ops.append(("read_gt_u8_leq_u16", 9 + width % 8))
        elif kind == 4:
            ops.append(("read_leq_u16", width % 17))
        else:
            ops.append(("read_leq_u32", width))
    return ops


def _run_bits(bits_mod, readers_mod, data, ops):
    b = bits_mod.Bitstream(readers_mod.MemReader(data))
    out = []
    for op in ops:
        out.append(_outcome(lambda: getattr(b, op[0])(*op[1:])))
        if out[-1][0] == "error":
            break
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bitstream_reads_match_jax(seed):
    """Every read method at every width, over random bytes (seed 0), mostly
    zero bytes (long unary codes, seed 1) and bytes of all ones, to the
    end of the data, where both raise the same IoError."""
    rng = np.random.default_rng(100 + seed)
    data = rng.integers(0, 256, 600, dtype=np.uint8)
    if seed == 1:
        data[rng.random(600) < 0.9] = 0
    if seed == 2:
        data[:] = 0xFF
    ops = _bit_ops(seed, n=2000)
    want = _run_bits(jbits, jreaders, data.tobytes(), ops)
    got = _run_bits(tbits, treaders, data.tobytes(), ops)
    assert got == want
    assert want[-1][0] == "error" and len(want) > 100


def test_bitstream_reference_vectors():
    """tests/test_input.py's read_bit and read_unary vectors, both
    packages."""
    for bits_mod, readers_mod in ((jbits, jreaders), (tbits, treaders)):
        b = bits_mod.Bitstream(readers_mod.MemReader(
            bytes([0b1010_0100, 0b1110_0001])))
        assert [int(b.read_bit()) for _ in range(16)] == \
            [1, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1]
        b = bits_mod.Bitstream(readers_mod.MemReader(bytes(
            [0b1010_0100, 0b1000_0000, 0b0010_0000, 0b0000_0000,
             0b0000_1010])))
        assert [b.read_unary() for _ in range(6)] == [0, 1, 2, 2, 9, 17]
        assert b.read_leq_u8(3) == 0b010


_BYTE_OPS = ("read_u8", "read_u8_or_eof", "read_be_u16",
             "read_be_u16_or_eof", "read_be_u24", "read_be_u32",
             "read_le_u32")


def _run_crc_reader(readers_mod, cls, data, ops):
    r = getattr(readers_mod, cls)(readers_mod.MemReader(data))
    out = []
    for op in ops:
        out.append((_outcome(lambda: getattr(r, op)()), r.crc))
        if out[-1][0][0] == "error":
            break
    out.append(_outcome(lambda: r.read_into(2)))
    out.append(_outcome(lambda: r.skip(2)))
    return out


@pytest.mark.parametrize("cls", ["Crc8Reader", "Crc16Reader"])
def test_crc_readers_match_jax(cls):
    """The CRC-8 and CRC-16 decorator readers: every byte read updates the
    checksum as in JAX and as the port's whole-buffer crc8 / crc16 say;
    read_into and skip raise the same AssertionError."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    ops = [_BYTE_OPS[int(i)] for i in rng.integers(0, 7, 200)]
    want = _run_crc_reader(jreaders, cls, data, ops)
    got = _run_crc_reader(treaders, cls, data, ops)
    assert got == want
    whole = getattr(treaders, cls)(treaders.MemReader(data))
    for _ in range(len(data)):
        whole.read_u8()
    assert whole.crc == (tcrc.crc8(data) if cls == "Crc8Reader"
                         else tcrc.crc16(data))
    assert got[-2][0] == "error" and got[-2][1] == "AssertionError"


def _run_buffered(readers_mod, data, size, ops):
    r = readers_mod.BufferedReader(io.BytesIO(data), buffer_size=size)
    out = []
    for op in ops:
        out.append(_outcome(lambda: getattr(r, op[0])(*op[1:])))
    return out


@pytest.mark.parametrize("size", BUFFER_SIZES)
def test_buffered_reader_matches_jax(size):
    """BufferedReader at buffer sizes 1, 4096 and 65536: reads, skips,
    the native window's read_up_to, and the reads past the end."""
    rng = np.random.default_rng(size)
    data = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    ops = []
    for i in range(300):
        k = int(rng.integers(0, 5))
        if k == 0:
            ops.append((_BYTE_OPS[i % 7],))
        elif k == 1:
            ops.append(("read_into", int(rng.integers(0, 600))))
        elif k == 2:
            ops.append(("skip", int(rng.integers(0, 600))))
        elif k == 3:
            ops.append(("read_up_to", int(rng.integers(1, 700))))
        else:
            ops.append(("read_into", int(rng.integers(0, 3000))))
    ops += [("read_into", 70000), ("read_u8_or_eof",),
            ("read_be_u16_or_eof",), ("read_u8",), ("skip", 1),
            ("read_up_to", 10)]
    want = _run_buffered(jreaders, data, size, ops)
    got = _run_buffered(treaders, data, size, ops)
    assert got == want
    assert ("error", "IoError", "unexpected end of stream") in want


def test_one_memreader_class():
    """Every module of the port reads through one MemReader class, the
    one FrameReader's native fast path tests for."""
    from claxon_tpu_torch import io as tio
    from claxon_tpu_torch.containers import mp4, ogg, pipeline
    from claxon_tpu_torch.native import binding
    from claxon_tpu_torch.testing import containers_gen

    assert tio.MemReader is treaders.MemReader
    for mod in (mp4, ogg, pipeline, binding, containers_gen):
        assert mod.MemReader is treaders.MemReader, mod.__name__
    assert set(tio.__all__) == set(jt.io.__all__)


# -- subframe ----------------------------------------------------------------

_SIGN_VECTORS = [(5, 4, 5), (0x3FFE, 15, 0x3FFE), (16 - 5, 4, -5),
                 (512 - 3, 9, -3), (0xFFFF, 16, -1), (0xFFFE, 16, -2),
                 (0x7FFF, 15, -1), (0xFFFFFFFF, 32, -1),
                 (0xFFFFFFFE, 32, -2), (0x7FFFFFFF, 31, -1),
                 (124680, 17, -6392), (124467, 17, -6605),
                 (124222, 17, -6850), (124011, 17, -7061)]


def test_extend_sign_and_rice_to_signed():
    """tests/test_subframe.py's vectors, then random values at every
    width, both packages equal."""
    for v, bits, want in _SIGN_VECTORS:
        assert tsub.extend_sign(v, bits) == jsub.extend_sign(v, bits) == want
    rng = np.random.default_rng(3)
    for bits in range(1, 33):
        for v in rng.integers(0, 1 << bits, 50, dtype=np.uint64).tolist():
            assert tsub.extend_sign(v, bits) == jsub.extend_sign(v, bits)
    for v in list(range(64)) + rng.integers(0, 1 << 32, 200,
                                            dtype=np.uint64).tolist():
        assert tsub.rice_to_signed(v) == jsub.rice_to_signed(v)
    assert [tsub.rice_to_signed(v) for v in range(5)] == [0, -1, 1, -2, 2]


_FIXED_CASES = [
    (3, [-729, -722, -667, -19, -16, 17, -23, -7, 16, -16, -5, 3, -8, -13,
         -15, -1]),
    (2, [21877, 27482, -6513]),  # wraps in int32
]
_LPC_CASES = [
    ([-75, 166, 121, -269, -75, -399, 1042], 9,
     [-796, -547, -285, -32, 199, 443, 670, -2, -23, 14, 6, 3, -4, 12, -2,
      10]),
    ([119, -255, 555, -836, 879, -1199, 1757], 10,
     [-21363, -21951, -22649, -24364, -27297, -26870, -30017, 3157]),
    ([709, -2589, 4600, -4612, 1350, 4220, -9743, 12671, -12129, 8586,
      -3775, -645, 3904, -5543, 4373, 182, -6873, 13265, -15417, 11550], 12,
     [213238, 210830, 234493, 209515, 235139, 201836, 208151, 186277,
      157720, 148176, 115037, 104836, 60794, 54523, 412, 17943, -6025,
      -3713, 8373, 11764, 30094]),
]


def test_predictors_match_jax():
    """predict_fixed and predict_lpc on tests/test_subframe.py's real-stream
    vectors (with the int32 wrap) and on random extremes of every order."""
    for order, buf in _FIXED_CASES:
        a, b = list(buf), list(buf)
        jsub.predict_fixed(order, a)
        tsub.predict_fixed(order, b)
        assert a == b
    for coefs, shift, buf in _LPC_CASES:
        a, b = list(buf), list(buf)
        jsub.predict_lpc(coefs, shift, a)
        tsub.predict_lpc(coefs, shift, b)
        assert a == b
    rng = np.random.default_rng(11)
    for order in range(5):
        buf = rng.integers(-2**31, 2**31, 40).tolist()
        a, b = list(buf), list(buf)
        jsub.predict_fixed(order, a)
        tsub.predict_fixed(order, b)
        assert a == b
    for order in range(1, 33):
        coefs = rng.integers(-2**15, 2**15, order).tolist()
        shift = int(rng.integers(0, 32))
        buf = rng.integers(-2**31, 2**31, order + 30).tolist()
        a, b = list(buf), list(buf)
        jsub.predict_lpc(coefs, shift, a)
        tsub.predict_lpc(coefs, shift, b)
        assert a == b


def _bitstr_bytes(bitstr):
    bitstr += "0" * (-len(bitstr) % 8)
    return bytes(int(bitstr[i:i + 8], 2) for i in range(0, len(bitstr), 8))


#: tests/test_subframe.py's residual cases: a Rice partition, the escape
#: code, an invalid partition order and the reserved method.
_RESIDUALS = {
    "rice_partition": ("00" + "0000" + "0010" + "100101110111", 4),
    "rice_escape": ("00" + "0000" + "1111" + "0" * 6, 4),
    "invalid_partition_order": ("00" + "0010" + "0010" + "0" * 6, 6),
    "reserved_method": ("10" + "0" * 14, 4),
}


@pytest.mark.parametrize("case", sorted(_RESIDUALS))
def test_decode_residual_matches_jax(case):
    bitstr, n = _RESIDUALS[case]
    data = _bitstr_bytes(bitstr)

    def run(bits_mod, readers_mod, sub_mod):
        buf = [0] * n
        sub_mod.decode_residual(bits_mod.Bitstream(readers_mod.MemReader(
            data)), n, buf, 0, n)
        return buf

    want = _outcome(lambda: run(jbits, jreaders, jsub))
    assert _outcome(lambda: run(tbits, treaders, tsub)) == want
    if case == "rice_partition":
        assert want == ("ok", [0, -1, 1, -2])
    else:
        assert want[0] == "error"


@pytest.mark.parametrize("seed", range(6))
def test_subframe_decode_matches_jax_on_random_bits(seed):
    """subframe.decode over random bytes at bps 8 to 33 (garbage headers,
    every subframe type the bits happen to name): the same samples or the
    same error."""
    rng = np.random.default_rng(seed)
    for _ in range(30):
        data = rng.integers(0, 256, 256, dtype=np.uint8)
        data[0] &= 0x7F  # the zero padding bit of a subframe header
        bps = int(rng.integers(8, 34))
        n = int(rng.integers(1, 64))

        def run(bits_mod, readers_mod, sub_mod):
            buf = [0] * n
            sub_mod.decode(bits_mod.Bitstream(readers_mod.MemReader(
                data.tobytes())), bps, buf)
            return buf

        assert _outcome(lambda: run(tbits, treaders, tsub)) == \
            _outcome(lambda: run(jbits, jreaders, jsub))


# -- frame -------------------------------------------------------------------

def test_read_var_length_int_matches_jax():
    """tests/test_frame.py's vector: four valid integers, then an invalid
    continuation and a continuation byte first, in both packages."""
    data = bytes([0x24, 0xC2, 0xA2, 0xE2, 0x82, 0xAC, 0xF0, 0x90, 0x8D,
                  0x88, 0xC2, 0x00, 0x80])
    out = []
    for frame_mod, readers_mod in ((jframe, jreaders), (tframe, treaders)):
        r = readers_mod.MemReader(data)
        out.append([_outcome(lambda: frame_mod.read_var_length_int(r))
                    for _ in range(6)])
    assert out[0] == out[1]
    assert [o[1] for o in out[1][:4]] == [0x24, 0xA2, 0x20AC, 0x010348]
    assert out[1][4][:2] == ("error", "FormatError")


_DECORRELATION = {
    "decode_left_side": [2, 5, 83, 113, 127, -63, -45, -15,
                         7, 38, 142, 238, 0, -152, -52, -18],
    "decode_right_side": [7, 38, 142, 238, 0, -152, -52, -18,
                          -5, -33, -59, -125, 127, 89, 7, 3],
    "decode_mid_side": [-2, -14, 12, -6, 127, 13, -19, -6,
                        7, 38, 142, 238, 0, -152, -52, -18],
}


@pytest.mark.parametrize("fn", sorted(_DECORRELATION))
def test_decorrelation_matches_jax(fn):
    """tests/test_frame.py's vectors, then random int32 extremes (the
    wrapping side channel and mid * 2)."""
    cases = [np.array(_DECORRELATION[fn], dtype=np.int32)]
    rng = np.random.default_rng(5)
    cases += [rng.integers(-2**31, 2**31, 64).astype(np.int32)
              for _ in range(4)]
    for buf in cases:
        a, b = buf.copy(), buf.copy()
        getattr(jframe, fn)(a)
        getattr(tframe, fn)(b)
        assert np.array_equal(a, b)
    b = cases[0].copy()
    getattr(tframe, fn)(b)
    assert b.tolist() == [2, 5, 83, 113, 127, -63, -45, -15,
                          -5, -33, -59, -125, 127, 89, 7, 3]


def test_block_and_ensure_buffer_len_match_jax():
    """Block's sample layout and stereo iterator, and ensure_buffer_len's
    resize matrix and storage reuse (tests/test_frame.py), in both
    packages."""
    for mod in (jframe, tframe):
        buf = np.array([2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43,
                        47], dtype=np.int32)
        block = mod.Block(0, 5, buf)
        assert (block.channels(), block.sample(0, 2), block.sample(1, 3),
                block.sample(2, 4)) == (3, 5, 23, 47)
        assert block.channel(1).tolist() == [13, 17, 19, 23, 29]
        assert list(mod.Block(0, 3, np.array(
            [2, 3, 5, 7, 11, 13], dtype=np.int32)).stereo_samples()) == \
            [(2, 7), (3, 11), (5, 13)]
        with pytest.raises(AssertionError):
            mod.Block(0, 5, np.zeros(15, dtype=np.int32)).stereo_samples()
        for capacity in range(10):
            for new_len in range(10):
                got = mod.ensure_buffer_len(
                    np.zeros(capacity, dtype=np.int32), new_len)
                assert got.shape[0] == new_len and got.dtype == np.int32
        big = np.arange(16, dtype=np.int32)
        regrown = mod.ensure_buffer_len(mod.ensure_buffer_len(big, 4), 16)
        assert regrown.base is big or regrown is big
        assert mod.ensure_buffer_len(None, 7).shape == (7,)


# -- FlacReader --------------------------------------------------------------

def _reader_view(pkg, data):
    """Everything FlacReader shows of a stream: streaminfo, vendor, tags,
    get_tag (a name of any case, and the Kelvin sign, which only
    str.lower() would fold into 'k'), blocks(), then samples() and
    into_samples() of fresh readers."""
    r = pkg.FlacReader(data)
    si = r.streaminfo()
    view = [tuple(getattr(si, f) for f in si.__dataclass_fields__),
            r.vendor(), list(r.tags())]
    for name in ("artist", "ARTIST", "Title", "key", "\u212aey", "missing"):
        view.append(list(r.get_tag(name)))
    fr = r.blocks()
    blocks, buf = [], None
    while (b := fr.read_next_or_eof(buf)) is not None:
        blocks.append((b.time(), b.duration(), b.channels(),
                       np.array([b.channel(c) for c in range(b.channels())])))
        buf = b.into_buffer()
    view.append(blocks)
    view.append(np.array(list(pkg.FlacReader(data).samples()),
                         dtype=np.int64))
    view.append(np.array(list(pkg.FlacReader(data).into_samples()),
                         dtype=np.int64))
    return view


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("name", STREAMS)
def test_flac_reader_matches_jax(name, route):
    data = _stream(name)
    want = _reader_view(jt, data)
    got = _reader_view(ct, data)
    _same(got, want)
    if name == "encoded_lpc12_1152":
        assert got[3:9] == [["Queen", "Bowie"], ["Queen", "Bowie"], ["x"],
                            ["ascii"], [], []]
    # The samples are the scalar decoder's, and their MD5 STREAMINFO's.
    si, pcm = tnative.decode_stream_scalar(data)
    assert np.array_equal(got[-2], pcm.reshape(-1))
    assert ttesting.pcm_md5(pcm, si.bits_per_sample) == si.md5sum


def _buffered_blocks(pkg_readers, read_header, read_metadata, frame_mod,
                     data, size):
    """Metadata, then every block, through a BufferedReader of ``size``
    bytes over a file-like object; then a second FrameReader on the same
    reader (it continues where the first stopped: nothing is left)."""
    r = pkg_readers.BufferedReader(io.BytesIO(data), buffer_size=size)
    read_header(r)
    si, _vc = read_metadata(r)
    fr = frame_mod.FrameReader(r)
    out = []
    first = fr.read_next_or_eof()
    out.append((first.time(), first.into_buffer().copy()))
    fr2 = frame_mod.FrameReader(r)  # continues frame-aligned
    buf = None
    while (b := fr2.read_next_or_eof(buf)) is not None:
        out.append((b.time(), b.into_buffer()[:b.duration() * b.channels()]
                    .copy()))
        buf = b.into_buffer()
    return si.md5sum, out


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("size", BUFFER_SIZES)
def test_buffered_frame_reader_matches_jax(size, route):
    """FrameReader over a BufferedReader of 1, 4096 and 65536 bytes, on
    both routes, two FrameReaders in turn on one reader (the native window
    lives on the reader), over the encoded streams and two generated
    ones."""
    for name in sorted(ENCODED) + ["hires24.flac", "variable_blocking.flac"]:
        data = _stream(name)
        want = _buffered_blocks(jreaders, j_read_stream_header,
                                j_read_flac_metadata, jframe, data, size)
        got = _buffered_blocks(treaders, t_read_stream_header,
                               t_read_flac_metadata, tframe, data, size)
        _same(got, want)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_samples_continue_through_the_native_window(route):
    """samples() then into_samples() on a file-like input continue at the
    next block boundary (tests/test_native_reader.py's continuation
    case), in both packages."""
    pcm = ttesting.synth_music(3000, channels=2, bps=16, seed=81)
    data = ttesting.encode_flac(pcm, 44100, 16, block_size=1024)
    outs = []
    for pkg in (jt, ct):
        reader = pkg.FlacReader(io.BytesIO(data))
        first = [next(reader.samples())]
        outs.append(np.array(first + list(reader.into_samples())))
    assert np.array_equal(outs[0], outs[1])
    assert outs[1][0] == pcm[0, 0]
    assert np.array_equal(outs[1][1:], pcm[1024:].reshape(-1))


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_reader_options_and_errors_match_jax(route):
    """metadata_only (blocks() and samples() refused), read_vorbis_comment
    off, the ID3 and bad-magic errors, empty and truncated input,
    into_inner, and buffer poisoning: recycled buffers filled with other
    values give the same blocks."""
    data = _stream("encoded_lpc12_1152")

    def probes(pkg):
        opts = pkg.FlacReaderOptions
        out = []
        meta = pkg.FlacReader(data, opts(metadata_only=True))
        out.append((meta.vendor(), list(meta.tags())))
        out.append(_outcome(lambda: meta.blocks()))
        out.append(_outcome(lambda: meta.samples()))
        out.append(_outcome(lambda: meta.into_samples()))
        quiet = pkg.FlacReader.new_ext(data, opts(read_vorbis_comment=False))
        out.append((quiet.vendor(), list(quiet.tags())))
        for bad in (b"ID3\x04\x00\x00\x00\x00", b"garbage!", b"", b"fLa",
                    data[:60], data[:200]):
            out.append(_outcome(
                lambda: list(pkg.FlacReader(bad).samples())))
        stream = io.BytesIO(data)
        out.append(pkg.FlacReader.new(stream).into_inner() is stream)
        mem = pkg.FlacReader(data)
        out.append(mem.into_inner() == data)
        for fill in (13, 17):
            r = pkg.FlacReader(data)
            fr = r.blocks()
            si = r.streaminfo()
            buf = np.full(si.max_block_size * si.channels, fill,
                          dtype=np.int32)
            blocks = []
            while (blk := fr.read_next_or_eof(buf)) is not None:
                blocks.append(np.array([blk.channel(c)
                                        for c in range(blk.channels())]))
                buf = blk.into_buffer()
                buf[:] = fill
            out.append(blocks)
        return out

    want = probes(jt)
    got = probes(ct)
    _same(got, want)
    assert [o[:2] for o in got[1:4]] == [("error", "AssertionError")] * 3
    assert got[5] == ("error", "FormatError", "Ill-formed FLAC stream: "
                      "stream starts with ID3 header rather than FLAC header")
    _same(got[-1], got[-2])


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_damaged_streams_match_jax(route):
    """24 seeded damaged streams (flipped bytes, truncations) through
    samples(): the same samples before the same error, or the same
    samples to the end."""
    from test_torch_cuda import fuzzed_streams

    def run(pkg, data):
        got = []
        try:
            for s in pkg.FlacReader(data).samples():
                got.append(s)
        except Exception as e:  # noqa: BLE001 -- compared across packages
            return got, type(e).__name__, str(e)
        return got, None, None

    errors = 0
    for data in fuzzed_streams():
        want = run(jt, data)
        assert run(ct, data) == want
        errors += want[1] is not None
    assert errors > 0


def test_open_and_open_ext(tmp_path):
    """FlacReader.open / open_ext on a path, and a missing path's IoError,
    in both packages."""
    data = _stream("encoded_fixed_rice2_mono")
    path = tmp_path / "s.flac"
    path.write_bytes(data)
    want = list(jt.FlacReader(data).samples())
    for pkg in (jt, ct):
        r = pkg.FlacReader.open(str(path))
        assert list(r.samples()) == want
        r.into_inner().close()
        r = pkg.FlacReader.open_ext(str(path), pkg.FlacReaderOptions(
            metadata_only=True))
        assert r.streaminfo().samples == len(want)
        r.into_inner().close()
    assert _outcome(lambda: ct.FlacReader.open(str(tmp_path / "no"))) == \
        _outcome(lambda: jt.FlacReader.open(str(tmp_path / "no")))


@pytest.mark.parametrize("bps", [8, 16, 20, 24, 32])
def test_write_wav_matches_jax(bps):
    rng = np.random.default_rng(bps)
    hi = 1 << (bps - 1)
    pcm = rng.integers(-hi, hi, (50, 2)).astype(np.int32)
    a, b = io.BytesIO(), io.BytesIO()
    j_write_wav(a, pcm, 44100, bps)
    t_write_wav(b, pcm, 44100, bps)
    assert a.getvalue() == b.getvalue()
    assert _outcome(lambda: t_write_wav(io.BytesIO(), pcm, 44100, 40)) == \
        _outcome(lambda: j_write_wav(io.BytesIO(), pcm, 44100, 40))
