"""ctypes binding to the port's C++ host core (``src/claxon_demux.cpp``; a
copy of ``claxon_tpu.native.binding``).

Layering: Python parses the (cold, byte-aligned) stream header + metadata
blocks; the C++ core does the hot bit-level work -- the boundary walk of
the bits path, the FrameDesc and raw extractions (the raw one feeds the
sample-shipping route of ``CLAXON_TPU_NO_BITS``, with its int16 pack
helpers), the scalar and single-frame decodes, bulk CRC-16 -- and returns
flat descriptor arrays.
"""

import ctypes

import numpy as np

from ..error import FormatError, IoError, Unsupported
from ..io import MemReader
from ..metadata import read_flac_metadata, read_stream_header
from .build import ensure_built

__all__ = ["available", "extract_stream", "extract_stream_raw",
           "extract_frames_raw", "extract_stream_bits", "extract_frames_bits",
           "merge_bits_batches", "BitsBatch", "crc16_bytes", "extract_frames",
           "decode_frames_limited", "decode_stream_scalar",
           "has_pack_helpers", "rows_to_i16", "minmax"]

#: Expected cxt_abi_version() of the loaded .so; must move in lockstep with
#: any change to the C-ABI struct layouts below.
ABI_VERSION = 5

FRAME_DTYPE = np.dtype([("time", "<i8"), ("block_size", "<i4"),
                        ("channels", "<i4"), ("mode", "<i4"), ("bps", "<i4")])
SUB_DTYPE = np.dtype([("order", "<i4"), ("shift", "<i4"), ("wasted", "<i4"),
                      ("pad", "<i4"), ("coefs", "<i4", (32,))])
# Bits-path records (CxtBFrame / CxtBSub in claxon_demux.cpp).
BFRAME_DTYPE = np.dtype([("time", "<i8"), ("block_size", "<i4"),
                         ("channels", "<i4"), ("mode", "<i4"), ("bps", "<i4"),
                         ("flags", "<i4"), ("s_class", "<i4"),
                         ("byte0", "<i4"), ("byte1", "<i4")])
BSUB_DTYPE = np.dtype([("order", "<i4"), ("shift", "<i4"), ("wasted", "<i4"),
                       ("n_parts", "<i4"), ("ps", "<i4"), ("n_chunks", "<i4"),
                       ("pbits", "<i4"), ("flags", "<i4"),
                       ("coefs", "<i4", (32,)), ("warm", "<i4", (32,))])

_lib = None
_load_failed = False  # negative cache: never retry a doomed build/load


def _load():
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    path = ensure_built()
    if path is None:
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.cxt_extract.restype = ctypes.c_void_p
        lib.cxt_extract.argtypes = [u8p, ctypes.c_uint64,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_char_p, ctypes.c_uint64]
        lib.cxt_decode.restype = ctypes.c_void_p
        lib.cxt_decode.argtypes = lib.cxt_extract.argtypes
        lib.cxt_decode_limited.restype = ctypes.c_void_p
        lib.cxt_decode_limited.argtypes = [u8p, ctypes.c_uint64,
                                           ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_uint64),
                                           ctypes.POINTER(ctypes.c_int32),
                                           ctypes.c_char_p, ctypes.c_uint64]
        lib.cxt_extract_limited.restype = ctypes.c_void_p
        lib.cxt_extract_limited.argtypes = lib.cxt_decode_limited.argtypes
        for name in ("cxt_n_frames", "cxt_n_subframes",
                     "cxt_n_lane_samples", "cxt_pcm_len"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        lib.cxt_fill.restype = None
        lib.cxt_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        lib.cxt_pcm_fill.restype = None
        lib.cxt_pcm_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cxt_free.restype = None
        lib.cxt_free.argtypes = [ctypes.c_void_p]
        lib.cxt_extract_bits.restype = ctypes.c_void_p
        lib.cxt_extract_bits.argtypes = [u8p, ctypes.c_uint64,
                                         ctypes.c_int32, ctypes.c_int64,
                                         ctypes.POINTER(ctypes.c_uint64),
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_char_p, ctypes.c_uint64]
        lib.cxt_b_counts.restype = None
        lib.cxt_b_counts.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint64)]
        lib.cxt_b_fill.restype = None
        lib.cxt_b_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        lib.cxt_crc16.restype = ctypes.c_int32
        lib.cxt_crc16.argtypes = [u8p, ctypes.c_uint64]
        lib.cxt_rows_to_i16.restype = None
        lib.cxt_rows_to_i16.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int64]
        lib.cxt_minmax.restype = None
        lib.cxt_minmax.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.POINTER(ctypes.c_int32)]
        # A stale .so whose symbols still resolve but whose struct layouts
        # differ would corrupt memory in cxt_fill; the ABI version gate
        # turns that into available() -> False.
        lib.cxt_abi_version.restype = ctypes.c_int32
        lib.cxt_abi_version.argtypes = []
        if lib.cxt_abi_version() != ABI_VERSION:
            raise AttributeError("claxon_tpu_torch native ABI version "
                                 "mismatch")
    except (OSError, AttributeError):
        _load_failed = True
        return None
    _lib = lib
    return lib


def available():
    """True when the C++ core is built and loadable."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "the claxon_tpu_torch native core is not available (build "
            "failed or unloadable); check python -m "
            "claxon_tpu_torch.native.build")
    return lib


_ERRORS = {1: FormatError, 2: Unsupported, 3: IoError}


def _checked(h, err, msg):
    """Map a null handle to the claxon error indicated by err/msg."""
    if not h:
        raise _ERRORS.get(err.value, RuntimeError)(
            msg.value.decode("utf-8", "replace"))
    return h


def _call(fn, data):
    """Invoke cxt_extract/cxt_decode, mapping errors; returns a handle."""
    buf = np.frombuffer(data, dtype=np.uint8)
    err = ctypes.c_int32(0)
    msg = ctypes.create_string_buffer(256)
    h = fn(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
           ctypes.byref(err), msg, 256)
    return _checked(h, err, msg)


def _read_metadata(data):
    """Parse header + metadata in Python; returns (streaminfo, frame_off).

    Uses the port's metadata reader (``metadata.read_flac_metadata``), the
    same validation as the JAX package's decode paths."""
    reader = MemReader(data)
    read_stream_header(reader)
    streaminfo, _vorbis = read_flac_metadata(reader)
    return streaminfo, reader.pos


class BitsBatch:
    """Flat bits-path arrays of one stream's frame section.

    ``bframes`` (BFRAME_DTYPE) and ``bsubs`` (BSUB_DTYPE) describe every
    frame/subframe in stream order. Non-fallback subframes (their frame's
    ``flags`` bit 0 clear) consume, in lane order:

    * ``deltas``: ``block_size`` bytes each -- per-sample Rice code length
      ``q + 1 + k`` (0 at warm-up positions);
    * ``slots``: ``n_chunks * (s_class + 1)`` int32 words each -- the k-bit
      remainders of the codes at block positions [32c, 32c+32) packed
      MSB-first from word ``c * (s_class + 1)``;
    * ``ks``: ``n_parts`` Rice parameters each.

    Fallback frames instead consume ``block_size`` int32 samples per lane
    from ``samples`` (legacy warm-up ++ residuals layout).

    ``bases`` holds, per bits-lane chunk, the absolute bit position (within
    the frame section) where the chunk's codes start -- the stream-gather
    kernel reads chunk words straight from the uploaded stream with these.
    ``payload`` keeps the frame-section bytes for that upload. ``slots``
    is only populated when extraction ran with ``emit_slots=True``.
    """

    __slots__ = ("bframes", "bsubs", "deltas", "slots", "ks", "samples",
                 "bases", "payload")

    def __init__(self, bframes, bsubs, deltas, slots, ks, samples, bases,
                 payload=None):
        self.bframes = bframes
        self.bsubs = bsubs
        self.deltas = deltas
        self.slots = slots
        self.ks = ks
        self.samples = samples
        self.bases = bases
        self.payload = payload


def extract_frames_bits(payload, emit_slots=True, max_frames=None,
                        consumed=None, defer_crc=False):
    """Bits-path extraction of a stream's frame section (positioned at the
    first frame byte): the boundary-only C++ walk (walk_stream_bits in
    claxon_demux.cpp) that ships residual *bits* instead of decoded
    samples. Returns a BitsBatch.

    ``max_frames`` bounds the walk (the port walks a large stream in
    chunks of frames, and container chunks declare their frame count);
    ``consumed``, a one-element list, receives the byte length of the
    frames actually parsed. ``defer_crc`` skips host CRC-16
    verification entirely (flagged frames get flags bit 1); callers MUST
    then verify the flagged byte0/byte1 ranges -- the port runs K4
    (``ops.crc.crc16_ranges``) over the stream upload and surfaces "frame
    CRC mismatch"."""
    lib = _require()
    buf = np.frombuffer(payload, dtype=np.uint8)
    err = ctypes.c_int32(0)
    msg = ctypes.create_string_buffer(256)
    used = ctypes.c_uint64(0)
    h = lib.cxt_extract_bits(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        (1 if emit_slots else 0) | (2 if defer_crc else 0),
        -1 if max_frames is None else max_frames, ctypes.byref(used),
        ctypes.byref(err), msg, 256)
    _checked(h, err, msg)
    if consumed is not None:
        consumed.append(int(used.value))
    try:
        counts = (ctypes.c_uint64 * 7)()
        lib.cxt_b_counts(h, counts)
        nf, ns, nd, nw, nk, nx, nb = (int(c) for c in counts)
        bframes = np.empty(nf, dtype=BFRAME_DTYPE)
        bsubs = np.empty(ns, dtype=BSUB_DTYPE)
        deltas = np.empty(nd, dtype=np.uint8)
        slots = np.empty(nw, dtype=np.int32)
        ks = np.empty(nk, dtype=np.int32)
        samples = np.empty(nx, dtype=np.int32)
        bases = np.empty(nb, dtype=np.int32)
        lib.cxt_b_fill(h, bframes.ctypes.data, bsubs.ctypes.data,
                       deltas.ctypes.data, slots.ctypes.data,
                       ks.ctypes.data, samples.ctypes.data,
                       bases.ctypes.data)
    finally:
        lib.cxt_free(h)
    return BitsBatch(bframes, bsubs, deltas, slots, ks, samples, bases,
                     payload)


def extract_stream_bits(data, emit_slots=True, defer_crc=False):
    """(streaminfo, BitsBatch) for a whole stream."""
    data = bytes(data)
    streaminfo, pos = _read_metadata(data)
    return streaminfo, extract_frames_bits(memoryview(data)[pos:],
                                           emit_slots, defer_crc=defer_crc)


def merge_bits_batches(batches):
    """Concatenate BitsBatches of consecutive frame runs into one batch.

    Containers split a stream's frame section into chunks (MP4 stsc runs,
    Ogg packets); each chunk extracts independently and this stitches the
    flat arrays back into the single-section form the device pipeline
    expects. Chunk payloads are byte-concatenated, so every chunk's
    ``bases`` (absolute bit positions within its own payload) is rebased
    by the bits preceding it."""
    if len(batches) == 1:
        return batches[0]
    payloads = [bytes(b.payload) for b in batches]
    bases, bframes, bit0 = [], [], 0
    for b, p in zip(batches, payloads):
        bases.append(b.bases + np.int32(bit0))
        bf = b.bframes.copy()
        bf["byte0"] += np.int32(bit0 // 8)  # frame spans rebase too
        bf["byte1"] += np.int32(bit0 // 8)
        bframes.append(bf)
        bit0 += 8 * len(p)
    cat = np.concatenate
    return BitsBatch(cat(bframes),
                     cat([b.bsubs for b in batches]),
                     cat([b.deltas for b in batches]),
                     cat([b.slots for b in batches]),
                     cat([b.ks for b in batches]),
                     cat([b.samples for b in batches]),
                     cat(bases),
                     b"".join(payloads))


def crc16_bytes(data):
    """Bulk CRC-16 (slice-by-8 in C++) over a bytes-like; reference
    semantics claxon `src/crc.rs:33-57`."""
    lib = _require()
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(lib.cxt_crc16(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf)))


def extract_frames_raw(payload, max_frames=None):
    """Extract the flat descriptor arrays of a stream's frame section:
    (frames_buf FRAME_DTYPE, subs_buf SUB_DTYPE, samples int32). The
    samples array holds each lane's block (warm-up ++ residuals)
    consecutively, frame-major, channel-minor. ``max_frames`` bounds the
    parse (container chunks hold a known frame count followed by slack)."""
    lib = _require()
    if max_frames is None:
        h = _call(lib.cxt_extract, payload)
    else:
        buf = np.frombuffer(payload, dtype=np.uint8)
        err = ctypes.c_int32(0)
        consumed = ctypes.c_uint64(0)
        msg = ctypes.create_string_buffer(256)
        h = lib.cxt_extract_limited(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            max_frames, ctypes.byref(consumed), ctypes.byref(err), msg, 256)
        _checked(h, err, msg)
    try:
        n_frames = lib.cxt_n_frames(h)
        n_subs = lib.cxt_n_subframes(h)
        n_samp = lib.cxt_n_lane_samples(h)
        frames_buf = np.empty(n_frames, dtype=FRAME_DTYPE)
        subs_buf = np.empty(n_subs, dtype=SUB_DTYPE)
        samples = np.empty(n_samp, dtype=np.int32)
        lib.cxt_fill(h, frames_buf.ctypes.data, subs_buf.ctypes.data,
                     samples.ctypes.data)
    finally:
        lib.cxt_free(h)
    return frames_buf, subs_buf, samples


def extract_stream_raw(data):
    """(streaminfo, frames_buf, subs_buf, samples) for a whole stream: the
    flat arrays ``pipeline.decode_raw_batches_device`` plans from, with no
    Python object per frame."""
    data = bytes(data)
    streaminfo, pos = _read_metadata(data)
    return (streaminfo,) + extract_frames_raw(memoryview(data)[pos:])


def extract_frames(payload, max_frames=None):
    """Extract FrameDescs from the frame section of a stream (bytes
    positioned at the first frame). Native counterpart of
    ``claxon_tpu_torch.extract.extract_frames``."""
    from ..extract import FrameDesc, SubframeDesc

    frames_buf, subs_buf, samples = extract_frames_raw(payload, max_frames)
    n_frames = len(frames_buf)

    frames = []
    lane = 0
    off = 0
    coefs_all = subs_buf["coefs"]
    for i in range(n_frames):
        f = frames_buf[i]
        bs = int(f["block_size"])
        nch = int(f["channels"])
        fd = FrameDesc(block_size=bs, channels=nch, mode=int(f["mode"]),
                       bps=int(f["bps"]), time=int(f["time"]))
        for _ in range(nch):
            s = subs_buf[lane]
            order = int(s["order"])
            fd.subframes.append(SubframeDesc(
                x=samples[off:off + bs],
                order=order,
                shift=int(s["shift"]),
                coefs=coefs_all[lane, 32 - order:] if order else
                      np.zeros(0, np.int32),
                wasted=int(s["wasted"])))
            lane += 1
            off += bs
        frames.append(fd)
    return frames


def extract_stream(data):
    """Extract a whole FLAC stream (bytes) into a StreamBatch using the
    C++ core for the frame section."""
    from ..extract import StreamBatch

    data = bytes(data)
    streaminfo, pos = _read_metadata(data)
    return StreamBatch(streaminfo=streaminfo,
                       frames=extract_frames(memoryview(data)[pos:]))


def decode_frames_limited(payload, max_frames=1):
    """Decode up to ``max_frames`` frames from ``payload`` (bytes-like,
    positioned at a frame boundary) fully on the host.

    Returns (consumed_bytes, frames_buf FRAME_DTYPE, pcm int32) where pcm
    is interleaved (sum(block_size), channels-of-each-frame) row-major in
    frame order. ``consumed_bytes`` counts only fully decoded frames, so a
    streaming caller can retry with a larger window after an ``IoError``
    (the mid-frame EOF signal). The FrameReader fast path.
    """
    lib = _require()
    buf = np.frombuffer(payload, dtype=np.uint8)
    err = ctypes.c_int32(0)
    consumed = ctypes.c_uint64(0)
    msg = ctypes.create_string_buffer(256)
    h = lib.cxt_decode_limited(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        max_frames, ctypes.byref(consumed), ctypes.byref(err), msg, 256)
    _checked(h, err, msg)
    try:
        n_frames = lib.cxt_n_frames(h)
        frames_buf = np.empty(n_frames, dtype=FRAME_DTYPE)
        lib.cxt_fill(h, frames_buf.ctypes.data, None, None)
        n = lib.cxt_pcm_len(h)
        pcm = np.empty(n, dtype=np.int32)
        lib.cxt_pcm_fill(h, pcm.ctypes.data)
    finally:
        lib.cxt_free(h)
    return int(consumed.value), frames_buf, pcm


def has_pack_helpers():
    """True when the C++ core loads: the port's core always has
    :func:`rows_to_i16` and :func:`minmax` (the JAX package's name)."""
    return available()


def rows_to_i16(src, n_rows, bs, dst16, lane0):
    """Fused copy-convert: ``n_rows`` rows of ``bs`` int32 samples from the
    contiguous ``src`` (1-D int32) into rows [lane0, lane0+n_rows) of the
    C-contiguous 2-D int16 array ``dst16``. Values must already fit
    int16. Raises ValueError for arrays or bounds the copy would overrun
    (the JAX package asserts the same conditions)."""
    lib = _require()
    if not (src.dtype == np.int32 and src.flags.c_contiguous
            and dst16.dtype == np.int16 and dst16.ndim == 2
            and dst16.flags.c_contiguous):
        raise ValueError("rows_to_i16: src must be contiguous int32 and "
                         "dst16 a C-contiguous 2-D int16 array")
    if not (0 <= lane0 and 0 <= n_rows and lane0 + n_rows <= dst16.shape[0]
            and 0 <= bs <= dst16.shape[1] and n_rows * bs <= src.size):
        raise ValueError(f"rows_to_i16: {n_rows} rows of {bs} samples at "
                         f"lane {lane0} overrun src ({src.size}) or dst16 "
                         f"{dst16.shape}")
    lib.cxt_rows_to_i16(src.ctypes.data, n_rows, bs, dst16.ctypes.data,
                        dst16.shape[1], lane0)


def minmax(arr):
    """(min, max) over a contiguous int32 array, including 0 (single C
    pass; the int16-input packing decision)."""
    lib = _require()
    if not (arr.dtype == np.int32 and arr.flags.c_contiguous):
        raise ValueError("minmax: arr must be contiguous int32")
    mn = ctypes.c_int32(0)
    mx = ctypes.c_int32(0)
    lib.cxt_minmax(arr.ctypes.data, arr.size, ctypes.byref(mn),
                   ctypes.byref(mx))
    return int(mn.value), int(mx.value)


def decode_stream_scalar(data):
    """Full native host decode (prediction + epilogue in C++); returns
    (streaminfo, pcm) with pcm shaped (total_samples, channels).

    The scalar oracle; bit-exact with the device pipeline.
    """
    lib = _require()
    data = bytes(data)
    streaminfo, pos = _read_metadata(data)
    h = _call(lib.cxt_decode, memoryview(data)[pos:])
    try:
        n_frames = lib.cxt_n_frames(h)
        frames_buf = np.empty(n_frames, dtype=FRAME_DTYPE)
        lib.cxt_fill(h, frames_buf.ctypes.data, None, None)
        n = lib.cxt_pcm_len(h)
        pcm = np.empty(n, dtype=np.int32)
        lib.cxt_pcm_fill(h, pcm.ctypes.data)
    finally:
        lib.cxt_free(h)
    channels = streaminfo.channels
    if np.any(frames_buf["channels"] != channels):
        raise FormatError("frame channel count does not match streaminfo")
    return streaminfo, pcm.reshape(-1, channels)
