"""Container decode through the port's batched pipeline (counterpart of
``claxon_tpu.containers.pipeline``).

Ogg audio packets are whole consecutive FLAC frames (one per packet) and
MP4 chunks are runs of consecutive frames, so concatenating them
reconstitutes a plain frame section. The port's C++ core walks it
(boundaries only, frame CRC-16 checks deferred to the device) and the
host-walk bits path decodes it on ``device`` in stream mode, as the JAX
package's container calls do: K2, K1 + K3 (one fused kernel) and K4, then
K3b for the int16 fetch. ``CLAXON_TPU_HOST_CRC`` (any nonempty value)
moves the frame CRC-16 checks into the walk, which then raises at the
first mismatch, and K4 does not run.

A frame section of ``pipeline_bits.MAX_BATCH_BYTES`` or more (int32 chunk
bit positions) decodes too: an Ogg payload walks in chunks of frames with
the container's STREAMINFO, an MP4's chunks are grouped into walk units
below the limit, and the units' results merge (``pipeline._decode_walked``).
The JAX package switches to its FrameDesc path there, with a warning; the
port has no such path and switches nothing, so it warns of nothing. The
PCM is the same.

``use_native=False`` extracts the frame section with the Python extractor
(``extract.extract_frames``, frame CRC-16 checked on the host) and decodes
its FrameDescs on the FrameDesc route (``pipeline.decode_batch``: K3b
unpack, K1 + K3), as the JAX package does. ``CLAXON_TPU_NO_BITS`` (any
nonempty value) takes the same route from the C++ core's FrameDesc
extraction (``native.extract_frames``), as the JAX package does.

Not carried over: ``CLAXON_TPU_BITS_PAYLOAD_CAP`` selects a switch the
port does not make and is not read.
"""

import io as _io

from ..error import Error, fmt_err
from ..io import MemReader
from ..metadata import read_metadata_block_with_header
from .mp4 import read_flac_from_mp4
from .ogg import read_flac_from_ogg

__all__ = ["decode_ogg_stream", "decode_mp4_stream"]


def _extract_section(payload, native, max_frames=None):
    """FrameDescs of a frame section (bytes-like) through the C++ core
    ``native``, or when it is None the Python extractor; ``max_frames``
    bounds the parse (an MP4 chunk declares its frame count)."""
    from ..extract import extract_frames

    if native is not None:
        return native.extract_frames(payload, max_frames)
    return extract_frames(MemReader(payload), max_frames=max_frames)


def _decode_frames(streaminfo, frames, device):
    """Decode one stream's FrameDescs on the FrameDesc route."""
    from ..extract import StreamBatch
    from ..pipeline import decode_batch

    return decode_batch(StreamBatch(streaminfo=streaminfo, frames=frames),
                        device=device)


def _defer_crc():
    """The walk defers the frame CRC-16 checks to the device (K4) unless
    ``CLAXON_TPU_HOST_CRC`` is set (``claxon_tpu.containers.pipeline.
    _defer_crc``)."""
    import os

    return not os.environ.get("CLAXON_TPU_HOST_CRC")


def _decode_units(streaminfo, units, device):
    """Decode one stream's walk units (BitsBatches of consecutive frame
    runs, each below the byte limit) and fetch its PCM."""
    from ..pipeline import (_L_QUANTUM, _decode_walked, _unit_bytes,
                            _verify_before_bad_channels)

    _verify_before_bad_channels(streaminfo, units)
    dd = _decode_walked([(streaminfo, bb) for bb in units],
                        [0] * len(units), [_unit_bytes(bb) for bb in units],
                        1, _L_QUANTUM, device)
    return dd.start_fetch().to_host()[0]


def decode_ogg_stream(data, use_native=True, verify_crc=True, device="cuda"):
    """Decode a whole FLAC-in-Ogg stream (bytes, or a file-like object)
    on ``device``; returns a ``DecodedStream``. ``verify_crc`` checks each
    Ogg page's CRC-32; frame CRC-16s are always verified, on the device
    (on the host with ``CLAXON_TPU_HOST_CRC``, by the Python extractor
    with ``use_native=False`` and by the C++ FrameDesc extraction under
    ``CLAXON_TPU_NO_BITS``)."""
    from .. import pipeline_bits
    from ..pipeline import _native, _no_bits, _walk_frames_chunked

    stream = _io.BytesIO(data) if isinstance(
        data, (bytes, bytearray, memoryview)) else data
    streaminfo, header_packets, audio_packets = read_flac_from_ogg(
        stream, verify_crc=verify_crc)
    for packet in header_packets:
        # Metadata blocks: decoded (validated) and discarded, mirroring
        # the reference example (`examples/decode_ogg.rs:39-43`).
        read_metadata_block_with_header(MemReader(packet))
    # Every audio packet is exactly one frame, so the concatenation is a
    # plain frame section.
    payload = b"".join(p for p in audio_packets if p)
    native = _native() if use_native else None
    if native is None or _no_bits():
        return _decode_frames(streaminfo, _extract_section(payload, native),
                              device)
    limit = pipeline_bits.MAX_BATCH_BYTES
    defer = _defer_crc()
    if len(payload) < limit:
        units = [native.extract_frames_bits(payload, emit_slots=False,
                                            defer_crc=defer)]
    else:
        units = _walk_frames_chunked(streaminfo, memoryview(payload), native,
                                     limit, defer_crc=defer)
    return _decode_units(streaminfo, units, device)


def decode_mp4_stream(data, use_native=True, device="cuda"):
    """Decode a whole FLAC-in-MP4 file (bytes) on ``device``; returns a
    ``DecodedStream``."""
    from .. import pipeline_bits
    from ..pipeline import (_native, _no_bits, _split_batch, _unit_bytes,
                            _walk_frames_chunked)
    from ..pipeline_bits import _host_verify_deferred

    native = _native() if use_native else None
    framedesc = native is None or _no_bits()
    data = bytes(data)
    view = memoryview(data)
    track = read_flac_from_mp4(data)
    limit = pipeline_bits.MAX_BATCH_BYTES
    # Bound each chunk's byte range by the next chunk's offset (offsets may
    # be written in any order) so a decode never copies the whole file
    # suffix per chunk.
    sorted_offsets = sorted(o for o, n in
                            zip(track.chunk_offsets,
                                track.samples_per_chunk) if n)
    defer = _defer_crc()
    frames, batches = [], []

    def _crc_before_error():
        # Reference order parity: frames of EARLIER chunks (and of the
        # current chunk's successful prefix) precede the error about to
        # surface, so any deferred CRC mismatch among them wins -- the
        # sequential reference would have hit it first. The C++ walker
        # only re-verifies within one extract call; chunks are separate
        # calls, so the cross-chunk pass happens here.
        for done in batches:
            _host_verify_deferred(done, len(done.bframes))

    for offset, n in zip(track.chunk_offsets, track.samples_per_chunk):
        if not n:
            continue
        if not 0 <= offset < len(data):
            _crc_before_error()
            fmt_err("invalid MP4 chunk offset")
        nxt = [o for o in sorted_offsets if o > offset]
        end = nxt[0] if nxt else len(data)
        # A chunk holds exactly n frames; the bounded parse stops before
        # any inter-chunk slack (`examples/decode_mp4.rs:132-167`).
        if framedesc:
            got = _extract_section(view[offset:end], native, n)
            if len(got) < n:
                fmt_err("MP4 chunk ends before its declared frame count")
            frames.extend(got)
            continue
        try:
            if end - offset < limit:
                used = []
                got = [native.extract_frames_bits(
                    view[offset:end], emit_slots=False, max_frames=n,
                    consumed=used, defer_crc=defer)]
                # Trim inter-chunk slack so merged chunk payloads
                # reconstitute a contiguous frame section.
                got[0].payload = view[offset:offset + used[0]]
            else:
                got = _walk_frames_chunked(track.streaminfo,
                                           view[offset:end], native, limit,
                                           max_frames=n, defer_crc=defer)
        except Error:
            _crc_before_error()
            raise
        batches.extend(got)
        if sum(len(bb.bframes) for bb in got) < n:
            _crc_before_error()
            fmt_err("MP4 chunk ends before its declared frame count")
    if framedesc:
        return _decode_frames(track.streaminfo, frames, device)
    # Consecutive chunks merge into walk units below the byte limit: one
    # unit, as in the JAX package, unless the file is that large.
    units = [native.merge_bits_batches([batches[k] for k in run])
             for run in _split_batch([_unit_bytes(bb) for bb in batches],
                                     limit)]
    return _decode_units(track.streaminfo, units, device)
