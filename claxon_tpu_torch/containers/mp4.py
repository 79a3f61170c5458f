"""FLAC in MP4 (ISO BMFF) -- the "FLAC in MP4" encapsulation spec (a copy
of ``claxon_tpu.containers.mp4``).

Spec-derived box walker playing the role of the ``mp4parse`` crate in the
reference's `examples/decode_mp4.rs`: find the track whose sample entry is
'fLaC', read the FLACSpecificBox ('dfLa': version/flags + metadata blocks
with headers, STREAMINFO first), and expose the chunk layout (stco/co64
chunk offsets + stsc samples-per-chunk with its 1-based first_chunk
semantics, `examples/decode_mp4.rs:75-93`). Each MP4 "sample" is one FLAC
frame.
"""

import struct
from dataclasses import dataclass
from typing import List

from ..error import fmt_err
from ..io import MemReader

__all__ = ["Mp4FlacTrack", "read_flac_from_mp4"]


def _boxes(data, start, end):
    """Yield (type, body_start, body_end) for boxes in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, btype = struct.unpack_from(">I4s", data, pos)
        body = pos + 8
        if size == 1:
            if pos + 16 > end:
                fmt_err("invalid MP4 box size")
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            body = pos + 16
            if size < 16:
                fmt_err("invalid MP4 box size")
        elif size == 0:
            size = end - pos
        if size < 8 or pos + size > end:
            fmt_err("invalid MP4 box size")
        yield btype, body, pos + size
        pos += size


def _find(data, start, end, path):
    """Walk a container path like [b'moov', b'trak'] yielding leaf spans."""
    if not path:
        yield start, end
        return
    for btype, b0, b1 in _boxes(data, start, end):
        if btype == path[0]:
            yield from _find(data, b0, b1, path[1:])


@dataclass
class Mp4FlacTrack:
    """The demuxed FLAC track of an MP4 file."""
    #: raw FLACSpecificBox payload: metadata blocks with headers
    flac_specific: bytes
    #: parsed STREAMINFO
    streaminfo: object
    #: absolute file offset of each chunk
    chunk_offsets: List[int]
    #: number of FLAC frames in each chunk
    samples_per_chunk: List[int]


def _parse_stsc(data, b0, b1):
    if b0 + 8 > b1:
        fmt_err("invalid MP4 sample table")
    count = struct.unpack_from(">I", data, b0 + 4)[0]
    if b0 + 8 + count * 12 > b1:
        fmt_err("invalid MP4 sample table")  # count overruns the box
    entries = []
    pos = b0 + 8
    for _ in range(count):
        first_chunk, spc, _sdi = struct.unpack_from(">III", data, pos)
        entries.append((first_chunk, spc))
        pos += 12
    return entries


def _parse_stco(data, b0, b1, wide):
    if b0 + 8 > b1:
        fmt_err("invalid MP4 sample table")
    count = struct.unpack_from(">I", data, b0 + 4)[0]
    fmt = ">Q" if wide else ">I"
    step = 8 if wide else 4
    if b0 + 8 + count * step > b1:
        fmt_err("invalid MP4 sample table")
    return [struct.unpack_from(fmt, data, b0 + 8 + i * step)[0]
            for i in range(count)]


def read_flac_from_mp4(data) -> Mp4FlacTrack:
    """Find the (first) FLAC track in an MP4 file (bytes)."""
    from ..metadata import read_metadata_block_with_header

    data = bytes(data)
    for t0, t1 in _find(data, 0, len(data), [b"moov", b"trak"]):
        flac_specific = None
        stsc = stco = None
        for s0, s1 in _find(data, t0, t1,
                            [b"mdia", b"minf", b"stbl"]):
            for btype, b0, b1 in _boxes(data, s0, s1):
                if btype == b"stsd":
                    # version/flags(4) + entry_count(4), then sample entries.
                    for etype, e0, e1 in _boxes(data, b0 + 8, b1):
                        if etype != b"fLaC":
                            continue
                        # AudioSampleEntry: 8 (SampleEntry) + 20 fixed
                        # fields, then child boxes (dfLa).
                        for ctype, c0, c1 in _boxes(data, e0 + 28, e1):
                            if ctype == b"dfLa":
                                # version(1) + flags(3), then blocks.
                                flac_specific = data[c0 + 4:c1]
                elif btype == b"stsc":
                    stsc = _parse_stsc(data, b0, b1)
                elif btype == b"stco":
                    stco = _parse_stco(data, b0, b1, wide=False)
                elif btype == b"co64":
                    stco = _parse_stco(data, b0, b1, wide=True)
        if flac_specific is None:
            continue
        if stco is None or stsc is None:
            fmt_err("FLAC track missing chunk tables")

        # stsc semantics: entry (first_chunk, spc) applies from first_chunk
        # (1-based) until the next entry's first_chunk.
        spc = []
        for i in range(1, len(stco) + 1):
            current = 0
            for first_chunk, n in stsc:
                if first_chunk <= i:
                    current = n
                else:
                    break
            spc.append(current)

        cursor = MemReader(flac_specific)
        block = read_metadata_block_with_header(cursor)
        if block.kind != "streaminfo":
            fmt_err("streaminfo block missing")
        return Mp4FlacTrack(flac_specific=flac_specific,
                            streaminfo=block.streaminfo,
                            chunk_offsets=stco, samples_per_chunk=spc)
    fmt_err("no FLAC track found in MP4 file")
