"""Ogg encapsulation of FLAC (RFC 3533 pages + the FLAC-to-Ogg mapping; a
copy of ``claxon_tpu.containers.ogg``).

Spec-derived Ogg page/packet reader playing the role of the ``ogg`` crate
in the reference's `examples/decode_ogg.rs`. The FLAC mapping (xiph.org
"FLAC-to-Ogg mapping"): the first packet is 0x7F 'FLAC' major minor
header-count(u16be) 'fLaC' followed by the STREAMINFO metadata block with
header; each subsequent header packet is one metadata block; every audio
packet is exactly one FLAC frame.

Decode flow mirrors `examples/decode_ogg.rs:26-125`: packet 0 ->
skip 7 magic bytes + u16 header count -> read_metadata_block_with_header;
header packets decoded and discarded; each audio packet becomes one frame
decoded over an in-memory cursor.
"""

import struct

from ..error import fmt_err
from ..io import MemReader

__all__ = ["OggPacketReader", "read_flac_from_ogg", "ogg_page_crc"]

_CRC_TABLE = []


def _crc_table():
    # CRC-32 poly 0x04c11db7, MSB-first, no reflection (RFC 3533 section 6).
    if not _CRC_TABLE:
        for b in range(256):
            r = b << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7 if r & 0x80000000 else r << 1)
                r &= 0xFFFFFFFF
            _CRC_TABLE.append(r)
    return _CRC_TABLE


def ogg_page_crc(page_bytes):
    """The Ogg page CRC-32 (computed with the CRC field zeroed)."""
    table = _crc_table()
    crc = 0
    for b in page_bytes:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ table[((crc >> 24) ^ b) & 0xFF]
    return crc


class OggPacketReader:
    """Iterate packets of ONE logical Ogg bitstream (the first serial seen).

    Verifies each page's CRC-32 and reassembles packets across page
    boundaries via the 255-lacing continuation rule.
    """

    def __init__(self, stream, verify_crc=True):
        self._stream = stream
        self._verify_crc = verify_crc
        self._serial = None
        self._segments = []   # queued (data, ends_packet) from current page
        self._partial = bytearray()
        self._eos = False

    def __iter__(self):
        return self

    def _read_exact(self, n):
        """Read exactly n bytes; file-like objects may legally return
        short reads before EOF, so loop. b'' only at immediate EOF."""
        parts = []
        got = 0
        while got < n:
            chunk = self._stream.read(n - got)
            if not chunk:
                break
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def _read_page(self):
        hdr = self._read_exact(27)
        if not hdr:
            return False
        if len(hdr) < 27 or hdr[:4] != b"OggS":
            fmt_err("invalid Ogg page")
        (version, htype, granule, serial, seq, crc,
         nsegs) = struct.unpack("<xxxxBBqIIIB", hdr)
        if version != 0:
            fmt_err("unsupported Ogg page version")
        lacing = self._read_exact(nsegs)
        if len(lacing) < nsegs:
            fmt_err("truncated Ogg page")
        body_len = sum(lacing)
        body = self._read_exact(body_len)
        if len(body) < body_len:
            fmt_err("truncated Ogg page")

        if self._verify_crc:
            page = bytearray(hdr)
            page[22:26] = b"\x00\x00\x00\x00"
            page += lacing + body
            if ogg_page_crc(page) != crc:
                fmt_err("Ogg page CRC mismatch")

        if self._serial is None:
            self._serial = serial
        if serial != self._serial:
            return True  # skip pages of other logical streams

        continued = bool(htype & 0x01)
        if not continued and self._partial:
            # Lost continuation; drop the stale partial packet.
            self._partial = bytearray()

        drop_tail = 0
        if continued and not self._partial and not self._segments:
            # Orphaned continuation (e.g. interleaved pages of another
            # serial split the packet): the leading segments up to and
            # including the first packet terminator belong to a packet
            # whose head we never saw -- discard them instead of gluing
            # them onto the next packet.
            drop_tail = len(lacing)  # no terminator: the whole page is tail
            for i, lace in enumerate(lacing):
                if lace < 255:
                    drop_tail = i + 1
                    break

        pos = 0
        for i, lace in enumerate(lacing):
            seg = body[pos:pos + lace]
            pos += lace
            if i < drop_tail:
                continue
            self._segments.append((seg, lace < 255))
        # A page ending with a 255 lace leaves the packet open for the next
        # page (handled naturally by the queue).
        return True

    def __next__(self):
        while True:
            while self._segments:
                seg, ends = self._segments.pop(0)
                self._partial += seg
                if ends:
                    pkt = bytes(self._partial)
                    self._partial = bytearray()
                    return pkt
            if not self._read_page():
                if self._partial:
                    fmt_err("truncated Ogg packet at end of stream")
                raise StopIteration


def read_flac_from_ogg(stream, verify_crc=True):
    """Parse a FLAC-in-Ogg stream; returns (streaminfo, header_packets,
    audio_packet_iterator). Mirrors `examples/decode_ogg.rs:70-94`."""
    from ..metadata import read_metadata_block_with_header

    packets = OggPacketReader(stream, verify_crc=verify_crc)
    first = next(packets, None)
    if first is None:
        fmt_err("invalid Ogg page")  # empty stream: no pages at all
    cursor = MemReader(first)
    # 0x7F 'FLAC' major minor: 7 bytes of mapping magic/version.
    if len(first) < 9 or first[0] != 0x7F or first[1:5] != b"FLAC":
        fmt_err("invalid FLAC-to-Ogg mapping packet")
    cursor.skip(7)
    n_header_packets = cursor.read_be_u16()
    if cursor.read_into(4) != b"fLaC":
        fmt_err("invalid stream header")
    block = read_metadata_block_with_header(cursor)
    if block.kind != "streaminfo":
        fmt_err("streaminfo block missing")

    def header_packets():
        for _ in range(n_header_packets):
            pkt = next(packets, None)
            if pkt is None:
                fmt_err("Ogg stream ends before its declared header packets")
            yield pkt

    return block.streaminfo, header_packets(), packets
