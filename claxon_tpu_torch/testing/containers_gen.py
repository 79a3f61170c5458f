"""Spec-derived Ogg and MP4 muxers for FLAC test corpora (a copy of
``claxon_tpu.testing.containers_gen``; the frame spans come from the
port's C++ walk, since the port has no Python frame reader).

The reference has no muxers (its container examples are decode-only and its
test corpus ships no .oga/.mp4 files); these generators exist so the
container demux layers (``claxon_tpu_torch.containers``) can be round-trip
tested hermetically. Formats written straight from RFC 3533 + the
FLAC-to-Ogg mapping, and ISO BMFF + the FLAC-in-MP4 encapsulation spec.
"""

import struct

from ..io import MemReader
from ..metadata import read_metadata_block_header, read_stream_header

__all__ = ["split_flac", "mux_ogg_flac", "mux_mp4_flac"]


def split_flac(data):
    """Split a FLAC stream into (metadata_blocks, frames): raw byte strings
    of each metadata block (with header) and of each frame."""
    from ..native import extract_frames_bits

    data = bytes(data)
    r = MemReader(data)
    read_stream_header(r)

    blocks = []
    while True:
        p0 = r.pos
        is_last, _block_type, length = read_metadata_block_header(r)
        r.skip(length)
        blocks.append(data[p0:r.pos])
        if is_last:
            break

    # Only the frame spans are needed: the stored frame CRCs are not
    # checked, so a stream with a damaged CRC can be muxed for a test.
    pos = r.pos
    bf = extract_frames_bits(memoryview(data)[pos:], emit_slots=False,
                             defer_crc=True).bframes
    frames = [data[pos + int(b0):pos + int(b1)]
              for b0, b1 in zip(bf["byte0"], bf["byte1"])]
    return blocks, frames


def _ogg_pages(packets, serial=0x01020304):
    """Yield raw Ogg pages for the packet sequence (RFC 3533)."""
    from ..containers.ogg import ogg_page_crc

    # Build the global lacing/segment stream, then cut into pages of at
    # most 255 segments.
    segments = []  # (bytes, continues_previous)
    for pkt in packets:
        pos = 0
        first = True
        while True:
            take = min(255, len(pkt) - pos)
            segments.append((pkt[pos:pos + take], not first))
            first = False
            pos += take
            if take < 255:
                break

    pages = []
    seq = 0
    i = 0
    while i < len(segments) or seq == 0:
        page_segs = segments[i:i + 255]
        i += len(page_segs)
        htype = 0
        if page_segs and page_segs[0][1]:
            htype |= 0x01  # continued packet
        if seq == 0:
            htype |= 0x02  # beginning of stream
        if i >= len(segments):
            htype |= 0x04  # end of stream
        lacing = bytes(len(s) for s, _ in page_segs)
        body = b"".join(s for s, _ in page_segs)
        hdr = struct.pack("<4sBBqIIIB", b"OggS", 0, htype, 0, serial, seq,
                          0, len(page_segs))
        crc = ogg_page_crc(hdr + lacing + body)
        hdr = hdr[:22] + struct.pack("<I", crc) + hdr[26:]
        pages.append(hdr + lacing + body)
        seq += 1
        if not page_segs:
            break
    return pages


def mux_ogg_flac(flac_data):
    """Wrap a FLAC stream in Ogg per the FLAC-to-Ogg mapping."""
    blocks, frames = split_flac(flac_data)
    streaminfo_block = blocks[0]
    rest = blocks[1:]
    first_packet = (bytes([0x7F]) + b"FLAC" + bytes([1, 0]) +
                    struct.pack(">H", len(rest)) + b"fLaC" +
                    streaminfo_block)
    packets = [first_packet] + list(rest) + list(frames)
    return b"".join(_ogg_pages(packets))


def _box(btype, payload):
    return struct.pack(">I4s", 8 + len(payload), btype) + payload


def mux_mp4_flac(flac_data, frames_per_chunk=3):
    """Wrap a FLAC stream in a minimal MP4 per the FLAC-in-MP4 spec.

    Frames are grouped ``frames_per_chunk`` per chunk (the tail chunk is
    smaller, exercising the stsc 1-based first_chunk semantics the
    reference's example handles, `decode_mp4.rs:75-93`).
    """
    blocks, frames = split_flac(flac_data)

    # Chunks of frames.
    chunks = [frames[i:i + frames_per_chunk]
              for i in range(0, len(frames), frames_per_chunk)]
    chunk_bytes = [b"".join(c) for c in chunks]

    # dfLa: version+flags, then all metadata blocks with headers; the
    # STREAMINFO's is_last bit must reflect the dfLa content.
    dfla_payload = b"\x00\x00\x00\x00" + b"".join(blocks)
    dfla = _box(b"dfLa", dfla_payload)

    # AudioSampleEntry 'fLaC': 6 reserved + 2 data_ref_index + 8 reserved +
    # channels(2) + samplesize(2) + predefined(2) + reserved(2) +
    # samplerate(16.16 fixed), then dfLa.
    sample_entry = _box(
        b"fLaC",
        b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 8 +
        struct.pack(">HHHHI", 2, 16, 0, 0, 44100 << 16) + dfla)
    stsd = _box(b"stsd", struct.pack(">II", 0, 1) + sample_entry)

    # stsc entries: (first_chunk, samples_per_chunk, sdi), first_chunk
    # strictly increasing (ISO 14496-12): a second entry only when a short
    # tail chunk follows at least one full chunk.
    if chunks and len(chunks[-1]) != frames_per_chunk:
        if len(chunks) == 1:
            entries = [(1, len(chunks[-1]), 1)]
        else:
            entries = [(1, frames_per_chunk, 1),
                       (len(chunks), len(chunks[-1]), 1)]
    else:
        entries = [(1, frames_per_chunk, 1)]
    stsc = _box(b"stsc", struct.pack(">II", 0, len(entries)) +
                b"".join(struct.pack(">III", *e) for e in entries))

    # stco offsets are absolute; lay out ftyp + moov first, then mdat.
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2")

    def build_moov(offsets):
        stco = _box(b"stco", struct.pack(">II", 0, len(offsets)) +
                    b"".join(struct.pack(">I", o) for o in offsets))
        stbl = _box(b"stbl", stsd + stsc + stco)
        minf = _box(b"minf", stbl)
        mdia = _box(b"mdia", minf)
        trak = _box(b"trak", mdia)
        return _box(b"moov", trak)

    # moov size is independent of offset VALUES (fixed-width u32), so one
    # dry pass with zeros determines the layout.
    moov_size = len(build_moov([0] * len(chunk_bytes)))
    mdat_payload_start = len(ftyp) + moov_size + 8
    offsets = []
    pos = mdat_payload_start
    for cb in chunk_bytes:
        offsets.append(pos)
        pos += len(cb)
    moov = build_moov(offsets)
    mdat = _box(b"mdat", b"".join(chunk_bytes))
    return ftyp + moov + mdat
