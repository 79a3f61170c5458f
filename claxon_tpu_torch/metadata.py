"""Stream header and metadata blocks at the beginning of a FLAC stream (a
copy of ``claxon_tpu.metadata``, plus ``read_stream_header`` from
``claxon_tpu.reader``).

Mirrors claxon `src/metadata.rs`: STREAMINFO parse + validation, Vorbis
comment parse with anti-DoS limits, block-type dispatch, tag iterators, and
the two standalone entry points used for container embedding:

* ``read_metadata_block_with_header`` -- Ogg embeds metadata blocks verbatim
  including their headers (`src/metadata.rs:243-248`).
* ``read_metadata_block`` -- MP4's "FLAC Specific Box" carries the block
  type and raw data separately (`src/metadata.rs:260-319`).

The port's decode paths call :func:`read_stream_header` and
:func:`read_flac_metadata` (through ``native.binding._read_metadata``), as
``FlacReader`` and the Python extractor do.
"""

from dataclasses import dataclass, field
from typing import Optional, List, Tuple

from .error import Error, Unsupported, fmt_err

__all__ = [
    "StreamInfo", "SeekPoint", "SeekTable", "VorbisComment",
    "MetadataBlock", "MetadataBlockReader",
    "read_metadata_block", "read_metadata_block_with_header",
    "Tags", "GetTag", "read_flac_metadata", "read_stream_header",
]

# Metadata block bodies larger than this are rejected to avoid
# memory-exhaustion DoS via tiny malicious files (reference
# `src/metadata.rs:422-425,532-536`).
_MAX_BLOCK_BODY = 10 * 1024 * 1024


@dataclass(frozen=True)
class StreamInfo:
    """The streaminfo metadata block (reference `src/metadata.rs:23-54`)."""

    #: Minimum block size (in inter-channel samples) used in the stream.
    min_block_size: int
    #: Maximum block size (in inter-channel samples) used in the stream.
    #: A buffer of this size times the number of channels can be allocated
    #: up front and passed into ``FrameReader.read_next_or_eof``.
    max_block_size: int
    #: Minimum frame size in bytes, or None if unknown.
    min_frame_size: Optional[int]
    #: Maximum frame size in bytes, or None if unknown.
    max_frame_size: Optional[int]
    #: Sample rate in Hz.
    sample_rate: int
    #: Number of channels.
    channels: int
    #: Bits per sample.
    bits_per_sample: int
    #: Total number of inter-channel samples, or None if unknown.
    samples: Optional[int]
    #: MD5 signature of the unencoded audio data.
    md5sum: bytes


@dataclass(frozen=True)
class SeekPoint:
    """A seek point in the seek table (reference `src/metadata.rs:56-66`)."""
    sample: int
    offset: int
    samples: int


@dataclass
class SeekTable:
    """A seek table. Deliberately never constructed: the reference defines
    the same struct but skips SEEKTABLE blocks as padding
    (`src/metadata.rs:69-73`, its TODO: implement seeking), and this
    library matches that behavior exactly -- the type exists only for API
    parity with the reference's public surface."""
    seekpoints: List[SeekPoint] = field(default_factory=list)


@dataclass
class VorbisComment:
    """Vorbis comments, also known as FLAC tags.

    ``comments`` stores the raw representation: the full ``"NAME=value"``
    string plus the index of ``'='`` (reference `src/metadata.rs:75-101`).
    Names are ASCII and matched case-insensitively; they need not be unique.
    """
    vendor: str
    comments: List[Tuple[str, int]]


class MetadataBlock:
    """A metadata block (reference `src/metadata.rs:103-129`).

    ``kind`` is one of: ``"streaminfo"``, ``"padding"``, ``"application"``,
    ``"vorbis_comment"``, ``"reserved"``. SEEKTABLE, CUESHEET and PICTURE
    blocks are skipped and surface as ``"padding"``, exactly like the
    reference (`src/metadata.rs:287-304`); the ``seektable`` attribute
    exists only for API parity and is never populated.
    """

    __slots__ = ("kind", "streaminfo", "vorbis_comment", "length",
                 "application_id", "application_data", "seektable")

    def __init__(self, kind, **kw):
        self.kind = kind
        self.streaminfo = kw.get("streaminfo")
        self.vorbis_comment = kw.get("vorbis_comment")
        self.length = kw.get("length")
        self.application_id = kw.get("application_id")
        self.application_data = kw.get("application_data")
        self.seektable = kw.get("seektable")

    def __repr__(self):
        return f"MetadataBlock(kind={self.kind!r})"


class Tags:
    """Iterator over (name, value) pairs of Vorbis comments
    (reference `src/metadata.rs:131-165`)."""

    def __init__(self, comments):
        self._comments = comments
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._comments):
            raise StopIteration
        comment, sep = self._comments[self._i]
        self._i += 1
        return (comment[:sep], comment[sep + 1:])

    def __len__(self):
        return len(self._comments) - self._i


class GetTag:
    """Case-insensitive lookup of a named tag; yields values
    (reference `src/metadata.rs:167-211`)."""

    def __init__(self, comments, needle):
        self._comments = comments
        self._needle = needle
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        needle = self._needle
        while self._i < len(self._comments):
            comment, sep = self._comments[self._i]
            self._i += 1
            name = comment[:sep]
            if _eq_ignore_ascii_case(name, needle):
                return comment[sep + 1:]
        raise StopIteration


def _eq_ignore_ascii_case(a, b):
    """ASCII-only case-insensitive equality, like the reference's
    eq_ignore_ascii_case (`src/metadata.rs:204`): non-ASCII characters
    never match case-insensitively (Python's str.lower() would fold e.g.
    the Kelvin sign into 'k')."""
    if len(a) != len(b):
        return False
    for ca, cb in zip(a, b):
        oa, ob = ord(ca), ord(cb)
        if 65 <= oa <= 90:
            oa += 32
        if 65 <= ob <= 90:
            ob += 32
        if oa != ob:
            return False
    return True


def read_metadata_block_header(input):
    """Read the 4-byte block header: is_last bit, 7-bit type, 24-bit length
    (reference `src/metadata.rs:213-231`)."""
    byte = input.read_u8()
    is_last = (byte >> 7) == 1
    block_type = byte & 0b0111_1111
    length = input.read_be_u24()
    return is_last, block_type, length


def read_metadata_block_with_header(input):
    """Read a single metadata block header and body from the input.

    For FLAC embedded in a container that keeps block headers (Ogg).
    Returns the ``MetadataBlock`` (reference `src/metadata.rs:243-248`).
    """
    _is_last, block_type, length = read_metadata_block_header(input)
    return read_metadata_block(input, block_type, length)


def read_metadata_block(input, block_type, length):
    """Read a single metadata block body of the given type and length.

    For FLAC embedded in a container that separates type and payload (MP4's
    FLAC Specific Box). Reference dispatch: `src/metadata.rs:260-319`.
    """
    if block_type == 0:
        # STREAMINFO payloads are always exactly 34 bytes long.
        if length != 34:
            fmt_err("invalid streaminfo metadata block length")
        return MetadataBlock("streaminfo", streaminfo=read_streaminfo_block(input))
    elif block_type == 1:
        input.skip(length)
        return MetadataBlock("padding", length=length)
    elif block_type == 2:
        app_id, data = read_application_block(input, length)
        return MetadataBlock("application", application_id=app_id,
                             application_data=data)
    elif block_type == 3:
        # Seektable: parsed as padding, matching the reference
        # (`src/metadata.rs:287-289`; seeking is not implemented there).
        input.skip(length)
        return MetadataBlock("padding", length=length)
    elif block_type == 4:
        return MetadataBlock("vorbis_comment",
                             vorbis_comment=read_vorbis_comment_block(input, length))
    elif block_type == 5:
        input.skip(length)
        return MetadataBlock("padding", length=length)
    elif block_type == 6:
        input.skip(length)
        return MetadataBlock("padding", length=length)
    elif block_type == 127:
        # Invalid to avoid confusion with a frame sync code.
        fmt_err("invalid metadata block type")
    else:
        input.skip(length)
        return MetadataBlock("reserved")


def read_streaminfo_block(input):
    """Parse the 34-byte streaminfo body with the reference's validation
    (`src/metadata.rs:321-400`)."""
    min_block_size = input.read_be_u16()
    max_block_size = input.read_be_u16()
    min_frame_size = input.read_be_u24()
    max_frame_size = input.read_be_u24()

    # 20 bits sample rate, 3 bits channels-1, 5 bits bps-1, 36 bits samples.
    sample_rate_msb = input.read_be_u16()
    sample_rate_lsb = input.read_u8()
    sample_rate = (sample_rate_msb << 4) | (sample_rate_lsb >> 4)

    n_channels = ((sample_rate_lsb >> 1) & 0b0000_0111) + 1
    bps_msb = sample_rate_lsb & 1
    bps_lsb_n_samples = input.read_u8()
    bits_per_sample = ((bps_msb << 4) | (bps_lsb_n_samples >> 4)) + 1

    n_samples_msb = bps_lsb_n_samples & 0b0000_1111
    n_samples_lsb = input.read_be_u32()
    n_samples = (n_samples_msb << 32) | n_samples_lsb

    md5sum = input.read_into(16)

    # Lower bounds can never be larger than upper bounds; 0 means unknown for
    # the frame sizes; the block size must be at least 16.
    if min_block_size > max_block_size:
        fmt_err("inconsistent bounds, min block size > max block size")
    if min_block_size < 16:
        fmt_err("invalid block size, must be at least 16")
    if min_frame_size > max_frame_size and max_frame_size != 0:
        fmt_err("inconsistent bounds, min frame size > max frame size")

    # Sample rate 0 is invalid; frame headers limit the rate to 655350 Hz.
    if sample_rate == 0 or sample_rate > 655350:
        fmt_err("invalid sample rate")

    return StreamInfo(
        min_block_size=min_block_size,
        max_block_size=max_block_size,
        min_frame_size=min_frame_size if min_frame_size != 0 else None,
        max_frame_size=max_frame_size if max_frame_size != 0 else None,
        sample_rate=sample_rate,
        channels=n_channels,
        bits_per_sample=bits_per_sample,
        samples=n_samples if n_samples != 0 else None,
        md5sum=bytes(md5sum),
    )


def read_vorbis_comment_block(input, length):
    """Parse a Vorbis comment block with the reference's anti-DoS limits and
    length cross-checks (`src/metadata.rs:402-513`)."""
    if length < 8:
        # At minimum a 32-bit vendor string length and a 32-bit comment count.
        fmt_err("Vorbis comment block is too short")

    # Reject excessively large blocks: they are full of length-prefixed
    # strings for which memory is allocated up front; a malicious file could
    # otherwise cause OOM.
    if length > _MAX_BLOCK_BODY:
        raise Unsupported("Vorbis comment blocks larger than 10 MiB are not supported")

    vendor_len = input.read_le_u32()
    if vendor_len > length - 8:
        fmt_err("vendor string too long")
    vendor_bytes = input.read_into(vendor_len)
    try:
        vendor = vendor_bytes.decode("utf-8")
    except UnicodeDecodeError:
        fmt_err("Vorbis comment or vendor string is not valid UTF-8")

    # Every comment is at least 4 bytes (its length prefix), so there cannot
    # be more comments than length / 4; upper bound against DoS allocation.
    comments_len = input.read_le_u32()
    if comments_len >= length // 4:
        fmt_err("too many entries for Vorbis comment block")

    comments = []
    bytes_left = length - 8 - vendor_len

    while bytes_left >= 4 and len(comments) < comments_len:
        comment_len = input.read_le_u32()
        bytes_left -= 4

        if comment_len > bytes_left:
            fmt_err("Vorbis comment too long for Vorbis comment block")

        # Some older libflac versions wrote zero-length Vorbis comments;
        # such files occur in the wild, skip the empty comment.
        if comment_len == 0:
            comments_len -= 1
            continue

        comment_bytes = input.read_into(comment_len)
        bytes_left -= comment_len

        sep_index = comment_bytes.find(b"=")
        if sep_index == -1:
            fmt_err("Vorbis comment does not contain '='")

        name_bytes = comment_bytes[:sep_index]
        # Per the Vorbis spec the field name is ASCII 0x20..0x7d, '=' excluded.
        # If this check passes, the name part is valid UTF-8 too.
        if any(b < 0x20 or b > 0x7D for b in name_bytes):
            fmt_err("Vorbis comment field name contains invalid byte")

        try:
            comment = comment_bytes.decode("utf-8")
        except UnicodeDecodeError:
            fmt_err("Vorbis comment or vendor string is not valid UTF-8")

        comments.append((comment, sep_index))

    if bytes_left != 0:
        fmt_err("Vorbis comment block has excess data")

    if len(comments) != comments_len:
        fmt_err("Vorbis comment block contains wrong number of entries")

    return VorbisComment(vendor=vendor, comments=comments)


def read_application_block(input, length):
    """Parse an application block (reference `src/metadata.rs:524-549`)."""
    if length < 4:
        fmt_err("application block length must be at least 4 bytes")

    if length > _MAX_BLOCK_BODY:
        raise Unsupported("application blocks larger than 10 MiB are not supported")

    app_id = input.read_be_u32()
    data = input.read_into(length - 4)
    return app_id, data


def read_flac_metadata(input, metadata_only=False, read_vorbis_comment=True):
    """Scan the metadata section with the public-reader validation rules
    (reference `src/lib.rs:230-297`): the first block must be STREAMINFO,
    a second STREAMINFO or second Vorbis comment is a format error, and
    with ``metadata_only`` the scan stops once all desired blocks are read.

    Returns (streaminfo, vorbis_comment). Every decode path of the port
    reads metadata through it, so they accept and reject the same streams
    as the JAX package's.
    """
    metadata_iter = MetadataBlockReader(input)
    first = next(metadata_iter)
    if first.kind != "streaminfo":
        fmt_err("streaminfo block missing")
    streaminfo = first.streaminfo

    want_vorbis = read_vorbis_comment
    vorbis_comment = None
    for block in metadata_iter:
        if block.kind == "vorbis_comment":
            if vorbis_comment is not None:
                fmt_err("encountered second Vorbis comment block")
            vorbis_comment = block.vorbis_comment
            want_vorbis = False
        elif block.kind == "streaminfo":
            fmt_err("encountered second streaminfo block")
        if metadata_only and not want_vorbis:
            break
    return streaminfo, vorbis_comment


class MetadataBlockReader:
    """Iterator over metadata blocks (reference `src/metadata.rs:551-609`).

    It is assumed the next byte read is the first byte of a metadata block
    header, so the iterator yields at least one value. After an error no
    more data is read.
    """

    def __init__(self, input):
        self.input = input
        self.done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.done:
            raise StopIteration
        try:
            is_last, block_type, length = read_metadata_block_header(self.input)
            block = read_metadata_block(self.input, block_type, length)
        except Error:
            # After a failure, no more attempts to read will be made, because
            # we don't know where we are in the stream.
            self.done = True
            raise
        self.done = is_last
        return block


def read_stream_header(input):
    """Check the 'fLaC' magic; detect ID3-prefixed files with a helpful
    error like the reference (`src/lib.rs:186-205`)."""
    FLAC_HEADER = 0x664C6143
    ID3_HEADER = 0x49443300

    header = input.read_be_u32()
    if header != FLAC_HEADER:
        if (header & 0xFFFFFF00) == ID3_HEADER:
            fmt_err("stream starts with ID3 header rather than FLAC header")
        else:
            fmt_err("invalid stream header")
