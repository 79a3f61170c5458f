"""The public reader API (a copy of ``claxon_tpu.reader``; reference layer
L5, claxon `src/lib.rs`).

``FlacReader`` mirrors the reference surface 1:1: ``open``/``open_ext``
(paths), the constructor (file-like objects) with ``FlacReaderOptions``,
``streaminfo()``, ``vendor()``, ``tags()``, ``get_tag()``, ``blocks()``,
``samples()``, ``into_samples()``, ``into_inner()``.
``read_stream_header`` lives in the port's ``metadata``.
"""

from dataclasses import dataclass

from .frame import Block, FrameReader
from .io.readers import BufferedReader, MemReader
from .metadata import read_flac_metadata, read_stream_header, Tags, GetTag

__all__ = ["FlacReader", "FlacReaderOptions", "FlacSamples",
           "FlacIntoSamples"]


@dataclass
class FlacReaderOptions:
    """Controls what metadata ``FlacReader`` reads when constructed
    (reference `src/lib.rs:122-151`).

    * ``metadata_only=True``: return as soon as all desired metadata has
      been read; the reader then cannot be used to read audio.
    * ``read_vorbis_comment=False``: don't read tags even if present.
    """
    metadata_only: bool = False
    read_vorbis_comment: bool = True


def _open_file(filename):
    from .error import IoError
    try:
        return open(filename, "rb")
    except OSError as e:
        raise IoError(str(e)) from e


class FlacReader:
    """A FLAC decoder reading from bytes, an in-memory cursor, or a binary
    stream; use ``FlacReader.open(path)`` for file paths.

    Reference: `src/lib.rs:93-471`. The streaming decode path here is the
    reference-fidelity host path; for maximum throughput over whole files
    use ``claxon_tpu_torch.pipeline``, which batches frames onto the card.
    """

    def __init__(self, reader, options=None):
        """Create a reader from a binary file-like object (``new``/
        ``new_ext`` in the reference, `src/lib.rs:217-307`).

        The stream header and metadata blocks are read immediately; audio
        frames are read on demand. Files claiming excessively large metadata
        blocks are rejected (``Unsupported``) to prevent DoS.
        """
        options = options or FlacReaderOptions()
        if isinstance(reader, (bytes, bytearray, memoryview)):
            buf_reader = MemReader(reader)
        elif isinstance(reader, MemReader):
            # An in-memory cursor is used directly, like the reference's
            # io::Cursor input (`src/input.rs:234-278`): the caller keeps a
            # handle and can inspect ``.pos`` (e.g. to measure metadata
            # size, `examples/bench_decode.rs:42-45`).
            buf_reader = reader
        else:
            buf_reader = BufferedReader(reader)

        read_stream_header(buf_reader)

        streaminfo, vorbis_comment = read_flac_metadata(
            buf_reader, metadata_only=options.metadata_only,
            read_vorbis_comment=options.read_vorbis_comment)

        if not options.read_vorbis_comment:
            vorbis_comment = None

        self._streaminfo = streaminfo
        self._vorbis_comment = vorbis_comment
        self._input = buf_reader
        # Only mark "full" when metadata_only was false, even if we happened
        # to read all metadata: more predictable behavior (`src/lib.rs:290-297`).
        self._metadata_only = options.metadata_only

    @classmethod
    def open(cls, filename):
        """Create a reader that reads from the file at ``filename``
        (`src/lib.rs:449-458`). No extra buffering is needed.

        OS errors surface as ``IoError``, like the reference's
        ``Error::IoError`` wrapping of ``File::open`` failures."""
        return cls(_open_file(filename))

    @classmethod
    def open_ext(cls, filename, options):
        """``open`` with ``FlacReaderOptions`` (`src/lib.rs:465-471`)."""
        return cls(_open_file(filename), options)

    @classmethod
    def new(cls, reader):
        """Alias of the constructor, mirroring the reference's ``new``."""
        return cls(reader)

    @classmethod
    def new_ext(cls, reader, options):
        """Alias of the constructor, mirroring the reference's ``new_ext``."""
        return cls(reader, options)

    def streaminfo(self):
        """The streaminfo metadata: sample rate, channels, etc."""
        return self._streaminfo

    def vendor(self):
        """The vendor string of the Vorbis comment block, if present."""
        return self._vorbis_comment.vendor if self._vorbis_comment else None

    def tags(self):
        """Iterator of (name, value) Vorbis comments. Names are ASCII and
        case-insensitive, and need not be unique."""
        comments = self._vorbis_comment.comments if self._vorbis_comment else []
        return Tags(comments)

    def get_tag(self, tag_name):
        """Case-insensitive lookup of a tag; yields each value."""
        comments = self._vorbis_comment.comments if self._vorbis_comment else []
        return GetTag(comments, tag_name)

    def blocks(self):
        """A ``FrameReader`` for frame-at-a-time decoding with buffer
        recycling; the low-level, high-performance interface."""
        if self._metadata_only:
            raise AssertionError(
                "FlacReaderOptions.metadata_only must be False to be able "
                "to use FlacReader.blocks()")
        return FrameReader(self._input)

    def samples(self):
        """Iterator over all samples, channels interleaved.

        Streaming: a second call continues (block-aligned) where the first
        stopped. User-friendly; for performance use ``blocks()``.
        """
        if self._metadata_only:
            raise AssertionError(
                "FlacReaderOptions.metadata_only must be False to be able "
                "to use FlacReader.samples()")
        return FlacSamples(FrameReader(self._input))

    def into_samples(self):
        """Like ``samples()``; named for parity with the reference's
        owning variant."""
        if self._metadata_only:
            raise AssertionError(
                "FlacReaderOptions.metadata_only must be False to be able "
                "to use FlacReader.into_samples()")
        return FlacSamples(FrameReader(self._input))

    def into_inner(self):
        """Return the underlying reader. Buffered data is lost."""
        return self._input.into_inner()


class FlacSamples:
    """Iterator yielding decoded samples, channel-interleaved
    (reference `src/lib.rs:168-178,473-520`).

    After any error, iteration stops for good (the failure latch).
    """

    def __init__(self, frame_reader):
        self._frame_reader = frame_reader
        self._block = Block.empty()
        self._sample = 0
        self._channel = 0
        self._has_failed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._has_failed:
            raise StopIteration

        self._channel += 1
        if self._channel >= self._block.channels():
            self._channel = 0
            self._sample += 1
            if self._sample >= self._block.duration():
                self._sample = 0
                current = self._block
                self._block = Block.empty()
                try:
                    next_block = self._frame_reader.read_next_or_eof(
                        current.into_buffer())
                except Exception:
                    self._has_failed = True
                    raise
                if next_block is None:
                    raise StopIteration
                self._block = next_block

        return self._block.sample(self._channel, self._sample)


#: Name-parity alias: the reference distinguishes a borrowing and an owning
#: sample iterator (`src/lib.rs:180-184`); Python has no ownership split,
#: so both names are the same iterator type.
FlacIntoSamples = FlacSamples
