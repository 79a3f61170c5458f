"""Host-side extraction: FLAC frames -> batch descriptors for the device (a
copy of ``claxon_tpu.extract``).

This is the demux half of the batched design (SURVEY.md section 7): walk the
bit-serial stream once on the host, verify CRCs, and emit for every
(frame, channel) subframe a *descriptor* -- residuals/warm-up samples plus
(order, shift, coefficients, wasted bits) -- that the batched device kernels
(``claxon_tpu_torch.ops``) turn into PCM.

The subframe types unify into one descriptor form (see ops.predict):
CONSTANT -> order 0 with the value replicated; VERBATIM -> order 0 with the
samples; FIXED -> Pascal coefficients with shift 0; LPC -> its coefficients.

This module is the reference-fidelity Python extractor (oracle /
fallback, ``use_native=False``); ``claxon_tpu_torch.native.extract_stream``
is the C++ implementation emitting the same structures.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .error import Unsupported, fmt_err
from .frame import read_frame_header_or_eof
from .io.bits import Bitstream
from .io.readers import Crc16Reader, MemReader
from .subframe import (FIXED_COEFFICIENTS, extend_sign, read_subframe_header,
                       decode_residual, decode_verbatim)
from .metadata import read_flac_metadata, read_stream_header

__all__ = ["SubframeDesc", "FrameDesc", "StreamBatch", "extract_stream",
           "extract_frames", "MODE_CODES"]

MODE_CODES = {"independent": 0, "left_side": 1, "right_side": 2, "mid_side": 3}


@dataclass
class SubframeDesc:
    """Descriptor of one channel's subframe, ready for device synthesis."""
    x: np.ndarray              # int32 (block_size,): warm-up ++ residuals
    order: int                 # 0..32
    shift: int                 # 0..15 (0 for constant/verbatim/fixed)
    coefs: np.ndarray          # int32 (order,), oldest-sample-first
    wasted: int                # wasted bits (applied after synthesis)


@dataclass
class FrameDesc:
    """Descriptor of one frame: its subframes plus epilogue parameters."""
    block_size: int
    channels: int
    mode: int                  # MODE_CODES value
    bps: int
    time: int                  # first inter-channel sample number
    subframes: List[SubframeDesc] = field(default_factory=list)


@dataclass
class StreamBatch:
    """All frames of one stream, plus the stream-level metadata."""
    streaminfo: object
    frames: List[FrameDesc] = field(default_factory=list)

    @property
    def total_samples(self):
        return sum(f.block_size for f in self.frames)


def _extract_subframe(bits, bps, block_size):
    """Parse one subframe into a SubframeDesc (no prediction applied).

    Mirrors the parse of ``subframe.decode`` exactly, including
    every validation; reference `src/subframe.rs:184-228,651-721`.
    """
    sf_type, order, wasted = read_subframe_header(bits)
    if wasted >= bps:
        fmt_err("subframe has no non-wasted bits")
    sf_bps = bps - wasted

    if sf_type == "constant":
        v = extend_sign(bits.read_leq_u32(sf_bps), sf_bps)
        x = np.full(block_size, v, dtype=np.int32)
        return SubframeDesc(x, 0, 0, np.zeros(0, np.int32), wasted)

    buf = [0] * block_size

    if sf_type == "verbatim":
        decode_verbatim(bits, sf_bps, buf)
        return SubframeDesc(np.array(buf, dtype=np.int32), 0, 0,
                            np.zeros(0, np.int32), wasted)

    if sf_type == "fixed":
        if block_size < order:
            fmt_err("invalid fixed subframe, order is larger than block size")
        decode_verbatim(bits, sf_bps, buf, 0, order)
        decode_residual(bits, block_size, buf, order, block_size - order)
        coefs = np.array(FIXED_COEFFICIENTS[order], dtype=np.int32)
        return SubframeDesc(np.array(buf, dtype=np.int32), order, 0, coefs,
                            wasted)

    # LPC
    if block_size < order:
        fmt_err("invalid LPC subframe, lpc order is larger than block size")
    decode_verbatim(bits, sf_bps, buf, 0, order)
    qlp_precision = bits.read_leq_u8(4) + 1
    if qlp_precision - 1 == 0b1111:
        fmt_err("invalid subframe, qlp precision value invalid")
    qlp_shift = extend_sign(bits.read_leq_u16(5), 5)
    if qlp_shift < 0:
        raise Unsupported(
            "a negative quantized linear predictor coefficient shift is "
            "not supported, please file a bug.")
    coefs = np.zeros(order, dtype=np.int32)
    for k in range(order - 1, -1, -1):
        coefs[k] = extend_sign(bits.read_leq_u16(qlp_precision), qlp_precision)
    decode_residual(bits, block_size, buf, order, block_size - order)
    return SubframeDesc(np.array(buf, dtype=np.int32), order, qlp_shift,
                        coefs, wasted)


def extract_frames(input, max_frames=None):
    """Extract FrameDescs from a byte reader positioned at the first frame.

    Verifies the CRC-8 of each header and the CRC-16 of each frame, exactly
    like the decoding path. Returns a list of FrameDesc (empty at EOF).
    """
    frames = []
    while max_frames is None or len(frames) < max_frames:
        crc_input = Crc16Reader(input)
        header = read_frame_header_or_eof(crc_input)
        if header is None:
            break
        if header.bits_per_sample is None:
            raise Unsupported("header without bits per sample info")
        bps = header.bits_per_sample
        bits = Bitstream(crc_input)
        kind = header.channel_assignment[0]
        bs = header.block_size

        fd = FrameDesc(block_size=bs, channels=header.channels,
                       mode=MODE_CODES[kind], bps=bps, time=0)
        if kind == "independent":
            for _ in range(header.channels):
                fd.subframes.append(_extract_subframe(bits, bps, bs))
        elif kind == "left_side":
            fd.subframes.append(_extract_subframe(bits, bps, bs))
            fd.subframes.append(_extract_subframe(bits, bps + 1, bs))
        elif kind == "right_side":
            fd.subframes.append(_extract_subframe(bits, bps + 1, bs))
            fd.subframes.append(_extract_subframe(bits, bps, bs))
        else:  # mid_side
            fd.subframes.append(_extract_subframe(bits, bps, bs))
            fd.subframes.append(_extract_subframe(bits, bps + 1, bs))

        computed_crc = crc_input.crc
        presumed_crc = crc_input.read_be_u16()
        if computed_crc != presumed_crc:
            fmt_err("frame CRC mismatch")

        strategy, value = header.block_time
        fd.time = bs * value if strategy == "frame" else value
        frames.append(fd)
    return frames


def extract_stream(data, max_frames=None):
    """Extract a whole FLAC stream (bytes) into a StreamBatch.

    Uses the public reader's metadata validation (single STREAMINFO first,
    unique Vorbis comment) so the pipeline accepts and rejects exactly the
    same streams as ``FlacReader``.
    """
    reader = MemReader(data)
    read_stream_header(reader)
    streaminfo, _vorbis = read_flac_metadata(reader)
    frames = extract_frames(reader, max_frames=max_frames)
    return StreamBatch(streaminfo=streaminfo, frames=frames)
