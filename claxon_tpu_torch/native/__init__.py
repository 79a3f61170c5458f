"""The port's C++ host core (a copy of ``claxon_tpu.native``).

Loads ``libclaxon_demux.so`` via ctypes, building it with g++ on first use
(``python -m claxon_tpu_torch.native.build``); ``available()`` returns
False when it cannot be built or loaded.
"""

from .binding import (available, extract_stream, extract_stream_raw,
                      extract_frames_raw, extract_stream_bits,
                      extract_frames_bits, merge_bits_batches, BitsBatch,
                      crc16_bytes, extract_frames, decode_frames_limited,
                      decode_stream_scalar, has_pack_helpers, rows_to_i16,
                      minmax)

__all__ = ["available", "extract_stream", "extract_stream_raw",
           "extract_frames_raw", "extract_stream_bits", "extract_frames_bits",
           "merge_bits_batches", "BitsBatch", "crc16_bytes", "extract_frames",
           "decode_frames_limited", "decode_stream_scalar",
           "has_pack_helpers", "rows_to_i16", "minmax"]
