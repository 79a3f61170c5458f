"""claxon_tpu_torch: the PyTorch + CUDA port of claxon_tpu's decode path.

The port keeps its own copy of the host layers it calls (``error``,
``crc``, ``io``, ``metadata``, ``subframe``, ``frame``, ``reader``,
``extract``, ``utils``, the C++ core ``native`` and the test encoder
``testing``), so it imports nothing of ``claxon_tpu``. It exports the
reference's streaming reader API as the JAX package does (``FlacReader``
with ``blocks()`` / ``samples()``, ``FrameReader``, ``Block``,
``StreamInfo``, ``VorbisComment``; host code, no card). The device side
is rewritten for an NVIDIA Hopper card:

* ``ops`` -- each device kernel's wrapper beside its plain PyTorch form:
  K1 synthesis (with the K3 epilogue fused into its store), K2 stream
  Rice decode, K4 range CRC-16, K5 sync scan, K6 fused-demux body, K7
  subframe walk, K8 values gather and K3b int16 pack/unpack as
  hand-written CUDA (``csrc/``, built with nvcc at first use); K3 alone
  is torch ops, the fused kernel's plain form;
* ``pipeline_bits`` -- numpy bucket planning and the per-bucket steps of
  the host-walk path;
* ``pipeline_seg`` -- the segmented path (``segmentation="device"``):
  frame search and subframe walk on the card;
* ``pipeline`` -- the public calls and the device-resident result, and
  the FrameDesc route of ``use_native=False`` (the Python extractor's
  descriptors through K1 + K3);
* ``containers`` -- FLAC in Ogg and in MP4: the demuxers and
  ``decode_ogg_stream`` / ``decode_mp4_stream``.

This package never imports JAX. Output is bit-identical to ``claxon_tpu``
and to the C++ scalar decoder.
"""

from .containers import decode_mp4_stream, decode_ogg_stream
from .error import Error, FormatError, IoError, Unsupported
from .frame import Block, FrameReader
from .metadata import StreamInfo, VorbisComment
from .pipeline import (DecodedStream, DeviceDecoded, decode_stream,
                       decode_streams, decode_streams_device,
                       decode_streams_device_async, decode_streams_pipelined)
from .reader import (FlacReader, FlacReaderOptions, FlacSamples,
                     FlacIntoSamples)

__version__ = "0.1.0"

__all__ = ["decode_stream", "decode_streams", "decode_streams_device",
           "decode_streams_device_async", "decode_streams_pipelined",
           "decode_ogg_stream", "decode_mp4_stream", "DeviceDecoded",
           "DecodedStream", "Error", "FormatError", "IoError",
           "Unsupported", "Block", "FrameReader", "StreamInfo",
           "VorbisComment", "FlacReader", "FlacReaderOptions", "FlacSamples",
           "FlacIntoSamples", "__version__"]
