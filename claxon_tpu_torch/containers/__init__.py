"""Container demuxers for FLAC-in-Ogg and FLAC-in-MP4 (a copy of
``claxon_tpu.containers``, decoding through the port's pipeline).

``read_flac_from_ogg`` / ``read_flac_from_mp4`` are the spec-derived demux
layers; ``decode_ogg_stream`` / ``decode_mp4_stream`` feed what they find
to the port's host-walk bits path on the card.
"""

from .ogg import OggPacketReader, read_flac_from_ogg
from .mp4 import Mp4FlacTrack, read_flac_from_mp4
from .pipeline import decode_ogg_stream, decode_mp4_stream

__all__ = ["OggPacketReader", "read_flac_from_ogg",
           "Mp4FlacTrack", "read_flac_from_mp4",
           "decode_ogg_stream", "decode_mp4_stream"]
