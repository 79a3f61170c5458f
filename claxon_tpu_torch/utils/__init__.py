"""Small utilities shared by examples and tools (a copy of
``claxon_tpu.utils``)."""

from .wav import write_wav

__all__ = ["write_wav"]
