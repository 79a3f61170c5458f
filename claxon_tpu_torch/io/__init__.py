"""Byte- and bit-level input for the host layer (a copy of
``claxon_tpu.io``).

Layer map (mirrors reference layers L0/L1/L2, claxon `src/input.rs`,
`src/crc.rs`):

* ``readers``: byte-level readers -- the ``ReadBytes`` duck-type protocol
  with a buffered stream reader, an in-memory cursor, and CRC-computing
  decorator readers.
* ``bits``: the MSB-first ``Bitstream`` used inside a frame where data is
  no longer byte aligned.

These are the reference-fidelity Python implementations behind the
reader API and the Python extractor; the decode paths walk streams with
the C++ core in ``claxon_tpu_torch.native``.
"""

from .readers import BufferedReader, MemReader, Crc8Reader, Crc16Reader
from .bits import Bitstream

__all__ = [
    "BufferedReader",
    "MemReader",
    "Crc8Reader",
    "Crc16Reader",
    "Bitstream",
]
