"""CRC-8 and CRC-16 checksums used by FLAC frames (a copy of
``claxon_tpu.crc``, without the GF(2) combine matrices).

The tables are *generated* from the polynomials rather than hard-coded
(the reference, claxon `src/crc.rs`, wraps its byte readers in
CRC-computing decorators instead):

* CRC-8:  polynomial x^8 + x^2 + x^1 + x^0 (0x07), init 0, MSB-first.
  Protects the frame header (reference `src/crc.rs:59-61`).
* CRC-16: polynomial x^16 + x^15 + x^2 + x^0 (0x8005), init 0, MSB-first.
  Protects the whole frame (reference `src/crc.rs:67-69`).

The port uses the tables in its kernels' plain forms (K4, K5) and the
helpers in its test encoder (``claxon_tpu_torch.testing``).
"""

import numpy as np

__all__ = ["CRC8_TABLE", "CRC16_TABLE", "crc8", "crc16"]


def _gen_table(poly, width):
    table = np.zeros(256, dtype=np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            if crc & top:
                crc = ((crc << 1) ^ poly) & mask
            else:
                crc = (crc << 1) & mask
        table[byte] = crc
    return table


CRC8_TABLE = _gen_table(0x07, 8).astype(np.uint8)
CRC16_TABLE = _gen_table(0x8005, 16).astype(np.uint16)


def crc8(data, crc=0):
    """CRC-8 over ``data`` (bytes-like), starting from ``crc``."""
    table = CRC8_TABLE
    for b in memoryview(data):
        crc = table[crc ^ b]
    return int(crc)


def crc16(data, crc=0):
    """CRC-16 over ``data`` (bytes-like), starting from ``crc``."""
    table = CRC16_TABLE
    for b in memoryview(data):
        crc = int(table[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8) & 0xFFFF)
    return int(crc)

