"""CRC-8 and CRC-16 checksums used by FLAC frames (a copy of
``claxon_tpu.crc``).

The tables are *generated* from the polynomials rather than hard-coded
(the reference, claxon `src/crc.rs`, wraps its byte readers in
CRC-computing decorators instead):

* CRC-8:  polynomial x^8 + x^2 + x^1 + x^0 (0x07), init 0, MSB-first.
  Protects the frame header (reference `src/crc.rs:59-61`).
* CRC-16: polynomial x^16 + x^15 + x^2 + x^0 (0x8005), init 0, MSB-first.
  Protects the whole frame (reference `src/crc.rs:67-69`).

The port uses the tables in its kernels' plain forms (K4, K5), the
combine matrices in K4's kernel tables (``ops.crc``), and the helpers in
its test encoder (``claxon_tpu_torch.testing``).
"""

import numpy as np

__all__ = ["CRC8_TABLE", "CRC16_TABLE", "crc8", "crc16",
           "crc16_combine_matrices"]


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


def crc16_combine_matrices(max_log2_len=24):
    """GF(2) shift matrices for combining CRC-16s of concatenated spans.

    ``M[k]`` maps a CRC-16 state across 2^k zero *bytes*; CRC over a
    concatenation composes as ``crc(a++b) = shift(crc(a), len(b)) ^ crc(b)``
    with the shift applied via these matrices. This enables a parallel
    (reduction-tree) CRC-16 on device; the sequential reference semantics are
    claxon `src/crc.rs:33-57`.

    Returns an array of shape (max_log2_len, 16) of uint16 rows: entry
    ``M[k][i]`` is the image of basis state ``1 << i``.
    """
    # One-byte step: state' = table[state >> 8] ^ (state << 8).
    step = np.zeros(16, dtype=np.uint16)
    for i in range(16):
        s = 1 << i
        step[i] = np.uint16((int(CRC16_TABLE[(s >> 8) & 0xFF]) ^ ((s << 8) & 0xFFFF)))

    def matmul_gf2(a, b):
        # c[i] = image under (a then b) of basis vector i.
        out = np.zeros(16, dtype=np.uint16)
        for i in range(16):
            v = int(a[i])
            r = 0
            for j in range(16):
                if v & (1 << j):
                    r ^= int(b[j])
            out[i] = r
        return out

    mats = np.zeros((max_log2_len, 16), dtype=np.uint16)
    mats[0] = step
    for k in range(1, max_log2_len):
        mats[k] = matmul_gf2(mats[k - 1], mats[k - 1])
    return mats
