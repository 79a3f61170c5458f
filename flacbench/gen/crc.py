"""FLAC's frame checksums, from their polynomials.

CRC-8 (0x07) covers a frame header, CRC-16 (0x8005) the whole frame; both
start at 0, are MSB-first and have no final XOR. Both are linear over
GF(2) with a zero start, so a run of leading zero bytes leaves them at 0
(headers of different lengths are checked together, left-padded with
zeros) and the CRC-16 of ``head + body`` is the CRC-16 of ``head``
carried through ``len(body)`` zero bytes, XOR the CRC-16 of ``body``
(:func:`crc16_carry`).
"""

import numpy as np

__all__ = ["crc8", "crc16", "crc8_rows", "crc16_rows", "crc16_carry",
           "crc16_carry_basis"]


def _table(poly, width):
    table = np.zeros(256, dtype=np.uint32)
    top, mask = 1 << (width - 1), (1 << width) - 1
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top \
                else (crc << 1) & mask
        table[byte] = crc
    return table


CRC8_TABLE = _table(0x07, 8)
CRC16_TABLE = _table(0x8005, 16)
_T8 = CRC8_TABLE.tolist()
_T16 = CRC16_TABLE.tolist()


def crc8(data, crc=0):
    for b in bytes(data):
        crc = _T8[crc ^ b]
    return crc


def crc16(data, crc=0):
    for b in bytes(data):
        crc = _T16[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


def crc8_rows(rows):
    """CRC-8 of each row of a (n, m) uint8 array (rows left-padded with
    zeros where shorter)."""
    crc = np.zeros(len(rows), np.uint32)
    for j in range(rows.shape[1]):
        crc = CRC8_TABLE[crc ^ rows[:, j]]
    return crc


def crc16_rows(rows):
    """CRC-16 of each row of a (n, m) uint8 array (rows left-padded with
    zeros where shorter)."""
    crc = np.zeros(len(rows), np.uint32)
    for j in range(rows.shape[1]):
        crc = CRC16_TABLE[((crc >> 8) ^ rows[:, j]) & 0xFF] \
            ^ ((crc << 8) & 0xFFFF)
    return crc


def crc16_carry_basis(lengths):
    """(n, 16) uint32: each basis state 1 << j carried through
    ``lengths[i]`` zero bytes, for :func:`crc16_carry`."""
    lengths = np.asarray(lengths, np.int64)
    state = np.tile((1 << np.arange(16, dtype=np.uint32)), (len(lengths), 1))
    for step in range(int(lengths.max(initial=0))):
        live = lengths > step
        nxt = CRC16_TABLE[(state[live] >> 8) & 0xFF] ^ ((state[live] << 8)
                                                       & 0xFFFF)
        state[live] = nxt
    return state


def crc16_carry(crc, basis):
    """``crc`` (n,) carried through each row's zero bytes, by its
    ``basis`` row."""
    out = np.zeros(len(crc), np.uint32)
    for j in range(16):
        out ^= np.where((crc >> j) & 1, basis[:, j], 0).astype(np.uint32)
    return out
