"""MSB-first bitstream over a byte reader (a copy of ``claxon_tpu.io.bits``;
reference layer L1).

The reference keeps one buffered byte plus a bits-left counter and has six
specialized read methods (claxon `src/input.rs:414-643`). This Python
implementation keeps an integer bit accumulator instead -- simpler in Python
and semantically identical: bits are consumed most-significant-first, and a
byte is only pulled from the underlying reader when needed, so interleaving
with byte-aligned reads behaves exactly like the reference.

The production hot path does not run through this class; it exists as the
reference-fidelity oracle and as the pure-Python fallback when the C++ demux
core is not built.
"""

__all__ = ["Bitstream"]


class Bitstream:
    __slots__ = ("reader", "_acc", "_nbits")

    def __init__(self, reader):
        self.reader = reader
        self._acc = 0      # the _nbits least significant bits are unconsumed
        self._nbits = 0    # 0..7 between calls

    def read_bit(self):
        """Read a single bit, True for 1."""
        if self._nbits == 0:
            self._acc = self.reader.read_u8()
            self._nbits = 8
        self._nbits -= 1
        return ((self._acc >> self._nbits) & 1) != 0

    def read_unary(self):
        """Read zeros until a 1, return the number of zeros read.

        This is the Rice-quotient read; the reference accelerates it with
        leading-zero counts (`src/input.rs:475-511`).
        """
        n = 0
        nbits = self._nbits
        acc = self._acc & ((1 << nbits) - 1) if nbits else 0
        while True:
            if nbits == 0:
                acc = self.reader.read_u8()
                nbits = 8
            if acc == 0:
                n += nbits
                nbits = 0
                continue
            # Position of the highest set bit within the nbits-wide window.
            top = acc.bit_length()
            zeros = nbits - top
            n += zeros
            nbits = top - 1
            acc &= (1 << nbits) - 1
            self._acc = acc
            self._nbits = nbits
            return n

    def read_leq_u8(self, bits):
        """Read at most 8 bits (reference `src/input.rs:515-558`)."""
        return self._read(bits)

    def read_gt_u8_leq_u16(self, bits):
        """Read 8 < bits <= 16 bits (reference `src/input.rs:562-602`)."""
        return self._read(bits)

    def read_leq_u16(self, bits):
        return self._read(bits)

    def read_leq_u32(self, bits):
        return self._read(bits)

    def _read(self, bits):
        nbits = self._nbits
        acc = self._acc & ((1 << nbits) - 1) if nbits else 0
        while nbits < bits:
            acc = (acc << 8) | self.reader.read_u8()
            nbits += 8
        nbits -= bits
        self._acc = acc & ((1 << nbits) - 1)
        self._nbits = nbits
        return acc >> nbits
