"""Subframe decoding -- the numeric core (a copy of ``claxon_tpu.subframe``;
reference layer L3).

Reference-fidelity scalar implementation of claxon `src/subframe.rs`:
subframe header, wasted bits, CONSTANT/VERBATIM fill, FIXED prediction
(orders 0-4), LPC synthesis (orders 1-32), Rice/Rice2 partitioned residuals,
zig-zag mapping and sign extension.

This module is the host oracle and the Python extractor's parse; the
production paths are the C++ core (``claxon_tpu_torch.native``) and the
batched CUDA kernels (``claxon_tpu_torch.ops``). All three are bit-exact
against each other;
overflow semantics deliberately mirror the reference:

* FIXED prediction wraps in 32-bit arithmetic (`src/subframe.rs:461-470`).
* LPC accumulates exactly in >=53-bit arithmetic, arithmetic-shifts right by
  the QLP shift, adds the residual, and truncates to the low 32 bits
  (`src/subframe.rs:559-582`).
* The wasted-bits epilogue is a wrapping left shift (`src/subframe.rs:216-225`).

Invalid files thus produce garbage output, never a crash.
"""

from .error import Unsupported, fmt_err

__all__ = [
    "decode", "extend_sign", "rice_to_signed",
    "predict_fixed", "predict_lpc", "FIXED_COEFFICIENTS",
]

_U32 = 1 << 32
_I32_MIN = -(1 << 31)

# Coefficients for fitting an order-n polynomial: Pascal's triangle with
# alternating signs (reference `src/subframe.rs:427-431`). Index k of row n
# multiplies sample[i + k] to predict sample[i + n].
FIXED_COEFFICIENTS = (
    (),
    (1,),
    (-1, 2),
    (1, -3, 3),
    (-1, 4, -6, 4),
)


def _wrap32(x):
    """Truncate an unbounded int to two's-complement 32-bit."""
    x &= _U32 - 1
    return x - _U32 if x >= (1 << 31) else x


def extend_sign(val, bits):
    """Sign-extend the ``bits``-wide two's complement value ``val``.

    Reference: ``extend_sign_u16``/``extend_sign_u32``
    (`src/subframe.rs:96-122`).
    """
    if val >= (1 << (bits - 1)):
        return val - (1 << bits)
    return val


def rice_to_signed(val):
    """Zig-zag mapping from Rice-coded unsigned to signed:
    0,1,2,3,4 -> 0,-1,1,-2,2 (reference `src/subframe.rs:156-170`)."""
    if val & 1:
        return -1 - (val >> 1)
    return val >> 1


def read_subframe_header(bits):
    """Read the subframe header; returns (sf_type, order, wasted_bits).

    ``sf_type`` is one of ``"constant"``, ``"verbatim"``, ``"fixed"``,
    ``"lpc"``. Reference bit layout and reserved patterns:
    `src/subframe.rs:29-91`.
    """
    # A subframe header opens with a single zero bit (mandatory padding).
    if bits.read_bit():
        fmt_err("invalid subframe header")

    # Six type bits follow the padding bit.
    n = bits.read_leq_u8(6)
    if n == 0:
        sf_type, order = "constant", 0
    elif n == 1:
        sf_type, order = "verbatim", 0
    elif (n & 0b111_110) == 0b000_010 or (n & 0b111_100) == 0b000_100 \
            or (n & 0b110_000) == 0b010_000:
        # The spec reserves the 00001x, 0001xx and 01xxxx encodings.
        fmt_err("invalid subframe header, encountered reserved value")
    elif (n & 0b111_000) == 0b001_000:
        order = n & 0b000_111
        # Orders above 4 do not exist for fixed subframes (reserved codes).
        if order > 4:
            fmt_err("invalid subframe header, encountered reserved value")
        sf_type = "fixed"
    else:
        # Only 1xxxxx is left: LPC, the 5 low bits store order - 1.
        sf_type, order = "lpc", (n & 0b011_111) + 1

    # One bit: are there wasted bits? If so, k-1 zeros follow (unary k-1).
    wasted = 0
    if bits.read_bit():
        wasted = 1 + bits.read_unary()

    # More than 31 wasted bits would remove all data even for 32-bit samples.
    if wasted > 31:
        fmt_err("wasted bits per sample must not exceed 31")

    return sf_type, order, wasted


def decode(bits, bps, buffer):
    """Decode one channel's subframe for one frame into ``buffer`` (a list
    whose length is the block size). Reference: `src/subframe.rs:184-228`."""
    assert bps <= 32
    sf_type, order, wasted = read_subframe_header(bits)

    if wasted >= bps:
        fmt_err("subframe has no non-wasted bits")

    sf_bps = bps - wasted

    if sf_type == "constant":
        decode_constant(bits, sf_bps, buffer)
    elif sf_type == "verbatim":
        decode_verbatim(bits, sf_bps, buffer)
    elif sf_type == "fixed":
        decode_fixed(bits, sf_bps, order, buffer)
    else:
        decode_lpc(bits, sf_bps, order, buffer)

    # Everything must be shifted by the wasted bits per sample to the left.
    # Wrapping shift: an invalid file may overflow; decode garbage, no crash.
    if wasted > 0:
        for i, s in enumerate(buffer):
            buffer[i] = _wrap32(s << wasted)


def decode_residual(bits, block_size, buffer, buf_start, buf_len):
    """Decode the partitioned Rice residual into
    ``buffer[buf_start:buf_start+buf_len]`` (reference `src/subframe.rs:236-304`)."""
    # Two bits coding method.
    method = bits.read_leq_u8(2)
    if method == 0b00:
        rice2 = False
    elif method == 0b01:
        rice2 = True
    else:
        fmt_err("invalid residual, encountered reserved value")

    # Four bits partition order; there are 2^order partitions.
    order = bits.read_leq_u8(4)
    n_partitions = 1 << order
    n_samples_per_partition = block_size >> order

    # The partitions together must fill the block, so the block size must be
    # a multiple of 2^order.
    if block_size & (n_partitions - 1) != 0:
        fmt_err("invalid partition order")

    n_warm_up = block_size - buf_len

    # The first partition also contains the warm-up samples, so it must be
    # large enough to hold them.
    if n_warm_up > n_samples_per_partition:
        fmt_err("invalid residual")

    start = buf_start
    length = n_samples_per_partition - n_warm_up
    for _ in range(n_partitions):
        decode_rice_partition(bits, buffer, start, length, rice2)
        start += length
        length = n_samples_per_partition


def decode_rice_partition(bits, buffer, start, length, rice2):
    """Decode one Rice partition (reference `src/subframe.rs:309-380`)."""
    param_bits = 5 if rice2 else 4
    rice_param = bits.read_leq_u8(param_bits)

    # All ones is an escape code indicating unencoded binary.
    if rice_param == (1 << param_bits) - 1:
        raise Unsupported("unencoded binary is not yet implemented")

    read = bits.read_leq_u32
    read_unary = bits.read_unary
    for i in range(start, start + length):
        q = read_unary()
        r = read(rice_param)
        # The reference combines quotient and remainder in u32 arithmetic
        # (`src/subframe.rs:340`); a pathological quotient wraps mod 2^32.
        v = ((q << rice_param) | r) & 0xFFFFFFFF
        buffer[i] = -1 - (v >> 1) if v & 1 else (v >> 1)


def decode_constant(bits, bps, buffer):
    """A constant subframe stores one sample (reference `src/subframe.rs:382-394`)."""
    sample = extend_sign(bits.read_leq_u32(bps), bps)
    for i in range(len(buffer)):
        buffer[i] = sample


def decode_verbatim(bits, bps, buffer, start=0, length=None):
    """A verbatim subframe stores samples unencoded
    (reference `src/subframe.rs:396-415`)."""
    assert bps <= 32
    if length is None:
        length = len(buffer)
    read = bits.read_leq_u32
    half = 1 << (bps - 1)
    full = 1 << bps
    for i in range(start, start + length):
        v = read(bps)
        buffer[i] = v - full if v >= half else v


def predict_fixed(order, buffer, n=None):
    """Apply the order-``order`` fixed predictor in place, with 32-bit
    wrapping arithmetic (reference `src/subframe.rs:417-474`)."""
    assert order <= 4
    coefficients = FIXED_COEFFICIENTS[order]
    if n is None:
        n = len(buffer)

    # Wrapping semantics: sums/products mod 2^32 equal the reference's
    # sequence of wrapping i32 ops, so one final wrap of the exact value is
    # enough.
    for i in range(n - order):
        prediction = 0
        for k, c in enumerate(coefficients):
            prediction += c * buffer[i + k]
        delta = buffer[i + order]
        buffer[i + order] = _wrap32(prediction + delta)


def decode_fixed(bits, bps, order, buffer):
    """Decode a FIXED subframe (reference `src/subframe.rs:492-516`)."""
    if len(buffer) < order:
        fmt_err("invalid fixed subframe, order is larger than block size")

    # `order` unencoded warm-up samples, then the residual, then prediction.
    decode_verbatim(bits, bps, buffer, 0, order)
    decode_residual(bits, len(buffer), buffer, order, len(buffer) - order)
    predict_fixed(order, buffer)


def predict_lpc(coefficients, qlp_shift, buffer, n=None):
    """Apply LPC prediction in place.

    ``coefficients`` are stored oldest-sample-first, i.e. coefficient ``k``
    multiplies ``buffer[i - order + k]`` when predicting ``buffer[i]``.
    The accumulation is exact (Python ints stand in for the reference's
    i64, `src/subframe.rs:559-582`), the QLP shift is an arithmetic right
    shift, and the result is truncated to the low 32 bits.
    """
    order = len(coefficients)
    if n is None:
        n = len(buffer)
    for i in range(order, n):
        acc = 0
        for k in range(order):
            acc += coefficients[k] * buffer[i - order + k]
        prediction = acc >> qlp_shift
        buffer[i] = _wrap32(prediction + buffer[i])


def decode_lpc(bits, bps, order, buffer):
    """Decode an LPC subframe (reference `src/subframe.rs:651-721`)."""
    assert order <= 32
    if len(buffer) < order:
        fmt_err("invalid LPC subframe, lpc order is larger than block size")

    # `order` unencoded warm-up samples.
    decode_verbatim(bits, bps, buffer, 0, order)

    # Four bits QLP coefficient precision - 1; pattern 1111 is invalid.
    qlp_precision = bits.read_leq_u8(4) + 1
    if qlp_precision - 1 == 0b1111:
        fmt_err("invalid subframe, qlp precision value invalid")

    # Five bits QLP shift, in signed two's complement.
    qlp_shift = extend_sign(bits.read_leq_u16(5), 5)

    # The spec allows a negative shift but it does not occur in practice and
    # the reference does not support it either (`src/subframe.rs:687-691`).
    if qlp_shift < 0:
        raise Unsupported(
            "a negative quantized linear predictor coefficient shift is "
            "not supported, please file a bug.")

    # The coefficients, most recent sample's first in the stream; store them
    # oldest-first to match the prediction loop.
    coefficients = [0] * order
    for k in range(order - 1, -1, -1):
        coefficients[k] = extend_sign(bits.read_leq_u16(qlp_precision), qlp_precision)

    decode_residual(bits, len(buffer), buffer, order, len(buffer) - order)

    predict_lpc(coefficients, qlp_shift, buffer)
