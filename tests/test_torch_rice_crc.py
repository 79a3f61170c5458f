"""The port's rice_decode, crc16_device and crc16_frames_device (their
plain forms: CPU tensors) against the JAX package's functions, tolerance
0, on the JAX tests' own inputs (seeds 12, 21 and 77) and on garbage:
wrapping cursors, shifts by 32 or more, reads clipped to the buffer,
searches that run off it, lengths and ranges outside the data, int32
extremes. Errors are compared by class name and message.

The cases (claxon_tpu_torch/testing/rice_crc_cases.py, the kernels'
edge cases among them) are padded to a few shapes per function, so the
JAX package compiles few programs; each call's results are computed once
per module and every case checks its own lanes, rows or ranges."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from claxon_tpu.crc import crc16 as ref_crc16
from claxon_tpu.ops import crc as jcrc
from claxon_tpu.ops import rice as jrice

from claxon_tpu_torch.ops import crc as tcrc
from claxon_tpu_torch.ops import rice as trice
from claxon_tpu_torch.testing import rice_crc_cases as cases

# The edge calls of the shapes above (rice_edge_calls()[0]: the words,
# lanes and T of rice_calls()[0]; crc16_windows_edge_calls()[:2]: the
# upload, ranges and n_words of crc16_windows_calls()), so the JAX package
# compiles no new program for them.
RICE = cases.rice_calls() + cases.rice_edge_calls()[:1]
ROWS = cases.crc16_rows_calls()
WINDOWS = cases.crc16_windows_calls() + cases.crc16_windows_edge_calls()[:2]


def _cases(calls):
    return [pytest.param(i, label, id=label)
            for i, call in enumerate(calls) for label in call["labels"]]


def _jax_rice(args):
    words, sb, ks, cs, T = args
    out, end = jrice.rice_decode(words, sb, ks, cs, max_count=T)
    return np.asarray(out), np.asarray(end)


def _port_rice(args):
    words, sb, ks, cs, T = args
    out, end = trice.rice_decode(torch.from_numpy(words), sb, ks, cs,
                                 max_count=T)
    return out.numpy(), end.numpy()


def _jax_windows(args):
    stream, starts, ends, n_words = args
    fn = jax.jit(jcrc.crc16_frames_device, static_argnums=3)
    return np.asarray(fn(jnp.asarray(stream), jnp.asarray(starts),
                         jnp.asarray(ends), n_words))


def _port_windows(args):
    stream, starts, ends, n_words = args
    return tcrc.crc16_frames_device(torch.from_numpy(stream),
                                    torch.from_numpy(starts),
                                    torch.from_numpy(ends), n_words).numpy()


@pytest.fixture(scope="module")
def results():
    """(JAX, port) results of each call, computed at first use."""
    memo = {}

    def get(kind, i):
        key = (kind, i)
        if key not in memo:
            if kind == "rice":
                memo[key] = (_jax_rice(RICE[i]["args"]),
                             _port_rice(RICE[i]["args"]))
            elif kind == "rows":
                data, lengths = ROWS[i]["args"]
                memo[key] = (
                    np.asarray(jcrc.crc16_device(jnp.asarray(data),
                                                 jnp.asarray(lengths))),
                    tcrc.crc16_device(torch.from_numpy(data),
                                      torch.from_numpy(lengths)).numpy())
            else:
                memo[key] = (_jax_windows(WINDOWS[i]["args"]),
                             _port_windows(WINDOWS[i]["args"]))
        return memo[key]

    return get


@pytest.mark.parametrize("i, label", _cases(RICE))
def test_rice_decode_matches_jax(results, i, label):
    (j_out, j_end), (p_out, p_end) = results("rice", i)
    assert p_out.dtype == np.int32 and p_end.dtype == np.int32
    assert p_out.shape == j_out.shape
    lanes = RICE[i]["labels"][label]
    assert np.array_equal(p_out[lanes], j_out[lanes])
    assert np.array_equal(p_end[lanes], j_end[lanes])


def test_rice_decode_gives_the_values_that_made_the_buffer(results):
    """The seed-77 partitions decode to the values the generator wrote,
    and each lane's end cursor lands on the next lane's start, as the
    JAX test (tests/test_ops.py) checks there; so does a buffer of
    rice_stream's default distribution (long unary runs)."""
    i = next(i for i, c in enumerate(RICE) if "values" in c)
    _words, sb, _ks, cs, _T = RICE[i]["args"]
    _, (out, end) = results("rice", i)
    values = RICE[i]["values"]
    assert np.array_equal(out[:, :values.shape[1]], values)
    assert np.array_equal(end[:-1], sb[1:])
    st = cases.rice_stream(np.full(40, 64), seed=5, long_share=0.05)
    out, end = trice.rice_decode(torch.from_numpy(st["words"]),
                                 st["start_bits"], st["params"],
                                 st["counts"])
    assert np.array_equal(out.numpy(), st["values"])
    assert np.array_equal(end.numpy()[:-1], st["start_bits"][1:])


def test_rice_decode_takes_lists_arrays_and_tensors():
    """The per-lane arguments go through np.asarray(x, dtype=np.int32) as
    in the JAX function, or are moved to the words' device."""
    i = next(i for i, c in enumerate(RICE) if "values" in c)
    words, sb, ks, cs, _T = RICE[i]["args"]
    w = torch.from_numpy(words)
    want = trice.rice_decode(w, sb, ks, cs)
    for conv in (list, torch.from_numpy,
                 lambda a: torch.from_numpy(a).to(torch.int64)):
        got = trice.rice_decode(w, conv(sb), conv(ks), conv(cs))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[0].shape[1] == max(int(cs.max()), 0)


@pytest.mark.parametrize("i, label", _cases(ROWS))
def test_crc16_device_matches_jax(results, i, label):
    j, p = results("rows", i)
    assert p.dtype == np.int32
    rows = ROWS[i]["labels"][label]
    assert np.array_equal(p[rows], j[rows])
    if label == "seed 12 rows":
        data, lengths = ROWS[i]["args"]
        for l in range(rows.start, rows.stop):
            raw = bytes(data[l, :lengths[l]].astype(np.uint8))
            assert int(p[l]) == ref_crc16(raw)


@pytest.mark.parametrize("i, label", _cases(WINDOWS))
def test_crc16_frames_device_matches_jax(results, i, label):
    j, p = results("windows", i)
    assert p.dtype == np.int32
    ranges = WINDOWS[i]["labels"][label]
    assert np.array_equal(p[ranges], j[ranges])
    stream, starts, ends, n_words = WINDOWS[i]["args"]
    if n_words == 1:
        return  # a 4-byte window: most ranges are cut
    if label.startswith("a range ending in its stored CRC"):
        assert not p[ranges].any()
    if label.startswith("seed 21 ranges"):
        raw = stream.astype(">i4").tobytes()
        want = [ref_crc16(raw[a:b]) for a, b in
                zip(starts[ranges], ends[ranges])]
        assert p[ranges].tolist() == want


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


def test_errors_match_jax():
    """Above 2^26 words rice_decode raises the JAX ValueError before it
    reads anything (an untouched empty buffer of 2^26 + 1 words), and an
    n_words that is not a power of two the JAX AssertionError; both by
    class and message. Degenerate inputs (no words, no stream, n_words
    0) raise the JAX function's error class."""
    big = 1 << 26
    got = _raised(lambda: trice.rice_decode(
        torch.empty(big + 1, dtype=torch.int32), [0], [1], [1]))
    want = _raised(lambda: jrice.rice_decode(
        np.empty(big + 1, np.int32), [0], [1], [1]))
    assert got == want and got[0] == "ValueError"
    stream, starts, ends, _ = WINDOWS[0]["args"]
    t_args = [torch.from_numpy(x) for x in (stream, starts, ends)]
    j_args = [jnp.asarray(x) for x in (stream, starts, ends)]
    for n_words in (3, 6, 1000):
        got = _raised(lambda: tcrc.crc16_frames_device(*t_args, n_words))
        want = _raised(lambda: jcrc.crc16_frames_device(*j_args, n_words))
        assert got == want and got[0] == "AssertionError"
    one = np.array([0], np.int32)
    pairs = [
        (lambda: trice.rice_decode(torch.zeros(0, dtype=torch.int32), [5],
                                   [2], [2]),
         lambda: jrice.rice_decode(np.zeros(0, np.int32), [5], [2], [2])),
        (lambda: tcrc.crc16_frames_device(*t_args, 0),
         lambda: jcrc.crc16_frames_device(*j_args, 0)),
        (lambda: tcrc.crc16_frames_device(
            torch.zeros(0, dtype=torch.int32), torch.from_numpy(one),
            torch.from_numpy(one + 3), 2),
         lambda: jcrc.crc16_frames_device(
             jnp.zeros(0, jnp.int32), jnp.asarray(one), jnp.asarray(one + 3),
             2)),
    ]
    for port, ref in pairs:
        got, want = _raised(port), _raised(ref)
        assert got is not None and want is not None
        assert got[0] == want[0]
