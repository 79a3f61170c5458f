"""K7, the port's subframe walk (claxon_tpu_torch.ops.demux), in its plain
PyTorch form against the JAX package's ``walk_frames`` on the same frames.

Tolerance 0. ``ok`` (the accept set, which decides what falls back) is
equal on every frame; every other output is equal on the lanes of ok
frames, and ``end_bits`` on ok frames (a rejected frame's outputs are
unspecified in both packages). Every case is padded to one shape (F_PAD
frames, W_PAD stream words, T = 1024) so that the JAX program compiles
once per channel count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from claxon_tpu import native
from claxon_tpu.ops.demux import walk_frames as jax_walk
from claxon_tpu.pipeline_seg import host_header_fields
from claxon_tpu.testing import encode_flac, synth_music

from claxon_tpu_torch.ops import demux

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

F_PAD = 8
W_PAD = 8192
T = 1024


def _pad(a, n, fill=0):
    out = np.full(n, fill, np.int32)
    out[:len(a)] = a
    return out


def _inputs(data):
    """(words, start_bits, bs, modes, bps) of every frame of ``data``,
    padded to (W_PAD,) and (F_PAD,), plus the native walker's frames."""
    from claxon_tpu.native.binding import _read_metadata

    payload = data[_read_metadata(data)[1]:]
    bb = native.extract_frames_bits(payload, emit_slots=False,
                                    defer_crc=True)
    bf = bb.bframes
    assert len(bf) <= F_PAD and len(payload) <= 4 * W_PAD
    hlen = host_header_fields(np.frombuffer(payload, np.uint8),
                              bf["byte0"])["hlen"]
    buf = np.zeros(4 * W_PAD, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    words = buf.view(">i4").astype(np.int32)
    lanes = [_pad((bf["byte0"].astype(np.int64) + hlen) * 8, F_PAD),
             _pad(bf["block_size"], F_PAD), _pad(bf["mode"], F_PAD),
             _pad(bf["bps"], F_PAD, 1)]
    return [words] + lanes, bf


def _assert_same(args, nch, without_deltas=False):
    jo, je, jok = jax_walk(*(jnp.asarray(a) for a in args), T=T, nch=nch)
    to, te, tok = demux.walk_frames(*(torch.from_numpy(a) for a in args),
                                    T, nch, deltas=True)
    jok = np.asarray(jok)
    assert np.array_equal(jok, tok.numpy())
    assert np.array_equal(np.asarray(je)[jok], te.numpy()[jok])
    lane_ok = np.repeat(jok, nch)
    for key in demux.WALK_KEYS + ("deltas",):
        a = np.asarray(jo[key])[lane_ok]
        b = to[key].numpy()[lane_ok]
        assert a.dtype == b.dtype or key != "deltas"
        assert a.shape == b.shape and np.array_equal(a, b), key
    if without_deltas:
        # Without the flag the walk returns no deltas and the same rest.
        bare = demux.walk_frames(*(torch.from_numpy(a) for a in args), T,
                                 nch)
        assert "deltas" not in bare[0]
        assert all(torch.equal(bare[0][k], to[k]) for k in demux.WALK_KEYS)
    return jok


@pytest.mark.parametrize("kw", [
    dict(),
    dict(force_subframe="constant"),
    dict(force_subframe="verbatim"),
    dict(force_subframe="fixed"),
    dict(stereo="left_side"),
    dict(stereo="right_side"),
    dict(bps=8, partition_order=0),
    dict(bps=24, block_size=512),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_walk_matches_jax(kw):
    kw = dict(kw)
    bps = kw.pop("bps", 16)
    n = 3000
    if kw.get("force_subframe") == "constant":
        pcm = np.full((n, 2), -137, np.int32)
    else:
        pcm = synth_music(n, channels=2, bps=bps, seed=5)
    data = encode_flac(pcm, 44100, bps, block_size=kw.pop("block_size", T),
                       **kw)
    args, bf = _inputs(data)
    ok = _assert_same(args, 2)
    native_ok = _pad((bf["flags"] & 1) == 0, F_PAD).astype(bool)
    assert not (ok & ~native_ok).any()
    if bps <= 16:
        # Every code of a <= 16-bit stream fits the 32-bit device window.
        assert np.array_equal(ok, native_ok)


def test_walk_mono_matches_jax():
    data = encode_flac(synth_music(3000, channels=1, bps=16, seed=9),
                       44100, 16, block_size=T)
    args, bf = _inputs(data)
    ok = _assert_same(args, 1, without_deltas=True)
    assert ok[:len(bf)].all() and not ok[len(bf):].any()


def test_walk_escaped_partition_not_ok():
    """A hand-built subframe whose Rice partition is escaped: both walks
    reject its frame."""
    # pad(0) type(001000: fixed order 0) wasted(0), residual method 0,
    # partition order 0, parameter 1111 (the escape code).
    bits = "0" + "001000" + "0" + "00" + "0000" + "1111" + "0" * 64
    bits += "0" * ((-len(bits)) % 32)
    words = np.array([int(bits[i:i + 32], 2)
                      for i in range(0, len(bits), 32)],
                     np.uint32).astype(np.int32)
    args = [_pad(words, W_PAD), _pad([0], F_PAD), _pad([32], F_PAD),
            _pad([0], F_PAD), _pad([16], F_PAD, 1)]
    ok = _assert_same(args, 1)
    assert not ok.any()
