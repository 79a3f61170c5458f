"""The port's default route (claxon_tpu_torch.pipeline, device="cpu"):
``segmentation=None`` reads CLAXON_TPU_SEGMENTATION and then ``"auto"``,
which times both paths on the first batch that engages the device demux
and keeps the faster one for the process, as the JAX package does
(claxon_tpu/pipeline.py ``_calibrate_segmentation``). The overlapped
``decode_streams_pipelined`` begins each batch with
``decode_streams_device_async`` and lands it after the next has begun.

Every PCM is held to the C++ scalar decoder and the STREAMINFO MD5. The
streams are small (at most 2 frames of 1024 samples): on the CPU the
segmented path runs its kernels' plain forms, one step per code.
"""

import time

import numpy as np
import pytest
import torch

import claxon_tpu_torch as ct
import claxon_tpu_torch.pipeline as tp
import claxon_tpu_torch.pipeline_seg as tseg
from claxon_tpu_torch import native
from claxon_tpu_torch.testing import encode_flac, pcm_md5, synth_music

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

ENV = "CLAXON_TPU_SEGMENTATION"


@pytest.fixture(autouse=True)
def _fresh_route():
    """Each test starts uncalibrated and with no remembered rejects."""
    tp._SEG_AUTO.clear()
    tseg._REJECT_CACHE.clear()
    yield
    tp._SEG_AUTO.clear()
    tseg._REJECT_CACHE.clear()


def _enc(seed, n=2048, channels=2, bps=16):
    return encode_flac(synth_music(n, channels=channels, bps=bps, seed=seed),
                       44100, bps, block_size=1024)


def _batch(n=3):
    return [_enc(900 + s) for s in range(n)]


def _assert_oracle(datas, results):
    assert len(results) == len(datas)
    for data, dec in zip(datas, results):
        si, pcm = native.decode_stream_scalar(data)
        assert np.array_equal(dec.pcm, pcm)
        if si.md5sum != b"\x00" * 16:
            assert pcm_md5(dec.pcm, si.bits_per_sample) == si.md5sum


def _count_paths(monkeypatch):
    """Count the calls of each path's entry: {"device": n, "host": n}."""
    calls = {"device": 0, "host": 0}
    seg, host = tseg.decode_streams_segmented, tp._decode_host_walk

    def counted_seg(*a, **kw):
        calls["device"] += 1
        return seg(*a, **kw)

    def counted_host(*a, **kw):
        calls["host"] += 1
        return host(*a, **kw)

    monkeypatch.setattr(tseg, "decode_streams_segmented", counted_seg)
    monkeypatch.setattr(tp, "_decode_host_walk", counted_host)
    return calls


def test_default_route_calibrates_and_caches(monkeypatch):
    """With the variable unset, the first batch times both paths (a
    warm-up and two timed decodes each) and caches a choice; the next
    batch decodes through the cached path alone."""
    monkeypatch.delenv(ENV, raising=False)
    calls = _count_paths(monkeypatch)
    datas = _batch()
    _assert_oracle(datas, ct.decode_streams_device(datas,
                                                   device="cpu").to_host())
    choice = tp._seg_auto("cpu")["choice"]
    assert choice in ("host", "device")
    assert calls == {"device": 3, "host": 3}
    calls.update(device=0, host=0)
    _assert_oracle(datas, ct.decode_streams(datas, device="cpu"))
    assert calls == {"device": int(choice == "device"),
                     "host": int(choice == "host")}


def test_cpu_calibration_leaves_the_card_uncalibrated(monkeypatch):
    """The choice is cached per device type: a calibration on the CPU,
    through the plain forms, leaves the card's entry unset, so the first
    default-route call on the card calibrates for itself."""
    monkeypatch.delenv(ENV, raising=False)
    datas = _batch(2)
    _assert_oracle(datas, ct.decode_streams(datas, device="cpu"))
    choice = tp._seg_auto("cpu")["choice"]
    assert choice in ("host", "device")
    assert tp._seg_auto("cuda")["choice"] is None
    assert tp._seg_auto("cuda:0")["seconds"] is None
    assert tp._resolve_segmentation(None, "cuda") == "auto"
    assert tp._resolve_segmentation(None, torch.device("cpu")) == choice


def test_env_device_pins_the_segmented_path(monkeypatch):
    monkeypatch.setenv(ENV, "device")
    calls = _count_paths(monkeypatch)
    datas = _batch(2)
    dd = ct.decode_streams_device(datas, device="cpu")
    assert dd.segmented and not dd.fallback_streams
    _assert_oracle(datas, dd.to_host())
    assert calls == {"device": 1, "host": 0}
    assert tp._seg_auto("cpu")["choice"] is None


def test_auto_decodes_like_the_oracle(monkeypatch):
    """segmentation="auto" (which used to raise) calibrates whatever the
    variable says, and decodes exactly."""
    monkeypatch.setenv(ENV, "host")
    datas = _batch(2)
    _assert_oracle(datas, ct.decode_streams_device(
        datas, segmentation="auto", device="cpu").to_host())
    assert tp._seg_auto("cpu")["choice"] in ("host", "device")


@pytest.mark.parametrize("value", ["bogus", "HOST", ""])
def test_unknown_values_take_the_host_walk(monkeypatch, value):
    """Every value but "device" and "auto", passed or from the
    variable, takes the host walk, as in the JAX package."""
    monkeypatch.setenv(ENV, value)
    calls = _count_paths(monkeypatch)
    datas = _batch(2)
    for dd in (ct.decode_streams_device(datas, device="cpu"),
               ct.decode_streams_device(datas, segmentation=value,
                                        device="cpu")):
        assert not dd.seg_engaged
        _assert_oracle(datas, dd.to_host())
    assert calls == {"device": 0, "host": 2}
    assert tp._seg_auto("cpu")["choice"] is None


def test_all_streams_falling_back_caches_host(monkeypatch):
    """A batch whose every stream the engaged demux sends back (24-bit
    codes pass the walk's 32-bit cap) caches "host" without timing; a
    batch rejected on its shape alone (6 channels) caches nothing."""
    monkeypatch.delenv(ENV, raising=False)
    calls = _count_paths(monkeypatch)
    wide = [_enc(910, bps=24), _enc(911, bps=24)]
    dd = ct.decode_streams_device(wide, device="cpu")
    assert dd.seg_engaged and not dd.segmented
    assert dd.fallback_streams == [0, 1]
    assert tp._seg_auto("cpu")["choice"] == "host"
    assert calls["device"] == 1
    _assert_oracle(wide, dd.to_host())

    tp._seg_auto("cpu")["choice"] = None
    six = [_enc(912, channels=6)]
    dd = ct.decode_streams_device(six, device="cpu")
    assert not dd.seg_engaged
    assert tp._seg_auto("cpu")["choice"] is None
    _assert_oracle(six, dd.to_host())


@pytest.mark.parametrize("winner", ["device", "host"])
def test_calibration_returns_the_winners_result(monkeypatch, winner):
    """Under a clock that charges each path a fixed cost, the cheaper
    path is cached and its own timed result is returned (no decode after
    the timing)."""
    monkeypatch.delenv(ENV, raising=False)
    now = [0.0]
    cost = {"device": 1.0, "host": 2.0} if winner == "device" else \
        {"device": 2.0, "host": 1.0}
    made = []
    seg, host = tseg.decode_streams_segmented, tp._decode_host_walk

    def charged(path, fn):
        def run(*a, **kw):
            now[0] += cost[path]
            out = fn(*a, **kw)
            made.append((path, out))
            return out
        return run

    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    monkeypatch.setattr(tseg, "decode_streams_segmented",
                        charged("device", seg))
    monkeypatch.setattr(tp, "_decode_host_walk", charged("host", host))
    datas = _batch(2)
    dd = ct.decode_streams_device(datas, device="cpu")
    assert tp._seg_auto("cpu")["choice"] == winner
    assert [p for p, _ in made] == ["device", "host"] * 3
    last = [out for p, out in made if p == winner][-1]
    assert dd is last
    _assert_oracle(datas, dd.to_host())


def test_async_through_the_cached_device_path(monkeypatch):
    """With "device" cached, the default async call begins the segmented
    path; the first uncached "auto" batch calibrates and returns a
    finished handle."""
    monkeypatch.delenv(ENV, raising=False)
    begun = []
    begin = tseg.begin_segmented

    def recording(*a, **kw):
        begun.append(1)
        return begin(*a, **kw)

    monkeypatch.setattr(tseg, "begin_segmented", recording)
    datas = _batch(2)
    tp._seg_auto("cpu")["choice"] = "device"
    pend = ct.decode_streams_device_async(datas, device="cpu")
    assert begun == [1] and pend._done is None
    dd = pend.finish()
    assert dd.segmented and pend.finish() is dd
    _assert_oracle(datas, dd.to_host())

    tp._seg_auto("cpu")["choice"] = None
    pend = ct.decode_streams_device_async(datas, device="cpu")
    # Calibrated before finish().
    assert tp._seg_auto("cpu")["choice"] in ("host", "device")
    _assert_oracle(datas, pend.finish().to_host())


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_lands_after_the_next_batch_begins(monkeypatch, depth):
    """Batches of 2 through the device path: batch n is finished only
    after batch n+1 has begun, the PCM comes back in input order, and at
    most ``depth`` landed batches wait to be fetched."""
    monkeypatch.setenv(ENV, "device")
    events = []
    begin = tp.decode_streams_device_async

    def recording(datas, *a, **kw):
        n = sum(e[0] == "begin" for e in events)
        events.append(("begin", n))
        pend = begin(datas, *a, **kw)
        finish = pend.finish

        def finished():
            events.append(("finish", n))
            return finish()

        pend.finish = finished
        return pend

    monkeypatch.setattr(tp, "decode_streams_device_async", recording)
    calls = _count_paths(monkeypatch)
    datas = _batch(5)
    _assert_oracle(datas, ct.decode_streams_pipelined(
        datas, batch_streams=2, depth=depth, device="cpu"))
    assert events == [("begin", 0), ("begin", 1), ("finish", 0),
                      ("begin", 2), ("finish", 1), ("finish", 2)]
    assert calls["host"] == 0


def test_pipelined_error_order_matches_the_host_walk(monkeypatch):
    """In the second batch, a stream whose first frame's CRC is corrupt
    and which is cut off in its second frame: the deferred CRC check wins
    over the walk error, on the device route as on the host walk."""
    from claxon_tpu_torch.native.binding import _read_metadata

    datas = _batch(3)
    data = _enc(913, n=3072, channels=1)
    _si, bb = native.extract_stream_bits(data, emit_slots=False)
    _si, pos = _read_metadata(data)
    end0 = pos + int(bb.bframes[0]["byte1"])
    bad = bytearray(data[:end0 + 7])  # cut inside frame 1
    bad[end0 - 1] ^= 0xFF             # frame 0's stored CRC
    datas[2] = bytes(bad)
    raised = []
    for value in ("host", "device"):
        monkeypatch.setenv(ENV, value)
        with pytest.raises(ct.Error) as err:
            ct.decode_streams_pipelined(datas, batch_streams=2, depth=2,
                                        device="cpu")
        raised.append((type(err.value).__name__, str(err.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] == "FormatError"
    assert raised[0][1].endswith("frame CRC mismatch")
