"""The port's lane sharding (claxon_tpu_torch.parallel) on meshes of CPU
devices against the JAX package's (claxon_tpu.parallel on the virtual
8-device CPU platform), the port's unsharded decode and the C++ scalar
decoder. Tolerance 0 throughout.

The JAX calls reuse the shapes ``tests/test_parallel.py`` compiles, so
the persistent XLA cache serves them; a repeated ``"cpu"`` device stands
for each of the JAX tests' virtual devices.
"""

import importlib.util
import math
import pathlib

import jax
import numpy as np
import pytest
import torch

import claxon_tpu.parallel as jpar
from claxon_tpu import native
from claxon_tpu.error import Error as RefError
from claxon_tpu.extract import extract_stream as jax_extract_stream
from claxon_tpu.testing import encode_flac, synth_music

import claxon_tpu_torch as ct
import claxon_tpu_torch.pipeline_seg as tseg
from claxon_tpu_torch import pipeline as tp
from claxon_tpu_torch.error import Error, FormatError
from claxon_tpu_torch.extract import extract_stream
from claxon_tpu_torch.parallel import (LANE_AXIS, decode_batch_sharded,
                                       decode_streams_sharded, lane_quantum,
                                       make_decode_step, make_mesh)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")


@pytest.fixture(autouse=True)
def _clear_port_reject_cache():
    tseg._REJECT_CACHE.clear()
    yield
    tseg._REJECT_CACHE.clear()


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _streams():
    """``tests/test_parallel.py::test_decode_streams_sharded``'s corpus."""
    return [encode_flac(synth_music(5000, channels=2, bps=16, seed=s),
                        44100, 16, block_size=1024) for s in (31, 32, 33)]


@pytest.fixture(scope="module")
def streams_and_jax():
    """The corpus, and the JAX package's sharded decode of it on its
    8-device mesh (host walk, as ``tests/conftest.py`` pins it)."""
    datas = _streams()
    return datas, jpar.decode_streams_sharded(datas, jpar.make_mesh(8))


def _assert_pcm(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.pcm, w.pcm)
        assert list(g.frame_times) == list(w.frame_times)
        assert list(g.frame_sizes) == list(w.frame_sizes)


def _assert_scalar(datas, got):
    for data, dec in zip(datas, got):
        assert np.array_equal(dec.pcm, native.decode_stream_scalar(data)[1])


def test_lane_quantum_matches_jax():
    """The quantum is JAX's on the meshes the JAX tests build, and the
    formula lcm(128, 2n) on the others; every shard of a quantum is even,
    so a stereo pair never splits."""
    for n in (1, 2, 8):
        assert lane_quantum(_cpu_mesh(n)) == \
            jpar.lane_quantum(jpar.make_mesh(n))
    for n in (1, 2, 3, 8, 16, 32):
        q = lane_quantum(_cpu_mesh(n))
        assert q == math.lcm(128, 2 * n)
        assert q % 128 == 0 and (q // n) % 2 == 0
    assert LANE_AXIS == jpar.LANE_AXIS == "streams"
    import claxon_tpu_torch.parallel as tpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)


def test_make_mesh_errors(monkeypatch):
    """Too few devices raises the JAX package's ValueError, word for word;
    with no CUDA device and no ``devices`` there is no CPU fallback."""
    with pytest.raises(ValueError) as ref:
        jpar.make_mesh(len(jax.devices()) + 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count",
                        lambda: len(jax.devices()))
    with pytest.raises(ValueError) as port:
        make_mesh(len(jax.devices()) + 1)
    assert str(port.value) == str(ref.value)
    mesh = make_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.size == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("n", [2, 8])
def test_decode_batch_sharded_matches_jax(n):
    """``tests/test_parallel.py::test_sharded_matches_single_device``'s
    stream through both packages' sharded FrameDesc step: equal PCM, and
    equal to the scalar decoder."""
    pcm = synth_music(9000, channels=2, bps=16, seed=21)
    data = encode_flac(pcm, 44100, 16, block_size=1024)
    want = jpar.decode_batch_sharded(jax_extract_stream(data),
                                     jpar.make_mesh(n))
    got = decode_batch_sharded(extract_stream(data), _cpu_mesh(n))
    assert np.array_equal(got.pcm, want.pcm)
    assert np.array_equal(got.pcm, native.decode_stream_scalar(data)[1])
    assert np.array_equal(got.pcm, pcm)


def test_decode_step_returns_shards_in_lane_order():
    """The sharded step hands back one (L / n, T) tensor a shard, on the
    shard's device, cached per mesh; stacked in order they are the
    unsharded bucket."""
    data = encode_flac(synth_music(3000, channels=2, bps=16, seed=22),
                       44100, 16, block_size=1024)
    frames = extract_stream(data).frames
    mesh = _cpu_mesh(4)
    (key, idx), = tp.group_frames(frames, lane_quantum(mesh)).items()
    arrays = tp.pack_bucket(frames, idx, key[1], key[0], lane_quantum(mesh))
    step = make_decode_step(mesh)
    assert make_decode_step(mesh) is step
    shards = step(*arrays)
    L, T = arrays[0].shape
    assert [tuple(s.shape) for s in shards] == [(L // 4, T)] * 4
    assert [s.device for s in shards] == list(mesh.devices)
    whole = tp.device_decode_bucket(*arrays, device="cpu")
    assert torch.equal(torch.cat(shards), whole)


@pytest.mark.parametrize("n", [2, 8])
def test_decode_streams_sharded_host_walk_matches_jax(n, streams_and_jax):
    """The host-walk bits path split over 2 and 8 shards: the JAX
    package's sharded PCM, the port's unsharded decode and the scalar
    decoder's."""
    datas, want = streams_and_jax
    got = decode_streams_sharded(datas, _cpu_mesh(n), segmentation="host")
    _assert_pcm(got, want)
    _assert_pcm(got, ct.decode_streams(datas, device="cpu"))
    _assert_scalar(datas, got)


@pytest.mark.parametrize("route", ["device", "use_native=False"])
def test_decode_streams_sharded_other_routes(route, streams_and_jax):
    """The segmented path and the FrameDesc route over two shards: the
    port's unsharded PCM, frame times and sizes, and the scalar
    decoder's."""
    datas, _want = streams_and_jax
    mesh = _cpu_mesh(2)
    if route == "device":
        got = decode_streams_sharded(datas, mesh, segmentation="device")
        unsharded = ct.decode_streams_device(datas, segmentation="device",
                                             device="cpu").to_host()
    else:
        got = decode_streams_sharded(datas, mesh, use_native=False)
        unsharded = ct.decode_streams(datas, False, device="cpu")
    _assert_pcm(got, unsharded)
    _assert_scalar(datas, got)


def test_auto_calibrates_over_the_mesh(monkeypatch, streams_and_jax):
    """segmentation=None with the variable unset calibrates ("auto") over
    the mesh and caches the choice in the slot of the mesh's first
    device's type; the next call takes the cached path."""
    datas, want = streams_and_jax
    datas, want = datas[:1], want[:1]
    monkeypatch.delenv("CLAXON_TPU_SEGMENTATION", raising=False)
    monkeypatch.setitem(tp._SEG_AUTO, "cpu", {"choice": None,
                                              "seconds": None})
    mesh = _cpu_mesh(2)
    _assert_pcm(decode_streams_sharded(datas, mesh), want)
    slot = tp._seg_auto("cpu")
    assert slot["choice"] in ("host", "device")
    assert set(slot["seconds"]) == {"device", "host"}
    _assert_pcm(decode_streams_sharded(datas, mesh), want)


@pytest.mark.parametrize("route,n", [
    ("host", 2), ("device", 2), ("host", 1), ("device", 1),
    ("use_native=False", 2), ("use_native=False", 1)],
    ids=["host", "device", "host-mesh1", "device-mesh1", "framedesc",
         "framedesc-mesh1"])
def test_shards_live_on_their_devices(route, n, streams_and_jax):
    """Each bucket of a sharded ``decode_streams_device(..., mesh=)`` holds
    one tensor a shard, in lane order, on its mesh device:
    ``device_buckets()`` hands back the tuple of shards over a mesh of 2,
    and over a mesh of one device the tensor itself, as the unsharded
    call does; stacked in order they equal the unsharded decode's bucket;
    the lane plans and frame indices are the unsharded ones; on the bits
    paths the CRC check has a pair a shard whose valid counts add up to
    the batch's frames."""
    datas, _want = streams_and_jax
    mesh = _cpu_mesh(n)
    native_route = route != "use_native=False"
    segmentation = route if native_route else None
    dd = ct.decode_streams_device(datas, native_route, lane_quantum(mesh),
                                  segmentation, "cpu", mesh=mesh)
    if route == "device":
        assert dd.segmented and dd.fallback_streams == []
    one = ct.decode_streams_device(datas, native_route,
                                   segmentation=segmentation, device="cpu")
    assert dd.lane_plans() == one.lane_plans()
    for (fi, nch, shards), (fi1, nch1, whole) in zip(dd.device_buckets(),
                                                     one.device_buckets()):
        assert (fi, nch) == (fi1, nch1)
        if n == 1:
            assert isinstance(shards, torch.Tensor)
            shards = (shards,)
        assert isinstance(shards, tuple) and len(shards) == n
        L, T = whole.shape
        assert [tuple(s.shape) for s in shards] == [(L // n, T)] * n
        assert [s.device for s in shards] == list(mesh.devices)
        assert torch.equal(torch.cat(shards), whole)
    if native_route:
        assert len(dd.crc_check) == n * len(one.crc_check)
        assert sum(c for _v, c in dd.crc_check) == \
            sum(c for _v, c in one.crc_check) == 15
    else:
        assert dd.crc_check is one.crc_check is None
    _assert_pcm(dd.to_host(), one.to_host())


#: (variable, value, segmentation, the wrapper's name in ``ops.entropy``
#: or ``pipeline_bits``, the position of its (L, ...) lane argument)
_ENTROPY_ROUTES = {
    "host-delta": ("CLAXON_TPU_ENTROPY", "delta", "host",
                   "pipeline_bits.decode_residual_bits", 0),
    "seg-delta": ("CLAXON_TPU_SEG_ENTROPY", "delta", "device",
                  "entropy.decode_residual_bits_stream_delta", 1),
    "seg-scan": ("CLAXON_TPU_SEG_ENTROPY", "scan", "device",
                 "entropy.decode_residual_bits_stream", 1),
}


@pytest.mark.parametrize("route", sorted(_ENTROPY_ROUTES))
def test_entropy_modes_run_per_shard(route, monkeypatch, streams_and_jax):
    """The other entropy routes over a mesh of 2: the host walk's delta
    mode (K9), the segmented delta (K10) and scan (K2) modes. Each bucket
    or dispatch calls the route's entropy decoder once a shard on half
    its lanes, where the unsharded call calls it once on all of them, and
    the segmented modes gather no values (K8); the PCM is the JAX
    package's sharded PCM, the unsharded decode's and the scalar
    decoder's."""
    import claxon_tpu_torch.ops.entropy as entropy
    import claxon_tpu_torch.pipeline_bits as tpb
    import claxon_tpu_torch.ops.seg_gather as seg_gather

    var, value, segmentation, name, arg = _ENTROPY_ROUTES[route]
    module, attr = name.split(".")
    module = {"pipeline_bits": tpb, "entropy": entropy}[module]
    monkeypatch.setenv(var, value)
    lanes = []
    decoder = getattr(module, attr)

    def spy(*args, **kw):
        lanes.append((args[arg].shape[0], args[arg].device))
        return decoder(*args, **kw)

    def no_gather(*args, **kw):
        raise AssertionError("K8 ran on the " + route + " route")

    monkeypatch.setattr(module, attr, spy)
    monkeypatch.setattr(seg_gather, "gather_values", no_gather)
    datas, want = streams_and_jax
    unsharded = ct.decode_streams_device(datas, segmentation=segmentation,
                                         device="cpu").to_host()
    whole, lanes[:] = list(lanes), []
    mesh = _cpu_mesh(2)
    got = decode_streams_sharded(datas, mesh, segmentation=segmentation)
    assert whole
    assert lanes == [(L // 2, dev) for L, _d in whole
                     for dev in mesh.devices]
    _assert_pcm(got, unsharded)
    _assert_pcm(got, want)
    _assert_scalar(datas, got)


def test_per_lane_int16_flag_refetches_one_shard():
    """A damaged 16-bit stream whose garbage leaves int16 (its CRC
    repaired), behind a clean stream of 16 frames in one bucket over 4
    shards: the per-lane flag fires only on the damaged frame's two lanes
    of its shard, that shard alone comes back as int32, the others as
    int16 pairs, and the PCM is the scalar decoder's."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    bad = chip_smoke.overflow_stream()
    good = encode_flac(synth_music(4096 * 8, channels=2, bps=16, seed=3001),
                       44100, 16, block_size=4096)
    mesh = _cpu_mesh(4)
    dd = tp._decode_host_walk([good, bad], lane_quantum(mesh), "cpu",
                              mesh=mesh)
    got = dd.to_host()
    (d,) = dd.dispatches
    assert d.packed and d.out_full is None
    flags = [s.flag.tolist() for s in d.shards]
    # The good stream holds lanes 0-15, the damaged one 16-21; its frame
    # 1 (lanes 18, 19) decodes out of range.
    assert flags[0] == [0] * 18 + [1, 1] + [0] * 12
    assert flags[1:] == [[0] * 32] * 3
    assert [s.host is not None for s in d.shards] == [True, False, False,
                                                      False]
    _assert_scalar([good, bad], got)


def test_error_order_over_shards(streams_and_jax):
    """Errors over a mesh are the unsharded call's and the JAX package's:
    a corrupt stored CRC in the last stream's frame (in the second
    shard's half of the CRC ranges) raises "frame CRC mismatch" as JAX's
    sharded call does; a CRC-corrupt frame before a truncated one raises
    the CRC error first, as the sequential reference would."""
    from test_torch_pipeline import _corrupt_crc, _first_frame_span

    datas, _want = streams_and_jax
    batch = datas[:2] + [_corrupt_crc(datas[2])]
    mesh = _cpu_mesh(2)
    for segmentation in ("host", "device"):
        with pytest.raises(Error) as port:
            decode_streams_sharded(batch, mesh, segmentation=segmentation)
        assert isinstance(port.value, FormatError)
        assert "frame CRC mismatch" in str(port.value)
    with pytest.raises(RefError) as ref:
        jpar.decode_streams_sharded(batch, jpar.make_mesh(8))
    assert (type(port.value).__name__, str(port.value)) == \
        (type(ref.value).__name__, str(ref.value))

    data = encode_flac(synth_music(1024 * 3, channels=1, bps=16, seed=79),
                       44100, 16, block_size=1024)
    _b0, b1 = _first_frame_span(data)
    bad = bytearray(data[:b1 + 7])  # truncated mid-frame 1: a walk error
    bad[b1 - 1] ^= 0xFF             # and frame 0's CRC corrupted
    with pytest.raises(Error, match="frame CRC mismatch"):
        decode_streams_sharded([bytes(bad)], mesh, segmentation="host")
    with pytest.raises(Error) as truncated:
        decode_streams_sharded([bytes(data[:b1 + 7])], mesh,
                               segmentation="host")
    with pytest.raises(Error) as unsharded:
        ct.decode_streams([bytes(data[:b1 + 7])], device="cpu")
    assert str(truncated.value) == str(unsharded.value)
