"""The port runs where neither JAX nor the JAX package is importable (as
on the machine with the card): in a fresh interpreter whose imports of
``jax``/``jaxlib`` and of ``claxon_tpu`` fail (the top-level name exactly,
not ``claxon_tpu_torch``), ``claxon_tpu_torch`` and ``chip_smoke`` import,
the port's own encoder, muxers and C++ core work, and small streams decode
on the CPU bit-exactly through the host-walk and the segmented paths, in
the delta and scan entropy modes and with the host CRC check, and from
Ogg and MP4 containers; the reader API reads them (``FlacReader``'s
samples on both reader routes, ``FrameReader`` blocks from a file-like
input), and ``use_native=False`` decodes them through the Python
extractor and the FrameDesc route, with and without a ``decode_bucket``;
``claxon_tpu_torch.parallel`` splits their buckets over a mesh of two
CPU devices; ``CLAXON_TPU_NO_BITS`` sends the stream calls down the
sample-shipping route (``decode_raw_batches_device``, also over that
mesh) and the container and sharded calls down the FrameDesc route from
the C++ core's FrameDescs; and the plain forms of rice_decode,
crc16_device and crc16_frames_device run."""

import pathlib
import subprocess
import sys
import textwrap

import pytest

from claxon_tpu import native

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "claxon_tpu")

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this interpreter")
            return None

    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, sys.argv[1])

    import numpy as np

    for name in BLOCKED:
        try:
            __import__(name)
        except ImportError:
            pass
        else:
            raise AssertionError(f"{name} was not blocked")

    import chip_smoke
    import claxon_tpu_torch as ct
    import claxon_tpu_torch.containers.mp4
    import claxon_tpu_torch.containers.ogg
    import claxon_tpu_torch.containers.pipeline
    import claxon_tpu_torch.testing.containers_gen
    from claxon_tpu_torch import native
    from claxon_tpu_torch.testing import (encode_flac, mux_mp4_flac,
                                          mux_ogg_flac, pcm_md5, synth_music)

    from claxon_tpu_torch.crc import crc16_combine_matrices
    from claxon_tpu_torch.ops.crc import kernel_tables

    assert crc16_combine_matrices(31).shape == (31, 16)
    assert kernel_tables().shape == (1024 + 31 * 512,)

    import torch

    import claxon_tpu_torch.ops.rice
    from claxon_tpu_torch.crc import crc16
    from claxon_tpu_torch.ops import crc16_device, rice_decode
    from claxon_tpu_torch.ops.crc import crc16_frames_device
    from claxon_tpu_torch.testing.rice_crc_cases import rice_stream

    st = rice_stream(np.full(8, 16), seed=3)
    got, end = rice_decode(torch.from_numpy(st["words"]), st["start_bits"],
                           st["params"], st["counts"])
    assert np.array_equal(got.numpy(), st["values"])
    raw = np.random.default_rng(4).integers(0, 256, 64, dtype=np.uint8)
    rows = torch.from_numpy(np.stack([raw, raw[::-1]]).astype(np.int32))
    lens = torch.tensor([64, 10], dtype=torch.int32)
    assert crc16_device(rows, lens).tolist() == [
        crc16(raw.tobytes()), crc16(raw[::-1][:10].tobytes())]
    words = torch.from_numpy(raw.view(">u4").astype(np.int64)
                             .astype(np.int32))
    assert crc16_frames_device(words, torch.tensor([3], dtype=torch.int32),
                               torch.tensor([61], dtype=torch.int32),
                               16).tolist() == [crc16(raw[3:61].tobytes())]
    pcm = synth_music(3000, channels=2, bps=16, seed=5)
    data = encode_flac(pcm, 44100, 16, block_size=1152)
    dec = ct.decode_stream(data, device="cpu")
    assert np.array_equal(dec.pcm, native.decode_stream_scalar(data)[1])
    assert np.array_equal(dec.pcm, pcm)
    assert pcm_md5(dec.pcm, 16) == dec.streaminfo.md5sum
    mono = encode_flac(pcm[:, :1], 44100, 16, block_size=576)
    dd = ct.decode_streams_device([data, mono], segmentation="device",
                                  device="cpu")
    assert dd.segmented and dd.fallback_streams == []
    out = dd.to_host()
    assert np.array_equal(out[0].pcm, pcm)
    assert np.array_equal(out[1].pcm, pcm[:, :1])
    import os

    for knob, seg in (("CLAXON_TPU_ENTROPY=delta", "host"),
                      ("CLAXON_TPU_HOST_CRC=1", "host"),
                      ("CLAXON_TPU_SEG_ENTROPY=delta", "device"),
                      ("CLAXON_TPU_SEG_ENTROPY=scan", "device")):
        name, value = knob.split("=")
        os.environ[name] = value
        out = ct.decode_streams_device([data, mono], segmentation=seg,
                                       device="cpu").to_host()
        del os.environ[name]
        assert np.array_equal(out[0].pcm, pcm), knob
        assert np.array_equal(out[1].pcm, pcm[:, :1]), knob
    ogg = ct.decode_ogg_stream(mux_ogg_flac(data), device="cpu")
    mp4 = ct.decode_mp4_stream(mux_mp4_flac(data, 2), device="cpu")
    assert np.array_equal(ogg.pcm, pcm) and np.array_equal(mp4.pcm, pcm)
    import functools
    import io

    from claxon_tpu_torch.pipeline import device_decode_bucket

    for knob in (None, "1"):
        if knob:
            os.environ["CLAXON_TPU_NO_NATIVE_READER"] = knob
        got = np.array(list(ct.FlacReader(data).samples()))
        assert np.array_equal(got, pcm.reshape(-1)), knob
        fr = ct.FrameReader(ct.FlacReader(io.BytesIO(mono)).blocks().input)
        blocks = []
        while (b := fr.read_next_or_eof()) is not None:
            blocks.append(b.channel(0).copy())
        assert np.array_equal(np.concatenate(blocks), pcm[:, 0]), knob
        os.environ.pop("CLAXON_TPU_NO_NATIVE_READER", None)
    out = ct.decode_streams([data, mono], False, device="cpu")
    assert np.array_equal(out[0].pcm, pcm)
    assert np.array_equal(out[1].pcm, pcm[:, :1])
    out = ct.decode_streams([data], False, functools.partial(
        device_decode_bucket, device="cpu"), device="cpu")
    assert np.array_equal(out[0].pcm, pcm)
    ogg = ct.decode_ogg_stream(mux_ogg_flac(data), use_native=False,
                               device="cpu")
    assert np.array_equal(ogg.pcm, pcm)
    import claxon_tpu_torch.parallel as par

    mesh = par.make_mesh(devices=["cpu", "cpu"])
    out = par.decode_streams_sharded([data, mono], mesh,
                                     segmentation="host")
    assert np.array_equal(out[0].pcm, pcm)
    assert np.array_equal(out[1].pcm, pcm[:, :1])
    from claxon_tpu_torch.parallel import lane_quantum

    os.environ["CLAXON_TPU_NO_BITS"] = "1"
    for kw in ({}, {"lane_quantum": lane_quantum(mesh), "mesh": mesh}):
        dd = ct.decode_streams_device([data, mono], segmentation="device",
                                      device="cpu", **kw)
        assert dd.frames == [] and dd.crc_check is None, kw
        assert any(run[2] > 1 for plan in dd.lane_plans() for run in plan)
        out = dd.to_host()
        assert np.array_equal(out[0].pcm, pcm), kw
        assert np.array_equal(out[1].pcm, pcm[:, :1]), kw
    assert ct.pipeline._seg_auto("cpu")["choice"] is None
    ogg = ct.decode_ogg_stream(mux_ogg_flac(data), device="cpu")
    mp4 = ct.decode_mp4_stream(mux_mp4_flac(data, 2), device="cpu")
    out = par.decode_streams_sharded([data, mono], mesh)
    del os.environ["CLAXON_TPU_NO_BITS"]
    assert np.array_equal(ogg.pcm, pcm) and np.array_equal(mp4.pcm, pcm)
    assert np.array_equal(out[0].pcm, pcm)
    assert np.array_equal(out[1].pcm, pcm[:, :1])
    try:
        ct.decode_streams_device([data[:4] + b"!" + data[5:]], device="cpu")
    except ct.FormatError as e:
        assert "streaminfo" in str(e) or "metadata" in str(e), e
    else:
        raise AssertionError("a damaged metadata header decoded")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NOJAX-OK")
""")


@pytest.mark.skipif(not native.available(), reason="native core not built")
def test_port_imports_and_decodes_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(REPO)],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX-OK" in proc.stdout
