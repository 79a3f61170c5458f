"""The port's example and tool on the CPU: ``examples/
device_consumer_torch.py`` (per-channel stats taken on the device-resident
buckets, held to numpy on the scalar decoder's PCM) and ``tools/
verify_samples_torch.py`` (generated streams and a directory, its exit
code)."""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest

from claxon_tpu_torch import native

REPO = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

GENERATED = REPO / "testsamples" / "generated"


def _load(path):
    """The script at ``path`` as a module, loaded from its file so that
    its folder never joins ``sys.path``."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _two_files():
    """Two generated files of several frames: left/side stereo, and 8-bit
    mono in FIXED subframes."""
    return [GENERATED / "leftside.flac", GENERATED / "mono8_fixed.flac"]


def test_device_consumer_stats_match_numpy(capsys):
    """RMS and zero-crossing rate per stream and channel, taken by torch
    ops on ``device_buckets()`` over the lanes ``lane_plans()`` names,
    equal numpy's on the scalar decoder's PCM, frame by frame; the
    command line prints a line per channel."""
    ex = _load(REPO / "examples" / "device_consumer_torch.py")

    files = _two_files()
    datas = [f.read_bytes() for f in files]
    dd, stats = ex.analyze(datas, device="cpu")
    want = {}
    for i, (data, res) in enumerate(zip(datas, dd.results)):
        # The PCM stays on the device: the host arrays are never filled.
        _si, pcm = native.decode_stream_scalar(data)
        assert res.pcm.shape == pcm.shape and not res.pcm.any()
        starts = np.cumsum([0] + list(res.frame_sizes))
        for ch in range(pcm.shape[1]):
            x = pcm[:, ch].astype(np.float64)
            zc = sum(int(((x[a + 1:b] * x[a:b - 1]) < 0).sum())
                     for a, b in zip(starts[:-1], starts[1:]))
            pairs = sum(b - a - 1 for a, b in zip(starts[:-1], starts[1:]))
            want[(i, ch)] = (np.sqrt((x * x).sum() / len(x)), zc / pairs)
    assert sorted(stats) == sorted(want)
    for key, (rms, zcr) in stats.items():
        assert rms == pytest.approx(want[key][0], rel=1e-12)
        assert zcr == want[key][1]
    assert ex.main(["--cpu"] + [str(f) for f in files]) == 0
    out = capsys.readouterr().out
    assert out.count("channel ") == sum(p.shape[1] for p in (
        native.decode_stream_scalar(d)[1] for d in datas))


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["host", "segmented"])
def test_verify_samples_generate(segmented, capsys):
    """``--generate 3 --cpu`` at small sizes: every stream passes the
    three checks and the exit code is 0."""
    tool = _load(REPO / "tools" / "verify_samples_torch.py")

    argv = ["--generate", "3", "--seed", "5", "--cpu", "--max-samples",
            "4000"] + (["--segmented"] if segmented else [])
    assert tool.main(argv) == 0
    out = capsys.readouterr().out
    assert "verified 3 files" in out and "3 ok, 0 failed" in out
    assert ("segmented:" in out) is segmented


def test_verify_samples_directory_exit_code(tmp_path, capsys):
    """A directory walk: the generated corpus passes; a copy whose stored
    MD5 is damaged fails its first check and the exit code is 1."""
    tool = _load(REPO / "tools" / "verify_samples_torch.py")

    good = _two_files()[0]
    shutil.copy(good, tmp_path / "good.flac")
    bad = bytearray(good.read_bytes())
    bad[30] ^= 0xFF  # a byte of the STREAMINFO MD5 (bytes 26-41)
    (tmp_path / "bad.flac").write_bytes(bytes(bad))
    assert tool.main([str(tmp_path), "--cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "bad.flac" in out and "STREAMINFO MD5" in out
    assert "1 ok, 1 failed" in out
    (tmp_path / "bad.flac").unlink()
    assert tool.main([str(tmp_path), "--cpu"]) == 0
