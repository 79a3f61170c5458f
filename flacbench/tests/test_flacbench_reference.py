"""The plain reference decoder (CPU): every subframe kind, channel
assignment and residual coding, held to the audio that was encoded."""

import json

import numpy as np
import pytest

from claxon_tpu_torch.testing import encode_flac, synth_music
from flacbench.gen import pool
from flacbench.harness import BENCH_DIR
from flacbench.reference import flac


@pytest.mark.parametrize("name", ["cd16-flac5", "hires24-flac8"])
def test_reference_decodes_each_configuration(name):
    """A small pool of each configuration's preset and format: the pool
    build holds the reference's PCM to the encoded audio."""
    config = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    config.update(name=name, pool_frames=2, pool_segment_frames=2)
    arrays = pool.build_pool(config, workers=1)
    assert arrays["pcm"].shape == (2, 4096, 2)
    assert len(arrays["body"]) > 0


CASES = [
    dict(bps=16, stereo="independent"),
    dict(bps=16, stereo="left_side", force_subframe="fixed"),
    dict(bps=16, stereo="right_side", force_subframe="verbatim"),
    dict(bps=24, stereo="mid_side", rice2=True, partition_order=4),
    dict(bps=8, stereo="auto", max_lpc_order=3),
    dict(bps=20, stereo="auto", max_lpc_order=32, lpc_precision=15),
    dict(bps=12, channels=1, block_size=1152),
    dict(bps=16, channels=3, block_size=192, partition_order=0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_reference_decodes_encoded_audio(case):
    case = dict(case)
    bps, ch = case.pop("bps"), case.pop("channels", 2)
    bs = case.pop("block_size", 4096)
    pcm = synth_music(bs * 2 + 100, ch, bps, seed=bps * 7 + ch)
    pcm[:bs // 2] &= ~3 if bps > 8 else ~0      # wasted bits in frame 0
    pcm[bs + 7:bs + 90] = 5                     # nearly constant stretch
    data = encode_flac(pcm, 44100, bps, block_size=bs, **case)
    info, got = flac.decode_stream(data)
    assert np.array_equal(got, pcm)
    assert info["samples"] == len(pcm) and info["bps"] == bps


def test_constant_subframes():
    pcm = np.full((4096, 2), -3, np.int64)
    pcm[:, 1] = 17
    _info, got = flac.decode_stream(encode_flac(pcm, 44100, 16))
    assert np.array_equal(got, pcm)


@pytest.mark.parametrize("where", ["header", "body"])
def test_damaged_frames_raise(where):
    pcm = synth_music(4096, 2, 16, seed=4)
    data = bytearray(encode_flac(pcm, 44100, 16, block_size=4096))
    _info, pos = flac.read_streaminfo(bytes(data))
    data[pos + (4 if where == "header" else 200)] ^= 0x10
    with pytest.raises(ValueError, match="CRC"):
        flac.decode_stream(bytes(data))


def test_longest_code_counts_the_parameter_field():
    """Two Rice codes with parameter 2 after a 4-bit parameter field:
    u = 5 ("01" "01") and u = 12 ("0001" "00"); the first code counts
    4 + 4 bits, the second 6."""
    r = flac._Bits(bytes([0b01010001, 0b00000000]))
    vals = flac._rice_partition(r, 2, 2, 4)
    assert vals.tolist() == [-3, 6]
    assert r.pos == 10 and r.longest == 8
