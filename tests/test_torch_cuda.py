"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Marked ``cuda`` and skipped where no CUDA device is present (the kernels
have no CPU mode). On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Equality is exact. The inputs include fuzzed ones: the kernels clamp
every read into their inputs exactly as the plain forms do, so garbage
gives the same garbage and never a fault.
"""

import pathlib

import numpy as np
import pytest
import torch

from claxon_tpu import native

pytestmark = pytest.mark.cuda

GENERATED = pathlib.Path(__file__).resolve().parents[1] / "testsamples" / \
    "generated"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _c(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def test_synthesize_kernel_matches_plain(cuda):
    from claxon_tpu_torch.ops import predict

    rng = np.random.default_rng(1)
    L, T = 100, 333  # ragged: neither a whole block of lanes nor of steps
    x = rng.integers(-(1 << 31), 1 << 31, (L, T), dtype=np.int64)
    orders = rng.integers(0, 33, L)
    shifts = rng.integers(0, 32, L)
    coefs = rng.integers(-(1 << 15) + 1, 1 << 15, (L, 32))
    coefs[np.arange(32)[None, :] < 32 - orders[:, None]] = 0
    lengths = rng.integers(0, T + 1, L)
    args = [_c(a, cuda) for a in (x, coefs, shifts, orders, lengths)]
    n = predict.synthesize.launches
    got = predict.synthesize(*args)
    assert predict.synthesize.launches == n + 1
    assert torch.equal(got, predict.synthesize_plain(*args))


def test_entropy_kernel_matches_plain_on_garbage(cuda):
    from claxon_tpu_torch.ops import entropy

    rng = np.random.default_rng(2)
    for P, SA, W in ((1, 1, 1), (4, 5, 64), (64, 40, 300)):
        L, NC = 37, 3
        args = [rng.integers(-(1 << 31), 1 << 31, W, dtype=np.int64),
                rng.integers(-4096, 32 * W + 4096, (L, NC)),
                rng.integers(-40, 40, (L, P)),
                rng.integers(-3, 200, L), rng.integers(0, 40, L),
                rng.integers(0, 8, L), rng.integers(0, 8, L),
                rng.integers(-1000, 1000, (L, 32)),
                rng.integers(0, NC * 32 + 8, L)]
        args[0][::5] = 0
        args = [_c(a, cuda) for a in args]
        got = entropy.decode_residual_bits_stream(*args, n_parts_max=P,
                                                  sa=SA)
        want = entropy.decode_residual_bits_stream_plain(
            *args, n_parts_max=P, sa=SA)
        assert torch.equal(got, want), (P, SA, W)


def test_crc_kernel_matches_plain_and_host(cuda):
    from claxon_tpu_torch.ops import crc

    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    stream = np.frombuffer(raw, np.uint8).view(">i4").astype(np.int32)
    starts = rng.integers(-10, 4010, 300)
    ends = starts + rng.integers(-5, 900, 300)
    args = [_c(a, cuda) for a in (stream, starts, ends)]
    got = crc.crc16_ranges(*args)
    assert torch.equal(got, crc.crc16_ranges_plain(*args))
    s = np.clip(starts, 0, 4000)
    e = np.clip(np.maximum(np.minimum(ends, 4000), s), 0, 4000)
    assert got.tolist() == [native.crc16_bytes(raw[a:b])
                            for a, b in zip(s, e)]


def fuzzed_streams(n=24, seed=7):
    """``n`` small valid streams with seeded damage in their frame
    sections: 1-4 flipped bytes, or a truncation. Shared with the CPU
    tests (tests/test_torch_pipeline.py)."""
    from claxon_tpu.native.binding import _read_metadata
    from claxon_tpu.testing import encode_flac, synth_music

    rng = np.random.default_rng(seed)
    pcm = synth_music(1800, channels=2, bps=16, seed=seed)
    bases = [encode_flac(pcm, 44100, 16, block_size=576, partition_order=2),
             encode_flac(pcm, 44100, 16, block_size=576,
                         force_subframe="verbatim"),
             encode_flac(pcm[:, :1], 44100, 16, block_size=576,
                         max_lpc_order=12)]
    out = []
    for i in range(n):
        data = bytearray(bases[i % len(bases)])
        pos = _read_metadata(bytes(data))[1]
        if i % 4 == 3:
            del data[int(rng.integers(pos, len(data))):]
        else:
            for at in rng.integers(pos, len(data), int(rng.integers(1, 5))):
                data[at] ^= int(rng.integers(1, 256))
        out.append(bytes(data))
    return out


def assert_decodes_like_scalar(datas, device):
    """Each stream decodes to the scalar decoder's PCM, or raises
    claxon_tpu.Error where the scalar decoder does; nothing else."""
    import claxon_tpu_torch as ct
    from claxon_tpu.error import Error

    for data in datas:
        try:
            want = native.decode_stream_scalar(data)[1]
        except Error:
            want = None
        if want is None:
            with pytest.raises(Error):
                ct.decode_streams([data], device=device)
        else:
            got = ct.decode_streams([data], device=device)[0].pcm
            assert np.array_equal(got, want)


def test_fuzzed_streams_on_the_card(cuda):
    assert_decodes_like_scalar(fuzzed_streams(), cuda)
    torch.cuda.synchronize()


def test_generated_corpus_on_the_card(cuda):
    import claxon_tpu_torch as ct

    datas = [p.read_bytes() for p in sorted(GENERATED.glob("*.flac"))]
    dd = ct.decode_streams_device(datas, device=cuda).sync()
    assert all(b[2].is_cuda for b in dd.device_buckets())
    for data, dec in zip(datas, dd.to_host()):
        assert np.array_equal(dec.pcm, native.decode_stream_scalar(data)[1])
