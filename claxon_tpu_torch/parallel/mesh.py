"""The mesh, the lane split, and the sharded decode calls (counterpart of
``claxon_tpu.parallel.mesh``).

See the package docstring for the design: frames are independent, so a
bucket's lane axis splits into contiguous ranges, one a device, and
nothing crosses between devices.
"""

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

LANE_AXIS = "streams"

__all__ = ["Mesh", "make_mesh", "make_decode_step", "decode_batch_sharded",
           "decode_streams_sharded", "lane_quantum", "shard_ranges",
           "replicate", "device_guard", "LANE_AXIS"]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices the lane axis (``LANE_AXIS``) splits over,
    in shard order. A device may appear more than once (see
    :func:`make_mesh`)."""
    devices: tuple

    @property
    def size(self):
        """The number of shards."""
        return len(self.devices)


def _device(d):
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices=None, devices=None):
    """A :class:`Mesh` over ``devices``, or over the first ``n_devices``
    CUDA devices (default: every one, ``torch.cuda.device_count()``).
    Without a CUDA device and without ``devices`` it raises: there is no
    CPU fallback.

    ``devices`` may list one device several times, for example
    ``["cuda:0", "cuda:0"]`` or ``["cpu"] * 8``: each shard is still its
    own lane range with its own launches, on that device. This is how
    several shards run on one card, and how the CPU tests split lanes as
    the JAX package's tests do on their virtual CPU devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass devices= "
                               "to split lanes over other devices)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    if not len(devices):
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(_device(d) for d in devices))


def lane_quantum(mesh):
    """Lane padding quantum: a multiple of 128 (the JAX package's lane
    quantum, which the planners keep) and of 2 x the mesh size, so every
    shard gets an equal, pair-aligned lane count."""
    n = mesh.size
    return (128 * 2 * n) // math.gcd(128, 2 * n)


def shard_ranges(mesh, n):
    """[(device, start, stop), ...]: ``n`` rows split into ``mesh.size``
    equal contiguous ranges, in order."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over "
                         f"{mesh.size} shards")
    w = n // mesh.size
    return [(d, i * w, (i + 1) * w) for i, d in enumerate(mesh.devices)]


def replicate(t, mesh):
    """{device: tensor}: ``t`` on each distinct device of the mesh, copied
    once to each device it is not on."""
    return {d: t if t.device == d else t.to(d)
            for d in dict.fromkeys(mesh.devices)}


def device_guard(device):
    """The context in which launches go to ``device``: the kernels' entry
    points launch on the current CUDA device, so a shard's launches run
    with its device current. Nothing for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


_STEP_CACHE = {}


def make_decode_step(mesh):
    """The sharded per-bucket decode step of the FrameDesc route, cached
    per mesh as in the JAX package: it takes ``pipeline.pack_bucket``'s
    seven numpy arrays and returns the bucket's PCM as a tuple of
    (L / n, T) int32 shards in lane order, shard i on ``mesh.devices[i]``.
    Each shard uploads its lane rows (the residuals as int16 pairs when
    every value fits and T is even, unpacked by K3b on its device, the
    rule of ``pipeline.decode_batches_device``) and runs K1 + K3 there."""
    cached = _STEP_CACHE.get(mesh)
    if cached is not None:
        return cached

    from ..pipeline import _pack_input
    from ..pipeline_bits import _decode_sample_shards

    def decode_step(x, coefs, shifts, orders, wasted, pair_modes,
                    lengths=None):
        if lengths is None:
            lengths = np.full(x.shape[0], x.shape[1], dtype=np.int32)
        arrays, in_packed = _pack_input(
            (x, coefs, shifts, orders, wasted, pair_modes, lengths))
        return tuple(_decode_sample_shards(arrays, in_packed, mesh))

    _STEP_CACHE[mesh] = decode_step
    return decode_step


def decode_batch_sharded(batch, mesh=None):
    """Decode one extracted StreamBatch with its buckets split over the
    mesh (``pipeline.decode_batch`` with the sharded step and the mesh's
    lane quantum)."""
    from ..pipeline import decode_batch

    if mesh is None:
        mesh = make_mesh()
    return decode_batch(batch, make_decode_step(mesh),
                        lane_quantum(mesh))


def _calibrate_segmentation_sharded(datas, mesh):
    """``pipeline._calibrate_segmentation`` over the mesh (its choice goes
    to the ``_SEG_AUTO`` entry of ``mesh.devices[0]``'s type). Returns
    (choice, the winner's DeviceDecoded), so the batch is not decoded
    again; a batch that does not ride the device demux is "host"."""
    from ..pipeline import _calibrate_segmentation

    dd = _calibrate_segmentation(datas, lane_quantum(mesh), mesh.devices[0],
                                 mesh)
    return ("device" if dd.segmented else "host"), dd


def decode_streams_sharded(datas, mesh=None, use_native=True,
                           segmentation=None):
    """Decode many FLAC streams with every bucket's lanes split over the
    mesh (default: every CUDA device); PCM on the host.

    With the C++ core (``use_native``) this is
    ``pipeline.decode_streams_device`` over the mesh: the host-walk bits
    path with each bucket's K2 -> K1 + K3 (K9 -> K1 + K3 in delta mode)
    run per shard and K4 split on frames, or with
    ``segmentation="device"`` (or ``CLAXON_TPU_SEGMENTATION=device``) the
    segmented path, whose upload and fused demux run once on
    ``mesh.devices[0]`` and whose decode dispatches run per shard;
    ``"auto"`` (the default) times both over the mesh once and keeps the
    faster, as the unsharded calls do. ``use_native=False`` takes the
    FrameDesc route: the Python extractor, then :func:`make_decode_step`
    per bucket; under ``CLAXON_TPU_NO_BITS`` (any nonempty value) so does
    ``use_native=True``, from the C++ core's FrameDescs, whatever
    ``segmentation`` says, as in the JAX package."""
    from ..pipeline import (_extract, _no_bits, decode_batches,
                            decode_streams_device)

    if mesh is None:
        mesh = make_mesh()
    if use_native and not _no_bits():
        return decode_streams_device(
            datas, True, lane_quantum(mesh), segmentation, mesh.devices[0],
            mesh=mesh).start_fetch().to_host()
    return decode_batches([_extract(d, use_native) for d in datas],
                          make_decode_step(mesh), lane_quantum(mesh))
