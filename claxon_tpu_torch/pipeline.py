"""Batched decode pipeline of the port: the library's public entry points
(counterpart of ``claxon_tpu.pipeline``).

``decode_streams_device`` walks every stream once on the host with the
port's copy of the C++ core (frame CRC-16 checks deferred to the device
unless ``CLAXON_TPU_HOST_CRC`` is set; a stream of ``MAX_BATCH_BYTES`` or
more in chunks of frames), plans the batch into fixed (L, T) buckets
(``pipeline_bits``; ``CLAXON_TPU_ENTROPY=delta`` picks the delta entropy
mode, as in the JAX package), and runs the hand-written kernels on
``device``. With ``segmentation="device"`` the
card finds the frames and walks the subframes itself instead
(``pipeline_seg``). The default, as in the JAX package, is
``CLAXON_TPU_SEGMENTATION`` or else ``"auto"``: the first batch that
engages the device demux times both paths and the faster one is kept for
the process. The result, :class:`DeviceDecoded`, keeps the decoded
PCM on the device bucket by bucket; ``to_host()`` fetches it (16-bit
buckets as int16 pairs, K3b) and scatters it into per-stream interleaved
PCM. Each batch's host stages are spans of its record, ``dd.trace``
(``trace``).

``use_native=False`` takes the JAX package's FrameDesc route instead: the
Python extractor (``extract``, the reference-fidelity parse, frame CRC-16
checked on the host) emits per-subframe descriptors, which are grouped
into (L, T) buckets of residuals (:func:`pack_bucket`) and decoded on
``device`` by K1 + K3 (K3b unpack first when the residuals fit int16).
``decode_batches_device`` runs that dispatch on any extracted batches
(for example ``native.extract_stream``'s), and ``decode_streams``'
``decode_bucket`` argument replaces its per-bucket device call.

``CLAXON_TPU_NO_BITS`` (any nonempty value) takes the JAX package's
sample-shipping route instead, whatever ``segmentation`` says: the C++
core decodes the residuals on the host (``native.extract_stream_raw``) and
:func:`decode_raw_batches_device` plans buckets straight from its flat
arrays, so the card runs only K3b unpack and K1 + K3.

Every call takes an explicit ``device`` (default ``"cuda"``): nothing
probes for a GPU, and CPU tensors take the kernels' plain PyTorch forms.
The C++ core is required unless ``use_native=False``.
"""

import sys
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from . import trace
from .error import fmt_err

__all__ = ["decode_stream", "decode_streams", "decode_batch",
           "decode_batches", "decode_batches_device", "decode_streams_device",
           "decode_streams_device_async", "decode_streams_pipelined",
           "extract_streams_bits", "merge_decoded", "DeviceDecoded",
           "DecodedStream", "bucket_shape", "device_decode_bucket",
           "decode_raw_batches_device"]

# Time-axis bucket sizes: the common FLAC block sizes plus power-of-two
# fill-ins, so a stream with one block size makes one bucket shape.
_T_BUCKETS = (64, 192, 256, 576, 1024, 1152, 2048, 2304, 4096, 4608,
              8192, 16384, 32768, 65535)
_L_QUANTUM = 128  # lane-axis padding quantum (kept from the JAX package)

# The int16-pair transfer packing reads int32 words as int16 pairs through
# numpy views, which is right only on a little-endian host; elsewhere
# nothing packs and the pipeline stays bit-exact.
_LITTLE_ENDIAN = sys.byteorder == "little"


def bucket_shape(n_lanes, block_size, lane_quantum=_L_QUANTUM):
    """The padded (L, T) shape for a group of subframes."""
    if block_size > _T_BUCKETS[-1]:
        fmt_err("invalid block size, exceeds 65535")
    for t in _T_BUCKETS:
        if block_size <= t:
            break
    l = ((n_lanes + lane_quantum - 1) // lane_quantum) * lane_quantum
    return max(l, lane_quantum), t


@dataclass
class DecodedStream:
    """Decoded PCM plus stream metadata."""
    streaminfo: object
    #: (total_samples, channels) int32, channels interleaved on axis 1.
    pcm: np.ndarray
    #: first inter-channel sample number of each frame
    frame_times: List[int]
    #: block size of each frame
    frame_sizes: List[int]


@dataclass
class _BucketDispatch:
    """One bucket's decoded PCM on the device (and its host copies), or,
    split over a mesh, its shards (``parallel``)."""
    n_ch: int
    out_full: torch.Tensor      # (L, T) int32 on the device; None when
    #                             the bucket is split into shards
    #: the bucket is fetched as int16 pairs (16-bit audio; the JAX
    #: package's rule, set by the planners).
    packed: bool = False
    words: torch.Tensor = None  # packed: (L, T // 2) int32 host copy
    flag: torch.Tensor = None   # packed: () int32 host overflow flag
    host: torch.Tensor = None   # (L, T) int32 host copy (not packed, or
    #                             refetched after the flag fired)
    #: the FrameDesc route: indices into ``DeviceDecoded.frames`` of the
    #: bucket's frames, in lane order (empty on the bits paths).
    frame_idx: list = field(default_factory=list)
    #: a bucket split over a mesh: one dispatch per contiguous lane range,
    #: in lane order, each holding its own (L / n, T) ``out_full`` on its
    #: device and its host copies; a packed shard's flag is per lane. None
    #: for a bucket of one tensor.
    shards: list = None

    def leaves(self):
        """The dispatches that hold tensors: the shards, or this one."""
        return self.shards or [self]


def _shard_dispatch(n_ch, outs, packed, sharded, frame_idx=None):
    """A bucket's dispatch from its outputs in lane order: one tensor, or
    with ``sharded`` (a mesh, even of one device) one shard a tensor."""
    frame_idx = [] if frame_idx is None else frame_idx
    if not sharded:
        (out,) = outs
        return _BucketDispatch(n_ch, out, packed, frame_idx=frame_idx)
    return _BucketDispatch(n_ch, None, packed, frame_idx=frame_idx,
                           shards=[_BucketDispatch(n_ch, o, packed)
                                   for o in outs])


class DeviceDecoded:
    """Decoded PCM resident on the device, bucket-major.

    ``device_buckets()`` hands a consumer the (L, T) int32 buckets where
    they lie, and ``lane_plans()`` says which stream, frame and channel
    each lane holds. ``to_host()`` builds the per-stream PCM: a bucket of
    16-bit audio crosses the host link as int16 pairs (half the bytes),
    and as int32 when its overflow flag fired, which only an invalid
    stream's garbage can cause. The JAX package packs inside each bucket's
    device program; the port packs in ``start_fetch()``, so a consumer that
    reads ``device_buckets()`` and never fetches pays neither the launch
    nor the (L, T // 2) buffer. On the bits paths frame CRC-16
    verification runs on the device, and its verdict surfaces only through
    ``verify_crc()``, which ``sync()`` and ``to_host()`` call: a consumer
    reading buckets directly calls ``sync()`` before trusting them
    (``block_until_ready()`` waits without the verdict). The FrameDesc
    route's extractors check every frame on the host.
    """

    def __init__(self, results, dispatches, plans, pcms):
        self.results = results
        self.dispatches = dispatches
        self._plans = plans
        self._pcms = pcms
        #: [((F,) int32 device CRCs, n valid), ...] (one pair per CRC
        #: dispatch), "failed" once a mismatch was seen (it latches), or
        #: None when nothing is left to check.
        self.crc_check = None
        #: host-to-device bytes this batch uploaded.
        self.upload_bytes = 0
        #: segmented-path markers (``pipeline_seg``): at least one stream
        #: rode the device demux; the device demux ran at all; the stream
        #: indices that took the host walk instead.
        self.segmented = False
        self.seg_engaged = False
        self.fallback_streams = []
        #: segmented path: host seconds per stage of the batch (the
        #: ``claxon.seg.*`` spans summed by stage); {} on every other route.
        self.stage_seconds = {}
        #: the batch's record of spans and counters (``trace.Trace``).
        self.trace = trace.Trace()
        #: the FrameDesc route: every FrameDesc of the batch, in stream
        #: order (``device_buckets()``' frame indices point here).
        self.frames = []
        self._crc_host = None
        #: after start_fetch(), a CUDA event after the host copies per
        #: CUDA device the copies came from.
        self._fetched = None

    def block_until_ready(self):
        """Wait for every bucket's kernels; unlike ``sync()``, give no CRC
        verdict."""
        for dev in {leaf.out_full.device for d in self.dispatches
                    for leaf in d.leaves() if leaf.out_full.is_cuda}:
            torch.cuda.synchronize(dev)
        return self

    def sync(self):
        """Wait for every bucket's kernels, then surface a frame CRC
        mismatch (see verify_crc)."""
        with self.trace.span("claxon.sync.wait"):
            self.block_until_ready()
        with self.trace.span("claxon.sync.crc"):
            self.verify_crc()
        return self

    def verify_crc(self):
        """Raise FormatError "frame CRC mismatch" if the device verifier
        flagged a frame. A mismatch latches: every later verify_crc(),
        sync() or to_host() on this batch raises again."""
        if self.crc_check is None:
            return
        if self.crc_check == "failed":
            fmt_err("frame CRC mismatch")
        if self._crc_host is not None:
            self._wait_fetched()
            hosts = self._crc_host
        else:
            hosts = [vals.cpu() for vals, _n in self.crc_check]
        for host, (_vals, n) in zip(hosts, self.crc_check):
            if bool(host[:n].any()):
                self.crc_check = "failed"
                fmt_err("frame CRC mismatch")
        self.crc_check = None

    def start_fetch(self):
        """Start the device-to-host copies of every bucket (into pinned
        memory, without waiting), so they overlap host work done before
        ``to_host()``: a packed bucket's int16 pairs and overflow flag (K3b
        pack runs here, on the current stream of the bucket's device;
        per lane for a shard, as the JAX package packs under a mesh),
        another bucket's int32 samples. Idempotent."""
        from .ops.epilogue import pack_int16_pairs
        from .parallel.mesh import device_guard

        if self._fetched is not None:
            return self
        cuda = set()
        rec = self.trace

        def fetch(t):
            if not t.is_cuda:
                return t
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            cuda.add(t.device)
            rec.count("fetch_bytes", host.numel() * host.element_size())
            return host

        with rec.span("claxon.fetch.start"):
            for d in self.dispatches:
                for leaf in d.leaves():
                    if not leaf.packed:
                        leaf.host = fetch(leaf.out_full)
                        continue
                    with device_guard(leaf.out_full.device):
                        words, flag = pack_int16_pairs(
                            leaf.out_full, per_lane=d.shards is not None)
                    leaf.words, leaf.flag = fetch(words), fetch(flag)
            if isinstance(self.crc_check, list):
                self._crc_host = [fetch(vals) for vals, _n in self.crc_check]
            self._fetched = []
            for dev in cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                self._fetched.append(event)
        return self

    def _wait_fetched(self):
        """Block until the copies start_fetch() queued have landed."""
        for event in self._fetched:
            event.synchronize()

    def device_buckets(self):
        """[(frame_idx, n_ch, bucket), ...]; the lane layout of each bucket
        is in ``lane_plans()``. ``bucket`` is the (L, T) int32 device
        tensor when the bucket has one shard (no mesh, or a mesh of one
        device), and for a bucket split over a mesh of n > 1 devices
        (``parallel``) the tuple of its (L / n, T) shards in lane order,
        each on its own device (nothing gathers them). ``frame_idx``
        indexes ``self.frames`` on the FrameDesc route and is [] on the
        bits paths, which carry no FrameDesc objects."""
        def bucket(d):
            leaves = d.leaves()
            if len(leaves) == 1:
                return leaves[0].out_full
            return tuple(s.out_full for s in leaves)

        return [(list(d.frame_idx), d.n_ch, bucket(d))
                for d in self.dispatches]

    def lane_plans(self):
        """Per bucket (parallel to ``device_buckets()``), a list of runs
        ``(stream_index, out_sample_offset, n_frames, block_size,
        n_channels, first_lane)``; a run occupies lanes ``[first_lane,
        first_lane + n_frames * n_channels)``, frame-major, channel-minor."""
        return [list(p) for p in self._plans]

    def to_host(self):
        """Per-stream DecodedStreams with their PCM filled in."""
        rec = self.trace
        self.start_fetch()
        with rec.span("claxon.fetch.wait"):
            self._wait_fetched()
        with rec.span("claxon.fetch.scatter"):
            for d, plan in zip(self.dispatches, self._plans):
                outs = []
                for leaf in d.leaves():
                    if leaf.packed and not bool(leaf.flag.any()):
                        # (L, T // 2) int32 -> (L, T) int16, a
                        # little-endian view.
                        outs.append(leaf.words.numpy().view(np.int16))
                        continue
                    if leaf.host is None:
                        # Rare: an invalid stream's garbage.
                        leaf.host = leaf.out_full.cpu()
                    outs.append(leaf.host.numpy())
                # A bucket's shards in lane order make its lanes again.
                out = outs[0] if len(outs) == 1 else np.concatenate(outs)
                for si_idx, out0, nf, bs, n_ch, lane0 in plan:
                    pcm = self._pcms[si_idx]
                    # One strided copy per (run, channel): frames of a run
                    # are stream-consecutive, so their output rows are
                    # too.
                    for ci in range(n_ch):
                        pcm[out0:out0 + nf * bs, ci] = \
                            out[lane0 + ci:lane0 + nf * n_ch:n_ch,
                                :bs].reshape(-1)
        with rec.span("claxon.fetch.crc"):
            self.verify_crc()
        return self.results


def _native():
    from . import native

    if not native.available():
        raise RuntimeError(
            "claxon_tpu_torch needs its C++ host core "
            "(claxon_tpu_torch.native); build it with python -m "
            "claxon_tpu_torch.native.build")
    return native


def group_frames(frames, lane_quantum=_L_QUANTUM):
    """Group frame indices by (block_size bucket, channels)."""
    groups = {}
    for i, f in enumerate(frames):
        key = (bucket_shape(0, f.block_size, lane_quantum)[1], f.channels)
        groups.setdefault(key, []).append(i)
    return groups


def pack_bucket(frames, frame_idx, n_ch, t_bucket, lane_quantum=_L_QUANTUM):
    """Pack one group of frames into the padded device-bucket arrays.

    Returns (x, coefs, shifts, orders, wasted, pair_modes, lengths), numpy
    int32, all padded to the (L, T) = ``bucket_shape`` shape, lanes
    pair-aligned; ``lengths`` holds each lane's valid sample count. The
    same bytes as ``claxon_tpu.pipeline.pack_bucket``.
    """
    from .extract import MODE_CODES
    from .ops.predict import pack_coefficients

    n_lanes = len(frame_idx) * n_ch
    L, T = bucket_shape(n_lanes, t_bucket, lane_quantum)

    x = np.zeros((L, T), dtype=np.int32)
    coef_lists = []
    shifts = np.zeros(L, dtype=np.int32)
    orders = np.zeros(L, dtype=np.int32)
    wasted = np.zeros(L, dtype=np.int32)
    pair_modes = np.zeros(L // 2, dtype=np.int32)
    lengths = np.zeros(L, dtype=np.int32)

    lane = 0
    for fi in frame_idx:
        f = frames[fi]
        for sf in f.subframes:
            x[lane, :f.block_size] = sf.x
            coef_lists.append(sf.coefs)
            shifts[lane] = sf.shift
            orders[lane] = sf.order
            wasted[lane] = sf.wasted
            lengths[lane] = f.block_size
            lane += 1
        if f.mode != MODE_CODES["independent"] and n_ch == 2:
            # Stereo lanes are pair-aligned: this frame occupies lanes
            # (lane-2, lane-1) == pair (lane-2)//2.
            pair_modes[(lane - 2) // 2] = f.mode
    coef_lists.extend([[]] * (L - lane))
    coefs = pack_coefficients(coef_lists)
    return x, coefs, shifts, orders, wasted, pair_modes, lengths


def scatter_bucket(out, frames, frame_idx, n_ch, targets):
    """Scatter one bucket's output (an (L, T) host array) back into
    interleaved PCM. ``targets[fi]`` is the (pcm array, sample offset)
    destination of frame ``fi`` -- frames in one bucket may belong to
    different output streams."""
    lane = 0
    for fi in frame_idx:
        f = frames[fi]
        pcm, o = targets[fi]
        for ci in range(n_ch):
            pcm[o:o + f.block_size, ci] = out[lane, :f.block_size]
            lane += 1


def _pack_input(arrays):
    """The FrameDesc route's input rule for :func:`pack_bucket`'s seven
    arrays: when every value of ``x`` (residuals and warm-up) fits int16
    and T is even, ``x`` goes up as int16 pairs, half the bytes, and K3b
    unpacks it on the card. Returns (the arrays to upload, packed)."""
    from .pipeline_bits import _pack_input_i16

    x = arrays[0]
    if (_LITTLE_ENDIAN and x.shape[1] % 2 == 0 and
            x.min() >= -32768 and x.max() <= 32767):
        return (_pack_input_i16(x),) + tuple(arrays[1:]), True
    return tuple(arrays), False


def device_decode_bucket(x, coefs, shifts, orders, wasted, pair_modes,
                         lengths=None, device="cuda"):
    """Run K1 + K3 on one bucket of :func:`pack_bucket`'s numpy arrays,
    uploaded to ``device``; returns the (L, T) int32 PCM tensor there.
    Lanes pair-aligned; ``lengths`` defaults to T for every lane."""
    from .parallel.mesh import Mesh
    from .pipeline_bits import _decode_sample_shards

    if lengths is None:
        lengths = np.full(x.shape[0], x.shape[1], dtype=np.int32)
    (out,) = _decode_sample_shards(
        (x, coefs, shifts, orders, wasted, pair_modes, lengths), False,
        Mesh((torch.device(device),)))
    return out


def decode_frames_to(frames, targets, decode_bucket=None,
                     lane_quantum=_L_QUANTUM, device="cuda"):
    """Decode a list of FrameDescs bucket by bucket, scattering each frame
    into its ``targets`` destination. ``decode_bucket`` receives each
    bucket's seven numpy arrays (:func:`pack_bucket`) and returns its
    (L, T) PCM, a numpy array or a tensor, or a tuple of such shards in
    lane order (``parallel.make_decode_step``); None is
    :func:`device_decode_bucket` on ``device``."""
    if decode_bucket is None:
        def decode_bucket(*packed):
            return device_decode_bucket(*packed, device=device)
    for (t_bucket, n_ch), frame_idx in group_frames(
            frames, lane_quantum).items():
        packed = pack_bucket(frames, frame_idx, n_ch, t_bucket, lane_quantum)
        out = decode_bucket(*packed)
        # A tensor, on the card or the CPU, comes back through .cpu(); a
        # sharded step (``parallel.make_decode_step``) returns its shards
        # in lane order.
        outs = [o.cpu().numpy() if isinstance(o, torch.Tensor)
                else np.asarray(o)
                for o in (out if isinstance(out, tuple) else (out,))]
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        scatter_bucket(out, frames, frame_idx, n_ch, targets)


def _dispatch_bucket(frames, frame_idx, n_ch, t_bucket, lane_quantum,
                     device, mesh=None):
    """Pack one bucket, upload it and queue its kernels on ``device`` (on
    each shard's device over ``mesh``): K3b unpack when the residuals went
    up as int16 pairs (:func:`_pack_input`), then K1 + K3. Returns (the
    bucket's dispatch, bytes uploaded). K3b pack runs later, in
    ``DeviceDecoded.start_fetch``, when ``packed`` is set."""
    from .parallel.mesh import Mesh
    from .pipeline_bits import _decode_sample_shards

    arrays = pack_bucket(frames, frame_idx, n_ch, t_bucket, lane_quantum)
    T = arrays[0].shape[1]
    arrays, in_packed = _pack_input(arrays)
    # Output packing: final PCM fits bps bits for valid streams; the
    # overflow flag guards invalid ones.
    out_packed = (_LITTLE_ENDIAN and T % 2 == 0 and
                  all(frames[fi].bps <= 16 for fi in frame_idx))
    outs = _decode_sample_shards(
        arrays, in_packed, mesh or Mesh((torch.device(device),)))
    return (_shard_dispatch(n_ch, outs, out_packed, mesh is not None,
                            frame_idx),
            sum(a.nbytes for a in arrays))


def frame_offsets(frames):
    """Output-sample start offset of each frame (len(frames)+1 entries)."""
    offsets = np.zeros(len(frames) + 1, dtype=np.int64)
    for i, f in enumerate(frames):
        offsets[i + 1] = offsets[i] + f.block_size
    return offsets


def _prepare_outputs(batches):
    """Allocate per-stream PCM and the flat frame/target lists."""
    frames, targets, results = [], [], []
    for batch in batches:
        si = batch.streaminfo
        # The aggregated (total, channels) output requires a consistent
        # channel count; the streaming blocks() API handles per-frame
        # variation, but here it is a format error (crash-free reject).
        for f in batch.frames:
            if f.channels != si.channels:
                fmt_err("frame channel count does not match streaminfo")
        total = sum(f.block_size for f in batch.frames)
        pcm = np.zeros((total, si.channels), dtype=np.int32)
        offsets = frame_offsets(batch.frames)
        for i, f in enumerate(batch.frames):
            frames.append(f)
            targets.append((pcm, int(offsets[i])))
        results.append(DecodedStream(
            streaminfo=si, pcm=pcm,
            frame_times=[f.time for f in batch.frames],
            frame_sizes=[f.block_size for f in batch.frames]))
    return frames, targets, results


def decode_batches_device(batches, lane_quantum=_L_QUANTUM,
                          device="cuda", mesh=None) -> DeviceDecoded:
    """Decode many StreamBatches (``extract.extract_stream`` or
    ``native.extract_stream``) into buckets on ``device``, the FrameDesc
    route; with a ``mesh`` (``parallel``; ``lane_quantum`` then
    ``parallel.lane_quantum(mesh)``) every bucket splits into its lane
    shards, shard i on ``mesh.devices[i]``. Every bucket is queued before
    any result is awaited. Each bucket's lane plan holds one run per
    frame. ``crc_check`` stays None: both extractors checked every
    frame's CRC-16 on the host."""
    frames, targets, results = _prepare_outputs(batches)
    stream_of_pcm = {id(r.pcm): i for i, r in enumerate(results)}
    dispatches, plans, upload = [], [], 0
    for (t_bucket, n_ch), frame_idx in group_frames(
            frames, lane_quantum).items():
        d, nbytes = _dispatch_bucket(frames, frame_idx, n_ch, t_bucket,
                                     lane_quantum, device, mesh)
        dispatches.append(d)
        upload += nbytes
        plan, lane = [], 0
        for fi in frame_idx:
            pcm, off = targets[fi]
            plan.append((stream_of_pcm[id(pcm)], off, 1,
                         frames[fi].block_size, n_ch, lane))
            lane += n_ch
        plans.append(plan)
    dd = DeviceDecoded(results, dispatches, plans,
                       [r.pcm for r in results])
    dd.frames = frames
    dd.upload_bytes = upload
    return dd


def _t_bucket_of(bs):
    """The time bucket of block size ``bs``: the smallest of
    ``_T_BUCKETS`` that holds it."""
    from bisect import bisect_left

    return _T_BUCKETS[bisect_left(_T_BUCKETS, bs)]


def _fill_bucket(runs, samples_of, shape, native):
    """The bucket's ``x`` in its upload form, from its lane ``runs`` ((si,
    p0, nl, bs, lane0): ``nl`` rows of ``bs`` samples at ``p0`` of stream
    ``si``'s flat ``samples_of[si]``): int16 pairs, (L, T // 2) int32 words,
    when every sample fits int16 and T is even (one C min/max pass a run
    decides, the C++ core's fused convert fills), else (L, T) int32.
    Returns (x, packed)."""
    L, T = shape
    mn = mx = 0
    for si, p0, nl, bs, _lane0 in runs:
        lo, hi = native.minmax(samples_of[si][p0:p0 + nl * bs])
        mn, mx = min(mn, lo), max(mx, hi)
    if _LITTLE_ENDIAN and T % 2 == 0 and mn >= -32768 and mx <= 32767:
        x16 = np.zeros((L, T), dtype=np.int16)
        for si, p0, nl, bs, lane0 in runs:
            native.rows_to_i16(samples_of[si][p0:p0 + nl * bs], nl, bs,
                               x16, lane0)
        return x16.view(np.int32), True
    x = np.zeros((L, T), dtype=np.int32)
    for si, p0, nl, bs, lane0 in runs:
        x[lane0:lane0 + nl, :bs] = \
            samples_of[si][p0:p0 + nl * bs].reshape(nl, bs)
    return x, False


def decode_raw_batches_device(raws, lane_quantum=_L_QUANTUM, device="cuda",
                              mesh=None) -> DeviceDecoded:
    """Decode [(streaminfo, frames_buf, subs_buf, samples), ...]
    (``native.extract_stream_raw``: the residuals already decoded on the
    host, frame CRC-16 checked there) into buckets on ``device``, the
    sample-shipping route of ``CLAXON_TPU_NO_BITS``. The same PCM as the
    FrameDesc route on the same streams, planned from the flat arrays with
    no Python object per frame: frames group by (time bucket, channels) in
    first-seen order, and consecutive frames of one stream with one block
    size make one lane run, copied in bulk. Per bucket the samples go up
    as int16 pairs when they fit (K3b unpack on the card), then K1 + K3;
    a bucket of frames of 16 bits or fewer is fetched as int16 pairs (K3b
    pack in ``start_fetch()``). With a ``mesh`` (``lane_quantum`` then
    ``parallel.lane_quantum(mesh)``) every bucket splits into its lane
    shards. Every bucket is queued before any result is awaited."""
    from .ops.predict import ORDER_MAX
    from .parallel.mesh import Mesh
    from .pipeline_bits import _decode_sample_shards

    native = _native()
    results, pcms, groups = [], [], {}
    for si_idx, (si, frames_buf, _subs, _samples) in enumerate(raws):
        if np.any(frames_buf["channels"] != si.channels):
            fmt_err("frame channel count does not match streaminfo")
        bs_v = frames_buf["block_size"].astype(np.int64)
        nch_v = frames_buf["channels"].astype(np.int64)
        sub0_v = np.concatenate([[0], np.cumsum(nch_v)[:-1]])
        samp0_v = np.concatenate([[0], np.cumsum(bs_v * nch_v)[:-1]])
        out0_v = np.concatenate([[0], np.cumsum(bs_v)[:-1]])
        pcm = np.zeros((int(bs_v.sum()), si.channels), dtype=np.int32)
        results.append(DecodedStream(
            streaminfo=si, pcm=pcm,
            frame_times=frames_buf["time"].tolist(),
            frame_sizes=frames_buf["block_size"].tolist()))
        pcms.append(pcm)
        # Per frame: (stream, bs, nch, mode, sub0, samp0, out0, bps).
        for i in range(len(frames_buf)):
            rec = (si_idx, int(bs_v[i]), int(nch_v[i]),
                   int(frames_buf["mode"][i]), int(sub0_v[i]),
                   int(samp0_v[i]), int(out0_v[i]),
                   int(frames_buf["bps"][i]))
            groups.setdefault((_t_bucket_of(bs_v[i]), rec[2]),
                              []).append(rec)

    samples_of = [r[3] for r in raws]
    dispatches, plans, upload = [], [], 0
    for (t_bucket, n_ch), rlist in groups.items():
        L, T = bucket_shape(len(rlist) * n_ch, t_bucket, lane_quantum)
        coefs = np.zeros((L, ORDER_MAX), dtype=np.int32)
        shifts, orders, wasted, lengths = (np.zeros(L, dtype=np.int32)
                                           for _ in range(4))
        pair_modes = np.zeros(L // 2, dtype=np.int32)
        # Runs: consecutive frames of one stream with one block size whose
        # subframes are consecutive hold contiguous spans of the flat
        # arrays.
        plan, runs, lane, i = [], [], 0, 0
        while i < len(rlist):
            si_idx, bs = rlist[i][0], rlist[i][1]
            j = i
            while (j + 1 < len(rlist) and rlist[j + 1][0] == si_idx
                   and rlist[j + 1][1] == bs
                   and rlist[j + 1][4] == rlist[j][4] + n_ch):
                j += 1
            run = rlist[i:j + 1]
            nl = len(run) * n_ch
            subs = raws[si_idx][2]
            s0 = run[0][4]
            runs.append((si_idx, run[0][5], nl, bs, lane))
            plan.append((si_idx, run[0][6], len(run), bs, n_ch, lane))
            coefs[lane:lane + nl] = subs["coefs"][s0:s0 + nl]
            shifts[lane:lane + nl] = subs["shift"][s0:s0 + nl]
            orders[lane:lane + nl] = subs["order"][s0:s0 + nl]
            wasted[lane:lane + nl] = subs["wasted"][s0:s0 + nl]
            lengths[lane:lane + nl] = bs
            if n_ch == 2:
                pair_modes[lane // 2:lane // 2 + len(run)] = \
                    [r[3] for r in run]
            lane += nl
            i = j + 1
        x, in_packed = _fill_bucket(runs, samples_of, (L, T), native)
        out_packed = (_LITTLE_ENDIAN and T % 2 == 0 and
                      all(r[7] <= 16 for r in rlist))
        arrays = (x, coefs, shifts, orders, wasted, pair_modes, lengths)
        outs = _decode_sample_shards(arrays, in_packed,
                                     mesh or Mesh((torch.device(device),)))
        dispatches.append(_shard_dispatch(n_ch, outs, out_packed,
                                          mesh is not None))
        upload += sum(a.nbytes for a in arrays)
        plans.append(plan)
    dd = DeviceDecoded(results, dispatches, plans, pcms)
    dd.upload_bytes = upload
    return dd


def _no_bits():
    """The JAX package's ``CLAXON_TPU_NO_BITS`` (any nonempty value), read
    on each call: the sample-shipping route."""
    import os

    return bool(os.environ.get("CLAXON_TPU_NO_BITS"))


def decode_batches(batches, decode_bucket=None, lane_quantum=_L_QUANTUM,
                   device="cuda") -> List[DecodedStream]:
    """Decode many StreamBatches at once; frames from *all* streams share
    buckets. ``decode_bucket`` replaces the per-bucket device call (see
    :func:`decode_frames_to`)."""
    if decode_bucket is None:
        return decode_batches_device(batches, lane_quantum,
                                     device).start_fetch().to_host()
    frames, targets, results = _prepare_outputs(batches)
    decode_frames_to(frames, targets, decode_bucket, lane_quantum, device)
    return results


def decode_batch(batch, decode_bucket=None, lane_quantum=_L_QUANTUM,
                 device="cuda") -> DecodedStream:
    """Decode one extracted StreamBatch (see :func:`decode_batches`)."""
    return decode_batches([batch], decode_bucket, lane_quantum, device)[0]


def _extract(data, use_native):
    """One stream's StreamBatch: the C++ core's FrameDesc extraction, or
    with ``use_native=False`` the Python extractor."""
    if use_native:
        return _native().extract_stream(data)
    from .extract import extract_stream

    return extract_stream(data)


def merge_decoded(n_streams, parts):
    """One DeviceDecoded over ``n_streams`` streams from ``parts``, a list
    of ``(stream_indices, DeviceDecoded)``: part stream j is batch stream
    ``stream_indices[j]``. Dispatches and lane plans are concatenated with
    their stream indices remapped, and every part's CRC dispatches are
    kept. Part streams without a result (None) are skipped; several that
    land on one batch stream (the chunks of a large stream, in stream
    order) concatenate into one result, their lane plans shifted by the
    samples before them. The parts' records merge
    (:func:`trace.merged`)."""
    pieces = [[] for _ in range(n_streams)]
    for p, (idx, dd) in enumerate(parts):
        for j, i in enumerate(idx):
            if dd.results[j] is not None:
                pieces[i].append((p, j))
    results, pcms = [None] * n_streams, [None] * n_streams
    shift = {}  # (part, part stream) -> first output sample in its stream
    for i, got in enumerate(pieces):
        rs = [parts[p][1].results[j] for p, j in got]
        if len(rs) == 1:
            (p, j), = got
            results[i], pcms[i] = rs[0], parts[p][1]._pcms[j]
            continue
        off = 0
        for key, r in zip(got, rs):
            shift[key] = off
            off += len(r.pcm)
        if rs:
            pcms[i] = np.zeros((off, rs[0].pcm.shape[1]), dtype=np.int32)
            results[i] = DecodedStream(
                streaminfo=rs[0].streaminfo, pcm=pcms[i],
                frame_times=[t for r in rs for t in r.frame_times],
                frame_sizes=[b for r in rs for b in r.frame_sizes])
    dispatches, plans, crc = [], [], []
    upload = 0
    for p, (idx, dd) in enumerate(parts):
        dispatches.extend(dd.dispatches)
        plans.extend([(idx[r[0]], r[1] + shift.get((p, r[0]), 0))
                      + tuple(r[2:]) for r in plan] for plan in dd._plans)
        if dd.crc_check is not None:
            crc.extend(dd.crc_check)
        upload += dd.upload_bytes
    out = DeviceDecoded(results, dispatches, plans, pcms)
    out.crc_check = crc or None
    out.upload_bytes = upload
    out.trace = trace.merged([dd.trace for _idx, dd in parts])
    return out


def _split_batch(sizes, limit):
    """Runs of consecutive indices whose ``sizes`` total stays below
    ``limit``; an item of ``limit`` or more is a run of its own."""
    runs, run, size = [], [], 0
    for i, n in enumerate(sizes):
        if run and size + n >= limit:
            runs.append(run)
            run, size = [], 0
        run.append(i)
        size += n
    if run:
        runs.append(run)
    return runs


def _walk_options(mode=None):
    """(mode, emit_slots, defer_crc) of a host walk, as the JAX package
    reads them on each call (``claxon_tpu.pipeline.extract_streams_bits``):
    ``mode`` (None: ``CLAXON_TPU_ENTROPY``) is "stream" or "delta", any
    other value "stream"; delta mode has the walk emit the relocated slots
    and deltas K9 reads; the frame CRC-16 checks are deferred to the
    device (K4) only in stream mode without ``CLAXON_TPU_HOST_CRC`` (any
    nonempty value), else the walk checks each frame as it goes and
    raises at the first mismatch."""
    import os

    if mode is None:
        mode = os.environ.get("CLAXON_TPU_ENTROPY", "stream")
    if mode not in ("stream", "delta"):
        mode = "stream"
    defer = mode == "stream" and not os.environ.get("CLAXON_TPU_HOST_CRC")
    return mode, mode == "delta", defer


def extract_streams_bits(datas, native, mode=None):
    """Walk every stream of a batch with the C++ core: frame boundaries,
    descriptors and chunk bases, and in delta ``mode`` the relocated slots
    and deltas (see :func:`_walk_options`; None reads the environment).
    Returns [(streaminfo, BitsBatch), ...] for one plan, so the batch
    stays below ``MAX_BATCH_BYTES`` (``decode_streams_device`` splits
    larger batches and walks large streams in chunks)."""
    from .pipeline_bits import MAX_BATCH_BYTES

    total = sum(len(d) for d in datas)
    if total >= MAX_BATCH_BYTES:
        raise ValueError(
            f"claxon_tpu_torch: a batch of {total} bytes reaches the "
            f"{MAX_BATCH_BYTES}-byte limit of int32 chunk bit positions; "
            "plan it in smaller batches")
    _mode, emit, defer = _walk_options(mode)
    return [native.extract_stream_bits(d, emit_slots=emit, defer_crc=defer)
            for d in datas]


def _frame_bound(si):
    """Bytes one frame of the stream can take: STREAMINFO's maximum frame
    size, or where that is unknown a verbatim frame (side channels carry
    one bit more) with its header and footer."""
    if si.max_frame_size:
        return si.max_frame_size
    return (si.max_block_size * si.channels * (si.bits_per_sample + 1)
            + 7) // 8 + 64 + 2 * si.channels


def _walk_frames_chunked(si, payload, native, limit, max_frames=None,
                         emit_slots=False, defer_crc=True):
    """Walk a frame section (``payload``, a memoryview at its first frame)
    in chunks of whole frames, each below ``limit`` bytes, with the walk
    options of :func:`_walk_options`: the frame count
    per chunk comes from STREAMINFO (:func:`_frame_bound`) and halves for
    a chunk that overruns. The walk ends at the end of ``payload``, or
    after ``max_frames`` frames (a container chunk declares its count).
    Each chunk's bases and frame spans are relative to its own payload,
    so they stay inside int32. Returns [BitsBatch, ...]. Before a walk
    error surfaces, the deferred CRCs of the chunks before it are verified
    on the host, so an earlier CRC mismatch wins, as in sequential
    decode."""
    from .error import Error
    from .pipeline_bits import _host_verify_deferred

    budget = limit - 5  # a chunk's padded words stay below the limit
    per_chunk = max(1, budget // _frame_bound(si))
    chunks, off, left = [], 0, max_frames
    try:
        while off < len(payload) and left != 0:
            used = []
            n = per_chunk if left is None else min(per_chunk, left)
            bb = native.extract_frames_bits(
                payload[off:], emit_slots=emit_slots, max_frames=n,
                consumed=used, defer_crc=defer_crc)
            if used[0] > budget and n > 1:
                per_chunk //= 2
                continue
            if not len(bb.bframes):
                break  # a clean end of stream (0 or 1 trailing bytes)
            bb.payload = payload[off:off + used[0]]
            chunks.append(bb)
            off += used[0]
            if left is not None:
                left -= len(bb.bframes)
    except Error:
        for bb in chunks:
            _host_verify_deferred(bb, len(bb.bframes))
        raise
    return chunks


def _verify_before_bad_channels(si, units):
    """``units`` are one stream's walk units in order, planned apart. The
    planner raises the channel-count error of a frame that disagrees with
    STREAMINFO after the deferred CRCs of the frames before it in that
    unit; this verifies the units before, so an earlier CRC mismatch
    wins."""
    from .pipeline_bits import _host_verify_deferred

    bad = [k for k, bb in enumerate(units)
           if (bb.bframes["channels"] != si.channels).any()]
    for bb in units[:bad[0] if bad else 0]:
        _host_verify_deferred(bb, len(bb.bframes))


def _walk_chunks(data, native, limit, emit_slots=False, defer_crc=True):
    """Walk one stream of ``limit`` bytes or more in chunks of whole
    frames (:func:`_walk_frames_chunked`). Returns (streaminfo,
    [BitsBatch, ...])."""
    from .native.binding import _read_metadata

    si, pos = _read_metadata(data)
    chunks = _walk_frames_chunked(si, memoryview(data)[pos:], native, limit,
                                  emit_slots=emit_slots, defer_crc=defer_crc)
    _verify_before_bad_channels(si, chunks)
    return si, chunks


def _unit_bytes(bb):
    """Upload bytes of a walk unit: its payload padded to whole words."""
    return len(bb.payload) + 4


def _decode_walked(braws, owners, sizes, n_streams, lane_quantum, device,
                   mode="stream", mesh=None, rec=None):
    """Decode walk units ``braws`` ([(streaminfo, BitsBatch), ...], unit u
    a whole stream or a chunk of stream ``owners[u]``, in stream order,
    of at most ``sizes[u]`` upload bytes) in entropy ``mode`` (the one
    they were walked for), with each bucket split over ``mesh`` when one
    is given. Chunk bases are int32 bit
    positions into one plan's upload, so the units are planned as runs
    below ``MAX_BATCH_BYTES`` and the runs' results merge, a stream's
    chunks concatenating back into its one result. The planning and
    dispatch spans go to ``rec`` (None: a new record for each run)."""
    from . import pipeline_bits

    parts = [([owners[u] for u in run], pipeline_bits.decode_raw_bits_device(
        [braws[u] for u in run], lane_quantum, device=device, mode=mode,
        mesh=mesh, rec=rec))
        for run in _split_batch(sizes, pipeline_bits.MAX_BATCH_BYTES)]
    if len(parts) == 1 and len(braws) == n_streams:
        return parts[0][1]
    return merge_decoded(n_streams, parts)


def _decode_host_walk(datas, lane_quantum, device, mesh=None, rec=None):
    """The host-walk bits path: every stream is walked first (a stream of
    ``MAX_BATCH_BYTES`` or more in chunks of frames, :func:`_walk_chunks`),
    then the walked units are decoded (:func:`_decode_walked`; over
    ``mesh``, each bucket split into its lane shards, when one is given),
    in the entropy mode and with the CRC placement the environment names
    (:func:`_walk_options`). The JAX package switches a batch of
    ``MAX_BATCH_BYTES`` or more to delta mode; the port splits it and
    keeps the mode (the same PCM). The walk's spans
    (``claxon.walk.*``) go to ``rec``, the batch's record (None: a new
    one)."""
    from . import pipeline_bits

    if rec is None:
        rec = trace.batch()
    limit = pipeline_bits.MAX_BATCH_BYTES
    native = _native()
    mode, emit, defer = _walk_options()
    braws, owners, sizes = [], [], []
    with rec.span("claxon.walk.extract"):
        for i, d in enumerate(datas):
            if len(d) < limit:
                braws.append(native.extract_stream_bits(d, emit_slots=emit,
                                                        defer_crc=defer))
                owners.append(i)
                sizes.append(len(d))
                continue
            si, chunks = _walk_chunks(d, native, limit, emit, defer)
            braws.extend((si, bb) for bb in chunks)
            owners.extend([i] * len(chunks))
            sizes.extend(_unit_bytes(bb) for bb in chunks)
    return _decode_walked(braws, owners, sizes, len(datas), lane_quantum,
                          device, mode, mesh, rec)


#: per-process choices of segmentation="auto", one per device type
#: ("cpu", "cuda"): the JAX package has one backend per process, but each
#: call here names its device, and a CPU calibration (the plain forms)
#: says nothing of the card. In each entry "choice" is None until a batch
#: on that device type has calibrated it, then "host" or "device";
#: "seconds" holds the last calibration's min time of each path.
_SEG_AUTO = {}


def _seg_auto(device):
    """The ``_SEG_AUTO`` entry of ``device``'s type."""
    return _SEG_AUTO.setdefault(torch.device(device).type,
                                {"choice": None, "seconds": None})


def _resolve_segmentation(segmentation, device):
    """``segmentation`` with None read from ``CLAXON_TPU_SEGMENTATION``
    (default ``"auto"``) and ``"auto"`` replaced by the choice cached for
    ``device``'s type; ``"auto"`` stays only while nothing is cached. The
    JAX package also falls back to ``"host"`` here when its C++ core is
    missing; the port's core builds at first use, and a call that needs it
    raises without it. Under ``CLAXON_TPU_NO_BITS`` the callers take the
    sample-shipping route before they read the result."""
    import os

    if segmentation is None:
        segmentation = os.environ.get("CLAXON_TPU_SEGMENTATION", "auto")
    if segmentation == "auto" and _seg_auto(device)["choice"] is not None:
        segmentation = _seg_auto(device)["choice"]
    return segmentation


def _calibrate_segmentation(datas, lane_quantum, device, mesh=None,
                            rec=None):
    """Time synced decodes of ``datas`` through each path (over ``mesh``
    when one is given) and cache the faster one for the process and
    ``device``'s type; return the winner's own result, so the
    batch is not decoded again. A batch that does not ride the device
    demux returns its result at once: "host" is cached only when the demux
    ran and every stream still fell back, not when the batch was rejected
    on its shape alone (a later batch may engage). Both paths are warmed
    first (on the card this absorbs the first kernel build), then timed
    device, host, device, host with the host clock around ``sync()``,
    min of 2 per path. Both paths raise the same errors, so a bad batch
    raises here as it would at its first sync. Every decode's spans go
    to ``rec``, the batch's record (None: a new one)."""
    import time

    if rec is None:
        rec = trace.batch()

    def run(segmentation):
        return _decode_streams_device(datas, True, lane_quantum,
                                      segmentation, device, mesh, rec)

    d_seg = run("device")
    if not d_seg.segmented:
        if d_seg.seg_engaged:
            _seg_auto(device)["choice"] = "host"
        return d_seg
    d_seg.sync()
    run("host").sync()
    t_dev = t_host = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        d_seg = run("device").sync()
        t_dev = min(t_dev, time.perf_counter() - t0)
        t0 = time.perf_counter()
        d_host = run("host").sync()
        t_host = min(t_host, time.perf_counter() - t0)
    choice = "device" if t_dev < t_host else "host"
    _seg_auto(device).update(choice=choice, seconds={"device": t_dev,
                                                     "host": t_host})
    return d_seg if choice == "device" else d_host


def decode_streams_device(datas, use_native=True, lane_quantum=_L_QUANTUM,
                          segmentation=None, device="cuda",
                          mesh=None) -> DeviceDecoded:
    """Decode many FLAC streams (bytes) into PCM buckets on ``device``.

    The arguments keep the reference's order. ``use_native=False``
    extracts every stream with the Python extractor and takes the
    FrameDesc route (:func:`decode_batches_device`) whatever
    ``segmentation`` says; ``"auto"`` calibrates nothing then. Otherwise
    ``CLAXON_TPU_NO_BITS`` (any nonempty value) extracts every stream with
    ``native.extract_stream_raw`` first, in input order, and takes the
    sample-shipping route (:func:`decode_raw_batches_device`), whatever
    ``segmentation`` says; ``"auto"`` calibrates and caches nothing then.

    ``segmentation="device"`` takes the segmented path (``pipeline_seg``:
    frame search and subframe walk on the card, odd streams on the host
    walk); ``"auto"`` measures both paths on the first batch that engages
    the device demux and keeps the faster one for the process and the
    device's type; None reads
    ``CLAXON_TPU_SEGMENTATION`` and defaults to ``"auto"``. Every other
    value takes the host-walk bits path. All paths are bit-exact.

    A ``mesh`` (``parallel``; ``device`` then ``mesh.devices[0]`` and
    ``lane_quantum`` ``parallel.lane_quantum(mesh)``) splits every bucket
    into its lane shards on the mesh's devices, on every route.

    The batch's record (``dd.trace``, :func:`trace.batch`) holds the root
    span ``claxon.decode`` and the spans of its route's stages."""
    return _decode_streams_device(datas, use_native, lane_quantum,
                                  segmentation, device, mesh, trace.batch())


def _decode_streams_device(datas, use_native, lane_quantum, segmentation,
                           device, mesh, rec):
    """:func:`decode_streams_device` with its spans in ``rec``."""
    with rec.span("claxon.decode"):
        if not use_native:
            dd = decode_batches_device([_extract(d, False) for d in datas],
                                       lane_quantum, device, mesh)
        elif _no_bits():
            native = _native()
            dd = decode_raw_batches_device(
                [native.extract_stream_raw(d) for d in datas], lane_quantum,
                device, mesh)
        else:
            segmentation = _resolve_segmentation(segmentation, device)
            if segmentation == "auto":
                with rec.span("claxon.calibrate"):
                    dd = _calibrate_segmentation(datas, lane_quantum, device,
                                                 mesh, rec)
            elif segmentation == "device":
                from .pipeline_seg import decode_streams_segmented

                dd = decode_streams_segmented(datas, lane_quantum,
                                              device=device, mesh=mesh,
                                              rec=rec)
            else:
                dd = _decode_host_walk(datas, lane_quantum, device, mesh,
                                       rec=rec)
    dd.trace = rec
    return dd


class PendingDeviceBatch:
    """Handle for an in-flight ``decode_streams_device_async`` batch."""

    def __init__(self, finish):
        self._finish = finish
        self._done = None

    def finish(self) -> DeviceDecoded:
        """The batch's DeviceDecoded (computed once; idempotent)."""
        if self._done is None:
            self._done = self._finish()
            self._finish = None
        return self._done


def decode_streams_device_async(datas, use_native=True,
                                lane_quantum=_L_QUANTUM, segmentation=None,
                                device="cuda") -> PendingDeviceBatch:
    """Two-stage form of ``decode_streams_device``: returns once the
    batch's first stage is queued; ``finish()`` returns the DeviceDecoded.

    Only the segmented path has a first stage (uploads, frame search and
    subframe walk, the summary copy started), so a caller that begins
    batch n+1 before finishing batch n hides the summary wait behind the
    next batch's host work. The host-walk path, the FrameDesc route
    (``use_native=False``) and the sample-shipping route
    (``CLAXON_TPU_NO_BITS``) decode eagerly, and so does the first
    ``"auto"`` batch, which calibrates."""
    segmentation = _resolve_segmentation(segmentation, device)
    if use_native and segmentation == "device" and not _no_bits():
        from .pipeline_seg import (_host_fallback, begin_segmented,
                                   finish_segmented)

        pending = begin_segmented(datas, lane_quantum, device=device)
        if pending is not None:
            return PendingDeviceBatch(lambda: finish_segmented(pending))
        dd = _host_fallback(datas, lane_quantum, device)
    else:
        dd = decode_streams_device(datas, use_native, lane_quantum,
                                   segmentation, device)
    return PendingDeviceBatch(lambda: dd)


def decode_streams(datas, use_native=True, decode_bucket=None,
                   lane_quantum=_L_QUANTUM,
                   device="cuda") -> List[DecodedStream]:
    """Decode many FLAC streams in one batch, on the default route (see
    ``decode_streams_device``); PCM on the host. A ``decode_bucket``
    other than None takes the FrameDesc route with that per-bucket call
    (:func:`decode_frames_to`), the streams extracted as ``use_native``
    says."""
    if decode_bucket is None:
        return decode_streams_device(datas, use_native,
                                     lane_quantum=lane_quantum,
                                     device=device).to_host()
    return decode_batches([_extract(d, use_native) for d in datas],
                          decode_bucket, lane_quantum, device)


def decode_stream(data, use_native=True, device="cuda") -> DecodedStream:
    """Decode one whole FLAC stream (bytes)."""
    return decode_streams([data], use_native=use_native, device=device)[0]


def decode_streams_pipelined(datas, batch_streams=8, depth=2,
                             use_native=True, lane_quantum=_L_QUANTUM,
                             device="cuda") -> List[DecodedStream]:
    """Decode a large corpus as overlapping batches, on the default route.
    Each batch is begun with ``decode_streams_device_async`` and landed
    (finished, its PCM copies started) only after the next batch has
    begun, so a segmented batch's summary wait hides behind the next
    batch's host work. ``depth`` bounds the landed batches whose copies
    are in flight (the reference's default depth is 6). Results are in
    input order."""
    results = []
    in_flight = []
    pending = None

    def land(p):
        in_flight.append(p.finish().start_fetch())
        if len(in_flight) > depth:
            results.extend(in_flight.pop(0).to_host())

    for i in range(0, len(datas), batch_streams):
        h = decode_streams_device_async(datas[i:i + batch_streams],
                                        use_native=use_native,
                                        lane_quantum=lane_quantum,
                                        device=device)
        if pending is not None:
            land(pending)
        pending = h
    if pending is not None:
        land(pending)
    for dd in in_flight:
        results.extend(dd.to_host())
    return results
