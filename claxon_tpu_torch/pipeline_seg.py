"""Segmented device decode of the port: frame boundaries and subframe demux
on the card (counterpart of ``claxon_tpu.pipeline_seg``).

The host never walks payload bytes. It parses each stream's metadata,
groups streams by (STREAMINFO block-size bucket, channel count), and per
group uploads the raw little-endian payload words once and queues the
fused demux (``ops.seg_parse``: K6 bswap, K5 sync scan, K6 header parse and
compaction, K7 subframe walk, K6 summary). The summary copy is started at
once, so ``begin_segmented`` returns with the group's work in flight.
``finish_segmented`` waits for each summary, chains the candidates of each
stream (a real frame starts where the previous one's CRC-16 ends), and per
decode dispatch runs the entropy mode ``CLAXON_TPU_SEG_ENTROPY`` names
(read once per batch, in ``begin_segmented``), then K1 synthesis with the
K3 epilogue fused into its store, then K4 over the chained frames' CRC
ranges:

* ``"values"`` (the default; any unknown value too): K8 gathers the
  walk's decoded values and warm-up samples; one dispatch per frame
  block-size bucket;
* ``"delta"``: K7 also emits each code's bit advance, and K10 decodes
  every sample from them and the stream words at the walk's chunk bases;
* ``"scan"``: K2 decodes each chunk's codes in order from the walk's
  chunk bases.

The delta and scan dispatches are per (partition-count class, block-size
bucket), with the gather width SA the slot class of their frames' widest
chunk, as in the JAX package; the walk rows they read are gathered by
torch indexing.

A stream that cannot ride this path -- more than 2 channels, a STREAMINFO
block size above 65535, a walk-rejected frame, a chain break -- goes to
the host-walk path alone (``pipeline.decode_streams_device(...,
segmentation="host")``, which reproduces the reference's errors) and its
result merges into the batch; a group with more sync candidates than the
caps allow falls back as a group, and a batch of ``MAX_BATCH_BYTES`` or
more goes to the host walk whole. Every route is bit-exact.

With a mesh (``parallel``) each group's upload and fused demux run once,
on ``mesh.devices[0]``; the stream and walk outputs are copied once to
each other distinct device of the mesh, and every decode dispatch and
each group's K4 split into the mesh's shards, each on its device.

Each host stage is a span ``claxon.seg.<stage>`` of the batch's record
(``trace``): ``metadata``, then per group ``buffer``, ``upload`` and
``demux_queue``; ``between`` (the caller's time up to
``finish_segmented``); per group ``summary``, ``chain`` and
``plan_dispatch``; then ``fallback``. Their host seconds, summed by
stage, are ``DeviceDecoded.stage_seconds``. With ``CLAXON_TPU_SEG_DEBUG``
set (any nonempty value), ``finish_segmented`` also prints each stage's
host-CPU milliseconds, as the JAX package does: one line
``seg stage CPU ms: [(stage, ms), ...]``.
"""

import math
import os
import time

import numpy as np
import torch

from . import trace

__all__ = ["decode_streams_segmented", "begin_segmented",
           "finish_segmented", "host_header_fields"]

#: sample-rate extra bytes by code (codes 12, 13, 14 read 1/2/2 bytes).
_SR_EXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 2, 0],
                     np.int64)
_BPS_TABLE = np.array([0, 8, 12, -1, 16, 20, 24, -1], np.int64)


def host_header_fields(buf, positions):
    """Decode frame-header fields at ``positions`` of byte buffer ``buf``
    (a copy of ``claxon_tpu.pipeline_seg.host_header_fields``, numpy
    alone): the host twin of the device field parse in
    ``ops.seg_parse``, for tests and diagnostics. Vectorized over
    candidates; reads at most 16 bytes per position, clamped to the
    buffer's last byte. The grammar follows ``frame.
    read_frame_header_or_eof``; a malformed candidate gets ok=False
    rather than an error.

    Returns a dict of int64 arrays: ok, block_size, nch, mode, bps_code
    (0 = streaminfo), hlen (header bytes including the CRC-8 byte),
    time_raw (UTF-8-coded frame/sample number), variable (blocking flag).
    """
    buf = np.asarray(buf, dtype=np.uint8)
    pos = np.asarray(positions, dtype=np.int64)
    n = len(pos)
    if n == 0:
        z = np.zeros(0, np.int64)
        return {k: z for k in ("ok", "block_size", "nch", "mode",
                               "bps_code", "hlen", "time_raw", "variable")}
    win = buf[np.minimum(pos[:, None] + np.arange(16), len(buf) - 1)]
    win = win.astype(np.int64)

    ok = (win[:, 0] == 0xFF) & ((win[:, 1] & 0xFC) == 0xF8)
    variable = win[:, 1] & 1
    bs_code = win[:, 2] >> 4
    sr_code = win[:, 2] & 15
    ok &= (bs_code != 0) & (sr_code != 15)
    ca = win[:, 3] >> 4
    bps_code = (win[:, 3] >> 1) & 7
    ok &= (ca <= 10) & (_BPS_TABLE[np.minimum(bps_code, 7)] >= 0) \
        & ((win[:, 3] & 1) == 0)
    nch = np.where(ca < 8, ca + 1, 2)
    mode = np.where(ca < 8, 0, ca - 7)  # 1 LS, 2 RS, 3 MS (epilogue codes)

    # UTF-8 frame/sample number (1..7 bytes).
    first = win[:, 4]
    lead = np.zeros(n, np.int64)
    probe = 0x80
    live = np.ones(n, bool)
    for _ in range(8):
        hit = live & ((first & probe) != 0)
        lead += hit
        live &= hit
        probe >>= 1
    ok &= (lead != 1) & (lead != 8)
    ulen = np.maximum(lead, 1)
    mask0 = np.array([0x7F, 0, 0x1F, 0x0F, 0x07, 0x03, 0x01, 0], np.int64)
    val = first & mask0[np.minimum(lead, 7)]
    for j in range(1, 7):
        cont = win[:, 4 + j]
        use = j < ulen
        ok &= ~use | ((cont & 0xC0) == 0x80)
        val = np.where(use, (val << 6) | (cont & 0x3F), val)

    bs_extra = np.where(bs_code == 6, 1, 0) + np.where(bs_code == 7, 2, 0)
    sr_extra = _SR_EXTRA[sr_code]
    o = 4 + ulen
    b8 = win[np.arange(n), np.minimum(o, 15)]
    b16 = (b8 << 8) | win[np.arange(n), np.minimum(o + 1, 15)]
    block_size = np.select(
        [bs_code == 1, bs_code <= 5, bs_code == 6, bs_code == 7],
        [192, 576 << np.maximum(bs_code - 2, 0), b8 + 1, b16 + 1],
        256 << np.maximum(bs_code - 8, 0))
    ok &= ~((bs_code == 7) & (b16 == 0xFFFF))
    hlen = o + bs_extra + sr_extra + 1  # + the CRC-8 byte

    return {"ok": ok, "block_size": np.where(ok, block_size, 0),
            "nch": nch, "mode": mode, "bps_code": bps_code, "hlen": hlen,
            "time_raw": val, "variable": variable}

#: STREAMINFO identities of streams that left the device demux for a
#: per-stream reason (a walk-rejected frame or a chain break) once in this
#: process: ``begin_segmented`` sends them straight to the per-stream host
#: walk, so a repeated decode does not upload and walk them again. A
#: routing memo only (both routes are bit-exact); streams without a stored
#: MD5 are never cached, and a group overflow is not cached.
_REJECT_CACHE = set()
_REJECT_CACHE_CAP = 1 << 16

#: chunk gather-width classes (``claxon_tpu.pipeline_seg._SA_CLASSES``,
#: the C++ core's kSClasses), so the delta and scan dispatches come in a
#: few SA classes.
_SA_CLASSES = (4, 6, 8, 12, 16, 24, 32, 48, 64)


def _sa_class(s):
    """Words gathered per chunk for a widest chunk of ``s`` words: the
    first class at or above it, plus one word of alignment slack."""
    for c in _SA_CLASSES:
        if s <= c:
            return c + 1
    return _SA_CLASSES[-1] + 1


def _seg_mode():
    """``CLAXON_TPU_SEG_ENTROPY``: "values" (the default), "delta" or
    "scan"; any other value is "values" (``claxon_tpu.pipeline_seg.
    _seg_mode``)."""
    import os

    mode = os.environ.get("CLAXON_TPU_SEG_ENTROPY", "values")
    return mode if mode in ("values", "delta", "scan") else "values"


def _si_key(si, n_bytes):
    """The routing-memo key of a stream (``claxon_tpu.pipeline_seg.
    _si_key``), or None for a stream without a stored MD5."""
    md5 = si.md5sum
    if not md5 or md5 == b"\x00" * 16:
        return None
    # The rejection is a property of the ENCODE, not the audio, and the
    # PCM MD5 alone is shared by every encode of the same PCM. Block
    # sizes + the exact stream length separate encodes in practice (a
    # different rice/partition/LPC config virtually never produces the
    # same byte count); a residual collision only costs routing (the
    # host fallback is bit-exact), never correctness.
    return (md5, si.min_block_size, si.max_block_size, n_bytes)


class _SegPending:
    """An in-flight segmented batch: every group's upload and fused demux
    is queued and its summary copy started."""

    def __init__(self, datas, lane_quantum, device, mesh, rec):
        self.datas = datas
        self.lane_quantum = lane_quantum
        self.device = device
        self.mesh = mesh
        #: the batch's entropy mode (``_seg_mode``), read once.
        self.mode = _seg_mode()
        self.sis = []
        self.groups = []
        self.upload_bytes = 0
        self.pre_fallback = []
        #: the batch's record and its ``claxon.seg.*`` stages.
        self.trace = rec
        self.stages = trace.Stages(
            rec, "claxon.seg.",
            cpu_marks=bool(os.environ.get("CLAXON_TPU_SEG_DEBUG")))
        #: perf_counter_ns when ``begin_segmented`` returned.
        self.begun_ns = None


def _host_fallback(datas, lane_quantum, device, per_stream=False,
                   mesh=None, rec=None):
    """The host-walk path for ``datas``, its spans in ``rec`` (the batch's
    record; None: a new one). A per-stream fallback batch holds a few odd
    streams, so it pads lanes to 8 rather than the caller's quantum; over
    a ``mesh`` every bucket splits into its shards at the mesh's quantum
    instead, as in the JAX package."""
    from .pipeline import _L_QUANTUM, _decode_host_walk, _decode_streams_device

    if rec is None:
        rec = trace.batch()
    if mesh is not None:
        from .parallel.mesh import lane_quantum as mesh_quantum

        if lane_quantum is None:
            lane_quantum = mesh_quantum(mesh)
        return _decode_host_walk(datas, lane_quantum, mesh.devices[0],
                                 mesh=mesh, rec=rec)
    if lane_quantum is None:
        lane_quantum = _L_QUANTUM
    if per_stream:
        lane_quantum = min(lane_quantum, 8)
    return _decode_streams_device(datas, True, lane_quantum, "host", device,
                                  None, rec)


def begin_segmented(datas, lane_quantum=None, device="cuda", mesh=None,
                    rec=None):
    """Stage 1: metadata parse, stream grouping and, per group, one upload
    and one queued fused demux with its summary copy started. Returns the
    pending batch for :func:`finish_segmented`, or None when the batch
    cannot ride the device demux at all (the caller takes the host walk).
    With a ``mesh`` the groups run on ``mesh.devices[0]`` and
    ``lane_quantum`` defaults to ``parallel.lane_quantum(mesh)``. The
    stages' spans go to ``rec``, the batch's record (None: a new one,
    :func:`trace.batch`).
    """
    from . import native, pipeline_bits
    from .native.binding import _read_metadata
    from .ops.seg_parse import fused_demux_async
    from .parallel.mesh import device_guard
    from .pipeline import _L_QUANTUM, _T_BUCKETS

    if mesh is not None:
        from .parallel.mesh import lane_quantum as mesh_quantum

        device = mesh.devices[0]
        if lane_quantum is None:
            lane_quantum = mesh_quantum(mesh)
    if lane_quantum is None:
        lane_quantum = _L_QUANTUM
    if not native.available():
        return None
    if sum(len(d) for d in datas) >= pipeline_bits.MAX_BATCH_BYTES:
        return None  # int32 bit positions: the host walk splits the batch
    if rec is None:
        rec = trace.batch()
    pending = _SegPending(datas, lane_quantum, device, mesh, rec)
    stages = pending.stages

    # ---- metadata only; no payload byte is touched.
    with stages("metadata"):
        sis, payloads = [], []
        for d in datas:
            si, pos = _read_metadata(d)
            sis.append(si)
            payloads.append(np.frombuffer(d, np.uint8)[pos:])
        tbv = np.asarray(_T_BUCKETS, np.int64)
        # Streams the device demux cannot represent at all (> 2 channels;
        # a block size above the bucket ladder) and remembered rejects take
        # the per-stream host walk; the rest of the batch stays on the
        # card.
        pre_fb = [i for i, si in enumerate(sis)
                  if si.channels > 2 or si.max_block_size > int(tbv[-1])
                  or _si_key(si, len(datas[i])) in _REJECT_CACHE]
        if len(pre_fb) == len(datas):
            return None
        pending.pre_fallback = pre_fb
        pre_fb = set(pre_fb)
        pending.sis = sis

        # ---- groups: (T bucket of the STREAMINFO max block size,
        # channels).
        si_groups = {}
        for gi, si in enumerate(sis):
            if gi in pre_fb:
                continue
            T = int(tbv[np.searchsorted(tbv, max(si.max_block_size, 1))])
            si_groups.setdefault((T, si.channels), []).append(gi)
        # Same-channel groups whose buckets lie within 4x of the largest
        # merge: each group costs an upload, a demux and a summary round
        # trip, while walking a small-block stream at a larger T only
        # costs device work (the decode dispatches re-bucket per frame).
        merged = {}
        for (T, nch), g in sorted(si_groups.items(), reverse=True):
            for (Tm, nchm) in merged:
                if nchm == nch and Tm <= 4 * T:
                    merged[(Tm, nchm)].extend(g)
                    break
            else:
                merged[(T, nch)] = list(g)

    for (T, nch), g_streams in merged.items():
        with stages("buffer"):
            g_streams = sorted(g_streams)
            sizes = [payloads[i].nbytes for i in g_streams]
            wcs = [(s + 3) // 4 for s in sizes]
            total_q = pipeline_bits._pad_stream_words(sum(wcs))
            buf = np.zeros(total_q * 4, dtype=np.uint8)
            byte_off = np.zeros(len(g_streams), np.int64)
            off = 0
            for k, (i, s, wc) in enumerate(zip(g_streams, sizes, wcs)):
                buf[off:off + s] = payloads[i]
                byte_off[k] = off
                off += wc * 4
            ends_abs = byte_off + np.asarray(sizes, np.int64)
            # Frame-count bound from STREAMINFO for the capacity classes.
            frames_est = 0
            for i in g_streams:
                si = sis[i]
                if not si.samples or not si.min_block_size:
                    frames_est = None
                    break
                frames_est += -(-si.samples // si.min_block_size) + 2

        with stages("upload"):
            words_le = torch.from_numpy(buf.view(np.int32)).to(device)
        pending.upload_bytes += total_q * 4
        rec.count("upload_group_bytes", total_q * 4)
        with stages("demux_queue"), device_guard(device):
            pend = fused_demux_async(
                words_le, total_q * 4, T, nch, ends_abs,
                [sis[i].bits_per_sample for i in g_streams], frames_est,
                deltas=pending.mode == "delta")
        pending.groups.append((T, nch, g_streams, byte_off, ends_abs, sizes,
                               pend))
    pending.begun_ns = time.perf_counter_ns()
    return pending


def _chain(k, size, idx, cpos, end_byte, ok_c, byte_off):
    """The candidate indices that tile stream k's payload in order, or
    None on a chain break."""
    if idx.size == 0:
        return idx if size == 0 else None
    local = cpos[idx] - byte_off[k]
    nxt = end_byte[idx] - byte_off[k] + 2
    # Fast path: no mimics, every candidate links to the next.
    if ok_c[idx].all() and local[0] == 0 and nxt[-1] == size \
            and np.array_equal(nxt[:-1], local[1:]):
        return idx
    # Slow path: a payload byte mimicked a header; follow the chain.
    pos_map = {int(p): int(ci) for p, ci in zip(local, idx)}
    exp, chain = 0, []
    while exp < size:
        ci = pos_map.get(exp)
        if ci is None or not ok_c[ci]:
            return None
        chain.append(ci)
        nxt1 = int(end_byte[ci]) + 2 - int(byte_off[k])
        if nxt1 <= exp:
            return None
        exp = nxt1
    return np.asarray(chain, np.int64) if exp == size else None


def _dispatch(mode, stream, walk, rows, lengths, modes, tb32, P, SA, device):
    """One decode dispatch: (L,) int32 walk rows, lengths and modes (numpy)
    -> ((L, tb32) int32 PCM on the device, bytes uploaded). The entropy
    stage is ``mode``'s: K8 gathers the walk's values ("values"), or the
    dispatch's walk rows are gathered by torch indexing, their chunk axis
    cut to ``tb32`` samples, and K10 ("delta") or K2 ("scan") decodes them
    from ``stream``, the group's big-endian words, with P partitions and
    SA words a chunk. Then K1 + K3."""
    from .ops.entropy import (decode_residual_bits_stream,
                              decode_residual_bits_stream_delta)
    from .ops.predict import synthesize_epilogue
    from .ops.seg_gather import gather_values

    L = rows.shape[0]
    plan = torch.from_numpy(np.stack([rows, lengths, modes])).to(device)
    rows_t, lengths_t = plan[0], plan[1]
    pair_modes = plan[2].reshape(L // 2, 2)[:, 0].contiguous()
    pick = lambda key: walk[key].index_select(0, rows_t)
    order = pick("order")
    if mode == "values":
        x = gather_values(walk["values"], walk["warm"], walk["order"],
                          rows_t, tb32)
    else:
        bases = pick("bases")[:, :tb32 // 32].contiguous()
        ks = pick("ks")[:, :P].contiguous()
        lane = (pick("ps"), order, pick("pbits"), pick("flags"),
                pick("warm"), lengths_t)
        if mode == "delta":
            deltas = walk["deltas"][:, :tb32].index_select(0, rows_t)
            x = decode_residual_bits_stream_delta(
                stream, bases, deltas, ks, *lane, n_parts_max=P, sa=SA)
        else:
            x = decode_residual_bits_stream(stream, bases, ks, *lane,
                                            n_parts_max=P, sa=SA)
    out = synthesize_epilogue(x, pick("coefs"), pick("shift"), order,
                              lengths_t, pick("wasted"), pair_modes)
    return out, plan.numel() * 4


def finish_segmented(pending):
    """Stage 2: resolve each group's summary, chain the candidates, plan and
    dispatch the decode and the CRC check (per shard under a mesh), then
    host-walk the streams that left the device path and merge them in.
    Returns a DeviceDecoded."""
    from .ops.seg_parse import SUMMARY_COLS, DemuxOverflow
    from .parallel.mesh import Mesh, device_guard, replicate, shard_ranges
    from .pipeline_bits import _P_CLASSES, _crc_shards
    from .pipeline import (DecodedStream, DeviceDecoded, _LITTLE_ENDIAN,
                           _T_BUCKETS, _shard_dispatch, bucket_shape,
                           merge_decoded)

    datas = pending.datas
    lane_quantum = pending.lane_quantum
    device = pending.device
    sharded = pending.mesh is not None
    mesh = pending.mesh if sharded else Mesh((torch.device(device),))
    mode = pending.mode
    sis = pending.sis
    stages = pending.stages
    stages.add("between", pending.begun_ns)

    results = [None] * len(datas)
    pcms = [None] * len(datas)
    dispatches, plans, crc_pairs = [], [], []
    fb_streams = list(pending.pre_fallback)
    fb_learn = []   # per-stream rejects of this batch -> _REJECT_CACHE
    upload_bytes = pending.upload_bytes
    t_buckets = np.asarray(_T_BUCKETS, np.int64)

    for (T, nch, g_streams, byte_off, ends_abs, sizes, pend) \
            in pending.groups:
        with stages("summary"):
            try:
                with device_guard(device):
                    summary, count = pend.resolve()
            except DemuxOverflow:
                # A sync-saturated payload: the whole group host-walks.
                fb_streams.extend(g_streams)
                continue
            # The group's stream and walk outputs on each device of the
            # mesh.
            streams = replicate(pend.stream, mesh)
            walks = {dev: {k: v if v.device == dev else v.to(dev)
                           for k, v in pend.walk.items()}
                     for dev in streams}
        with stages("chain"):
            cols = {name: summary[:, k] for k, name in enumerate(SUMMARY_COLS)}
            cpos = cols["pos"]
            ok_c = (cols["valid"] != 0) & (cols["walk_ok"] != 0)
            # The device compacts walkable candidates in candidate order; this
            # is its lane map (walk row = walk_rank * nch + channel).
            walk_rank = np.cumsum(cols["valid"] != 0) - 1
            end_byte = cols["end_byte"]
            bs_c = cols["block_size"]
            time_raw = (cols["time_hi"] << 32) | (cols["time_lo"] & 0xFFFFFFFF)
            c_si = np.searchsorted(ends_abs, cpos, side="right")
            if len(g_streams):
                c_si = np.minimum(c_si, len(g_streams) - 1)

            chains = {}
            for k, size in enumerate(sizes):
                chain = _chain(k, size, np.flatnonzero(c_si == k), cpos,
                               end_byte, ok_c, byte_off)
                if chain is None:
                    fb_streams.append(g_streams[k])
                    fb_learn.append(g_streams[k])
                else:
                    chains[k] = chain

        with stages("plan_dispatch"):
            # ---- results and output offsets (chain order is stream order).
            out0_c = np.zeros(count, np.int64)
            chained = np.zeros(count, bool)
            crc_starts, crc_ends = [], []
            for k, chain in chains.items():
                si = sis[g_streams[k]]
                bs_v = bs_c[chain]
                pcm = np.zeros((int(bs_v.sum()), si.channels), dtype=np.int32)
                pcms[g_streams[k]] = pcm
                t_raw = time_raw[chain]
                times = np.where(cols["variable"][chain] != 0, t_raw,
                                 t_raw * bs_v)
                results[g_streams[k]] = DecodedStream(
                    streaminfo=si, pcm=pcm, frame_times=times.tolist(),
                    frame_sizes=bs_v.tolist())
                if chain.size:
                    out0_c[chain] = np.cumsum(bs_v) - bs_v
                    chained[chain] = True
                    crc_starts.append(cpos[chain])
                    crc_ends.append(end_byte[chain] + 2)

            # ---- decode dispatches, one per (P class, frame T bucket); values
            # mode never reads the partitions, so it has one P class. Sparse
            # classes merge upward, T first, as in the JAX package.
            g_idx = np.flatnonzero(chained)
            if g_idx.size:
                if mode == "values":
                    pcls = np.ones(g_idx.size, np.int64)
                else:
                    p_classes = np.asarray(_P_CLASSES, np.int64)
                    pcls = p_classes[np.minimum(
                        np.searchsorted(p_classes,
                                        np.maximum(cols["n_parts"][g_idx], 1)),
                        len(p_classes) - 1)]
                tcls = t_buckets[np.searchsorted(t_buckets,
                                                 np.maximum(bs_c[g_idx], 1))]
                uniqt = list(np.unique(tcls))
                for ci, Tc in enumerate(uniqt[:-1]):
                    m = tcls == Tc
                    if m.sum() * Tc < 32 * uniqt[ci + 1]:
                        tcls[m] = uniqt[ci + 1]
                uniq = list(np.unique(pcls))
                for ci, P in enumerate(uniq[:-1]):
                    if (pcls == P).sum() < 32:
                        pcls[pcls == P] = uniq[ci + 1]
                keys = pcls << 32 | tcls
                for key in np.unique(keys):
                    P, Tb = int(key >> 32), int(key & 0xFFFFFFFF)
                    sub = g_idx[keys == key]
                    sub = sub[np.lexsort((out0_c[sub], c_si[sub]))]
                    n_frames = sub.size
                    n_lanes = n_frames * nch
                    L, Tb = bucket_shape(n_lanes, Tb, lane_quantum)
                    bs_v = bs_c[sub]
                    # Padding lanes read walk row 0 with length 0: K1 writes
                    # zeros there and to_host never reads them.
                    rows = np.zeros(L, np.int32)
                    lengths = np.zeros(L, np.int32)
                    modes = np.zeros(L, np.int32)
                    rows[:n_lanes] = (walk_rank[sub][:, None] * nch
                                      + np.arange(nch)[None, :]).reshape(-1)
                    lengths[:n_lanes] = np.repeat(bs_v, nch)
                    modes[:n_lanes] = np.repeat(cols["mode"][sub], nch)
                    si_v = c_si[sub]
                    out0_v = out0_c[sub]
                    brk = np.flatnonzero(
                        (si_v[1:] != si_v[:-1]) | (bs_v[1:] != bs_v[:-1])
                        | (out0_v[1:] != out0_v[:-1] + bs_v[:-1])) + 1
                    starts_r = np.concatenate([[0], brk])
                    ends_r = np.concatenate([brk, [n_frames]])
                    plan = [(g_streams[int(si_v[st])], int(out0_v[st]),
                             int(en - st), int(bs_v[st]), nch, int(st * nch))
                            for st, en in zip(starts_r, ends_r)]
                    SA = 0 if mode == "values" else \
                        _sa_class(int(cols["sa"][sub].max()))
                    outs = []
                    for dev, a, z in shard_ranges(mesh, L):
                        with device_guard(dev):
                            out, nbytes = _dispatch(
                                mode, streams[dev], walks[dev], rows[a:z],
                                lengths[a:z], modes[a:z], (Tb + 31) // 32 * 32,
                                P, SA, dev)
                        outs.append(out)
                        upload_bytes += nbytes
                    # 16-bit audio fetches as int16 pairs (start_fetch packs).
                    out_packed = (_LITTLE_ENDIAN and Tb % 2 == 0
                                  and int(cols["bps"][sub].max()) <= 16)
                    dispatches.append(_shard_dispatch(nch, outs, out_packed,
                                                      sharded))
                    plans.append(plan)

            if crc_starts:
                starts = np.concatenate(crc_starts).astype(np.int32)
                ends_a = np.concatenate(crc_ends).astype(np.int32)
                n = len(starts)
                # The frame axis splits over the mesh: start from a multiple
                # of its size (the JAX package's lcm, so doubling keeps it).
                fq = math.lcm(8, mesh.size)
                while fq < n:
                    fq *= 2
                se = np.stack([np.pad(starts, (0, fq - n)),
                               np.pad(ends_a, (0, fq - n))])
                crc_pairs.extend(_crc_shards(streams, se, n, mesh))
                upload_bytes += se.nbytes

    for i in fb_learn:
        if len(_REJECT_CACHE) >= _REJECT_CACHE_CAP:
            break
        key = _si_key(sis[i], len(datas[i]))
        if key is not None:
            _REJECT_CACHE.add(key)

    dd = DeviceDecoded(results, dispatches, plans, pcms)
    dd.crc_check = crc_pairs or None
    dd.upload_bytes = upload_bytes
    dd.trace = pending.trace
    if fb_streams:
        fb_streams = sorted(set(fb_streams))
        with stages("fallback"):
            fb_dd = _host_fallback([datas[i] for i in fb_streams],
                                   lane_quantum, device, per_stream=True,
                                   mesh=pending.mesh, rec=pending.trace)
            dd = merge_decoded(len(datas), [(list(range(len(datas))), dd),
                                            (fb_streams, fb_dd)])
    # Markers: some stream rode the device demux; the demux ran at all;
    # the streams that took the host walk.
    dd.segmented = len(fb_streams) < len(datas)
    dd.seg_engaged = True
    dd.fallback_streams = list(fb_streams)
    dd.stage_seconds = dict(stages.seconds)
    stages.report()
    return dd


def decode_streams_segmented(datas, lane_quantum=None, device="cuda",
                             mesh=None, rec=None):
    """Decode FLAC streams with the frame search and subframe walk on the
    card. Returns a DeviceDecoded, like ``decode_streams_device``; streams
    the device demux cannot take are host-walked and merged in (see the
    module docstring). Overlapping callers use :func:`begin_segmented` and
    :func:`finish_segmented` (``decode_streams_device_async``). A ``mesh``
    (``parallel``) splits every decode dispatch into its lane shards and
    runs the demux on ``mesh.devices[0]``. The batch's spans go to
    ``rec``, its record (None: a new one)."""
    pending = begin_segmented(datas, lane_quantum, device, mesh, rec)
    if pending is None:
        return _host_fallback(datas, lane_quantum, device, mesh=mesh,
                              rec=rec)
    return finish_segmented(pending)
