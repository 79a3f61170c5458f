"""Bits-path device pipeline of the port: residual bits in, PCM out
(counterpart of ``claxon_tpu.pipeline_bits``).

The C++ boundary walk (``native.extract_stream_bits``, the port's copy
of the JAX package's core) ships each stream's frame-section bytes and
per-lane descriptors. :func:`plan_raw_bits` turns them, in numpy alone,
into the device uploads, in one of the JAX package's two entropy modes:

* ``"stream"`` (the default): one stream of big-endian int32 words for
  the batch, one packed int32 ``mb`` array per (T, nch) bucket (the
  ``_MB_FIXED`` layout below) and the frame CRC ranges ``se``;
  :func:`decode_raw_bits_device` runs K2 -> K1 + K3 per bucket
  (:func:`stream_step`; K3 fused into K1's store) and K4 once per batch
  over every deferred frame CRC;
* ``"delta"`` (``CLAXON_TPU_ENTROPY=delta``; the walk emitted the
  relocated slots and deltas, and checked the CRCs itself): per (T, nch,
  SA) bucket the slots (L, NC * SA) int32, the deltas (L, T) uint8, the
  Rice parameters (L, P) and the per-lane ``meta`` (L, 72) int32
  (``_META_W``); K9 -> K1 + K3 per bucket (:func:`delta_step`), no K4.

Both modes add the fallback-frame buckets (their residuals as int16 pairs
where they fit; K3b unpack -> K1 + K3). The planner produces the same
bytes as the JAX package's, which a test holds it to; the one difference
is that a delta bucket's slots start zeroed (the JAX planner leaves the
words no chunk fills uninitialised), so the upload is deterministic.
Each bucket also carries ``out_packed``, the JAX package's rule for
fetching it as int16 pairs (``DeviceDecoded.start_fetch`` packs then).

With a mesh (``parallel``) every bucket's lanes split into the mesh's
shards: the stream upload goes once to each distinct device, each shard
uploads its own rows and runs the bucket's kernels on its device, and K4
splits on frames.
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import trace
from .error import fmt_err
from .ops.crc import crc16_ranges
from .ops.entropy import decode_residual_bits, decode_residual_bits_stream
from .ops.epilogue import unpack_int16_pairs
from .ops.predict import ORDER_MAX, synthesize_epilogue

__all__ = ["plan_raw_bits", "decode_raw_bits_device", "stream_step",
           "delta_step", "unpack_mb", "inputs_from_numpy"]

# Partition-count classes: buckets quantize their maximum partition count.
_P_CLASSES = (1, 2, 4, 8, 16, 32, 64)


def _p_class(n):
    for p in _P_CLASSES:
        if n <= p:
            return p
    return _P_CLASSES[-1]


#: Packed per-lane upload layout (int32 words; int16 halfword pairs are
#: little-endian, low half first):
#:   word 0:            order | shift<<6 | wasted<<12 | pbits<<17
#:                      | flags<<20 | pair_mode<<23
#:   word 1:            ps (samples per partition)
#:   word 2:            length (block size)
#:   word 3:            base0 (absolute bit position of chunk 0)
#:   words 4:36:        warm-up samples
#:   words 36:52:       QLP coefficients, int16 pairs
#:   words 52:52+BD:    chunk-base deltas, int16 pairs, BD = ceil((NC-1)/2)
#:   words 52+BD..+KP:  per-partition Rice parameters, int16 pairs,
#:                      KP = ceil(P/2)
_MB_FIXED = 52


def _mb_width(nc, p):
    """Packed mb width in int32 words."""
    return _MB_FIXED + (nc - 1 + 1) // 2 + (p + 1) // 2


#: Delta-mode per-lane ``meta`` columns (int32): 0 order, 1 shift, 2
#: wasted, 3 ps, 4 pbits, 5 flags, 6 length, 7 pair mode (on both lanes of
#: a pair), 8:40 warm-up samples, 40:72 QLP coefficients.
_META_W = 72


#: chunk bases are int32 bit positions into the batch's stream upload, so
#: one plan stays below this many bytes (``pipeline._decode_host_walk``
#: splits a larger batch into runs and walks a larger stream in chunks).
MAX_BATCH_BYTES = 1 << 27

#: stream upload quantum (words) above the power-of-two classes.
_STREAM_QUANTUM = 1 << 16


def _pad_stream_words(total_w):
    """Padded word count of a batch's stream upload: power-of-two classes
    from 4096 words up to ``_STREAM_QUANTUM``, multiples of it above."""
    q = 1 << 12
    while q < _STREAM_QUANTUM:
        if total_w <= q:
            return q
        q *= 2
    return -(-max(total_w, 1) // _STREAM_QUANTUM) * _STREAM_QUANTUM


def _host_verify_deferred(bb, before_idx):
    """Re-verify deferred frame CRCs preceding frame ``before_idx`` on the
    host (cold path: runs only when another error is about to surface, so
    that an earlier CRC mismatch wins, as in sequential decode)."""
    from . import native

    bf = bb.bframes[:before_idx]
    payload = memoryview(bb.payload)
    for f in bf[(bf["flags"] & 2) != 0]:
        b0, b1 = int(f["byte0"]), int(f["byte1"])
        stored = (payload[b1 - 2] << 8) | payload[b1 - 1]
        if native.crc16_bytes(payload[b0:b1 - 2]) != stored:
            fmt_err("frame CRC mismatch")


def _excl_cumsum(v):
    """Exclusive cumsum with the same length as ``v``."""
    return np.cumsum(v) - v


def _group_runs(g_si, g_bs, g_lane0, n_ch):
    """Split a bucket group (frames in stream order) into runs of
    consecutive frames of one stream and one block size, whose spans in
    every flat array are contiguous. Returns (starts, ends)."""
    n = len(g_si)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    brk = np.flatnonzero((g_si[1:] != g_si[:-1])
                         | (g_bs[1:] != g_bs[:-1])
                         | (g_lane0[1:] != g_lane0[:-1] + n_ch)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [n]])
    return starts, ends


def _scatter_ks(ks, lane, nl, nparts, src, ko):
    """Lane j's Rice parameters src[ko+cum[j] : +nparts[j]] go to columns
    [0, nparts[j]) of ks row lane + j."""
    npr = nparts.astype(np.int64)
    tot = int(npr.sum())
    if not tot:
        return
    rows = np.repeat(np.arange(nl) + lane, npr)
    cols = np.arange(tot) - np.repeat(_excl_cumsum(npr), npr)
    ks[rows, cols] = src[ko:ko + tot]


@dataclass
class BitsBucket:
    """One stream-mode bucket: its packed upload and static shape."""
    n_ch: int
    n_parts_max: int   # P
    sa: int            # words gathered per chunk
    nc: int            # chunks per lane
    mb: np.ndarray     # (L, _mb_width(NC, P)) int32
    plan: list
    out_packed: bool   # 16-bit audio: fetch the PCM as int16 pairs


@dataclass
class DeltaBucket:
    """One delta-mode bucket: K9's uploads and static shape."""
    n_ch: int
    n_parts_max: int   # P
    sa: int            # words per chunk slot (the bucket's slot class)
    nc: int            # chunks per lane
    slots: np.ndarray  # (L, NC * SA) int32
    deltas: np.ndarray  # (L, NC * 32) uint8
    ks: np.ndarray     # (L, P) int32
    meta: np.ndarray   # (L, _META_W) int32
    plan: list
    out_packed: bool   # 16-bit audio: fetch the PCM as int16 pairs


@dataclass
class SampleBucket:
    """One fallback-frame bucket: host-decoded residuals for K1 + K3."""
    n_ch: int
    x: np.ndarray          # (L, T) int32, or (L, T // 2) with in_packed
    coefs: np.ndarray      # (L, 32) int32
    shifts: np.ndarray     # (L,)
    orders: np.ndarray     # (L,)
    wasted: np.ndarray     # (L,)
    pair_modes: np.ndarray  # (L//2,)
    lengths: np.ndarray    # (L,)
    plan: list
    in_packed: bool = False   # x is int16 pairs (every residual fits)
    out_packed: bool = False  # 16-bit audio: fetch the PCM as int16 pairs


@dataclass
class BitsPlan:
    """Everything a batch uploads, and where its PCM goes."""
    results: list          # DecodedStream per input stream
    pcms: list             # their (total, channels) int32 arrays
    stream: np.ndarray     # (W,) int32 big-endian frame-section words
    #                        (None in delta mode: nothing reads them)
    bits: list             # BitsBucket (DeltaBucket in delta mode), in
    #                        dispatch order
    samples: list          # SampleBucket, dispatched after the bits ones
    se: np.ndarray = None  # (2, F) int32 CRC ranges (starts, ends) or None
    n_crc: int = 0         # valid ranges in se


def _pack_input_i16(x):
    """Host-side int16-pair packing of an (L, T) int32 bucket whose values
    all fit int16 (T even): one copy, then a zero-copy int32 view."""
    L, T = x.shape
    x16 = np.ascontiguousarray(x.reshape(L, T // 2, 2).astype(np.int16))
    return x16.view(np.int32).reshape(L, T // 2)


def plan_raw_bits(braws, lane_quantum, mode="stream", n_shards=1):
    """Plan a batch of [(streaminfo, BitsBatch), ...] in entropy ``mode``
    ("stream": extracted with ``emit_slots=False``; "delta": with
    ``emit_slots=True`` and ``defer_crc=False``), in numpy alone, for a
    mesh of ``n_shards`` devices (the CRC ranges' count pads to a multiple
    of it, as in the JAX package; pass ``parallel.lane_quantum(mesh)`` as
    ``lane_quantum`` so every bucket splits too). Raises
    the reference's ``FormatError`` for a frame whose channel count
    disagrees with STREAMINFO, after re-checking the CRCs of the frames
    before it, and RuntimeError for a deferred-CRC batch in delta mode."""
    from .pipeline import (DecodedStream, _LITTLE_ENDIAN, _T_BUCKETS,
                           bucket_shape)

    t_buckets = np.asarray(_T_BUCKETS, dtype=np.int64)
    delta = mode == "delta"

    # Stream mode: one shared upload of every stream's frame-section words
    # (big-endian bit order, int32), chunk bases rebased into it.
    stream = None
    stream_bit_off = []
    if not delta:
        sizes = [len(b.payload) for _si, b in braws]
        wcs = [(s + 3) // 4 for s in sizes]
        buf = np.zeros(_pad_stream_words(sum(wcs)) * 4, dtype=np.uint8)
        off = 0
        for (_si, b), s, wc in zip(braws, sizes, wcs):
            buf[off:off + s] = np.frombuffer(b.payload, dtype=np.uint8)
            stream_bit_off.append(off * 8)
            off += wc * 4
        stream = buf.view(">i4").astype(np.int32)

    results, pcms = [], []
    bit_groups, smp_groups = {}, {}
    crc_starts, crc_ends = [], []
    for si_idx, (si, bb) in enumerate(braws):
        bf = bb.bframes
        bad_ch = bf["channels"] != si.channels
        if bad_ch.any():
            # An earlier frame's deferred CRC mismatch wins over this
            # later-frame error (sequential decode would hit it first).
            _host_verify_deferred(bb, int(np.argmax(bad_ch)))
            fmt_err("frame channel count does not match streaminfo")
        deferred = (bf["flags"] & 2) != 0
        if deferred.any():
            # Only the stream upload can be CRC-checked on the device.
            if delta:
                raise RuntimeError(
                    "BitsBatch extracted with defer_crc requires "
                    "mode='stream' (the CRC verifier reads the stream "
                    "upload)")
            off = stream_bit_off[si_idx] // 8
            crc_starts.append(bf["byte0"][deferred].astype(np.int64) + off)
            crc_ends.append(bf["byte1"][deferred].astype(np.int64) + off)
        bs_v = bf["block_size"].astype(np.int64)
        nch_v = bf["channels"].astype(np.int64)
        nc_v = (bs_v + 31) // 32
        sa_v = bf["s_class"].astype(np.int64) + 1
        fb_v = (bf["flags"] & 1) != 0
        out0_v = np.concatenate([[0], np.cumsum(bs_v)[:-1]])
        lane0_v = np.concatenate([[0], np.cumsum(nch_v)[:-1]])

        # Per-lane flat-buffer offsets: fallback lanes consume samples,
        # bits lanes consume chunk bases (and deltas and slots); every
        # lane consumes ks.
        lane_fb = np.repeat(fb_v, nch_v)
        lane_bs = np.repeat(bs_v, nch_v)
        x_sz = np.where(lane_fb, lane_bs, 0)
        b_sz = np.where(lane_fb, 0, np.repeat(nc_v, nch_v))
        d_sz = np.where(lane_fb, 0, lane_bs)
        s_sz = np.where(lane_fb, 0, np.repeat(nc_v * sa_v, nch_v))
        k_sz = bb.bsubs["n_parts"].astype(np.int64)
        x_off = _excl_cumsum(x_sz)
        b_off = _excl_cumsum(b_sz)
        d_off = _excl_cumsum(d_sz)
        s_off = _excl_cumsum(s_sz)
        k_off = _excl_cumsum(k_sz)

        pcm = np.zeros((int(bs_v.sum()), si.channels), dtype=np.int32)
        pcms.append(pcm)
        results.append(DecodedStream(
            streaminfo=si, pcm=pcm,
            frame_times=bf["time"].tolist(),
            frame_sizes=bf["block_size"].tolist()))
        if len(bf) == 0:
            continue

        # One composite key per frame: (fallback, T bucket, channels, and
        # in delta mode the slot class: its slots ship at that width).
        tb_idx = np.searchsorted(t_buckets, bs_v)
        np_max = np.maximum.reduceat(k_sz, lane0_v)
        sa_key = sa_v if delta else np.zeros_like(sa_v)
        key_v = (fb_v.astype(np.int64) << 48) | (tb_idx << 40) \
            | (nch_v << 20) | sa_key
        for kv in np.unique(key_v):
            idx = np.flatnonzero(key_v == kv)
            i0 = idx[0]
            lanes0 = lane0_v[idx]
            chunk = {
                "si": np.full(len(idx), si_idx, dtype=np.int64),
                "bs": bs_v[idx], "lane0": lanes0,
                "out0": out0_v[idx], "nc": nc_v[idx],
                "mode": bf["mode"][idx].astype(np.int64),
                "bps": bf["bps"][idx].astype(np.int64),
                "sa": sa_v[idx],
                "x0": x_off[lanes0], "k0": k_off[lanes0],
                "b0": b_off[lanes0], "d0": d_off[lanes0],
                "s0": s_off[lanes0], "np_max": np_max[idx],
            }
            t_bucket, n_ch = int(t_buckets[tb_idx[i0]]), int(nch_v[i0])
            if fb_v[i0]:
                smp_groups.setdefault((t_bucket, n_ch), []).append(chunk)
            else:
                bit_groups.setdefault((t_bucket, n_ch, int(sa_key[i0])),
                                      []).append(chunk)

    bits = []
    for (t_bucket, n_ch, sa_key), chunks in bit_groups.items():
        g = {f: np.concatenate([c[f] for c in chunks])
             for f in ("si", "bs", "lane0", "out0", "nc", "mode", "bps",
                       "sa", "k0", "b0", "d0", "s0", "np_max")}
        L, T = bucket_shape(len(g["si"]) * n_ch, t_bucket, lane_quantum)
        NC = (T + 31) // 32
        P = _p_class(int(g["np_max"].max()))
        SA = sa_key if delta else int(g["sa"].max())
        BD = (NC - 1 + 1) // 2
        if delta:
            slots = np.zeros((L, NC * SA), dtype=np.int32)
            slots3 = slots.reshape(L, NC, SA)
            deltas = np.zeros((L, NC * 32), dtype=np.uint8)
            ks = np.zeros((L, P), dtype=np.int32)
            meta = np.zeros((L, _META_W), dtype=np.int32)
        else:
            mb = np.zeros((L, _mb_width(NC, P)), dtype=np.int32)
            mb16 = mb.view(np.int16)  # (L, 2C) little-endian halfwords

        lane = 0
        plan = []
        starts, ends = _group_runs(g["si"], g["bs"], g["lane0"], n_ch)
        for st, en in zip(starts, ends):
            si = int(g["si"][st])
            bb = braws[si][1]
            nl = int(en - st) * n_ch
            bs, nc = int(g["bs"][st]), int(g["nc"][st])
            sub0 = int(g["lane0"][st])
            plan.append((si, int(g["out0"][st]), int(en - st), bs, n_ch,
                         lane))
            subs = bb.bsubs[sub0:sub0 + nl]
            if delta:
                d0, s0 = int(g["d0"][st]), int(g["s0"][st])
                deltas[lane:lane + nl, :bs] = \
                    bb.deltas[d0:d0 + nl * bs].reshape(nl, bs)
                slots3[lane:lane + nl, :nc, :] = \
                    bb.slots[s0:s0 + nl * nc * SA].reshape(nl, nc, SA)
                m = meta[lane:lane + nl]
                m[:, 0] = subs["order"]
                m[:, 1] = subs["shift"]
                m[:, 2] = subs["wasted"]
                m[:, 3] = subs["ps"]
                m[:, 4] = subs["pbits"]
                m[:, 5] = subs["flags"]
                m[:, 6] = bs
                if n_ch == 2:
                    m[:, 7] = np.repeat(g["mode"][st:en], 2)
                m[:, 8:40] = subs["warm"]
                m[:, 40:72] = subs["coefs"]
                _scatter_ks(ks, lane, nl, subs["n_parts"], bb.ks,
                            int(g["k0"][st]))
                lane += nl
                continue
            b0 = int(g["b0"][st])
            bas = bb.bases[b0:b0 + nl * nc].reshape(nl, nc)
            a = (subs["order"].astype(np.int32)
                 | (subs["shift"].astype(np.int32) << 6)
                 | (subs["wasted"].astype(np.int32) << 12)
                 | (subs["pbits"].astype(np.int32) << 17)
                 | (subs["flags"].astype(np.int32) << 20))
            if n_ch == 2:
                a |= np.repeat(g["mode"][st:en], 2).astype(np.int32) << 23
            m = mb[lane:lane + nl]
            m[:, 0] = a
            m[:, 1] = subs["ps"]
            m[:, 2] = bs
            m[:, 3] = bas[:, 0] + stream_bit_off[si]
            m[:, 4:36] = subs["warm"]
            c = subs["coefs"].astype(np.int32)
            m[:, 36:52] = (c[:, 0::2] & 0xFFFF) | (c[:, 1::2] << 16)
            if nc > 1:
                # A 32-sample chunk spans < 2^13 bits (codes <= 64 bits
                # each), so the deltas always fit int16.
                mb16[lane:lane + nl,
                     2 * _MB_FIXED:2 * _MB_FIXED + nc - 1] = \
                    np.diff(bas.astype(np.int64), axis=1)
            _scatter_ks(mb16[:, 2 * (_MB_FIXED + BD):], lane, nl,
                        subs["n_parts"], bb.ks, int(g["k0"][st]))
            lane += nl
        # The output is NC * 32 samples wide, so always even.
        out_packed = _LITTLE_ENDIAN and int(g["bps"].max()) <= 16
        bits.append(DeltaBucket(n_ch, P, SA, NC, slots, deltas, ks, meta,
                                plan, out_packed) if delta else
                    BitsBucket(n_ch, P, SA, NC, mb, plan, out_packed))

    # Fallback frames: the walker decoded their residuals on the host.
    samples = []
    for (t_bucket, n_ch), chunks in smp_groups.items():
        g = {f: np.concatenate([c[f] for c in chunks])
             for f in ("si", "bs", "lane0", "out0", "mode", "bps", "x0")}
        L, T = bucket_shape(len(g["si"]) * n_ch, t_bucket, lane_quantum)
        sb = SampleBucket(
            n_ch, np.zeros((L, T), dtype=np.int32),
            np.zeros((L, ORDER_MAX), dtype=np.int32),
            np.zeros(L, dtype=np.int32), np.zeros(L, dtype=np.int32),
            np.zeros(L, dtype=np.int32), np.zeros(L // 2, dtype=np.int32),
            np.zeros(L, dtype=np.int32), [])
        lane = 0
        starts, ends = _group_runs(g["si"], g["bs"], g["lane0"], n_ch)
        for st, en in zip(starts, ends):
            si = int(g["si"][st])
            bb = braws[si][1]
            nf = int(en - st)
            nl = nf * n_ch
            bs = int(g["bs"][st])
            sub0 = int(g["lane0"][st])
            sb.plan.append((si, int(g["out0"][st]), nf, bs, n_ch, lane))
            x0 = int(g["x0"][st])
            sb.x[lane:lane + nl, :bs] = \
                bb.samples[x0:x0 + nl * bs].reshape(nl, bs)
            subs = bb.bsubs[sub0:sub0 + nl]
            sb.orders[lane:lane + nl] = subs["order"]
            sb.shifts[lane:lane + nl] = subs["shift"]
            sb.wasted[lane:lane + nl] = subs["wasted"]
            sb.coefs[lane:lane + nl] = subs["coefs"]
            sb.lengths[lane:lane + nl] = bs
            if n_ch == 2:
                sb.pair_modes[lane // 2:lane // 2 + nf] = g["mode"][st:en]
            lane += nl
        if _LITTLE_ENDIAN and T % 2 == 0:
            sb.out_packed = int(g["bps"].max()) <= 16
            sb.in_packed = bool(sb.x.min(initial=0) >= -32768
                                and sb.x.max(initial=0) <= 32767)
            if sb.in_packed:
                sb.x = _pack_input_i16(sb.x)
        samples.append(sb)

    bp = BitsPlan(results, pcms, stream, bits, samples)
    if crc_starts:
        # One CRC dispatch per batch (per shard under a mesh); F pads to a
        # power of two (>= 8), then to a multiple of the mesh size, with
        # empty ranges, whose CRC is 0.
        starts = np.concatenate(crc_starts).astype(np.int32)
        ends = np.concatenate(crc_ends).astype(np.int32)
        n = len(starts)
        fq = 8
        while fq < n:
            fq *= 2
        fq = -(-fq // n_shards) * n_shards
        bp.se = np.stack([np.pad(starts, (0, fq - n)),
                          np.pad(ends, (0, fq - n))])
        bp.n_crc = n
    return bp


def _to_device(a, device):
    """A contiguous int32 tensor on ``device`` holding numpy array ``a``."""
    a = np.ascontiguousarray(a, dtype=np.int32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def inputs_from_numpy(stream, mb=None, se=None, device="cuda"):
    """The port's tensors for exactly the arrays the JAX package's
    ``_stream_program(stream, mb)`` and ``_crc_program(stream, se)``
    receive: int32, contiguous, on ``device``. ``mb``/``se`` may be None.
    Returns (stream, mb, se)."""
    return tuple(None if a is None else _to_device(a, device)
                 for a in (stream, mb, se))


def unpack_mb(mb, n_parts_max, nc):
    """Unpack a bucket's (L, C) mb upload (``_MB_FIXED`` layout) into the
    per-lane tensors K2, K1 and K3 take, all contiguous int32."""
    L = mb.shape[0]
    bd = (nc - 1 + 1) // 2
    a = mb[:, 0]
    base0 = mb[:, 3]
    # One K3b unpack of the whole int16 tail (coefficients, chunk-base
    # deltas, Rice parameters); the fields are column ranges of its result.
    h = unpack_int16_pairs(mb[:, 36:].contiguous())
    d0 = 2 * (_MB_FIXED - 36)
    k0 = d0 + 2 * bd
    if nc > 1:
        deltas = h[:, d0:d0 + nc - 1]
        bases = base0[:, None] + torch.cat(
            [torch.zeros((L, 1), dtype=torch.int32, device=mb.device),
             torch.cumsum(deltas, dim=1, dtype=torch.int32)], dim=1)
    else:
        bases = base0[:, None]
    return {
        "orders": (a & 63).contiguous(),
        "shifts": ((a >> 6) & 63).contiguous(),
        "wasted": ((a >> 12) & 31).contiguous(),
        "pbits": ((a >> 17) & 7).contiguous(),
        "flags": ((a >> 20) & 7).contiguous(),
        # The channel-assignment mode rides both lanes of a pair.
        "pair_modes": ((a >> 23) & 7).reshape(L // 2, 2)[:, 0].contiguous(),
        "ps": mb[:, 1].contiguous(),
        "lengths": mb[:, 2].contiguous(),
        "bases": bases.contiguous(),
        "warm": mb[:, 4:36].contiguous(),
        "coefs": h[:, :ORDER_MAX].contiguous(),
        "ks": h[:, k0:k0 + n_parts_max].contiguous(),
    }


def stream_step(stream, mb, n_parts_max, sa, nc):
    """One stream-mode bucket, stream (W,) + mb (L, C) -> (L, NC*32) int32
    PCM: the mb unpack, then K2 entropy decode -> K1 synthesis with the K3
    epilogue fused into its store."""
    u = unpack_mb(mb, n_parts_max, nc)
    x = decode_residual_bits_stream(
        stream, u["bases"], u["ks"], u["ps"], u["orders"], u["pbits"],
        u["flags"], u["warm"], u["lengths"], n_parts_max=n_parts_max, sa=sa)
    return synthesize_epilogue(x, u["coefs"], u["shifts"], u["orders"],
                               u["lengths"], u["wasted"], u["pair_modes"])


def delta_step(slots, deltas, ks, meta, n_parts_max, sa):
    """One delta-mode bucket, slots (L, NC * sa) int32, deltas (L, NC * 32)
    uint8, ks (L, P) and meta (L, _META_W) -> (L, NC * 32) int32 PCM: K9
    entropy decode -> K1 synthesis with the K3 epilogue fused into its
    store (the JAX package's ``_bits_program``)."""
    L = meta.shape[0]
    orders, shifts, wasted, ps, pbits, flags, lengths = (
        meta[:, i].contiguous() for i in range(7))
    pair_modes = meta[:, 7].reshape(L // 2, 2)[:, 0].contiguous()
    warm = meta[:, 8:40].contiguous()
    coefs = meta[:, 40:72].contiguous()
    x = decode_residual_bits(slots, deltas, ks, ps, orders, pbits, flags & 1,
                             warm, n_parts_max=n_parts_max, sa=sa)
    return synthesize_epilogue(x, coefs, shifts, orders, lengths, wasted,
                               pair_modes)


def _decode_sample_shards(arrays, in_packed, mesh):
    """K1 + K3 on one sample bucket, ``pipeline.pack_bucket``'s seven numpy
    arrays (``x`` as int16 pairs when ``in_packed``, unpacked by K3b),
    split over ``mesh`` (``parallel.mesh``): each shard uploads its lane
    rows to its device and decodes there. Returns the (L / n, T) int32
    shards in lane order."""
    from .parallel.mesh import device_guard, shard_ranges

    outs = []
    for dev, a, z in shard_ranges(mesh, len(arrays[0])):
        rows = [v[a:z] for v in arrays]
        rows[5] = arrays[5][a // 2:z // 2]  # pair_modes: a row a pair
        with device_guard(dev):
            x, coefs, shifts, orders, wasted, pair_modes, lengths = (
                _to_device(v, dev) for v in rows)
            if in_packed:
                x = unpack_int16_pairs(x)
            outs.append(synthesize_epilogue(x, coefs, shifts, orders,
                                            lengths, wasted, pair_modes))
    return outs


def _crc_shards(streams, se, n, mesh):
    """K4 on the (2, F) CRC ranges ``se``, ``n`` of them real and the rest
    empty padding (CRC 0), split on frames over ``mesh``, each shard on
    its device's copy of the stream (``streams``, by device). Returns
    ``DeviceDecoded.crc_check``: [(CRCs, valid count), ...] in frame
    order."""
    from .parallel.mesh import device_guard, shard_ranges

    pairs = []
    for dev, a, z in shard_ranges(mesh, se.shape[1]):
        with device_guard(dev):
            se_t = _to_device(se[:, a:z], dev)
            pairs.append((crc16_ranges(streams[dev], se_t[0], se_t[1]),
                          min(max(n - a, 0), z - a)))
    return pairs


def decode_raw_bits_device(braws, lane_quantum, device="cuda",
                           mode="stream", mesh=None, rec=None):
    """Decode [(streaminfo, BitsBatch), ...] in entropy ``mode`` into a
    DeviceDecoded whose buckets live on ``device``, or, with a ``mesh``
    (``parallel``; ``lane_quantum`` then ``parallel.lane_quantum(mesh)``),
    split into lane shards, shard i on ``mesh.devices[i]``: the stream
    upload goes once to each distinct device, each shard's rows only to
    its own, and K4's frames split the same way (``crc_check`` holds a
    pair per shard). Planning and dispatch are the spans
    ``claxon.walk.plan`` and ``claxon.walk.dispatch`` of ``rec``, the
    batch's record (None: a new one), which the result keeps."""
    from .parallel.mesh import Mesh, device_guard, replicate, shard_ranges
    from .pipeline import DeviceDecoded, _shard_dispatch

    if rec is None:
        rec = trace.Trace()
    sharded = mesh is not None
    if not sharded:
        mesh = Mesh((torch.device(device),))
    with rec.span("claxon.walk.plan"):
        bp = plan_raw_bits(braws, lane_quantum, mode, mesh.size)
    with rec.span("claxon.walk.dispatch"):
        upload = 0
        if bp.stream is not None:
            streams = replicate(torch.from_numpy(bp.stream), mesh)
            upload = bp.stream.nbytes * len(streams)
        dispatches, plans = [], []
        for b in bp.bits:
            outs = []
            for dev, a, z in shard_ranges(mesh, len(b.meta if mode == "delta"
                                                    else b.mb)):
                with device_guard(dev):
                    if mode == "delta":
                        outs.append(delta_step(
                            _to_device(b.slots[a:z], dev),
                            torch.from_numpy(b.deltas[a:z]).to(dev),
                            _to_device(b.ks[a:z], dev),
                            _to_device(b.meta[a:z], dev), b.n_parts_max,
                            b.sa))
                    else:
                        outs.append(stream_step(
                            streams[dev], _to_device(b.mb[a:z], dev),
                            b.n_parts_max, b.sa, b.nc))
            if mode == "delta":
                upload += b.slots.nbytes + b.deltas.nbytes + b.ks.nbytes \
                    + b.meta.nbytes
            else:
                upload += b.mb.nbytes
            dispatches.append(_shard_dispatch(b.n_ch, outs, b.out_packed,
                                              sharded))
            plans.append(b.plan)
        for s in bp.samples:
            arrays = (s.x, s.coefs, s.shifts, s.orders, s.wasted,
                      s.pair_modes, s.lengths)
            outs = _decode_sample_shards(arrays, s.in_packed, mesh)
            upload += sum(a.nbytes for a in arrays)
            dispatches.append(_shard_dispatch(s.n_ch, outs, s.out_packed,
                                              sharded))
            plans.append(s.plan)
        dd = DeviceDecoded(bp.results, dispatches, plans, bp.pcms)
        if bp.se is not None:
            dd.crc_check = _crc_shards(streams, bp.se, bp.n_crc, mesh)
            upload += bp.se.nbytes
    dd.upload_bytes = upload
    dd.trace = rec
    return dd
