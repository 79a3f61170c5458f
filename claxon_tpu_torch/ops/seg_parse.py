"""K6: the fused on-device demux (counterpart of ``claxon_tpu.ops.
seg_parse``): sync scan, header parse and subframe walk of one stream
group, returning the device-resident walk arrays and one packed summary
row per sync candidate.

One group's run (:func:`fused_demux_run`) is

  front (K6 bswap + K5 sync scan and header check + K6 fields and
  compaction, one pass) -> K7 walk -> K6 summary

all queued on the current stream with no host round trip; the host then
copies the (cap, 5) summary and the two counts back (:class:`PendingDemux`:
a non-blocking copy into pinned memory and an event). The K6 pieces:

* :func:`demux_front` -- the front in two kernels that read the upload
  once (``csrc/seg_parse.cu``); its plain form is the composition of
  :func:`bswap_words_plain` (the little-endian word upload to the
  big-endian stream every other kernel indexes), K5's
  ``find_frame_headers_plain`` and :func:`parse_candidates_plain` (the
  frame-header fields of every candidate, decoded from K5's 16-byte
  window, its stream (``searchsorted(ends, p, side="right")`` clamped to
  S - 1) and bits per sample, the walkable predicate, and the compaction
  of the walkable candidates into ``wcap`` walk lanes in stream order);
* :func:`pack_summary` -- each candidate's walk verdict, end, largest
  partition count and gather width back in candidate order, packed into 5
  int32 words with the JAX program's bit widths.

The capacity classes, the regrow loop and the overflow exception carry the
JAX package's values unchanged, so both packages route the same streams.
"""

import numpy as np
import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32
from .demux import walk_frames
from .segment import WIN, _leading_ones8, find_frame_headers_plain

__all__ = ["fused_demux", "fused_demux_async", "fused_demux_run",
           "PendingDemux", "DemuxOverflow", "SUMMARY_COLS", "PACKED_WORDS",
           "S_QUANTUM", "MAX_CAP", "MAX_WALK_BYTES", "max_walk_lanes",
           "pick_cap", "pick_wcap", "bswap_words_plain",
           "parse_candidates_plain", "pack_summary",
           "pack_summary_plain", "demux_front", "demux_front_plain",
           "FIELDS"]

#: summary columns, per candidate (int64 after unpacking). 'valid' is
#: valid AND walkable: the host recomputes the device's compaction rank as
#: cumsum(valid), so the two predicates are one.
SUMMARY_COLS = ("pos", "valid", "walk_ok", "end_byte", "n_parts", "sa",
                "block_size", "mode", "time_lo", "time_hi", "variable",
                "bps", "hlen", "nch_hdr")

#: packed form: 5 int32 words per candidate.
#: w0=pos, w1=end_byte, w2=time_lo,
#: w3=block_size(17)|hlen(5)|nch_hdr(4)|mode(2)|variable(1)|valid(1)|
#:    walk_ok(1),
#: w4=time_hi(4)|n_parts(7)|sa(9)|bps(6).
PACKED_WORDS = 5

#: per-candidate field row of :func:`parse_candidates_plain`.
FIELDS = ("block_size", "hlen", "nch_hdr", "mode", "variable", "lo", "hi",
          "bps", "walkable")
_F = {name: i for i, name in enumerate(FIELDS)}

#: stream-count padding quantum of the per-stream metadata arrays.
S_QUANTUM = 8

_BPS_TABLE = (0, 8, 12, -1, 16, 20, 24, -1)
_UTF8_MASK0 = (0x7F, 0, 0x1F, 0x0F, 0x07, 0x03, 0x01, 0)

#: candidate-capacity ceiling per group: past it the group takes the host
#: walk (DemuxOverflow) instead of growing the walk arrays without bound.
MAX_CAP = 1 << 18

#: device-memory budget for one group's walk arrays (sizes the largest
#: walk-lane class, :func:`max_walk_lanes`).
MAX_WALK_BYTES = 2 << 30

_M32 = 0xFFFFFFFF


class DemuxOverflow(Exception):
    """More sync candidates or walk lanes than the caps: take the host
    walk."""


def _unpack_summary(s):
    """(N, PACKED_WORDS) int32 -> (N, len(SUMMARY_COLS)) int64."""
    s = np.asarray(s).astype(np.int64)
    pos, end_byte, lo, w3, w4 = (s[:, k] for k in range(PACKED_WORDS))
    cols = {
        "pos": pos, "end_byte": end_byte, "time_lo": lo,
        "block_size": w3 & 0x1FFFF, "hlen": (w3 >> 17) & 31,
        "nch_hdr": (w3 >> 22) & 15, "mode": (w3 >> 26) & 3,
        "variable": (w3 >> 28) & 1, "valid": (w3 >> 29) & 1,
        "walk_ok": (w3 >> 30) & 1,
        "time_hi": w4 & 0xF, "n_parts": (w4 >> 4) & 127,
        "sa": (w4 >> 11) & 511, "bps": (w4 >> 20) & 63,
    }
    return np.stack([cols[c] for c in SUMMARY_COLS], axis=1)


def max_walk_lanes(T, nch):
    """Largest power-of-2 walk-lane capacity within MAX_WALK_BYTES."""
    per_cand = nch * (6 * ((T + 31) // 32) * 32 + 1024)
    cap = 256
    while cap * 2 * per_cand <= MAX_WALK_BYTES and cap < MAX_CAP:
        cap *= 2
    return cap


def pick_cap(n_bytes, frames_est=None):
    """Sync-candidate capacity class for a group payload: the frame
    estimate (bounded by the ~14-byte physical frame floor) plus a
    sync-mimic budget, or bytes/512 without an estimate; powers of two
    from 256 to MAX_CAP."""
    if frames_est is None:
        est = n_bytes // 512 + 1
    else:
        est = min(frames_est, n_bytes // 14 + 2) + n_bytes // 8192 + 64
    cap = 256
    while cap < est and cap < MAX_CAP:
        cap *= 2
    return cap


def pick_wcap(n_bytes, frames_est=None):
    """Walk-lane capacity class: the frame estimate plus a thin mimic
    budget (CRC-8 and the shape checks remove nearly every mimic before
    the walk)."""
    if frames_est is None:
        est = n_bytes // 512 + 1
    else:
        est = min(frames_est, n_bytes // 14 + 2) + n_bytes // (1 << 21) + 32
    cap = 256
    while cap < est and cap < MAX_CAP:
        cap *= 2
    return cap


def _wrap32(v):
    """int64 -> int32 with the same low 32 bits."""
    return (((v + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


# ---- bswap -----------------------------------------------------------

def bswap_words_plain(words_le):
    """(W,) int32 little-endian words -> (W,) int32 big-endian words."""
    u = words_le.to(torch.int64) & _M32
    be = (((u & 0xFF) << 24) | ((u & 0xFF00) << 8) | ((u >> 8) & 0xFF00)
          | (u >> 24))
    return _wrap32(be)


# ---- header fields + compaction --------------------------------------

def parse_candidates_plain(positions, valid, win, count, ends, si_bps, T,
                           nch, wcap):
    """K6's header fields and compaction in plain PyTorch (the fused
    front's second half).

    Args:
      positions, valid, count, win: K5's outputs ((C,) int32, (C,) bool,
              () int32, (C, 16) int32).
      ends:   (S,) int32 end byte of each stream of the group, ascending
              (padding entries: the group's byte count).
      si_bps: (S,) int32 STREAMINFO bits per sample (padding: 1).
      T, nch: the group's block-size bucket and channel count.
      wcap:   walk-lane capacity.

    Returns:
      (fields (C, len(FIELDS)) int32, lane_of (C,) int32 -- the walk lane
      of each candidate or -1, (start_bits, bs, modes, bps) the (wcap,)
      int32 walk inputs, counts (2,) int32 -- [sync hits, walkable]).
    """
    dev = positions.device
    i64 = torch.int64
    w = win.to(i64)
    p = positions.to(i64).clamp(min=0)
    variable = w[:, 1] & 1
    bs_code = w[:, 2] >> 4
    sr_code = w[:, 2] & 15
    ca = w[:, 3] >> 4
    bps_code = (w[:, 3] >> 1) & 7
    nch_hdr = torch.where(ca < 8, ca + 1, 2)
    mode = torch.where(ca < 8, 0, ca - 7)

    lead = _leading_ones8(w[:, 4])
    ulen = torch.where(lead == 0, 1, lead)
    mask0 = torch.tensor(_UTF8_MASK0, dtype=i64, device=dev)
    lo = w[:, 4] & mask0[lead.clamp(max=7)]
    hi = torch.zeros_like(lo)
    for j in range(1, 7):
        use = j < ulen
        hi = torch.where(use, ((hi << 6) & _M32) | ((lo >> 26) & 0x3F), hi)
        lo = torch.where(use, ((lo << 6) & _M32) | (w[:, 4 + j] & 0x3F), lo)

    bs_extra = (bs_code == 6).to(i64) + 2 * (bs_code == 7).to(i64)
    sr_extra = (sr_code == 12).to(i64) \
        + 2 * ((sr_code == 13) | (sr_code == 14)).to(i64)
    o = 4 + ulen
    b8 = torch.gather(w, 1, o.clamp(max=15)[:, None])[:, 0]
    b16 = (b8 << 8) | torch.gather(w, 1, (o + 1).clamp(max=15)[:, None])[:, 0]
    one = torch.ones_like(bs_code)
    block_size = torch.where(
        bs_code == 1, 192, torch.where(
            bs_code <= 5, 576 * (one << (bs_code - 2).clamp(min=0)),
            torch.where(bs_code == 6, b8 + 1, torch.where(
                bs_code == 7, b16 + 1,
                256 * (one << (bs_code - 8).clamp(min=0))))))
    ok = valid & ~((bs_code == 7) & (b16 == 0xFFFF))
    hlen = o + bs_extra + sr_extra + 1  # + the CRC-8 byte

    S = ends.shape[0]
    si = torch.searchsorted(ends.to(i64), p, right=True).clamp(max=S - 1)
    table = torch.tensor(_BPS_TABLE, dtype=i64, device=dev)
    bps = torch.where(bps_code == 0, si_bps.to(i64)[si], table[bps_code])
    walkable = ok & (nch_hdr == nch) & (bps > 0) & (block_size >= 1) \
        & (block_size <= T)
    fields = torch.stack([block_size, hlen, nch_hdr, mode, variable,
                          _wrap32(lo).to(i64), _wrap32(hi).to(i64), bps,
                          walkable.to(i64)], dim=1).to(torch.int32)

    rank = torch.cumsum(walkable.to(i64), 0) - 1
    lane_of = torch.where(walkable & (rank < wcap), rank, -1)
    live = torch.nonzero(lane_of >= 0)[:, 0]
    lanes = lane_of[live]
    start_bits = torch.zeros(wcap, dtype=i64, device=dev)
    w_bs = torch.zeros(wcap, dtype=i64, device=dev)
    w_mode = torch.zeros(wcap, dtype=i64, device=dev)
    w_bps = torch.ones(wcap, dtype=i64, device=dev)
    start_bits[lanes] = ((p + hlen) * 8)[live]
    w_bs[lanes] = block_size[live]
    w_mode[lanes] = mode[live]
    w_bps[lanes] = bps[live]
    counts = torch.stack([count.to(i64).reshape(()),
                          walkable.sum()]).to(torch.int32)
    walk_in = tuple(a.to(torch.int32) for a in (start_bits, w_bs, w_mode,
                                                 w_bps))
    return fields, lane_of.to(torch.int32), walk_in, counts


# ---- the fused front ---------------------------------------------------

def demux_front_plain(words_le, n_bytes, ends, si_bps, T, nch, cap, wcap):
    """The plain PyTorch form of :func:`demux_front`: bswap, K5's sync scan
    and header check, then the fields and compaction."""
    stream = bswap_words_plain(words_le)
    positions, valid, count, win = find_frame_headers_plain(stream, n_bytes,
                                                            cap)
    fields, lane_of, walk_in, counts = parse_candidates_plain(
        positions, valid, win, count, ends, si_bps, T, nch, wcap)
    return (stream, positions, valid, count, win, fields, lane_of, walk_in,
            counts)


def demux_front(words_le, n_bytes, ends, si_bps, T, nch, cap, wcap):
    """The fused front's wrapper: the plain form for CPU tensors; for CUDA
    tensors the kernels (``csrc/seg_parse.cu``: the scan over the upload,
    then the ranks and rows), or an exception.

    Args:
      words_le: (W,) int32 little-endian word upload.
      n_bytes:  bytes of the upload to scan.
      ends, si_bps, T, nch, wcap: as for :func:`parse_candidates_plain`.
      cap:      candidate capacity C.

    Returns:
      (stream (W,) int32 big-endian words, then K5's positions, valid,
      count and win, then :func:`parse_candidates_plain`'s fields, lane_of,
      walk_in and counts), as the three plain forms return them.
    """
    if on_cpu(words_le, ends, si_bps):
        return demux_front_plain(words_le, n_bytes, ends, si_bps, T, nch,
                                 cap, wcap)
    dev = require_cuda_int32("demux_front", words_le=words_le, ends=ends,
                             si_bps=si_bps)
    S = ends.shape[0]
    if words_le.dim() != 1 or words_le.shape[0] >= 1 << 29 or \
            si_bps.shape != (S,) or S < 1 or cap < 1 or wcap < 1:
        raise ValueError("demux_front: expected a (W,) upload below 2^31 "
                         "bytes (int32 positions), (S,) ends/si_bps with "
                         "S >= 1, cap >= 1, wcap >= 1")
    lib = _build.load()
    i32 = dict(dtype=torch.int32, device=dev)
    C = cap
    stream = torch.empty_like(words_le)
    positions = torch.empty((C,), **i32)
    valid = torch.empty((C,), dtype=torch.bool, device=dev)
    win = torch.empty((C, WIN), **i32)
    fields = torch.empty((C, len(FIELDS)), **i32)
    lane_of = torch.empty((C,), **i32)
    walk_in = tuple(torch.empty((wcap,), **i32) for _ in range(4))
    counts = torch.empty((2,), **i32)
    # Each tile's counts and first hits, for the second kernel.
    scratch = torch.empty((int(lib.cxk_front_scratch(words_le.shape[0])),),
                          **i32)
    _build.check(lib.cxk_demux_front(
        words_le.data_ptr(), words_le.shape[0], n_bytes, ends.data_ptr(),
        si_bps.data_ptr(), S, T, nch, C, wcap, stream.data_ptr(),
        positions.data_ptr(), valid.data_ptr(), win.data_ptr(),
        fields.data_ptr(), lane_of.data_ptr(),
        *(a.data_ptr() for a in walk_in), counts.data_ptr(),
        scratch.data_ptr(), _build.stream_handle(dev)), "cxk_demux_front")
    demux_front.launches += 1
    return (stream, positions, valid, counts[0], win, fields, lane_of,
            walk_in, counts)


# ---- summary -----------------------------------------------------------

def pack_summary_plain(positions, fields, lane_of, end_bits, walk_ok,
                       n_parts, sa_words, nch):
    """The plain PyTorch form of :func:`pack_summary`."""
    i64 = torch.int64
    f = fields.to(i64)
    lane = lane_of.to(i64)
    live = lane >= 0
    li = lane.clamp(min=0)
    ok = torch.where(live, walk_ok.to(i64)[li], 0)
    eb = torch.where(live, end_bits.to(i64)[li], 0)
    np_f = torch.where(live, n_parts.to(i64).reshape(-1, nch)
                       .max(dim=1).values[li], 0)
    sa_f = torch.where(live, sa_words.to(i64).reshape(-1, nch)
                       .max(dim=1).values[li], 0)
    col = lambda name: f[:, _F[name]]
    w3 = (col("block_size").clamp(0, 0x1FFFF)
          | (col("hlen").clamp(0, 31) << 17)
          | (col("nch_hdr").clamp(0, 15) << 22)
          | (col("mode").clamp(0, 3) << 26)
          | ((col("variable") & 1) << 28)
          | (col("walkable") << 29)
          | (ok << 30))
    w4 = ((col("hi") & 0xF)
          | (np_f.clamp(0, 127) << 4)
          | (sa_f.clamp(0, 511) << 11)
          | (col("bps").clamp(0, 63) << 20))
    return torch.stack([positions.to(i64), eb >> 3, col("lo"), w3, w4],
                       dim=1).to(torch.int32)


def pack_summary(positions, fields, lane_of, end_bits, walk_ok, n_parts,
                 sa_words, nch):
    """K6 summary wrapper: the plain form for CPU tensors; for CUDA tensors
    the kernel (``csrc/seg_parse.cu``), or an exception.

    Args:
      positions, fields, lane_of: as from :func:`demux_front`.
      end_bits, walk_ok: K7's (wcap,) int32 and bool per-frame results.
      n_parts, sa_words: K7's (wcap * nch,) int32 per-lane outputs.

    Returns:
      (C, PACKED_WORDS) int32 summary rows.
    """
    args = (positions, fields, lane_of, end_bits, walk_ok, n_parts, sa_words)
    if on_cpu(*args):
        return pack_summary_plain(*args, nch)
    dev = require_cuda_int32("pack_summary", positions=positions,
                             fields=fields, lane_of=lane_of,
                             end_bits=end_bits, n_parts=n_parts,
                             sa_words=sa_words)
    C = positions.shape[0]
    F = end_bits.shape[0]
    if fields.shape != (C, len(FIELDS)) or lane_of.shape != (C,) or \
            walk_ok.dtype != torch.bool or walk_ok.shape != (F,) or \
            n_parts.shape != (F * nch,) or sa_words.shape != (F * nch,):
        raise ValueError("pack_summary: inconsistent shapes")
    lib = _build.load()
    out = torch.empty((C, PACKED_WORDS), dtype=torch.int32, device=dev)
    _build.check(lib.cxk_seg_summary(
        positions.data_ptr(), fields.data_ptr(), lane_of.data_ptr(), C,
        end_bits.data_ptr(), walk_ok.data_ptr(), n_parts.data_ptr(),
        sa_words.data_ptr(), nch, out.data_ptr(),
        _build.stream_handle(dev)), "cxk_seg_summary")
    pack_summary.launches += 1
    return out


#: kernel launches through the wrappers (CUDA tensors only).
demux_front.launches = 0
pack_summary.launches = 0


# ---- one group ---------------------------------------------------------

def fused_demux_run(words_le, n_bytes, T, nch, ends, si_bps, cap, wcap,
                    deltas=False):
    """Queue one group's fused demux: the front (bswap, K5, fields +
    compaction), K7 (emitting its ``deltas`` too when asked), summary.
    Returns (stream (W,) int32 big-endian, walk (dict of K7's per-lane
    outputs), summary (cap, 5) int32, counts (2,) int32), all on the
    device of ``words_le``, nothing synchronised."""
    stream, positions, _valid, _count, _win, fields, lane_of, walk_in, \
        counts = demux_front(words_le, n_bytes, ends, si_bps, T, nch, cap,
                             wcap)
    walk, end_bits, walk_ok = walk_frames(stream, *walk_in, T, nch, deltas)
    summary = pack_summary(positions, fields, lane_of, end_bits, walk_ok,
                           walk["n_parts"], walk["sa_words"], nch)
    return stream, walk, summary, counts


def _fetch_async(t):
    """Start a copy of ``t`` to the host: pinned memory and a non-blocking
    copy for a CUDA tensor, ``t`` itself for a CPU one."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class PendingDemux:
    """An in-flight fused demux: the kernels are queued and the summary and
    count copies started, so the round trip overlaps what the caller does
    before ``resolve()``. ``resolve`` waits for the copies and
    re-dispatches with a larger capacity class on the rare overflow."""

    def __init__(self, words_le, n_bytes, T, nch, ends, si_bps, cap, wcap,
                 deltas=False):
        self._key = (words_le, n_bytes, T, nch, ends, si_bps)
        self._deltas = deltas
        self._wcap_max = max_walk_lanes(T, nch)
        self._dispatch(cap, min(wcap, self._wcap_max))

    def _dispatch(self, cap, wcap):
        words_le, n_bytes, T, nch, ends, si_bps = self._key
        self.cap = cap
        self.wcap = wcap
        self.stream, self.walk, summary, counts = fused_demux_run(
            words_le, n_bytes, T, nch, ends, si_bps, cap, wcap, self._deltas)
        self._summary = _fetch_async(summary)
        self._counts = _fetch_async(counts)
        self._event = None
        if summary.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(summary.device))

    def resolve(self):
        """(summary (count rows, SUMMARY_COLS layout, int64 numpy), count):
        waits for the copies and unpacks the 5-word form. Raises
        DemuxOverflow past MAX_CAP or the walk-lane budget."""
        while True:
            if self._event is not None:
                self._event.synchronize()
            count, walk_count = (int(v) for v in self._counts.tolist())
            if count <= self.cap and walk_count <= self.wcap:
                return _unpack_summary(self._summary[:count].numpy()), count
            cap, wcap = self.cap, self.wcap
            while cap < count:
                cap *= 2
            while wcap < walk_count:
                wcap *= 2
            if cap > MAX_CAP or wcap > min(MAX_CAP, self._wcap_max):
                raise DemuxOverflow(
                    f"{count} sync candidates / {walk_count} walk lanes "
                    f"> cap {MAX_CAP} / {min(MAX_CAP, self._wcap_max)}")
            self._dispatch(cap, wcap)


def fused_demux_async(words_le, n_bytes, T, nch, stream_ends, si_bps,
                      frames_est=None, deltas=False):
    """Queue the fused demux of one group and start the summary copy.

    Args:
      words_le:    (W,) int32 little-endian word upload on the device.
      n_bytes:     bytes of the upload to scan (4 W).
      T, nch:      the group's block-size bucket and channel count.
      stream_ends: end byte of each stream in the upload (host ints).
      si_bps:      each stream's STREAMINFO bits per sample.
      frames_est:  frame-count estimate for the capacity classes, or None.
      deltas:      have K7 emit its per-code bit advances (``walk["deltas"]``)
                   for the segmented delta decode.
    """
    S = -(-max(len(stream_ends), 1) // S_QUANTUM) * S_QUANTUM
    ends = np.full(S, n_bytes, np.int32)
    ends[:len(stream_ends)] = stream_ends
    bps_a = np.ones(S, np.int32)
    bps_a[:len(si_bps)] = si_bps
    dev = words_le.device
    return PendingDemux(words_le, n_bytes, T, nch,
                        torch.from_numpy(ends).to(dev),
                        torch.from_numpy(bps_a).to(dev),
                        pick_cap(n_bytes, frames_est),
                        pick_wcap(n_bytes, frames_est), deltas)


def fused_demux(words_le, n_bytes, T, nch, stream_ends, si_bps,
                frames_est=None):
    """Synchronous form. Returns (stream_be, walk, summary (np, count
    rows), count)."""
    p = fused_demux_async(words_le, n_bytes, T, nch, stream_ends, si_bps,
                          frames_est)
    summary, count = p.resolve()
    return p.stream, p.walk, summary, count
