"""numpy models of the kernels of rice_decode (csrc/rice.cu) and
crc16_frames_device's windows kernel (csrc/crc_lanes.cu), step by step as
a launch runs them, held to the plain forms (CPU tensors) with tolerance
0 on every case of claxon_tpu_torch/testing/rice_crc_cases.py, its edge
cases included. The plain forms are held to the JAX package in
test_torch_rice_crc.py; the kernels themselves run on the card
(test_torch_cuda.py). No JAX here.

The rice model keeps each lane's ring of shared memory as it stands
between copies: a word is readable only once the cp.async group that
copies it has been waited for, and any other read gives a random word,
so a step that used a word the kernel had not landed would give a wrong
sample."""

import collections

import numpy as np
import pytest
import torch

from claxon_tpu_torch.ops import crc as tcrc
from claxon_tpu_torch.ops import rice as trice
from claxon_tpu_torch.testing import rice_crc_cases as cases

M32 = 0xFFFFFFFF
#: csrc/rice.cu's kRingWords, kAhead and kSlack.
RING_WORDS, AHEAD, SLACK = 128, 24, 8
#: csrc/crc_lanes.cu's kItemWords and kStepWords.
ITEM_WORDS, STEP_WORDS = 1024, 128


def _wrap32(x):
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _clz(x):
    return 32 - x.bit_length()


def _fsl(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the high word of (hi:lo) << (s & 31)."""
    s &= 31
    return ((hi << s) | (lo >> (32 - s))) & M32 if s else hi


def _zigzag(v):
    return _wrap32((v >> 1) ^ (-(v & 1) & M32))


class _Lane:
    """One lane's registers and ring (rice_kernel's per-thread state)."""

    def __init__(self, pos, k, n):
        self.pos, self.k, self.n = pos, k, n
        self.ok, self.fast = True, False
        self.c = 0  # the codes written in the chunk
        self.wi = self.off = self.issued = self.E = 0
        self.w = [0] * 5
        self.h = 0
        self.slot = [-1] * RING_WORDS  # the landed word in each slot
        self.pending = []              # (group, slot, word)


def _rice_kernel_model(words, start_bits, params, counts, T, rng):
    """rice_kernel, a warp of 32 lanes at a time: the refill at each
    chunk's top (restarts, fills of the 4-word units up to AHEAD past the
    cursor's unit, the commit and the wait for all groups but the newest,
    or for all of them after a restart, and the window of 5 words read
    again), then each lane's codes of the chunk, by actions on the ring
    (a code whose quotient ends within the 32 bits at the cursor, or 32
    or 64 zero bits passed) while its cursor's words lie below E, else on
    the global words (search / decode_code) from the start of the code.
    Returns (out, end_bits, flag, path counts)."""
    w = [int(x) & M32 for x in words]
    W = len(w)
    L = len(start_bits)
    out = np.zeros((L, T), np.int64)
    end = np.zeros(L, np.int64)
    flag = False
    stats = collections.Counter()

    def word_at(i):
        return w[min(max(i, 0), W - 1)]

    def search(pos):
        wi0 = pos >> 5
        masked = word_at(wi0) & (M32 >> (pos & 31))
        if masked or wi0 >= W:
            return wi0, masked, masked != 0
        k = wi0 + 1
        if k <= 0:
            if w[0]:
                return k, w[0], True
            k = 1
        for k in range(k, W):
            if w[k]:
                return k, w[k], True
        return None, 0, False

    def slow_step(pos, k):
        wi, m, found = search(pos)
        if not found:
            return 0, pos, False
        one = ((wi << 5) + _clz(m)) & M32
        q = (one - pos) & M32
        p = _wrap32(one + 1)
        off = p & 31
        window = (word_at(p >> 5) << off) & M32
        if off:
            window |= word_at((p >> 5) + 1) >> (32 - off)
        sh = (32 - k) & M32
        r = 0 if k == 0 or sh >= 32 else window >> sh
        v = (0 if (k & M32) >= 32 else (q << k) & M32) | r
        return _zigzag(v), _wrap32(one + 1 + k), True

    for l0 in range(0, L, 32):
        lanes = []
        for lane in range(32):
            live = l0 + lane < L
            n = int(counts[l0 + lane]) if live else 0
            lanes.append(_Lane(int(start_bits[l0 + lane]) if live else 0,
                               int(params[l0 + lane]) if live else 0,
                               min(max(n, 0), T)))
        group = 0

        def land(ln, keep):
            """Groups older than the newest ``keep`` land."""
            left = []
            for g, s, x in ln.pending:
                if g < group - keep:
                    ln.slot[s] = x
                else:
                    left.append((g, s, x))
            ln.pending = left

        def read(ln, i):
            if ln.slot[i & (RING_WORDS - 1)] == i:
                return w[i]
            return int(rng.integers(0, 1 << 32))

        for j0 in range(0, T, 32):
            act = [ln.ok and j0 < ln.n for ln in lanes]
            restart = [a and not ln.fast and 0 <= ln.k < 32 and ln.pos >= 0
                       and (ln.pos >> 5) <= W - SLACK
                       for a, ln in zip(act, lanes)]
            any_restart = any(restart)
            for a, rs, ln in zip(act, restart, lanes):
                if any_restart:
                    land(ln, 0)
                if rs:
                    ln.wi, ln.off = ln.pos >> 5, ln.pos & 31
                    ln.issued = ln.wi >> 2
                    ln.fast = True
                    stats["restart"] += 1
                ln.landed = ln.issued
                if ln.fast and a:
                    while ln.issued < (ln.wi >> 2) + AHEAD:
                        for i in range(4):
                            x = ln.issued * 4 + i
                            if x < W:
                                s = x & (RING_WORDS - 1)
                                ln.slot[s] = -1  # in flight
                                ln.pending.append((group, s, x))
                        ln.issued += 1
            group += 1  # the commit
            for ln in lanes:
                land(ln, 0 if any_restart else 1)
                ln.E = min(4 * (ln.issued if any_restart else ln.landed), W)
                if ln.fast:
                    ln.w = [read(ln, ln.wi + i) for i in range(5)]
                    ln.h = _fsl(ln.w[1], ln.w[0], ln.off)
            for lane, ln in enumerate(lanes):
                k, sh = ln.k, 32 - ln.k
                lim = ln.E - 3
                row, qa = [0] * 32, 0
                want = min(32, ln.n - j0)
                while ln.ok and ln.c < want:
                    if ln.fast and ln.wi <= lim:
                        # one action: a code within the 32 bits at the
                        # cursor, or 32 / 64 zero bits passed
                        wd = ln.w

                        def at(b):  # the 32 bits at bit b (< 96) of wd
                            return _fsl(wd[(b >> 5) + 1], wd[b >> 5], b)

                        zero = ln.h == 0
                        q0 = _clz(ln.h)
                        p = ln.off + q0 + 1
                        zz = zero and _fsl(wd[2], wd[1], ln.off) == 0
                        no = ln.off + (64 if zz else 32) if zero else p + k
                        if not zero:
                            r = at(p) >> sh if sh < 32 else 0
                            row[ln.c] = _zigzag((((qa + q0) & M32) << k
                                                 & M32) | r)
                            ln.c += 1
                            qa = 0
                            stats["fast"] += 1
                        else:
                            qa += 64 if zz else 32
                            stats["skip"] += 1
                        sl = no >> 5  # the window slides 0..2
                        ln.wi += sl
                        ln.off = no & 31
                        ln.w = wd[sl:sl + 3] + [read(ln, ln.wi + 3),
                                                read(ln, ln.wi + 4)]
                        ln.h = _fsl(ln.w[1], ln.w[0], ln.off)
                    else:
                        if ln.fast:  # off the ring, back at the code start
                            ln.fast = False
                            ln.pos = _wrap32(ln.wi * 32 + ln.off - qa)
                            stats["left in a zero run" if qa else
                                  "left the ring"] += 1
                            qa = 0
                        v, ln.pos, ln.ok = slow_step(ln.pos, k)
                        stats["global"] += 1
                        if ln.ok:
                            row[ln.c] = v
                            ln.c += 1
                assert qa == 0
                ln.c = 0
                if l0 + lane < L:
                    m = min(32, T - j0)
                    out[l0 + lane, j0:j0 + m] = row[:m]
        for lane, ln in enumerate(lanes):
            if l0 + lane < L:
                end[l0 + lane] = ln.wi * 32 + ln.off if ln.fast else ln.pos
            flag |= not ln.ok
    return out.astype(np.int32), end.astype(np.int32), flag, stats


def _rice_model(words, start_bits, params, counts, T):
    """The launch: rice_kernel, then rice_exact_kernel, which decodes the
    input again (the plain form: the JAX program's steps) when a lane ran
    off the buffer and returns at once otherwise."""
    rng = np.random.default_rng(0)
    out, end, flag, stats = _rice_kernel_model(words, start_bits, params,
                                               counts, T, rng)
    if flag:
        want = trice.rice_decode_plain(*(torch.from_numpy(
            np.ascontiguousarray(a, np.int32)) for a in (
                words, start_bits, params, counts)), T)
        out, end = want[0].numpy(), want[1].numpy()
    return out, end, flag, stats


def _rice_calls():
    calls = cases.rice_calls() + cases.rice_edge_calls()
    calls.append({"args": (*(cases.rice_stream(np.full(70, 300), seed=5,
                                               long_share=0.05)[k]
                             for k in ("words", "start_bits", "params",
                                       "counts")), 300),
                  "labels": {"70 partitions of 300 codes, 5% long": None}})
    return calls


RICE = _rice_calls()


@pytest.mark.parametrize("i", range(len(RICE)),
                         ids=[", ".join(c["labels"]) for c in RICE])
def test_rice_kernel_model_matches_plain(i):
    call = RICE[i]
    words, sb, ks, cs, T = call["args"]
    T = max(int(np.max(cs, initial=0)), 0) if T is None else T
    out, end, flag, stats = _rice_model(words, sb, ks, cs, T)
    want = trice.rice_decode_plain(*(torch.from_numpy(
        np.ascontiguousarray(a, np.int32)) for a in (words, sb, ks, cs)), T)
    assert np.array_equal(out, want[0].numpy())
    assert np.array_equal(end, want[1].numpy())
    if "values" in call:
        v = call["values"]
        assert np.array_equal(out[:v.shape[0], :v.shape[1]], v)
    # Only searches that run off the buffer (all-zero words, the zeroed
    # tail) raise the flag.
    assert flag == ("all-zero words: all lanes" in call["labels"] or
                    "zero tail: all lanes" in call["labels"])


def test_rice_kernel_model_takes_every_path():
    """The edge cases drive each path of the kernel: codes and zero-run
    actions on the ring, lanes that leave the ring in a zero run longer
    than it or at a code (codes that outrun its landed words, the
    buffer's end), the global path, and restarts of a ring mid-partition
    (cursors that enter the buffer, lanes after a zero run)."""
    rng = np.random.default_rng(0)
    seen = collections.Counter()
    for call in cases.rice_edge_calls():
        words, sb, ks, cs, T = call["args"]
        *_, flag, stats = _rice_kernel_model(words, sb, ks, cs, T, rng)
        assert not flag
        seen.update(stats)
    assert min(seen[p] for p in ("fast", "skip", "left the ring",
                                 "left in a zero run", "global")) > 0, seen
    n_lanes = sum(len(c["args"][1]) for c in cases.rice_edge_calls())
    assert seen["restart"] > n_lanes, seen  # some lanes start again


def _windows_model(stream, starts, ends, n_words, vec):
    """crc16_windows_kernel of csrc/crc_lanes.cu, an item at a time, the
    32 lanes as numpy vectors: the kept count m = clamp(ends - starts, 0,
    4 n) (the message: the window's last ceil(m / 4) words, the first one's
    leading bytes masked), items of ITEM_WORDS window words aligned to its
    end, steps of STEP_WORDS end-aligned to the item, 4 window words a
    lane from its 16-byte group of stream words and the next one (lane t
    + 1's, shuffled; lane 31 takes lane 0's of the next step, or lane 0's
    load after the item), the groups read as aligned loads that must lie
    in the stream (``vec``) or with each index clipped, the words
    selected by (q0 + n) mod 4 and funnel-shifted by 8 (ends mod 4),
    slice-by-4, the
    lane states carried with M_9 and joined with M_4..M_8, each item
    shifted across the items after it (M_12 and up) and xored into its
    range (zeroed first)."""
    tab = tcrc.kernel_tables().astype(np.int64)
    Tb = tab[:1024].reshape(4, 256)
    M = tab[1024:].reshape(tcrc.LEVELS, 2, 256)

    def shift(k, c):
        return M[k, 0][c & 255] ^ M[k, 1][c >> 8]

    S = len(stream)
    u = stream.astype(np.int64) & M32
    lane = np.arange(32, dtype=np.int64)
    n = int(n_words)
    J = -(-n // ITEM_WORDS)

    def group(g):
        i = 4 * g[:, None] + np.arange(4)[None, :]
        fits = (i[:, 0] >= 0) & (i[:, 3] < S)
        if vec:
            # the aligned load, where the kernel takes it
            got = np.where(fits[:, None], u[np.where(fits[:, None], i, 0)],
                           u[np.clip(i, 0, S - 1)])
        else:
            got = u[np.clip(i, 0, S - 1)]
        return got

    out = np.zeros(len(starts), np.int64)
    for f in range(len(starts)):
        e, st = int(ends[f]), int(starts[f])
        m = min(max(e - st, 0), 4 * n)
        nm = (m + 3) >> 2
        for j in range(J):
            if ITEM_WORDS * j >= nm:
                continue
            s_lo = n - nm
            lead_mask = M32 >> (8 * (4 * nm - m))
            item_end = n - ITEM_WORDS * j
            item_start = max(item_end - ITEM_WORDS, s_lo)
            n_steps = -(-(item_end - item_start) // STEP_WORDS)
            q0 = _wrap32(e - 4 * n) >> 2
            r8 = 8 * (e & 3)
            sb0 = item_end - STEP_WORDS * n_steps + 4 * lane
            delta = (q0 + sb0) & 3
            assert (delta == delta[0]).all()
            delta = int(delta[0])
            # every step's groups (lanes whose words all precede the
            # message load none), and lane 0's group after the item
            X = []
            for i in range(n_steps):
                sb = sb0 + STEP_WORDS * i
                live = sb + 3 >= s_lo
                X.append(np.where(live[:, None], group((q0 + sb) >> 2), 0))
            Z = group(np.array([(q0 + item_end) >> 2]))[0]
            acc = np.zeros(32, np.int64)
            for i in range(n_steps):
                sb = sb0 + STEP_WORDS * i
                # the next group: lane t + 1's, for lane 31 lane 0's of
                # the next step (Z after the last)
                nxt = X[i + 1][0] if i + 1 < n_steps else Z
                Y = np.concatenate([X[i][1:], nxt[None, :]])
                z = np.concatenate([X[i], Y], axis=1)
                d = sb - s_lo
                c = np.clip(d, -4, 1)
                state = np.zeros(32, np.int64)
                for k in range(4):
                    hi, lo = z[:, delta + k], z[:, delta + k + 1]
                    wd = ((hi << r8) | (lo >> (32 - r8))) & M32 if r8 else hi
                    wd = np.where(c + k < 0, 0,
                                  np.where(c + k == 0, wd & lead_mask, wd))
                    x = wd ^ (state << 16)
                    state = Tb[3][x >> 24] ^ Tb[2][(x >> 16) & 255] ^ \
                        Tb[1][(x >> 8) & 255] ^ Tb[0][x & 255]
                acc = shift(9, acc) ^ state
            for d in range(5):
                acc = shift(4 + d, acc) ^ np.concatenate(
                    [acc[1 << d:], acc[32 - (1 << d):]])
            crc = int(acc[0])
            for b in range(j.bit_length()):
                if (j >> b) & 1:
                    crc = int(shift(12 + b, np.int64(crc)))
            out[f] ^= crc
    return out.astype(np.int32)


WINDOWS = cases.crc16_windows_calls() + cases.crc16_windows_edge_calls()
# The seed-21 ranges at the other window sizes: 2 words, and 4096 (four
# items of 4 KB).
WINDOWS += [{"args": (*WINDOWS[0]["args"][:3], n_words),
             "labels": {f"seed 21 ranges, n_words {n_words}": None}}
            for n_words in (2, 4096)]


@pytest.mark.parametrize("vec", [True, False], ids=["aligned", "clipped"])
@pytest.mark.parametrize("i", range(len(WINDOWS)),
                         ids=[", ".join(c["labels"]) for c in WINDOWS])
def test_windows_kernel_model_matches_plain(i, vec):
    stream, starts, ends, n_words = WINDOWS[i]["args"]
    want = tcrc.crc16_frames_device_plain(
        torch.from_numpy(stream), torch.from_numpy(starts),
        torch.from_numpy(ends), n_words).numpy()
    got = _windows_model(stream, starts, ends, n_words, vec)
    assert np.array_equal(got, want)


def test_windows_kept_bytes_are_a_suffix():
    """The kernel reads only the window's last clamp(ends - starts, 0,
    4 n) bytes: every byte the JAX formula keeps (int32 positions that
    wrap) is among them and every one of them is kept, for ranges near
    both int32 extremes and at every n_words."""
    rng = np.random.default_rng(3)
    lo, hi = cases.INT32_MIN, cases.INT32_MAX
    for n in (1, 2, 4, 1024, 1 << 20):
        e = np.concatenate([rng.integers(lo, lo + 4 * n + 8, 200),
                            rng.integers(hi - 8, hi + 1, 20),
                            rng.integers(lo, hi, 200)])
        s = np.concatenate([e[:220] - rng.integers(-9, 4 * n + 9, 220),
                            rng.integers(lo, hi, 200)])
        s = np.clip(s, lo, hi)
        for a, b in zip(s.tolist(), e.tolist()):
            i = np.unique(np.concatenate([
                np.arange(min(64, 4 * n)),
                np.arange(max(0, 4 * n - 64), 4 * n),
                rng.integers(0, 4 * n, 64)]))
            p = (b - 4 * n + i + (1 << 31)) % (1 << 32) - (1 << 31)
            keep = (p >= a) & (p < b)
            m = min(max(b - a, 0), 4 * n)
            assert np.array_equal(keep, i >= 4 * n - m), (n, a, b)
