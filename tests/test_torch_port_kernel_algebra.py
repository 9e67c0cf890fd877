"""PyTorch port: the arithmetic and the index maps the CUDA kernels of
``csrc/*.cu`` rely on, modelled here in numpy and held exactly against the
plain versions on the CPU.

The kernels themselves run only on a card (``tests/test_torch_port_cuda.py``);
these models repeat their algebra step by step -- the thresholded median as
a majority count, the close as OR/AND of shifted rows, the van Herk window
max over a ring of frames, the reciprocal floor mean, the byte permutes and
packed-lane tricks, the vote's theta runs, passes, rounds of points and
drain, the pick's thread-to-column map, and the peak ladder's rows,
halo shuffles and rung histogram -- so that a wrong identity fails here,
without a card.
"""

import numpy as np
import pytest
import torch

from metdetpy_tpu_torch.ops import f32, filters, kernels

torch.set_num_threads(2)

SEED = 20261016


@pytest.fixture()
def nrng():
    return np.random.default_rng(SEED)


# -- models of the kernels' helpers -------------------------------------------


def byte_perm(a, b, sel: int):
    """CUDA's __byte_perm(a, b, sel) for selectors with nibbles 0..7."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    src = [(a >> np.uint64(8 * i)) & np.uint64(255) for i in range(4)]
    src += [(b >> np.uint64(8 * i)) & np.uint64(255) for i in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for k in range(4):
        out |= src[(sel >> (4 * k)) & 7] << np.uint64(8 * k)
    return out


def even_bytes(x):
    return byte_perm(x, 0, 0x4240)


def odd_bytes(x):
    return byte_perm(x, 0, 0x4341)


def join_bytes(e, o):
    return byte_perm(e, o, 0x6240)


def sub_bytes(a, b):
    """Per-byte (a - b) mod 256, as window_diff.cu's sub_bytes."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    hi = np.uint64(0x80808080)
    return ((((a | hi) - (b & np.uint64(0x7F7F7F7F))) & m32)
            ^ ((a ^ (~b & m32)) & hi))


def to_words(row):
    """uint8 [..., 4k] -> little-endian uint32 words [..., k] (as uint64)."""
    return np.ascontiguousarray(row).view("<u4").astype(np.uint64)


def from_words(words):
    return np.ascontiguousarray(words.astype("<u4")).view(np.uint8)


def above(x, thr: int):
    """median_binarize_close.cu's above(): 1 in each byte of the words x
    where the byte exceeds thr, as the carry out of byte + (255 - thr):
    majority of the two top bits and the carry into bit 7."""
    x = np.asarray(x, np.uint64)
    low7, ones = np.uint64(0x7F7F7F7F), np.uint64(0x01010101)
    c = np.uint64((255 - thr) * 0x01010101)
    s = (x & low7) + (c & low7)
    return (((x & c) | (x & s) | (c & s)) >> np.uint64(7)) & ones


def binary_by_count(img: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """binary_threshold(median3x3(img), thr) as median_binarize_close.cu
    forms it, with no median: threshold every pixel (above(), on words),
    count the pixels above thr over the 3x3 window with the replicated
    border -- three rows added, then each column and its two neighbours --
    and take bit 7 of count + 123 (set exactly when count >= 5), 0x80."""
    t, h, w = img.shape
    pad = np.pad(img, [(0, 0), (1, 1), (1, 1)], mode="edge")
    wp = -(-(w + 2) // 4) * 4
    pad = np.pad(pad, [(0, 0), (0, 0), (0, wp - (w + 2))])
    g = np.stack([from_words(above(to_words(pad[i]), int(thr[i])))
                  .reshape(h + 2, wp) for i in range(t)]).astype(np.int64)
    vert = g[:, :-2] + g[:, 1:-1] + g[:, 2:]
    cnt = vert[..., :w] + vert[..., 1:w + 1] + vert[..., 2:w + 2]
    return ((cnt + 123) & 0x80).astype(np.uint8)


def close_or_and(binary: np.ndarray, on: int = 0x80) -> np.ndarray:
    """close3x3 of a binary frame whose set bytes hold ``on`` (0x80 in the
    kernel), as the kernel takes it: dilate = OR of the three rows, then of
    the row shifted one byte each way (0 outside the frame); erode = AND
    likewise (``on`` outside the frame)."""
    def spread(x, fill, op):
        pad = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)],
                     constant_values=fill)
        v = op(op(pad[..., :-2, :], pad[..., 1:-1, :]), pad[..., 2:, :])
        return op(op(v[..., :-2], v[..., 1:-1]), v[..., 2:])
    return spread(spread(binary, 0, np.bitwise_or), on, np.bitwise_and)


def wd_model(history, frames, n, timer0, stages=5):
    """window_diff.cu's per-thread loop, vectorised over pixels: a ring of
    n + stages + 1 frame slots, van Herk suffix maxima at each segment's
    first output, a running prefix max, running sums and the reciprocal
    floor mean. Returns (diff, new_hist)."""
    t_block = frames.shape[0]
    seq = np.concatenate([history, frames]).astype(np.int64)
    n_total = seq.shape[0]
    ring_n = n + stages + 1
    ring = np.zeros((ring_n,) + seq.shape[1:], np.int64)
    sfx = np.zeros((n,) + seq.shape[1:], np.int64)
    for i in range(min(stages, n_total)):
        ring[i] = seq[i]
    diff = np.zeros_like(frames)
    new_hist = np.zeros_like(history)
    total = np.zeros(seq.shape[1:], np.int64)
    pfx = np.zeros_like(total)
    slot_x, slot_l, slot_f, j = 0, ring_n - n, stages, 0
    for e in range(n_total):
        x = ring[slot_x].copy()
        leave = ring[slot_l].copy() if e >= n else np.zeros_like(x)
        if e + stages < n_total:
            ring[slot_f] = seq[e + stages]
        if e >= t_block:
            new_hist[e - t_block] = x
        total += x - leave
        if e >= n - 1:
            t = e - (n - 1)
            if j == 0:
                acc = x.copy()
                sfx[n - 1] = acc
                s = slot_x
                for q in range(n - 2, -1, -1):
                    s = ring_n - 1 if s == 0 else s - 1
                    acc = np.maximum(acc, ring[s])
                    sfx[q] = acc
                win_max = acc
                pfx[:] = 0
            else:
                pfx = np.maximum(pfx, x)
                win_max = np.maximum(sfx[j], pfx)
            j = 0 if j + 1 == n else j + 1
            length = min(timer0 + 1 + t, n)
            mul = (2 ** 32 + length - 1) // length
            q = (total * mul) >> 32 if length > 1 else total
            diff[t] = ((win_max - q) & 255).astype(np.uint8)
        slot_x = (slot_x + 1) % ring_n
        slot_l = (slot_l + 1) % ring_n
        slot_f = (slot_f + 1) % ring_n
    return diff, new_hist


# -- (a) the thresholded median as a majority count --------------------------


@pytest.mark.parametrize("levels", [256, 3, 2])
@pytest.mark.parametrize("shape", [(4, 23, 37), (2, 1, 9), (2, 7, 1),
                                   (1, 2, 2)])
def test_median_above_thr_is_majority_count(nrng, levels, shape):
    """median3x3 > thr exactly where at least 5 of the 9 window pixels
    (replicated border) are above thr, on random frames and on frames of
    few distinct values (ties), at thresholds 0, 255 and on the values."""
    img = nrng.integers(0, levels, shape).astype(np.uint8) * (255 // max(
        levels - 1, 1))
    thr = img.reshape(shape[0], -1)[:, 0].copy()
    thr[0], thr[-1] = 0, 255 if shape[0] > 1 else thr[-1]
    want = filters.binary_threshold(
        filters.median3x3(torch.from_numpy(img)),
        torch.from_numpy(thr)[:, None, None]).numpy()
    np.testing.assert_array_equal(binary_by_count(img, thr) // 0x80 * 255,
                                  want)


# -- (b) close as OR / AND ----------------------------------------------------


@pytest.mark.parametrize("density", [0.05, 0.5, 0.95])
@pytest.mark.parametrize("shape", [(3, 19, 33), (1, 1, 5), (1, 4, 1)])
def test_close_of_binary_is_or_then_and(nrng, density, shape):
    """close3x3 of a {0, 255} frame == OR / AND of shifted rows on the
    kernel's {0, 0x80} bytes, then (byte >> 7) * 255."""
    binary = np.where(nrng.random(shape) < density, 255, 0).astype(np.uint8)
    want = filters.close3x3(torch.from_numpy(binary)).numpy()
    got = (close_or_and(binary & 0x80) >> 7) * 255
    np.testing.assert_array_equal(got, want)


def test_above_is_the_carry_of_byte_plus_complement():
    """above(): for every byte value and every threshold, 1 exactly where
    the byte exceeds the threshold, in each byte of the word."""
    vals = np.arange(256, dtype=np.uint64)
    words = (vals | (vals[::-1] << np.uint64(8)) | (vals << np.uint64(16))
             | (vals[::-1] << np.uint64(24)))
    for thr in range(256):
        got = above(words, thr)
        for byte, v in enumerate((vals, vals[::-1], vals, vals[::-1])):
            np.testing.assert_array_equal(
                (got >> np.uint64(8 * byte)) & np.uint64(255),
                (v > thr).astype(np.uint64))


# -- (c) van Herk window max, ring of frames, reciprocal mean -----------------


@pytest.mark.parametrize("timer0", [0, 10_000])
@pytest.mark.parametrize("n", [1, 2, 5, 25, 60, 100])
def test_van_herk_ring_model_equals_plain(nrng, n, timer0):
    """window_diff.cu's loop (ring slots, segment suffix maxima, running
    prefix max, running sums, reciprocal mean) at T = 64 with history ==
    the sliding max seq.unfold(0, n, 1).amax(-1) and window_diff_plain."""
    t_block, pix = 64, 40
    history = nrng.integers(0, 256, (n - 1, 1, pix), dtype=np.uint8)
    frames = nrng.integers(0, 256, (t_block, 1, pix), dtype=np.uint8)
    diff, new_hist = wd_model(history, frames, n, timer0)
    want, want_hist = kernels.window_diff_plain(
        torch.from_numpy(history), torch.from_numpy(frames), n, timer0)
    np.testing.assert_array_equal(diff, want.numpy())
    np.testing.assert_array_equal(new_hist, want_hist.numpy())
    # the max alone, with the mean taken out
    seq = torch.from_numpy(np.concatenate([history, frames]))
    sliding = seq.unfold(0, n, 1).amax(-1).numpy()
    win_max = (diff.astype(np.int64) + _floor_means(seq.numpy(), n, timer0,
                                                    t_block)) & 255
    np.testing.assert_array_equal(win_max, sliding)


def _floor_means(seq, n, timer0, t_block):
    cs = np.concatenate([[np.zeros(seq.shape[1:], np.int64)],
                         np.cumsum(seq.astype(np.int64), 0)])
    sums = cs[n:] - cs[:-n]
    lengths = np.minimum(timer0 + 1 + np.arange(t_block), n)
    return sums // lengths[:, None, None]


@pytest.mark.parametrize("n,t_block,timer0", [(100, 1, 0), (60, 1, 3),
                                               (25, 3, 7), (7, 64, 2)])
def test_van_herk_ring_model_short_blocks(nrng, n, t_block, timer0):
    """History longer than the block (n - 1 > T) and warm-up lengths."""
    history = nrng.integers(0, 256, (n - 1, 2, 9), dtype=np.uint8)
    frames = nrng.integers(0, 256, (t_block, 2, 9), dtype=np.uint8)
    diff, new_hist = wd_model(history, frames, n, timer0)
    want, want_hist = kernels.window_diff_plain(
        torch.from_numpy(history), torch.from_numpy(frames), n, timer0)
    np.testing.assert_array_equal(diff, want.numpy())
    np.testing.assert_array_equal(new_hist, want_hist.numpy())


# -- (d) reciprocal floor mean ------------------------------------------------


@pytest.mark.parametrize("first,last", [(2, 384), (385, 768), (769, 1152),
                                        (1153, 1536)])
def test_reciprocal_floor_mean_is_exact(first, last):
    """The high word of sum * ceil(2^32 / len) (__umulhi) == sum // len for
    every 2 <= len <= 1536 and every sum <= 1536 * 255 (a window of up to
    1536 u8 frames); len == 1 takes the sum itself."""
    x = np.arange(1536 * 255 + 1, dtype=np.uint64)
    for d in range(first, last + 1):
        mul = np.uint64((2 ** 32 + d - 1) // d)
        assert mul < 2 ** 32
        q = (x * mul) >> np.uint64(32)
        d = np.uint64(d)
        bad = (q * d > x) | ((q + 1) * d <= x)
        assert not bad.any(), (d, int(x[bad][0]))


# -- (e) byte permutes and packed-lane tricks ---------------------------------


def test_byte_pair_split_and_join(nrng):
    x = nrng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    e, o = even_bytes(x), odd_bytes(x)
    np.testing.assert_array_equal(join_bytes(e, o), x)
    for lane, byte in ((0, 0), (1, 2)):
        np.testing.assert_array_equal(
            (e >> np.uint64(16 * lane)) & np.uint64(0xFFFF),
            (x >> np.uint64(8 * byte)) & np.uint64(0xFF))
        np.testing.assert_array_equal(
            (o >> np.uint64(16 * lane)) & np.uint64(0xFFFF),
            (x >> np.uint64(8 * byte + 8)) & np.uint64(0xFF))


def test_neighbour_permutes_shift_a_row_by_one_byte(nrng):
    """0x6543 / 0x4321 give each byte's left / right neighbour (the count
    and the close of median_binarize_close.cu)."""
    row = nrng.integers(0, 256, 64, dtype=np.uint8)
    words = to_words(row)
    prev, cur, nxt = words[:-2], words[1:-1], words[2:]
    left = from_words(byte_perm(prev, cur, 0x6543))
    right = from_words(byte_perm(cur, nxt, 0x4321))
    np.testing.assert_array_equal(left, row[3:-5])
    np.testing.assert_array_equal(right, row[5:-3])


def test_sub_bytes_and_mean_packing(nrng):
    """sub_bytes is per-byte subtraction mod 256, and the 0x0040 / 0x5410
    permutes pack the low bytes of four means into one word."""
    a = nrng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    b = nrng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    want = np.zeros_like(a)
    for i in range(4):
        s = np.uint64(8 * i)
        want |= ((((a >> s) & np.uint64(255)) - ((b >> s) & np.uint64(255)))
                 & np.uint64(255)) << s
    np.testing.assert_array_equal(sub_bytes(a, b), want)
    q = nrng.integers(0, 400_000, (4, 4096), dtype=np.uint64)
    packed = byte_perm(byte_perm(q[0], q[1], 0x0040),
                       byte_perm(q[2], q[3], 0x0040), 0x5410)
    want = sum((q[i] & np.uint64(255)) << np.uint64(8 * i) for i in range(4))
    np.testing.assert_array_equal(packed, want)


# -- (f) hough_vote.cu: theta runs, passes, rounds of points, drain -----------
#
# The kernel's launch geometry, modelled on the CPU with small sizes: a block
# takes one frame and the theta run [g*180//G, (g+1)*180//G), works through
# it in passes of th_pass thetas into two histograms in turn, holds the
# points in per-thread slots (slot k of thread (warp, lane) is point
# (warp + k*warps)*32 + lane of a round), and drains a finished histogram
# word by word (thread tid takes words tid, tid + threads, ...), leaving it
# zero.


def theta_runs(groups: int) -> list:
    return [(g * 180 // groups, (g + 1) * 180 // groups)
            for g in range(groups)]


def slot_points(m: int, threads: int, pts: int) -> np.ndarray:
    """[threads, pts] point index of each slot of a round of m points, -1
    where the slot is past the end."""
    warps = threads // 32
    tid = np.arange(threads)
    lane, warp = tid % 32, tid // 32
    i = (warp[:, None] + np.arange(pts)[None, :] * warps) * 32 + lane[:, None]
    return np.where(i < m, i, -1)


def rho_bins(xs, ys, n_rho: int, off: int) -> np.ndarray:
    """[T, 180, N] bins, with the plain version's arithmetic."""
    from metdetpy_tpu_torch.ops.f32 import fma_f32, trig_tables
    cos_t, sin_t = trig_tables(torch.device("cpu"))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    rho = fma_f32(cos_t[None, :, None], x[:, None, :],
                  sin_t[None, :, None] * y[:, None, :]) + float(off)
    return torch.clamp(torch.round(rho).to(torch.int64), 0,
                       n_rho - 1).numpy()


def vote_model(xs, ys, valid, n_rho, off, groups, th_pass, threads=64,
               pts=2, aggregate=False) -> np.ndarray:
    """hough_vote.cu block by block. aggregate: the counts of a warp's 32
    points are merged per bin before they are added (HV_MATCH)."""
    t_block, n = xs.shape
    q_all = rho_bins(xs, ys, n_rho, off)
    votes = np.full((t_block, 180, n_rho), -7, np.int64)   # all overwritten
    round_pts = threads * pts
    for t in range(t_block):
        for th0, th1 in theta_runs(groups):
            hist = np.zeros((2, th_pass * n_rho), np.int64)
            drain = None                        # (buffer, first theta, count)

            def run_drain():
                buf, c0, th = drain
                words = np.arange(th * n_rho)
                # thread tid takes words tid + j*threads: each word once
                owner = words % threads
                assert np.bincount(owner, minlength=threads).sum() == len(
                    words)
                votes[t, c0:c0 + th] = hist[buf, words].reshape(th, n_rho)
                hist[buf, words] = 0

            for p, c0 in enumerate(range(th0, th1, th_pass)):
                th = min(th_pass, th1 - c0)
                h = hist[p & 1]
                assert not h.any()              # clean when its pass begins
                for r0 in range(0, n, round_pts):
                    idx = slot_points(min(round_pts, n - r0), threads, pts)
                    for k in range(pts):
                        for w in range(threads // 32):
                            i = idx[w * 32:(w + 1) * 32, k]
                            i = i[i >= 0] + r0
                            i = i[valid[t, i]]
                            # the missing thetas of a short last pass vote
                            # into rows that are never stored
                            for j in range(th_pass):
                                c = min(c0 + j, 179)
                                bins = q_all[t, c, i] + j * n_rho
                                if aggregate:
                                    b, cnt = np.unique(bins,
                                                       return_counts=True)
                                    h[b] += cnt
                                else:
                                    np.add.at(h, bins, 1)
                if drain is not None:
                    run_drain()                 # between this pass's votes
                drain = (p & 1, c0, th)
            if drain is not None:
                run_drain()
    return votes


def raster_points(rng, t_block, n, w=96, h=54, density=0.05):
    """Compacted raster-ordered points of random masks with a streak."""
    xs = np.zeros((t_block, n), np.float32)
    ys = np.zeros((t_block, n), np.float32)
    valid = np.zeros((t_block, n), bool)
    for t in range(t_block):
        mask = rng.random((h, w)) < density
        d = np.arange(min(h, w) - 4)
        mask[d + 2, d + 2] = mask[d + 3, d + 2] = True
        yy, xx = np.nonzero(mask)
        m = min(n, len(xx)) if t != 1 else 0    # frame 1 is empty
        xs[t, :m], ys[t, :m], valid[t, :m] = xx[:m], yy[:m], True
    return xs, ys, valid


@pytest.mark.parametrize("aggregate", [False, True])
@pytest.mark.parametrize("order", ["random", "raster"])
@pytest.mark.parametrize("groups,th_pass,n", [(3, 4, 200), (16, 4, 128),
                                               (45, 3, 77), (7, 1, 130)])
def test_vote_by_runs_passes_and_rounds_equals_plain(nrng, aggregate, order,
                                                     groups, th_pass, n):
    """Voting per theta run in passes of th_pass thetas, the points walked
    in rounds of 128 held in per-thread slots, counts added one by one or
    merged per (warp of 32 consecutive points, bin), and each pass drained
    out of its histogram == hough_vote_plain; with partial and empty
    frames."""
    t_block, w, h = 3, 96, 54
    n_rho, off = 384, w + h
    if order == "raster":
        xs, ys, valid = raster_points(nrng, t_block, n, w, h)
    else:
        xs = nrng.integers(0, w, (t_block, n)).astype(np.float32)
        ys = nrng.integers(0, h, (t_block, n)).astype(np.float32)
        valid = np.arange(n)[None, :] < np.array([n, 0, n // 3])[:, None]
    got = vote_model(xs, ys, valid, n_rho, off, groups, th_pass,
                     aggregate=aggregate)
    want = kernels.hough_vote_plain(
        torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(valid),
        n_rho, off)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n_sm", [1, 16, 108, 132, 144, 1000])
def test_theta_runs_cover_each_theta_once(n_sm):
    """For every block count the plan can choose (any T, any SM count) the
    runs [g*180//G, (g+1)*180//G) are disjoint, in order, non-empty and
    cover 0..179; cut into passes of 1..4 thetas they still do."""
    for t_block in range(1, 260):
        groups, th_pass = kernels.vote_plan(t_block, 3072, n_sm)
        assert 1 <= groups <= 180 and groups * t_block <= max(n_sm, t_block)
        runs = theta_runs(groups)
        assert runs[0][0] == 0 and runs[-1][1] == 180
        assert all(a < b for a, b in runs)
        assert all(runs[i][1] == runs[i + 1][0] for i in range(groups - 1))
        for th in range(1, th_pass + 1):
            seen = [c for a, b in runs for c0 in range(a, b, th)
                    for c in range(c0, min(c0 + th, b))]
            assert seen == list(range(180))


@pytest.mark.parametrize("n_rho", [1, 128, 3072, 6016, 7219, 7220, 14000,
                                   kernels.MAX_VOTE_RHO])
def test_vote_plan_fits_shared_memory(n_rho):
    """Two histograms of th_pass thetas fit the block's shared memory, with
    as many thetas (up to VOTE_THETAS) as fit; above MAX_VOTE_RHO the plan
    refuses."""
    _, th_pass = kernels.vote_plan(8, n_rho, 132)
    assert 1 <= th_pass <= kernels.VOTE_THETAS
    assert 8 * th_pass * n_rho <= kernels.VOTE_SMEM
    assert (th_pass == kernels.VOTE_THETAS
            or 8 * (th_pass + 1) * n_rho > kernels.VOTE_SMEM)
    with pytest.raises(ValueError):
        kernels.vote_plan(8, kernels.MAX_VOTE_RHO + 1, 132)


@pytest.mark.parametrize("m", [0, 1, 31, 32, 100, 8191, 8192])
def test_point_slots_cover_a_round_once(m):
    """Slot k of thread (warp, lane) holds point (warp + k*warps)*32 + lane:
    over 1024 threads of 8 slots every point of a round of m <= 8192 lies
    in exactly one slot, and a warp's slot holds 32 consecutive points."""
    idx = slot_points(m, 1024, 8)
    held = np.sort(idx[idx >= 0])
    np.testing.assert_array_equal(held, np.arange(m))
    assert 1024 * 8 == kernels.VOTE_ROUND
    by_warp = idx.reshape(32, 32, 8)          # [warp, lane, slot]
    full = (by_warp >= 0).all(1)              # [warp, slot]
    run = by_warp - by_warp[:, :1, :]
    np.testing.assert_array_equal(
        run.transpose(0, 2, 1)[full],
        np.broadcast_to(np.arange(32), (int(full.sum()), 32)))


@pytest.mark.parametrize("end", [0, 1, 1023, 1024, 4097, 12288, 12289])
@pytest.mark.parametrize("step_words", [1, 2, 4])
def test_drain_steps_take_each_word_once(end, step_words):
    """A drain step of thread tid takes words at + q*threads (q <
    step_words, at = tid + step*step_words*threads) below end: over all
    threads and steps every word of [0, end) exactly once."""
    threads = 1024
    taken = []
    for tid in range(0, threads):
        at = tid
        while at < end:
            taken += [at + q * threads for q in range(step_words)
                      if at + q * threads < end]
            at += step_words * threads
    assert sorted(taken) == list(range(end))


# -- (g) walk_pick.cu: (block, thread, column-of-4) -> (t, k, c) -------------


def pick_model(planes, r, xmaj, cols=4):
    """walk_pick.cu: block tk = frame*K + peak, thread x takes columns
    x*cols .. x*cols + cols - 1 and strides by blockDim*cols; the vector
    path where S % cols == 0, else one column per thread."""
    t_block, k, s = r.shape
    per = cols if s % cols == 0 else 1
    threads = min(1024, -(-(-(-s // per)) // 32) * 32)
    out = np.full((t_block, k, s), -7, np.int64)
    flat_r, flat_out = r.reshape(-1), out.reshape(-1)
    for tk in range(t_block * k):
        t = tk // k
        plane = planes[t, 0 if xmaj.reshape(-1)[tk] else 1]
        for x in range(threads):
            for c in range(x * per, s, threads * per):
                for j in range(per):
                    row = int(flat_r[tk * s + c + j])
                    inside = 0 <= row < s
                    assert flat_out[tk * s + c + j] == -7    # written once
                    flat_out[tk * s + c + j] = (plane[row, c + j]
                                                if inside else 0)
    return out


@pytest.mark.parametrize("t_block,k,s", [(2, 1, 128), (1, 5, 256),
                                         (3, 7, 384), (1, 2, 1152),
                                         (1, 1, 4224), (2, 3, 200),
                                         (1, 3, 130)])
def test_pick_index_map_equals_flat_index(nrng, t_block, k, s):
    """The pick's (block, thread, column of 4) map writes every (t, k, c)
    once, for ragged K, every kind of S (multiples of 128 up to beyond
    1024 threads * 4 columns, and sizes that take the one-column path), and
    equals walk_pick_plain, rows outside [0, S) giving 0."""
    planes = nrng.integers(0, 16, (t_block, 2, s, s), dtype=np.uint8)
    r = nrng.integers(-(s // 4), s + s // 4, (t_block, k, s)).astype(np.int32)
    r[0, 0, :7] = [-1, s, s - 1, 0, -2 ** 31, 2 ** 31 - 1, s + 1]
    xmaj = nrng.random((t_block, k)) < 0.5
    want = kernels.walk_pick_plain(torch.from_numpy(planes),
                                   torch.from_numpy(r),
                                   torch.from_numpy(xmaj)).numpy()
    np.testing.assert_array_equal(pick_model(planes, r, xmaj), want)
    outside = (r < 0) | (r >= s)
    assert not want[outside].any()


@pytest.mark.parametrize("fill", ["negative", "beyond"])
def test_pick_rows_outside_the_plane_give_zero(nrng, fill):
    from metdetpy_tpu_torch.ops import kernel_cases
    case = next(c for c in kernel_cases.PICK_CASES if c[4] == fill)
    planes, r, xmaj = kernel_cases.pick_case(case, "cpu", SEED)
    assert not kernels.walk_pick(planes, r, xmaj).any()


def ladder_model(votes, threshold, cuts, vec: bool, rows: int = 4,
                 threads: int = 128):
    """csrc/peak_ladder.cu block by block: a thread's kBins columns of a
    run of ``rows`` theta rows and the rows around it (INT32_MIN outside
    the plane), its halo columns from the lanes beside it (shuffles) or,
    on a warp's edge lanes, loaded; the 3x3 max as rows, then columns; each
    block's rung histogram added into the count."""
    t, n_theta, n_rho = votes.shape
    bins = 4 if vec else 1
    lo = np.iinfo(np.int32).min
    is_peak = np.full((t, n_theta * n_rho), 7, np.uint8)    # 7: unwritten
    count = np.zeros((t, len(cuts) + 1), np.int64)
    lane = np.arange(threads) % 32
    per_block = threads * bins
    for b in range(t):
        for by in range(-(-n_theta // rows)):
            th0 = by * rows
            for bx in range(-(-n_rho // per_block)):
                c0 = (bx * threads + np.arange(threads)) * bins
                active = c0 < n_rho
                v = np.full((rows + 2, threads, bins + 2), lo, np.int64)
                for i in range(rows + 2):
                    th = th0 - 1 + i
                    if not 0 <= th < n_theta:
                        continue
                    row = votes[b, th]
                    for j in range(bins):
                        v[i, active, 1 + j] = row[c0[active] + j]
                    left = (lane == 0) & (c0 > 0) & (c0 <= n_rho)
                    v[i, left, 0] = row[c0[left] - 1]
                    right = (lane == 31) & (c0 + bins < n_rho)
                    v[i, right, bins + 1] = row[c0[right] + bins]
                    up = np.roll(v[i, :, bins], 1)        # lane - 1's last
                    down = np.roll(v[i, :, 1], -1)        # lane + 1's first
                    v[i, lane != 0, 0] = up[lane != 0]
                    v[i, lane != 31, bins + 1] = down[lane != 31]
                hist = np.zeros(len(cuts) + 1, np.int64)
                for i in range(1, rows + 1):
                    th = th0 - 1 + i
                    if th >= n_theta:
                        break
                    col = np.maximum(np.maximum(v[i - 1], v[i]), v[i + 1])
                    for j in range(bins):
                        x = v[i, :, j + 1]
                        m = np.maximum(np.maximum(col[:, j], col[:, j + 1]),
                                       col[:, j + 2])
                        peak = active & (x > threshold) & (x >= m)
                        rung = (x[peak, None] >= cuts[None, :]).sum(axis=1)
                        np.add.at(hist, rung, 1)
                        cols = c0[active] + j
                        assert (is_peak[b, th * n_rho + cols] == 7).all()
                        is_peak[b, th * n_rho + cols] = peak[active]
                count[b] += hist
    return is_peak, count


# (T, n_theta, n_rho, vec): the vector path needs n_rho % 4 == 0
LADDER_SHAPES = [(2, 7, 12, True), (1, 5, 128, True), (2, 9, 516, True),
                 (1, 4, 1028, True), (2, 1, 8, True), (2, 7, 12, False),
                 (1, 5, 128, False), (2, 9, 516, False), (1, 4, 1028, False),
                 (2, 1, 8, False), (1, 6, 1, False), (1, 3, 131, False)]


@pytest.mark.parametrize("t,n_theta,n_rho,vec", LADDER_SHAPES)
def test_ladder_model_equals_plain(nrng, t, n_theta, n_rho, vec):
    """The peak ladder's blocks, rows and halo shuffles write every bin
    once and give peak_ladder_plain's mask and counts, with tiles and runs
    of theta rows cut off by the plane's edges, warps' edge lanes inside
    the plane, plateaus, and peaks on every rung, on the 4-column and the
    one-column path."""
    cuts = np.unique(np.round(np.geomspace(11, 8192, 24))).astype(np.int32)
    votes = nrng.integers(0, 14, (t, n_theta, n_rho)).astype(np.int32)
    spikes = nrng.random(votes.shape) < 0.05
    votes[spikes] = nrng.integers(11, 9000, int(spikes.sum()))
    votes[0, 0, :min(n_rho, 3)] = 12                   # a plateau at a border
    votes[-1, -1, -1] = cuts[5]                        # a vote at a cut
    want_mask, want_count = kernels.peak_ladder_plain(
        torch.from_numpy(votes), 10, torch.from_numpy(cuts))
    mask, count = ladder_model(votes, 10, cuts, vec)
    np.testing.assert_array_equal(mask, want_mask.numpy())
    np.testing.assert_array_equal(count, want_count.numpy())
    assert want_count.sum() == want_mask.sum() > 0


# -- (i) walk_segments.cu: corner tiles, peak geometry, walk-order scans -----

F32 = np.float32
K_NEG = -(10 ** 6)
INT_MIN, INT_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def corner_planes_model(imgs, s, vec=True, tile=64, threads=256):
    """corner_planes.cu block by block: a (tile+1)^2 shared tile of the
    frame (0 outside it), thread x's 4 columns (x % 16) of rows x // 16,
    x // 16 + 16, ...; plane 0's word from tile[i][j..], plane 1's (the
    transposed plane, bits 1 and 2 swapped) from tile[j..][i]; every byte
    of both planes written once, as words where S % 4 == 0."""
    t, h, w = imgs.shape
    planes = np.full((t, 2, s, s), 0xEE, np.uint8)       # 0xEE: unwritten
    n_tiles = -(-s // tile)
    lane = np.arange(threads)
    g = (lane & 15) * 4
    for b in range(t):
        pad = np.zeros((h + 2, w + 2), np.uint8)
        pad[1:-1, 1:-1] = imgs[b] != 0
        for by in range(n_tiles):
            for bx in range(n_tiles):
                y0, x0 = by * tile, bx * tile
                tl = np.zeros((tile + 1, tile + 1), np.uint8)
                ys = np.arange(y0 - 1, y0 + tile)
                xs = np.arange(x0 - 1, x0 + tile)
                iy = (ys >= 0) & (ys < h)
                ix = (xs >= 0) & (xs < w)
                tl[np.ix_(iy, ix)] = pad[1:-1, 1:-1][np.ix_(ys[iy], xs[ix])]
                for i0 in range(0, tile, threads // 16):
                    i = i0 + (lane >> 4)
                    for q in range(4):
                        j = g + q
                        a = (tl[i, j] | tl[i, j + 1] << 1 | tl[i + 1, j] << 2
                             | tl[i + 1, j + 1] << 3)
                        tr = (tl[j, i] | tl[j + 1, i] << 1 | tl[j, i + 1] << 2
                              | tl[j + 1, i + 1] << 3)
                        for plane, row, col, val in ((0, y0 + i, x0 + j, a),
                                                     (1, x0 + i, y0 + j, tr)):
                            # the vector path stores a word where its first
                            # column is inside; bytes alone check each one
                            first = x0 + g if plane == 0 else y0 + g
                            inside = (row < s) & ((first < s) if vec
                                                  else (col < s))
                            assert (planes[b, plane, row[inside],
                                           col[inside]] == 0xEE).all()
                            planes[b, plane, row[inside], col[inside]] = \
                                val[inside]
    return planes


def fma_f32_np(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def peak_geom_model(theta_idx, rho_idx, rho_offset, h, w):
    """walk_segments.cu's peak_geom, each f32 operation rounded alone and
    fma_f32 as a float64 product and sum rounded once."""
    cos_t = np.array(f32.COS_BITS, np.uint32).view(F32)
    sin_t = np.array(f32.SIN_BITS, np.uint32).view(F32)
    c, s_ = cos_t[theta_idx], sin_t[theta_idx]
    rho = rho_idx.astype(F32) - F32(rho_offset)
    m = np.maximum(np.abs(s_), np.abs(c))
    vx, vy = (-s_) / m, c / m
    cx, cy = F32(0.5) * F32(w - 1), F32(0.5) * F32(h - 1)
    fx, fy = c * rho, s_ * rho
    proj_x = fma_f32_np(fma_f32_np(-s_, rho, cy), c, (cx - fx) * (-s_))
    proj_y = fma_f32_np(cy - fy, c, fma_f32_np(-c, rho, cx) * (-s_))
    px, py = fma_f32_np(proj_x, -s_, fx), fma_f32_np(proj_y, c, fy)
    xmaj = np.abs(s_) >= np.abs(c)
    dirn = np.where(xmaj, vx, vy)
    floor_a = np.floor(np.where(xmaj, px, py))
    return dict(vx=vx, vy=vy, px=px, py=py, dirn=dirn, floor_a=floor_a,
                xmaj=xmaj)


def walk_t_model(g, col):
    """The walk step of plane column col (col broadcast against the
    peaks' [..., 1] scalars)."""
    return ((F32(col) - F32(1)) - g["floor_a"]) * g["dirn"]


def sample_model(g, t):
    x = fma_f32_np(t, g["vx"], g["px"])
    y = fma_f32_np(t, g["vy"], g["py"])
    x0, y0 = np.floor(x), np.floor(y)
    return x - x0, y - y0, x0.astype(np.int32) + 1, y0.astype(np.int32) + 1


def row_threads(s):
    """walk_segments.cu's row_threads: 4 columns a thread, 32 to 1024."""
    return min(max(((s + 3) // 4 + 31) // 32 * 32, 32), 1024)


def walk_geom_model(theta_idx, rho_idx, rho_offset, h, w, s):
    """walk_geom_kernel: block (frame, peak), thread x columns 4x..4x+3
    (one column where S % 4 != 0), striding by the block; r = yi on
    x-major walks, xi on y-major ones; every column written once."""
    g = {k: v.reshape(-1, 1) for k, v in peak_geom_model(
        theta_idx, rho_idx, rho_offset, h, w).items()}
    n = g["xmaj"].shape[0]
    r = np.full((n, s), INT_MIN, np.int64)
    cols = 4 if s % 4 == 0 else 1
    threads = row_threads(s)
    for base in range(0, s, threads * cols):
        for j in range(cols):
            c = base + np.arange(threads) * cols + j
            c = c[c < s]
            _, _, xi, yi = sample_model(g, walk_t_model(g, c[None, :]))
            assert (r[:, c] == INT_MIN).all()
            r[:, c] = np.where(g["xmaj"], yi, xi)
    return (r.reshape(*theta_idx.shape, s).astype(np.int32),
            g["xmaj"].reshape(theta_idx.shape))


def shfl(x, d, up):
    """__shfl_up_sync / __shfl_down_sync by d within warps of 32 along the
    last axis; a lane with no source keeps its own value."""
    xw = x.reshape(*x.shape[:-1], -1, 32)
    out = xw.copy()
    if up:
        out[..., d:] = xw[..., :-d]
    else:
        out[..., :-d] = xw[..., d:]
    return out.reshape(x.shape)


def block_exclusive_max_model(x):
    """[B, threads] -> the max over each block's earlier threads (K_NEG for
    thread 0): warp inclusive scans by shuffles, warp 0's scan of the
    warps' totals (K_NEG past the last warp), then each thread's exclusive
    value, its warp's lane before it and the warps before."""
    n_warps = x.shape[1] // 32
    lane = np.arange(x.shape[1]) % 32
    incl = x.copy()
    for d in (1, 2, 4, 8, 16):
        incl = np.where(lane >= d, np.maximum(incl, shfl(incl, d, True)),
                        incl)
    tot = np.full((x.shape[0], 32), K_NEG, np.int64)
    tot[:, :n_warps] = incl[:, 31::32]
    for d in (1, 2, 4, 8, 16):
        tot = np.where(np.arange(32) >= d,
                       np.maximum(tot, shfl(tot, d, True)), tot)
    excl = np.where(lane == 0, K_NEG, shfl(incl, 1, True))
    warp = np.arange(x.shape[1]) // 32
    before = tot[:, np.maximum(warp - 1, 0)]
    return np.where(warp > 0, np.maximum(excl, before), excl)


def take_better_model(a, b):
    """The larger len, the lower step among equals, on (len, step, start)
    triples of arrays."""
    better = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return tuple(np.where(better, y, x) for x, y in zip(a, b))


def block_argmax_model(vals):
    """walk_finish's block_argmax on [B, threads] triples: a shuffle-down
    tree in each warp, lane 0's totals to shared memory, the same tree in
    warp 0 over them (padded with (INT_MIN, INT_MAX, K_NEG)); thread 0's
    triple."""
    for d in (16, 8, 4, 2, 1):
        vals = take_better_model(vals, tuple(shfl(v, d, False)
                                             for v in vals))
    n_warps = vals[0].shape[1] // 32
    pads = (INT_MIN, INT_MAX, K_NEG)
    tot = tuple(np.full((vals[0].shape[0], 32), p, np.int64) for p in pads)
    for t_, v in zip(tot, vals):
        t_[:, :n_warps] = v[:, ::32]
    for d in (16, 8, 4, 2, 1):
        tot = take_better_model(tot, tuple(shfl(v, d, False) for v in tot))
    return tuple(t_[:, 0] for t_ in tot)


def walk_finish_model(v, theta_idx, rho_idx, peak_ok, max_gap, rho_offset,
                      n_steps, h, w, min_len):
    """walk_finish_kernel, vectorised over the (frame, peak) blocks and
    their threads: thread x takes walk steps x*per .. x*per + per - 1 (step
    j is column S-1-j where dirn < 0), its on and new-run flags as bit
    masks; the two block exclusive max-scans; each on step's run length;
    the block argmax; thread 0's endpoints, zeros where not ok."""
    t, k, s = v.shape
    threads = row_threads(s)
    per = -(-s // threads)
    assert per <= 32
    g = {k_: a.reshape(-1, 1) for k_, a in peak_geom_model(
        theta_idx, rho_idx, rho_offset, h, w).items()}
    n_blk = t * k
    vv = v.reshape(n_blk, s)
    gap_max = np.repeat(max_gap.astype(F32), k)[:, None]
    half = F32(0.5) * F32(n_steps)
    rev = g["dirn"] < 0
    j0 = np.arange(threads)[None, :] * per
    on = np.zeros((n_blk, threads), np.int64)
    last_on = np.full((n_blk, threads), K_NEG, np.int64)
    for i in range(per):
        j = j0 + i
        live = j < s
        col = np.where(rev, s - 1 - j, j)
        tt = walk_t_model(g, col)
        fx, fy, xi, yi = sample_model(g, tt)
        inp = ((xi >= 0) & (xi <= w) & (yi >= 0) & (yi <= h)
               & (tt >= -half) & (tt < half) & live)
        bits = np.take_along_axis(vv, np.clip(col, 0, s - 1), axis=1)
        wx0, wy0 = F32(1) - fx, F32(1) - fy
        w10, w01 = fx * wy0, wx0 * fy
        least = F32(0.05)
        p = (((bits & 1) != 0) & (wx0 * wy0 > least)
             | ((bits & 2) != 0) & (np.where(g["xmaj"], w10, w01) > least)
             | ((bits & 4) != 0) & (np.where(g["xmaj"], w01, w10) > least)
             | ((bits & 8) != 0) & (fx * fy > least))
        hit = p & inp
        on |= hit.astype(np.int64) << i
        last_on = np.where(hit, j, last_on)
    prev = block_exclusive_max_model(last_on)
    fresh = np.zeros_like(on)
    last_new = np.full_like(last_on, K_NEG)
    for i in range(per):
        j = j0 + i
        is_on = (on >> i & 1) == 1
        new = is_on & ((j - prev - 1).astype(F32) > gap_max)
        fresh |= new.astype(np.int64) << i
        last_new = np.where(new, j, last_new)
        prev = np.where(is_on, j, prev)
    start = block_exclusive_max_model(last_new)
    best = (np.full_like(on, INT_MIN), np.full_like(on, INT_MAX),
            np.full_like(on, K_NEG))
    for i in range(per):
        j = j0 + i
        start = np.where((fresh >> i & 1) == 1, j, start)
        length = np.where((on >> i & 1) == 1, j - start, -1)
        length = np.where(j < s, length, INT_MIN)
        steps = np.broadcast_to(j, length.shape)
        best = take_better_model(best, (length, steps, start))
    best_len, best_step, best_start = block_argmax_model(best)
    good = (best_len >= min_len) & peak_ok.reshape(-1)
    g1 = {k_: a[:, 0] for k_, a in g.items()}

    def endpoint(j):
        j = np.clip(j, 0, s - 1)
        tt = walk_t_model(g1, np.where(g1["dirn"] < 0, s - 1 - j, j))
        ex = np.rint(fma_f32_np(tt, g1["vx"], g1["px"])).astype(np.int32)
        ey = np.rint(fma_f32_np(tt, g1["vy"], g1["py"])).astype(np.int32)
        return np.clip(ex, 0, w - 1), np.clip(ey, 0, h - 1)

    lines = np.stack([*endpoint(best_start), *endpoint(best_step)], -1)
    lines = np.where(good[:, None], lines, 0).astype(np.int32)
    return lines.reshape(t, k, 4), good.reshape(t, k)


def _walk_inputs(case, seed=SEED):
    from metdetpy_tpu_torch.ops import hough, kernel_cases
    c = kernel_cases.walk_case(case, "cpu", seed)
    _, h, w = c.imgs01.shape
    planes = hough.corner_planes(c.imgs01, c.s_dim)
    r, xmaj = kernels.walk_geom_plain(c.theta_idx, c.rho_idx, c.rho_offset,
                                      c.n_steps, h, w, c.s_dim)
    return c, kernels.walk_pick(planes, r, xmaj)


# (id, T, K, H, W, S, fill, offset) of kernel_cases.WALK_CASES' kinds, at
# sizes the numpy models take in seconds: S of 128, 200 and 1024, portrait
# frames, chunks of 1 to 8 frames
WALK_MODEL_CASES = [
    ("lines_s1024", 2, 8, 540, 960, 1024, "lines", 0),
    ("lines_t1", 1, 24, 100, 127, 128, "lines", 0),
    ("lines_t8", 8, 6, 60, 90, 128, "lines", 0),
    ("s200", 2, 16, 150, 199, 200, "lines", 0),
    ("portrait", 3, 16, 300, 120, 384, "lines", 0),
    ("crafted", 2, 64, 37, 150, 256, "crafted", 0),
    ("crafted_portrait", 3, 64, 150, 37, 256, "crafted", 0),
    ("empty", 2, 16, 37, 150, 256, "empty", 0),
    ("dense", 5, 16, 64, 96, 128, "dense", 0),
]


@pytest.mark.parametrize("case", WALK_MODEL_CASES,
                         ids=[c[0] for c in WALK_MODEL_CASES])
def test_walk_finish_model_equals_plain(case):
    """walk_finish's walk-order index map, bit masks, block max-scans over
    the warps' totals and lowest-step argmax give walk_finish_plain's
    lines and ok bit for bit: thetas at 0, 45, 90 and 135 degrees, walks in
    both directions, rho at both ends, peaks not ok, empty and dense
    frames, max_gap 0 and 1e7, S not a multiple of 128."""
    c, v = _walk_inputs(case)
    _, h, w = c.imgs01.shape
    args = (c.theta_idx, c.rho_idx, c.peak_ok, c.gaps, c.rho_offset,
            c.n_steps, h, w, c.min_len)
    want_lines, want_ok = kernels.walk_finish_plain(v, *args)
    lines, ok = walk_finish_model(v.numpy(), *[
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args])
    np.testing.assert_array_equal(ok, want_ok.numpy())
    np.testing.assert_array_equal(lines, want_lines.numpy())
    if case[6] in ("lines", "crafted"):
        assert want_ok.any()


@pytest.mark.parametrize("dirn", [1, -1])
@pytest.mark.parametrize("max_gap", [0.0, 2.0, 1e7])
def test_walk_finish_model_on_random_picks(nrng, dirn, max_gap):
    """Random picks (every run length and gap) on walks of one direction:
    the scans and the argmax over several warps and ragged last threads
    (S = 200, 1000, 1024), against walk_finish_plain."""
    for s, h, w in ((200, 150, 199), (1000, 540, 960), (1024, 540, 960)):
        n = 40
        # dirn -1: x-major walks (45..135 degrees); +1: y-major, theta < 45
        th = nrng.integers(46, 135, (1, n)) if dirn < 0 else \
            nrng.integers(0, 45, (1, n))
        rh = nrng.integers(w + h - 60, w + h + 60, (1, n))
        v = (nrng.random((1, n, s)) < nrng.uniform(0.2, 0.95, (1, n, 1))
             ) * nrng.integers(1, 16, (1, n, s))
        ok = nrng.random((1, n)) < 0.9
        gaps = np.array([max_gap], F32)
        g = peak_geom_model(th, rh, w + h, h, w)
        assert (np.sign(g["dirn"]) == dirn).all()
        n_steps = -(-(max(h, w) + 4) // 128) * 128
        args = [torch.from_numpy(a) for a in (v.astype(np.int32), th, rh, ok,
                                              gaps)]
        want = kernels.walk_finish_plain(*args, w + h, n_steps, h, w, 10)
        got = walk_finish_model(v.astype(np.int32), th, rh, ok, gaps, w + h,
                                n_steps, h, w, 10)
        np.testing.assert_array_equal(got[1], want[1].numpy())
        np.testing.assert_array_equal(got[0], want[0].numpy())
        assert want[1].any()


@pytest.mark.parametrize("case", WALK_MODEL_CASES,
                         ids=[c[0] for c in WALK_MODEL_CASES])
def test_walk_geom_model_equals_plain(case):
    """walk_geom's column map and the shared peak geometry (one function
    of both kernels) give hough.walk_geom's r and xmaj bit for bit."""
    from metdetpy_tpu_torch.ops import kernel_cases
    c = kernel_cases.walk_case(case, "cpu", SEED)
    _, h, w = c.imgs01.shape
    want_r, want_x = kernels.walk_geom_plain(
        c.theta_idx, c.rho_idx, c.rho_offset, c.n_steps, h, w, c.s_dim)
    r, xmaj = walk_geom_model(c.theta_idx.numpy(), c.rho_idx.numpy(),
                              c.rho_offset, h, w, c.s_dim)
    np.testing.assert_array_equal(xmaj, want_x.numpy())
    np.testing.assert_array_equal(r, want_r.numpy())


def test_peak_geom_model_equals_walk_geom_scalars(nrng):
    """Every theta and rho at both ends and between: peak_geom's px, py,
    vx, vy, dirn and xmaj equal hough.walk_geom's bit for bit."""
    from metdetpy_tpu_torch.ops import hough
    for h, w in ((540, 960), (37, 150), (300, 120)):
        n_rho = -(-(2 * (w + h) + 1) // 128) * 128
        th = np.repeat(np.arange(180), 5)[None]
        rh = np.tile([0, 1, w + h, n_rho - 2, n_rho - 1], 180)[None]
        rh = np.concatenate([rh, nrng.integers(0, n_rho, rh.shape)])
        th = np.concatenate([th, th])
        want = hough.walk_geom(torch.from_numpy(th), torch.from_numpy(rh),
                               w + h, 1024, h, w, 128)
        got = peak_geom_model(th, rh, w + h, h, w)
        for name in ("px", "py", "vx", "vy", "dirn", "xmaj"):
            np.testing.assert_array_equal(got[name],
                                          getattr(want, name).numpy(), name)


@pytest.mark.parametrize("t,h,w,s,vec", [
    (1, 37, 150, 256, True), (2, 100, 127, 128, True),
    (1, 150, 199, 200, True), (2, 64, 63, 128, True), (1, 1, 1, 64, True),
    (1, 37, 150, 256, False), (1, 150, 199, 200, False),
    (3, 130, 60, 131, False), (1, 1, 1, 3, False)])
def test_corner_planes_model_equals_plain(nrng, t, h, w, s, vec):
    """corner_planes' 65 x 65 tile and its transposed reads, with bits 1
    and 2 swapped, write every byte of both planes once and give
    hough.corner_planes, zero padding and ragged last tiles included (the
    byte path, which S % 4 != 0 takes, and the word path)."""
    imgs = (nrng.random((t, h, w)) < 0.3).astype(np.uint8)
    imgs[0, 0, :] = 1
    imgs[-1, -1, -1] = 1
    want = kernels.corner_planes_plain(torch.from_numpy(imgs), s).numpy()
    np.testing.assert_array_equal(corner_planes_model(imgs, s, vec), want)
    assert (want[:, 1] == np.swapaxes(
        (want[:, 0] & 9) | (want[:, 0] & 2) << 1 | (want[:, 0] & 4) >> 1,
        1, 2)).all()


def test_block_scans_equal_running_maxima(nrng):
    """The block exclusive max-scan and the block argmax equal a running
    maximum and np.argmax (first of equals) for 1 to 32 warps."""
    for n_warps in (1, 2, 7, 8, 32):
        x = nrng.integers(-5, 50, (6, 32 * n_warps))
        x[0] = K_NEG
        x[1] = 7
        run = np.maximum.accumulate(x, axis=1)
        want = np.concatenate([np.full((6, 1), K_NEG), run[:, :-1]], axis=1)
        np.testing.assert_array_equal(block_exclusive_max_model(x), want)
        steps = np.broadcast_to(np.arange(x.shape[1]), x.shape)
        got = block_argmax_model((x, steps.copy(), -x))
        np.testing.assert_array_equal(got[0], x.max(axis=1))
        np.testing.assert_array_equal(got[1], x.argmax(axis=1))
        np.testing.assert_array_equal(got[2], -x.max(axis=1))


def test_kernel_case_lists_run_on_the_cpu():
    """Every ragged case of ops/kernel_cases.py builds its inputs (with the
    storage offset asked for) and goes through the wrappers' CPU path; the
    large ones are only built at a reduced size here."""
    from metdetpy_tpu_torch.ops import kernel_cases as C
    for case in C.VOTE_CASES:
        name, t, n, n_rho, fill, offset = case
        small = (name, min(t, 2), min(n, 300), min(n_rho, 512), fill, offset)
        xs, ys, valid, n_rho, off = C.vote_case(small, "cpu", SEED)
        assert xs.is_contiguous() and xs.storage_offset() * 4 == offset
        votes = kernels.hough_vote(xs, ys, valid, n_rho, off)
        assert int(votes.sum()) == 180 * int(valid.sum())
    for case in C.PICK_CASES:
        name, t, k, s, fill, offset = case
        small = (name, min(t, 2), min(k, 3), min(s, 256), fill, offset)
        planes, r, xmaj = C.pick_case(small, "cpu", SEED)
        assert r.is_contiguous() and r.storage_offset() * 4 == offset
        assert kernels.walk_pick(planes, r, xmaj).shape == r.shape
    for case in C.PEAK_CASES:
        name, t, n_rho, fill, offset = case
        small = (name, min(t, 2), min(n_rho, 512), fill, offset)
        votes, threshold, cuts = C.peak_case(small, "cpu", SEED)
        assert votes.is_contiguous() and votes.storage_offset() * 4 == offset
        is_peak, count = kernels.peak_ladder(votes, threshold, cuts)
        assert count.sum(dim=1).tolist() == is_peak.sum(dim=1).tolist()
    for case in C.WALK_CASES:
        name, t, k, h, w, s, fill, offset = case
        small = (name, min(t, 2), min(k, 8), min(h, 300), min(w, 300),
                 min(s, 384), fill, offset)
        c = C.walk_case(small, "cpu", SEED)
        assert c.theta_idx.is_contiguous()
        assert c.theta_idx.storage_offset() * 8 == offset
        _, h, w = c.imgs01.shape
        planes = kernels.corner_planes(c.imgs01, c.s_dim)
        r, xmaj = kernels.walk_geom(c.theta_idx, c.rho_idx, c.rho_offset,
                                    c.n_steps, h, w, c.s_dim)
        v = kernels.walk_pick(planes, r, xmaj)
        lines, ok = kernels.walk_finish(v, c.theta_idx, c.rho_idx, c.peak_ok,
                                        c.gaps, c.rho_offset, c.n_steps, h, w,
                                        c.min_len)
        assert not (ok & ~c.peak_ok).any() and not lines[~ok].any()
