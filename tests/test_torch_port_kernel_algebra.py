"""PyTorch port: the arithmetic the CUDA kernels of ``csrc/window_diff.cu``
and ``csrc/median_binarize_close.cu`` rely on, modelled here in numpy and
held exactly against the plain versions on the CPU.

The kernels themselves run only on a card (``tests/test_torch_port_cuda.py``);
these models repeat their algebra step by step -- the thresholded median as
a majority count, the close as OR/AND of shifted rows, the van Herk window
max over a ring of frames, the reciprocal floor mean and the byte permutes
and packed-lane tricks -- so that a wrong identity fails here, without a
card.
"""

import numpy as np
import pytest
import torch

from metdetpy_tpu_torch.ops import filters, kernels

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
