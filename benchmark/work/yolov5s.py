"""Forward FLOPs of YOLOv5s (v6.0, width 0.50, depth 0.33) from its layer
shapes, and the tiles the multiscale plan forwards for an image.

Two operations a multiply-add of each convolution (the detect heads'
included, their bias and the batch norms, activations, pooling and the
box decoding left out). At 640x640 with 80 classes this gives the 16.5
GFLOPs that YOLOv5's own model summary states for v5s.
"""

from __future__ import annotations

import math


def _ch(c: int, width: float = 0.50) -> int:
    return int(math.ceil(c * width / 8) * 8)


def _n(n: int, depth: float = 0.33) -> int:
    return max(round(n * depth), 1)


class _Counter:
    def __init__(self) -> None:
        self.flops = 0

    def conv(self, c_in: int, c_out: int, k: int, s: int, hw: tuple):
        h, w = hw
        ho, wo = -(-h // s), -(-w // s)
        self.flops += 2 * k * k * c_in * c_out * ho * wo
        return c_out, (ho, wo)

    def c3(self, c_in: int, c_out: int, n: int, hw: tuple):
        hid = c_out // 2
        self.conv(c_in, hid, 1, 1, hw)          # cv1
        self.conv(c_in, hid, 1, 1, hw)          # cv2
        for _ in range(n):                      # bottlenecks, e = 1.0
            self.conv(hid, hid, 1, 1, hw)
            self.conv(hid, hid, 3, 1, hw)
        return self.conv(2 * hid, c_out, 1, 1, hw)


def forward_flops(h: int, w: int, nc: int = 8) -> int:
    """FLOPs of one forward of an h x w image (h, w multiples of 32)."""
    m = _Counter()
    c, hw = m.conv(3, _ch(64), 6, 2, (h, w))
    c, hw = m.conv(c, _ch(128), 3, 2, hw)
    c, hw = m.c3(c, _ch(128), _n(3), hw)
    c, hw = m.conv(c, _ch(256), 3, 2, hw)
    c3_, hw3 = m.c3(c, _ch(256), _n(6), hw)
    c, hw = m.conv(c3_, _ch(512), 3, 2, hw3)
    c4_, hw4 = m.c3(c, _ch(512), _n(9), hw)
    c, hw = m.conv(c4_, _ch(1024), 3, 2, hw4)
    c, hw5 = m.c3(c, _ch(1024), _n(3), hw)
    m.conv(c, c // 2, 1, 1, hw5)                     # SPPF cv1
    c, hw5 = m.conv(4 * (c // 2), _ch(1024), 1, 1, hw5)  # SPPF cv2
    c10, _ = m.conv(c, _ch(512), 1, 1, hw5)                    # h10
    c13, _ = m.c3(c10 + c4_, _ch(512), _n(3), hw4)             # h13
    c14, _ = m.conv(c13, _ch(256), 1, 1, hw4)                  # h14
    c17, _ = m.c3(c14 + c3_, _ch(256), _n(3), hw3)             # h17: P3 out
    c18, _ = m.conv(c17, _ch(256), 3, 2, hw3)                  # h18
    c20, _ = m.c3(c18 + c14, _ch(512), _n(3), hw4)             # h20: P4 out
    c21, _ = m.conv(c20, _ch(512), 3, 2, hw4)                  # h21
    c23, _ = m.c3(c21 + c10, _ch(1024), _n(3), hw5)            # h23: P5 out
    no = 3 * (5 + nc)
    for cc, hh in ((c17, hw3), (c20, hw4), (c23, hw5)):
        m.conv(cc, no, 1, 1, hh)
    return m.flops


PARTITION_MIN_OVERLAP = 0.2


def tiles_per_image(h: int, w: int, model_hw=(320, 320),
                    multiscale_pred: int = 1, multiscale_partition: int = 2,
                    hw_tolerance: float = 0.2) -> int:
    """Tiles the multiscale plan forwards for one h x w image: one level
    per ``multiscale_pred`` (at least one; 0 is the single whole-image
    forward), each level ``multiscale_partition`` times the last's tiles
    along each side, starting from the tiles the image's aspect needs."""
    if multiscale_pred == 0:
        return 1
    mh, mw = model_hw
    ratio, in_ratio = mh / mw, h / w
    h_rep = w_rep = 1
    if abs(ratio - in_ratio) > hw_tolerance:
        if ((in_ratio - 1) * (ratio - 1)) > 0 or abs(
                ratio - 1 / in_ratio) < hw_tolerance:
            h, w = w, h
        if h > w:
            h_rep = int(math.ceil(h * mw / (mh * w)))
        else:
            w_rep = int(math.ceil(w * mh / (h * mw)))
    total = 0
    for level in range(multiscale_pred):
        if level > 0:
            h_rep *= multiscale_partition
            w_rep *= multiscale_partition
        total += h_rep * w_rep
    return total
