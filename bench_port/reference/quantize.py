"""LINEMOD's two quantizers and OpenCV's pyrDown, written from their
definitions, on [n, H, W, 3] u8 BGR and [n, H, W] depth tensors.

Colour gradients (``linemod.cpp`` quantizedOrientations and
hysteresisGradient): the integer 7x7 Gaussian (taps 8 28 56 72 56 28 8,
replicated borders, ``(acc + 2^15) >> 16``), the 3x3 Sobel of each
channel, the channel of largest squared magnitude (the first on ties),
cv::fastAtan2 in degrees, 16 bins folded to 8, the frame's 1-pixel border
set to bin 0, and ``1 << bin`` where a bin holds at least 5 of the 3x3
neighbourhood's 9 labels and the magnitude exceeds the weak threshold.

Depth normals (quantizedNormals): per interior pixel a least-squares depth
gradient over 8 samples at radius 5, each kept while its depth differs by
less than the difference threshold, the normal (1150 ddx, 1150 ddy,
-det d), its direction on the 20 x 20 cells of LINEMOD's normal table,
then cv::medianBlur with a 5 x 5 window.

Integer steps are exact. Every float step is one rounding in the
precision ``fl`` gives (float32, or bfloat16 for the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

GAUSS7 = (8, 28, 56, 72, 56, 28, 8)
PYR5 = (1, 4, 6, 4, 1)
# cv::fastAtan2's polynomial, degrees
ATAN_COEF = tuple(float(np.float32(c * 180.0 / math.pi)) for c in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281, -0.04432655554792128))
FLT_EPSILON = float(np.float32(2.0 ** -23))
NEIGHBOUR_VOTES = 5
RING = 5

# LINEMOD's normal table: the one-hot bin of a normal whose x and y,
# scaled to [0, 20), fall in cell [int(10 ny + 10)][int(10 nx + 10)]
NORMAL_TABLE = np.array([
    [32, 32, 32, 32, 32, 32, 64, 64, 64, 64, 64, 64, 64, 64, 64, 128, 128, 128, 128, 128],
    [32, 32, 32, 32, 32, 32, 32, 64, 64, 64, 64, 64, 64, 64, 128, 128, 128, 128, 128, 128],
    [32, 32, 32, 32, 32, 32, 32, 64, 64, 64, 64, 64, 64, 64, 128, 128, 128, 128, 128, 128],
    [32, 32, 32, 32, 32, 32, 32, 32, 64, 64, 64, 64, 64, 128, 128, 128, 128, 128, 128, 128],
    [32, 32, 32, 32, 32, 32, 32, 32, 64, 64, 64, 64, 64, 128, 128, 128, 128, 128, 128, 128],
    [32, 32, 32, 32, 32, 32, 32, 32, 64, 64, 64, 64, 64, 128, 128, 128, 128, 128, 128, 128],
    [16, 32, 32, 32, 32, 32, 32, 32, 32, 64, 64, 64, 128, 128, 128, 128, 128, 128, 128, 128],
    [16, 16, 16, 32, 32, 32, 32, 32, 32, 64, 64, 64, 128, 128, 128, 128, 128, 128, 1, 1],
    [16, 16, 16, 16, 16, 16, 32, 32, 32, 32, 64, 128, 128, 128, 128, 1, 1, 1, 1, 1],
    [16, 16, 16, 16, 16, 16, 16, 16, 32, 32, 64, 128, 128, 1, 1, 1, 1, 1, 1, 1],
    [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [16, 16, 16, 16, 16, 16, 16, 16, 8, 8, 4, 2, 2, 1, 1, 1, 1, 1, 1, 1],
    [16, 16, 16, 16, 16, 16, 8, 8, 8, 8, 4, 2, 2, 2, 2, 1, 1, 1, 1, 1],
    [16, 16, 16, 8, 8, 8, 8, 8, 8, 4, 4, 4, 2, 2, 2, 2, 2, 2, 1, 1],
    [16, 8, 8, 8, 8, 8, 8, 8, 8, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2, 2],
    [8, 8, 8, 8, 8, 8, 8, 8, 4, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2],
    [8, 8, 8, 8, 8, 8, 8, 8, 4, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2],
    [8, 8, 8, 8, 8, 8, 8, 8, 4, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2],
    [8, 8, 8, 8, 8, 8, 8, 4, 4, 4, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2],
    [8, 8, 8, 8, 8, 8, 8, 4, 4, 4, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2],
], dtype=np.uint8)


def rounding(precision: str):
    """The rounding of one float step: float32, or bfloat16 (the control)."""
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision {precision!r}")


def _border_index(n: int, r: int, kind: str, device) -> torch.Tensor:
    i = torch.arange(-r, n + r, device=device)
    if kind == "replicate":
        return i.clamp(0, n - 1)
    i = torch.where(i < 0, -i, i)  # reflect-101
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _pad(x: torch.Tensor, r: int, kind: str, dims=(-2, -1)) -> torch.Tensor:
    for d in dims:
        x = x.index_select(d, _border_index(x.shape[d], r, kind, x.device))
    return x


def _separable(p: torch.Tensor, taps, H: int, W: int) -> torch.Tensor:
    """sum_ij taps_i taps_j p[y + i, x + j] over a padded [..., H+k-1, W+k-1]."""
    rows = sum(t * p[..., i:i + H, :] for i, t in enumerate(taps))
    return sum(t * rows[..., :, j:j + W] for j, t in enumerate(taps))


def pyr_down(bgr: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown of [n, H, W, 3] u8: the 5x5 [1 4 6 4 1] kernel over a
    reflect-101 border at the even pixels, ``(acc + 128) >> 8``."""
    x = bgr.movedim(-1, -3).to(torch.int32)  # [n, 3, H, W]
    H, W = x.shape[-2:]
    acc = _separable(_pad(x, 2, "reflect"), PYR5, H, W)[..., ::2, ::2]
    return ((acc + 128) >> 8).clamp(0, 255).to(torch.uint8).movedim(-3, -1).contiguous()


def fast_atan2(y: torch.Tensor, x: torch.Tensor, fl) -> torch.Tensor:
    """cv::fastAtan2(y, x) in degrees, [0, 360]."""
    def c32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    p1, p3, p5, p7 = (c32(v) for v in ATAN_COEF)
    x, y = fl(x), fl(y)
    ax, ay = x.abs(), y.abs()
    steep = ay > ax
    c = torch.where(steep, fl(ax / fl(ay + c32(FLT_EPSILON))),
                    fl(ay / fl(ax + c32(FLT_EPSILON))))
    cc = fl(c * c)
    a = fl(fl(fl(fl(fl(fl(fl(p7 * cc) + p5) * cc) + p3) * cc) + p1) * c)
    a = torch.where(steep, fl(c32(90.0) - a), a)
    a = torch.where(x < 0, fl(c32(180.0) - a), a)
    return torch.where(y < 0, fl(c32(360.0) - a), a)


def color_gradient(bgr: torch.Tensor, weak_threshold: float, fl) -> torch.Tensor:
    """[n, H, W, 3] u8 BGR -> [n, H, W] u8 one-hot orientations."""
    x = bgr.movedim(-1, -3).to(torch.int64)  # [n, 3, H, W]
    H, W = x.shape[-2:]
    g = (_separable(_pad(x, 3, "replicate"), GAUSS7, H, W) + (1 << 15)) >> 16
    p = _pad(g.clamp(0, 255), 1, "replicate")
    dx = sum(w * (p[..., i:i + H, 2:W + 2] - p[..., i:i + H, 0:W])
             for i, w in enumerate((1, 2, 1)))
    dy = sum(w * (p[..., 2:H + 2, j:j + W] - p[..., 0:H, j:j + W])
             for j, w in enumerate((1, 2, 1)))
    mag = dx * dx + dy * dy  # < 2^24: exact in float32
    ch = mag.argmax(dim=-3, keepdim=True)  # the first largest channel
    sdx, sdy, smag = (v.gather(-3, ch).squeeze(-3) for v in (dx, dy, mag))
    angle = fast_atan2(sdy.to(torch.float32), sdx.to(torch.float32), fl)
    scale = torch.tensor(float(np.float32(16.0 / 360.0)), dtype=torch.float32,
                         device=bgr.device)
    label = torch.round(fl(angle * scale)).clamp(0, 255).to(torch.int64) & 7
    rows = torch.arange(H, device=bgr.device)[:, None]
    cols = torch.arange(W, device=bgr.device)[None, :]
    border = (rows == 0) | (rows == H - 1) | (cols == 0) | (cols == W - 1)
    label = torch.where(border, 0, label)
    onehot = torch.nn.functional.one_hot(label, 8).movedim(-1, -3)  # [n, 8, H, W]
    q = torch.nn.functional.pad(onehot, (1, 1, 1, 1))  # no votes outside the frame
    votes = sum(q[..., i:i + H, j:j + W] for i in range(3) for j in range(3))
    best_votes, best = votes.max(dim=-3)  # the first bin among equals
    weak2 = float(np.float32(weak_threshold)) ** 2
    strong = (smag.to(torch.float32) > weak2) & (best_votes >= NEIGHBOUR_VOTES) & ~border
    return torch.where(strong, 1 << best, 0).to(torch.uint8)


def _median5(img: torch.Tensor) -> torch.Tensor:
    """cv::medianBlur(ksize=5) of [n, H, W] u8 (replicated border)."""
    H, W = img.shape[-2:]
    p = _pad(img.to(torch.int16), 2, "replicate")
    win = torch.stack([p[..., i:i + H, j:j + W] for i in range(5) for j in range(5)])
    return win.sort(dim=0).values[12].to(torch.uint8)


def depth_normal(depth: torch.Tensor, distance_threshold: int, difference_threshold: int,
                 fl) -> torch.Tensor:
    """[n, H, W] depth (mm) -> [n, H, W] u8 one-hot normal directions."""
    d = depth.to(torch.int64)
    H, W = d.shape[-2:]
    p = torch.nn.functional.pad(d, (RING, RING, RING, RING))  # zero outside the frame
    a00 = a01 = a11 = b0 = b1 = 0
    for oy in (-RING, 0, RING):
        for ox in (-RING, 0, RING):
            if ox == 0 and oy == 0:
                continue
            delta = p[..., RING + oy:RING + oy + H, RING + ox:RING + ox + W] - d
            kept = (delta.abs() < difference_threshold).to(torch.int64)
            a00 = a00 + kept * ox * ox
            a01 = a01 + kept * ox * oy
            a11 = a11 + kept * oy * oy
            b0 = b0 + kept * ox * delta
            b1 = b1 + kept * oy * delta
    det = a00 * a11 - a01 * a01
    nx = (1150 * (a11 * b0 - a01 * b1)).to(torch.float32)
    ny = (1150 * (a00 * b1 - a01 * b0)).to(torch.float32)
    nz = (-det * d).to(torch.float32)
    nx, ny, nz = fl(nx), fl(ny), fl(nz)
    norm = fl(torch.sqrt(fl(fl(fl(nx * nx) + fl(ny * ny)) + fl(nz * nz))))
    rows = torch.arange(H, device=d.device)[:, None]
    cols = torch.arange(W, device=d.device)[None, :]
    interior = ((rows >= RING) & (rows < H - RING - 1)
                & (cols >= RING) & (cols < W - RING - 1))
    ok = interior & (d < distance_threshold) & (norm > 0)
    inv = fl(torch.reciprocal(torch.where(ok, norm, 1.0)))
    ten = torch.tensor(10.0, dtype=torch.float32, device=d.device)

    def cell(v):  # int(10 v / |n| + 10), truncated, on the table's 20 cells
        return fl(fl(fl(v * inv) * ten) + ten).to(torch.int64).clamp(0, 19)

    table = torch.as_tensor(NORMAL_TABLE, device=d.device)
    q = torch.where(ok, table[cell(ny), cell(nx)], 0).to(torch.uint8)
    return _median5(q)
