"""Color-gradient modality: quantized orientations (port of
object_detector_6d_tpu/quant/color_gradient.py), plain PyTorch.

Per pixel of a BGR u8 image:

1. the exact integer 7x7 Gaussian (taps 8,28,56,72,56,28,8 per axis,
   edge-replicated, one rounding shift ``(acc + 2^15) >> 16``);
2. the 3x3 Sobel dx, dy of each channel (int32, edge-replicated);
3. the channel with the largest squared magnitude (first one on ties);
4. cv::fastAtan2's float32 polynomial, quantized to 16 bins (round half
   to even) and folded to 8;
5. the 1-pixel frame border forced to bin 0, a 3x3 vote (zero outside
   the frame), and ``1 << bin`` where the winning bin has >= 5 of 9
   votes and the squared magnitude exceeds weak_threshold^2.

Every float step is one separately rounded float32 operation in the
reference's order (no fused multiply-add), and the division is a true
division of two tensors. This is the plain version the K1 kernel
(ops/quantize.py, csrc/cg_quantize.cu) is held against. The training
side (quant/pyramid.py) takes the one-hot image from K1's wrapper (this
twin for a CPU image) and the magnitude from ``selected_magnitude``.
``ColorGradient`` is the modality's front end: one frame through K1.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.config import ColorGradientParams
from object_detector_6d_tpu_torch.core.device import on_device

_GAUSS7 = (8, 28, 56, 72, 56, 28, 8)
# cv::fastAtan2's coefficients in degrees, as float32 (csrc/cg_quantize.cu
# spells the same values as hex literals)
ATAN_P = tuple(float(np.float32(c * (180 / math.pi))) for c in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
    -0.04432655554792128))
ATAN_EPS = float(np.float32(1.1920929e-07))
BIN_SCALE = float(np.float32(16.0 / 360.0))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _edge_pad(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    lo = x.narrow(dim, 0, 1)
    hi = x.narrow(dim, x.shape[dim] - 1, 1)
    return torch.cat([lo] * n + [x] + [hi] * n, dim)


def _gauss7(img: torch.Tensor) -> torch.Tensor:
    """Exact integer 7x7 Gaussian; img [..., H, W] int32 -> int32 0..255."""
    H, W = img.shape[-2:]
    p = _edge_pad(img, 3, -1)
    t = sum(k * p[..., i:i + W] for i, k in enumerate(_GAUSS7))
    p = _edge_pad(t, 3, -2)
    o = sum(k * p[..., i:i + H, :] for i, k in enumerate(_GAUSS7))
    return torch.clamp((o + (1 << 15)) >> 16, 0, 255)


def _sobel(s: torch.Tensor):
    """3x3 Sobel dx, dy of [..., H, W] int32, edge-replicated."""
    H, W = s.shape[-2:]
    px = _edge_pad(s, 1, -1)
    gx = px[..., 2:] - px[..., :-2]
    py = _edge_pad(gx, 1, -2)
    dx = py[..., :-2, :] + 2 * py[..., 1:-1, :] + py[..., 2:, :]
    py = _edge_pad(s, 1, -2)
    gy = py[..., 2:, :] - py[..., :-2, :]
    px = _edge_pad(gy, 1, -1)
    dy = px[..., :-2] + 2 * px[..., 1:-1] + px[..., 2:]
    return dx, dy


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 in float32: degrees in [0, 360)."""
    p1, p3, p5, p7 = (_f32(c, x) for c in ATAN_P)
    eps = _f32(ATAN_EPS, x)
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ax < ay
    c = torch.where(swap, ax / (ay + eps), ay / (ax + eps))
    c2 = c * c
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(swap, _f32(90.0, x) - a, a)
    a = torch.where(x < 0, _f32(180.0, x) - a, a)
    return torch.where(y < 0, _f32(360.0, x) - a, a)


def _box3_sum(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum over the trailing [H, W], zero outside."""
    H, W = x.shape[-2:]
    p = torch.nn.functional.pad(x, (0, 0, 1, 1))
    x = p[..., 0:H, :] + p[..., 1:H + 1, :] + p[..., 2:H + 2, :]
    p = torch.nn.functional.pad(x, (1, 1))
    return p[..., 0:W] + p[..., 1:W + 1] + p[..., 2:W + 2]


def _selected_gradient(bgr: torch.Tensor):
    """Steps 1-3: the Sobel dx, dy (int32) of the channel with the largest
    squared magnitude, and that magnitude (f32, exact: < 2^24)."""
    img = torch.movedim(bgr.to(torch.int32), -1, -3)  # [..., 3, H, W]
    dx, dy = _sobel(_gauss7(img))
    mag = (dx * dx + dy * dy).to(torch.float32)
    m0, m1, m2 = mag.unbind(-3)
    sel1 = (m1 > m0) & (m1 >= m2)
    sel2 = (m2 > m0) & (m2 > m1)
    sel0 = ~(sel1 | sel2)

    def pick(v):
        return torch.where(sel0, v[..., 0, :, :],
                           torch.where(sel1, v[..., 1, :, :], v[..., 2, :, :]))

    return pick(dx), pick(dy), pick(mag)


def selected_magnitude(bgr: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] u8 -> the squared gradient magnitude of the selected
    channel, f32 [..., H, W] (the oracle's ``magnitude`` image), on the
    image's device. Integer arithmetic below 2^24, so it is exact on any
    device; no TPU kernel computes it (the reference's plain XLA does), so
    on the card it runs beside K1 in plain PyTorch."""
    return _selected_gradient(bgr)[2]


def quantized_orientations(bgr: torch.Tensor, weak_threshold: float = 10.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, W, 3] u8 -> (one-hot u8 [..., H, W], squared magnitude of
    the selected channel f32 [..., H, W]); the magnitude feeds template
    extraction's strong threshold."""
    sdx, sdy, smag = _selected_gradient(bgr)
    ang = fast_atan2_deg(sdy.to(torch.float32), sdx.to(torch.float32))
    q16 = torch.clamp(torch.round(ang * _f32(BIN_SCALE, ang)), 0, 255).to(torch.int32)
    q8 = q16 & 7
    H, W = q8.shape[-2:]
    v = torch.arange(H, device=q8.device)[:, None]
    u = torch.arange(W, device=q8.device)[None, :]
    border = (v == 0) | (v == H - 1) | (u == 0) | (u == W - 1)
    q8 = torch.where(border, 0, q8)
    # vote counts <= 9 < 16: all eight bins as 4-bit fields of one int64
    votes = _box3_sum(torch.ones_like(q8, dtype=torch.int64) << (4 * q8))
    best = torch.zeros_like(q8)
    best_votes = (votes & 15).to(torch.int32)
    for k in range(1, 8):
        vk = ((votes >> (4 * k)) & 15).to(torch.int32)
        best = torch.where(vk > best_votes, k, best)  # strict: first max wins
        best_votes = torch.maximum(best_votes, vk)
    weak2 = _f32(float(np.float32(weak_threshold) ** 2), smag)
    strong = (smag > weak2) & (best_votes >= 5) & ~border
    q = torch.where(strong, torch.ones_like(best) << best, 0).to(torch.uint8)
    return q, smag


class ColorGradient:
    """Color-gradient modality front end (mirrors linemod::ColorGradient)."""

    name = "ColorGradient"

    def __init__(self, params: ColorGradientParams | None = None, device="cuda"):
        self.params = params or ColorGradientParams()
        self.device = device

    def quantize(self, bgr) -> torch.Tensor:
        """[H, W, 3] u8 BGR -> [H, W] u8 one-hot orientations, through K1
        at B=1; numpy goes to ``device``, a tensor stays on its own."""
        from object_detector_6d_tpu_torch.ops.quantize import cg_quantize_batched

        img = on_device(bgr, self.device)
        return cg_quantize_batched(img[None], float(self.params.weak_threshold))[0]
