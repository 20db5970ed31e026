"""5x5 numeric median over one-hot u8 images (port of object_detector_6d_tpu/ops/median.py).

The depth-normal quantizer post-filters its one-hot image with the
oracle's cv::medianBlur(ksize=5) (replicate border). The image only ever
holds {0, 1, 2, 4, ..., 128}, so the median is found by counting: eight
per-code window counts (two int32 planes of four 8-bit fields each, a
count never exceeds 25), then the first code whose running count reaches
13 of 25, starting from the count of code 0 (25 minus the rest).
"""

from __future__ import annotations

import torch


def _box5_sum(x: torch.Tensor) -> torch.Tensor:
    """Separable 5x5 box sum with replicate padding. x: [B, H, W] int32."""
    H, W = x.shape[-2:]
    p = torch.cat([x[:, :1], x[:, :1], x, x[:, -1:], x[:, -1:]], dim=1)
    x = p[:, 0:H] + p[:, 1:H + 1] + p[:, 2:H + 2] + p[:, 3:H + 3] + p[:, 4:H + 4]
    p = torch.cat([x[:, :, :1], x[:, :, :1], x, x[:, :, -1:], x[:, :, -1:]], dim=2)
    return (p[:, :, 0:W] + p[:, :, 1:W + 1] + p[:, :, 2:W + 2]
            + p[:, :, 3:W + 3] + p[:, :, 4:W + 4])


def median5_onehot_u8(img: torch.Tensor) -> torch.Tensor:
    """Numeric 5x5 median of [B, H, W] images over {0, 1, 2, 4, ..., 128}."""
    x = img.to(torch.int32)
    lo = torch.zeros_like(x)
    hi = torch.zeros_like(x)
    for k in range(4):
        lo = lo + (((x >> k) & 1) << (8 * k))
        hi = hi + (((x >> (k + 4)) & 1) << (8 * k))
    lo = _box5_sum(lo)
    hi = _box5_sum(hi)
    counts = ([(lo >> (8 * k)) & 255 for k in range(4)]
              + [(hi >> (8 * k)) & 255 for k in range(4)])
    cum = 25 - sum(counts)
    val = torch.zeros_like(x)
    done = cum >= 13  # code 0 is already the median
    for k, c in enumerate(counts):
        cum = cum + c
        hit = ~done & (cum >= 13)
        val = torch.where(hit, torch.full_like(val, 1 << k), val)
        done = done | hit
    return val.to(torch.uint8)
