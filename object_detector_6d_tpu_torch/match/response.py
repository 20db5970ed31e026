"""Orientation spreading + response maps (port of
object_detector_6d_tpu/match/response.py), plain PyTorch.

``spread``: OR of the quantized one-hot image over the forward T x T
window, dst(y, x) = OR_{0<=r,c<T} src(y+r, x+c), zero beyond the frame
(log-step doubling per axis, as the reference).

``response_maps``: for each orientation i the best similarity against
any orientation in the spread byte, R[i] = max_{j in bits(s)} (4 -
circ_dist(i, j)), 0 for an empty byte: the byte is rotated so that
orientation i sits at bit 0 and the circular distance is resolved by a
priority select over fixed bit masks.
"""

from __future__ import annotations

import torch

from object_detector_6d_tpu_torch.ops.lut import similarity_table

# bit masks of the rotated byte grouped by circular distance 4..0
DIST_MASKS = ((1 << 4), (1 << 3) | (1 << 5), (1 << 2) | (1 << 6),
              (1 << 1) | (1 << 7), 1)


def dist_vals():
    table = similarity_table()
    return tuple(int(table[0, d]) for d in (4, 3, 2, 1, 0))


def _shift_fwd(a: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """a shifted k pixels toward the origin along ``dim``, zero-filled."""
    n = a.shape[dim]
    pad = torch.zeros_like(a.narrow(dim, 0, min(k, n)))
    return torch.cat([a.narrow(dim, min(k, n), n - min(k, n)), pad], dim=dim)


def spread(quantized: torch.Tensor, t: int) -> torch.Tensor:
    """OR-spread over the forward t x t window. [..., H, W] u8 -> same."""
    x = quantized
    for dim in (-2, -1):
        acc = x
        done = 1
        while done * 2 <= t:
            acc = acc | _shift_fwd(acc, done, dim)
            done *= 2
        if done < t:
            acc = acc | _shift_fwd(acc, t - done, dim)
        x = acc
    return x


def response_maps(spread_img: torch.Tensor) -> torch.Tensor:
    """Spread image [..., H, W] u8 -> response maps [..., 8, H, W] u8."""
    s = spread_img.to(torch.int32)
    outs = []
    for i in range(8):
        r = ((s >> i) | (s << (8 - i))) & 0xFF
        v = torch.zeros_like(s)
        for mask, val in zip(DIST_MASKS, dist_vals()):
            v = torch.where((r & mask) != 0, val, v)
        outs.append(v)
    return torch.stack(outs, dim=-3).to(torch.uint8)
