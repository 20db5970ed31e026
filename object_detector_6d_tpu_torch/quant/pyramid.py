"""Quantized pyramids + template extraction (port of
object_detector_6d_tpu/quant/pyramid.py), for the two LINEMOD modalities:

* ColorGradient: level l+1 re-quantizes ``pyr_down_u8`` of the image, a
  bit-exact cv::pyrDown (5-tap [1,4,6,4,1] kernel per axis, reflect-101
  borders, even-index decimation, ``(acc + 128) >> 8``);
* DepthNormal: level l+1 nearest-neighbour subsamples the quantized
  level-l image ([::2, ::2], the oracle's INTER_NEAREST halving).

Masks halve with [::2, ::2]; num_features (and DepthNormal's
extract_threshold) halve per level. The quantized images are computed on
``device`` (default the card) through the kernel wrappers of
ops/quantize.py: K1 at each ColorGradient level, K2 once; with
``device="cpu"`` the wrappers run their plain twins. The images come back
to the host for the numpy feature extraction. ``pyr_down_u8`` is also the
match program's level-1 step for the colour frames, on their device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu_torch.core.device import checked_device
from object_detector_6d_tpu_torch.ops.quantize import cg_quantize_batched, dn_quantize_batched
from object_detector_6d_tpu_torch.quant.color_gradient import selected_magnitude
from object_detector_6d_tpu_torch.quant.features import (
    Template,
    extract_color_gradient,
    extract_depth_normal,
)

_PYR5 = (1, 4, 6, 4, 1)


def _pyr_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """5-tap [1,4,6,4,1] filter along ``dim`` (reflect-101 borders), kept
    at the even indices."""
    n = x.shape[dim]
    p = torch.cat([x.narrow(dim, 2, 1), x.narrow(dim, 1, 1), x,
                   x.narrow(dim, n - 2, 1), x.narrow(dim, n - 3, 1)], dim)
    t = sum(k * p.narrow(dim, i, n) for i, k in enumerate(_PYR5))
    even = [slice(None)] * t.dim()
    even[dim] = slice(0, None, 2)
    return t[tuple(even)]


def pyr_down_u8(img: torch.Tensor) -> torch.Tensor:
    """Bit-exact cv::pyrDown of u8 images: [H, W], [H, W, C] or
    [B, H, W, C] -> ((H+1)//2, (W+1)//2) spatially."""
    x = img.to(torch.int32)
    if img.dim() == 2:
        x = x[..., None]
    x = _pyr_axis(_pyr_axis(x, -2), -3)
    out = torch.clamp((x + 128) >> 8, 0, 255).to(torch.uint8)
    return out[..., 0] if img.dim() == 2 else out


class ColorGradientPyramid:
    """Per-frame quantized color-gradient pyramid."""

    def __init__(
        self,
        bgr: np.ndarray,
        params: ColorGradientParams | None = None,
        levels: int = 2,
        mask: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.params = params or ColorGradientParams()
        self.levels = levels
        self._quantized: List[np.ndarray] = []
        self._magnitude: List[np.ndarray] = []
        self._masks: List[Optional[np.ndarray]] = []
        src = torch.as_tensor(np.ascontiguousarray(bgr, np.uint8),
                              device=checked_device(device))
        m = None if mask is None else np.asarray(mask) > 0
        for lvl in range(levels):
            q = cg_quantize_batched(src[None], self.params.weak_threshold)[0]
            self._quantized.append(q.cpu().numpy())
            self._magnitude.append(selected_magnitude(src).cpu().numpy())
            self._masks.append(m)
            if lvl + 1 < levels:
                src = pyr_down_u8(src)
                if m is not None:
                    m = m[::2, ::2]

    def quantize(self, level: int = 0) -> np.ndarray:
        return self._quantized[level]

    def extract_template(self, level: int) -> Optional[Template]:
        nf = self.params.num_features >> level
        return extract_color_gradient(self._quantized[level], self._magnitude[level],
                                      self._masks[level], nf,
                                      self.params.strong_threshold, level)


class DepthNormalPyramid:
    """Per-frame quantized depth-normal pyramid."""

    def __init__(
        self,
        depth_u16: np.ndarray,
        params: DepthNormalParams | None = None,
        levels: int = 2,
        mask: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.params = params or DepthNormalParams()
        self.levels = levels
        d = torch.as_tensor(np.asarray(depth_u16).astype(np.int32),
                            device=checked_device(device))
        q = dn_quantize_batched(d[None], self.params.distance_threshold,
                                self.params.difference_threshold)[0].cpu().numpy()
        m = None if mask is None else np.asarray(mask) > 0
        self._quantized = [q]
        self._masks: List[Optional[np.ndarray]] = [m]
        for _ in range(1, levels):
            q = q[::2, ::2]
            self._quantized.append(q)
            if m is not None:
                m = m[::2, ::2]
            self._masks.append(m)

    def quantize(self, level: int = 0) -> np.ndarray:
        return self._quantized[level]

    def extract_template(self, level: int) -> Optional[Template]:
        nf = self.params.num_features >> level
        thr = self.params.extract_threshold >> level
        return extract_depth_normal(self._quantized[level], self._masks[level],
                                    nf, thr, level)
