"""Quantized depth-normal pyramid + template extraction (port of
object_detector_6d_tpu/quant/pyramid.py, ``DepthNormalPyramid`` only).

Level l+1 nearest-neighbour subsamples the quantized level-l image
([::2, ::2], the oracle's INTER_NEAREST halving); masks halve the same
way; num_features and extract_threshold halve per level. Training runs
on the host: the plain quantizer on CPU tensors, numpy extraction.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.config import DepthNormalParams
from object_detector_6d_tpu_torch.quant.depth_normal import quantized_normals
from object_detector_6d_tpu_torch.quant.features import Template, extract_depth_normal


class DepthNormalPyramid:
    """Per-frame quantized depth-normal pyramid."""

    def __init__(
        self,
        depth_u16: np.ndarray,
        params: DepthNormalParams | None = None,
        levels: int = 2,
        mask: Optional[np.ndarray] = None,
    ):
        self.params = params or DepthNormalParams()
        self.levels = levels
        d = torch.as_tensor(np.asarray(depth_u16).astype(np.int32))
        q = quantized_normals(
            d,
            distance_threshold=self.params.distance_threshold,
            difference_threshold=self.params.difference_threshold,
        ).numpy()
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
