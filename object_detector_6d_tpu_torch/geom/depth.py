"""Frame ingest: depth rescaling (port of object_detector_6d_tpu/geom/depth.py).

Integer depth is millimetres, converted to float32 metres with 0 -> NaN;
float depth passes through (already metric).
"""

from __future__ import annotations

import torch


def rescale_depth(depth: torch.Tensor) -> torch.Tensor:
    """Depth image -> float32 metres with 0 -> NaN (for integer input)."""
    if depth.dtype.is_floating_point:
        return depth.to(torch.float32)
    d = depth.to(torch.float32)
    return torch.where(d == 0, torch.full_like(d, float("nan")), d * 0.001)
