"""Structured logging + per-stage pipeline counters (SURVEY.md section 5).

The reference's observability surface is cv::utils::logging + assertion
return codes; here the host layer keeps structured counters the
detection/streaming pipelines feed: hypotheses in/out, candidate
overflow/fallback events, match similarity distribution, ICP residual
histogram. Cheap (host-side ints/lists), queryable as a dict, loggable
as one JSON line per frame — the shape a fleet log pipeline wants.
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional

logger = logging.getLogger("object_detector_6d_tpu_torch")


class PipelineCounters:
    """Per-stage counters and small histograms for a detection stream."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = defaultdict(int)
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self._t0 = time.time()

    def inc(self, name: str, by: int = 1) -> None:
        self.counts[name] += by

    def observe(self, name: str, value: float, keep: int = 512) -> None:
        lst = self.samples[name]
        lst.append(float(value))
        if len(lst) > keep:
            del lst[: len(lst) - keep]

    def snapshot(self) -> dict:
        out = {"uptime_s": round(time.time() - self._t0, 3)}
        out.update(self.counts)
        for name, vals in self.samples.items():
            if vals:
                s = sorted(vals)
                out[name] = {
                    "n": len(s),
                    "p50": s[len(s) // 2],
                    "p90": s[int(len(s) * 0.9)],
                    "max": s[-1],
                }
        return out

    def log_line(self) -> str:
        line = json.dumps(self.snapshot(), default=float)
        logger.info(line)
        return line


def validate_frame(depth, K, rgb=None) -> None:
    """API-boundary validation before anything is traced/jitted
    (the reference's CV_Assert discipline, surfaced as ValueErrors)."""
    import numpy as np

    depth = np.asarray(depth)
    if depth.ndim != 2:
        raise ValueError(f"depth must be [H, W], got shape {depth.shape}")
    K = np.asarray(K)
    if K.shape != (3, 3):
        raise ValueError(f"K must be 3x3, got {K.shape}")
    if not np.isfinite(K).all() or K[0, 0] <= 0 or K[1, 1] <= 0:
        raise ValueError(f"invalid intrinsics: {K}")
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.shape[:2] != depth.shape:
            raise ValueError(
                f"rgb {rgb.shape[:2]} does not match depth {depth.shape}"
            )
        if rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError(f"rgb must be [H, W, 3], got {rgb.shape}")
