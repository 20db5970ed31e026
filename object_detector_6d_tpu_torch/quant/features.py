"""Template feature extraction (reference: QuantizedPyramid::extractTemplate,
linemod.hpp:74-110).

Host-side numpy: extraction runs once per training view at template-build
time (not latency-critical — SURVEY.md section 7), while the per-frame
quantizers it consumes are the TPU programs in quant/. Bit-parity with the
oracle is verified on the golden sphere template
(tests/test_features.py).

* ColorGradient: candidates are silhouette pixels (mask minus its 3x3
  erosion — "features on the border to distinguish from background") with
  non-zero quantized angle and squared magnitude > strong_threshold^2,
  scored by magnitude.
* DepthNormal: the mask is eroded (2 iterations) to drop unreliable
  border normals; per-orientation L-inf (DIST_C) distance transforms
  score how deep each pixel sits inside a same-orientation region;
  candidates need score >= extract_threshold.
* select_scattered_features: greedy pick of the highest-scored candidates
  subject to a minimum pairwise distance, relaxed by 1px on each full
  sweep until ``num_features`` are found.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Feature:
    """One quantized template feature (linemod.hpp:244-257)."""

    x: int
    y: int
    label: int


@dataclasses.dataclass
class Template:
    """One modality x pyramid-level template (linemod.hpp:259-287)."""

    width: int
    height: int
    pyramid_level: int
    features: List[Feature]

    def feature_array(self) -> np.ndarray:
        return np.array([(f.x, f.y, f.label) for f in self.features], np.int32).reshape(-1, 3)


def get_label(quantized: int) -> int:
    """One-hot byte -> bit index (linemod getLabel)."""
    lbl = int(quantized).bit_length() - 1
    if quantized != (1 << lbl):
        raise ValueError(f"invalid one-hot quantized value {quantized}")
    return lbl


def erode3x3(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Binary 3x3 rect erosion, replicate border (cv::erode defaults)."""
    m = mask.astype(bool)
    for _ in range(iterations):
        p = np.pad(m, 1, mode="edge")
        out = np.ones_like(m)
        for dy in range(3):
            for dx in range(3):
                out &= p[dy : dy + m.shape[0], dx : dx + m.shape[1]]
        m = out
    return m


def distance_transform_c(nonzero: np.ndarray) -> np.ndarray:
    """L-inf (chessboard) distance to the nearest zero pixel.

    Matches cv::distanceTransform(DIST_C, maskSize 3): two-pass chamfer
    with unit straight and diagonal costs; exact integers returned as f32.
    """
    H, W = nonzero.shape
    INF = 1 << 20
    d = np.where(nonzero, INF, 0).astype(np.int32)
    # forward pass
    for y in range(H):
        for x in range(W):
            if d[y, x] == 0:
                continue
            best = d[y, x]
            if x > 0:
                best = min(best, d[y, x - 1] + 1)
            if y > 0:
                best = min(best, d[y - 1, x] + 1)
                if x > 0:
                    best = min(best, d[y - 1, x - 1] + 1)
                if x < W - 1:
                    best = min(best, d[y - 1, x + 1] + 1)
            d[y, x] = best
    # backward pass
    for y in range(H - 1, -1, -1):
        for x in range(W - 1, -1, -1):
            best = d[y, x]
            if best == 0:
                continue
            if x < W - 1:
                best = min(best, d[y, x + 1] + 1)
            if y < H - 1:
                best = min(best, d[y + 1, x] + 1)
                if x < W - 1:
                    best = min(best, d[y + 1, x + 1] + 1)
                if x > 0:
                    best = min(best, d[y + 1, x - 1] + 1)
            d[y, x] = best
    return d.astype(np.float32)


def select_scattered_features(
    candidates: Sequence[Tuple[float, int, int, int]],
    num_features: int,
    distance: float,
) -> Optional[List[Feature]]:
    """Greedy distance-suppressed selection (linemod.hpp:107-109).

    ``candidates``: (score, x, y, label), already sorted by descending
    score (stable). Sweeps the list, keeping candidates at least
    ``distance`` away from all kept features; each full sweep relaxes the
    distance by 1. Returns None if the distance collapses below 1 first.
    """
    features: List[Feature] = []
    distance_sq = distance * distance
    i = 0
    while len(features) < num_features:
        if distance < 1.0 or not candidates:
            return None
        score, x, y, label = candidates[i]
        keep = True
        for f in features:
            dx = x - f.x
            dy = y - f.y
            if dx * dx + dy * dy < distance_sq:
                keep = False
                break
        if keep:
            features.append(Feature(x, y, label))
        i += 1
        if i == len(candidates):
            i = 0
            distance -= 1.0
            distance_sq = distance * distance
    return features


def _stable_sort_by_score(cands: List[Tuple[float, int, int, int]]):
    # candidates are generated in row-major scan order; stable sort by
    # descending score preserves that order among ties, matching the
    # oracle's std::stable_sort on Candidate::operator< (score >).
    cands.sort(key=lambda c: -c[0])


def extract_color_gradient(
    quantized: np.ndarray,
    magnitude: np.ndarray,
    mask: Optional[np.ndarray],
    num_features: int,
    strong_threshold: float,
    pyramid_level: int,
) -> Optional[Template]:
    """ColorGradient extractTemplate (candidates on the mask boundary)."""
    if mask is not None:
        local_mask = mask.astype(bool) & ~erode3x3(mask, 1)
    else:
        local_mask = np.ones_like(quantized, bool)
    thr = np.float32(strong_threshold) ** 2
    cands: List[Tuple[float, int, int, int]] = []
    ys, xs = np.nonzero(local_mask & (quantized > 0) & (magnitude > thr))
    order = np.lexsort((xs, ys))  # row-major scan order
    for i in order:
        y, x = int(ys[i]), int(xs[i])
        cands.append((float(magnitude[y, x]), x, y, get_label(int(quantized[y, x]))))
    if len(cands) < num_features:
        return None
    _stable_sort_by_score(cands)
    distance = float(len(cands) // num_features + 1)
    feats = select_scattered_features(cands, num_features, distance)
    if feats is None:
        return None
    return Template(-1, -1, pyramid_level, feats)


def extract_depth_normal(
    quantized: np.ndarray,
    mask: Optional[np.ndarray],
    num_features: int,
    extract_threshold: int,
    pyramid_level: int,
) -> Optional[Template]:
    """DepthNormal extractTemplate (interior, per-label stability DT)."""
    H, W = quantized.shape
    if mask is not None:
        local_mask = erode3x3(mask, 2)
    else:
        local_mask = np.ones((H, W), bool)
    distances = np.zeros((8, H, W), np.float32)
    for lbl in range(8):
        region = local_mask & (quantized == (1 << lbl))
        distances[lbl] = distance_transform_c(region)
    sel_mask = local_mask if mask is not None else np.ones((H, W), bool)
    cands: List[Tuple[float, int, int, int]] = []
    label_counts = np.zeros(8, np.int32)
    q_ok = sel_mask & (quantized != 0) & (quantized != 255)
    ys, xs = np.nonzero(q_ok)
    order = np.lexsort((xs, ys))
    for i in order:
        y, x = int(ys[i]), int(xs[i])
        lbl = get_label(int(quantized[y, x]))
        score = float(distances[lbl, y, x])
        if score >= extract_threshold:
            cands.append((score, x, y, lbl))
            label_counts[lbl] += 1
    if len(cands) < num_features:
        return None
    # Down-weight candidates of over-represented orientations so the
    # selected features balance across labels (oracle: score /= count).
    cands = [
        (float(np.float32(s) / np.float32(label_counts[lbl])), x, y, lbl)
        for (s, x, y, lbl) in cands
    ]
    _stable_sort_by_score(cands)
    if mask is not None:
        area = float(local_mask.sum())
    else:
        area = float(H * W)
    distance = float(np.sqrt(area) / np.sqrt(float(num_features)) + 1.5)
    feats = select_scattered_features(cands, num_features, distance)
    if feats is None:
        return None
    return Template(-1, -1, pyramid_level, feats)


def crop_templates(templates: List[Template]) -> Tuple[int, int, int, int]:
    """Crop all templates to their common bounding box (linemod
    cropTemplates); feature coords become bbox-relative. Returns the
    level-0 (x, y, w, h) bbox."""
    min_x = min_y = 1 << 30
    max_x = max_y = -(1 << 30)
    for t in templates:
        for f in t.features:
            x = f.x << t.pyramid_level
            y = f.y << t.pyramid_level
            min_x = min(min_x, x)
            min_y = min(min_y, y)
            max_x = max(max_x, x)
            max_y = max(max_y, y)
    if min_x % 2 == 1:
        min_x -= 1
    if min_y % 2 == 1:
        min_y -= 1
    for t in templates:
        t.width = (max_x - min_x) >> t.pyramid_level
        t.height = (max_y - min_y) >> t.pyramid_level
        ox = min_x >> t.pyramid_level
        oy = min_y >> t.pyramid_level
        for f in t.features:
            f.x -= ox
            f.y -= oy
    return (min_x, min_y, max_x - min_x, max_y - min_y)
