"""Synthetic template banks for benches and dry runs (numpy-only copy of
object_detector_6d_tpu/data/synthetic.py).

``synthetic_bank`` fills a Detector with a deterministic,
realistically-shaped template bank (63+63 features at level 0, 31+31 at
level 1, bbox sizes like LINEMOD objects) without running view
extraction. The random stream is drawn in the reference's order, feature
for feature (modality 0 level 0, modality 1 level 0, modality 0 level 1,
modality 1 level 1), so the same seed gives the reference's bank.
"""

from __future__ import annotations

import numpy as np

from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.quant.features import Feature, Template


def scattered_features(rng, n, w, h, min_dist):
    """n features in [0, w] x [0, h], at least min_dist apart while 10000
    tries last, with random labels 0..7."""
    feats = []
    tries = 0
    while len(feats) < n and tries < 10000:
        x, y = int(rng.randint(0, w + 1)), int(rng.randint(0, h + 1))
        if all((x - f.x) ** 2 + (y - f.y) ** 2 >= min_dist**2 for f in feats):
            feats.append(Feature(x, y, int(rng.randint(0, 8))))
        tries += 1
    while len(feats) < n:
        feats.append(Feature(int(rng.randint(0, w + 1)), int(rng.randint(0, h + 1)),
                             int(rng.randint(0, 8))))
    return feats


def synthetic_bank(
    n_classes: int = 13,
    per_class: int = 10,
    bbox_px: int = 120,
    num_features: int = 63,
    seed: int = 0,
    detector: Detector | None = None,
) -> Detector:
    """Detector with n_classes x per_class synthetic two-modality template
    pyramids."""
    det = detector or Detector()
    rng = np.random.RandomState(seed)
    for c in range(n_classes):
        for _ in range(per_class):
            w = h = int(bbox_px * rng.uniform(0.8, 1.2))
            w1, h1 = w // 2, h // 2
            tp = [
                Template(w, h, 0, scattered_features(rng, num_features, w, h, 6)),
                Template(w, h, 0, scattered_features(rng, num_features, w, h, 6)),
                Template(w1, h1, 1, scattered_features(rng, num_features // 2, w1, h1, 4)),
                Template(w1, h1, 1, scattered_features(rng, num_features // 2, w1, h1, 4)),
            ]
            det.add_synthetic_template(tp, f"class_{c:02d}")
    return det
