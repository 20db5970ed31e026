"""Frozen configuration dataclasses.

Parameter names and default values mirror the canonical C++ implementation of
the reference's algorithm stack (OpenCV 4.6 contrib) 1:1 so parity tests read
one config table:

* ``DepthNormalParams``  — linemod.hpp:203-240 (defaults measured from the
  oracle's YAML dump: distance_threshold 2000, difference_threshold 50,
  num_features 63, extract_threshold 2).
* ``ColorGradientParams`` — linemod.hpp:166-198 (weak_threshold 10,
  num_features 63, strong_threshold 55).
* ``DetectorParams``     — linemod.hpp:294-413 (pyramid_levels 2, T = [5, 8]).
* ``ICPParams``          — icp.hpp:90-98 (tolerance 0.005, rejection_scale
  2.5, max_iterations 250(ctor default; 100 in common use), num_levels 6).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ColorGradientParams:
    """Color-gradient modality parameters (linemod.hpp:166-198)."""

    weak_threshold: float = 10.0
    num_features: int = 63
    strong_threshold: float = 55.0


@dataclasses.dataclass(frozen=True)
class DepthNormalParams:
    """Depth-normal modality parameters (linemod.hpp:203-240)."""

    distance_threshold: int = 2000
    difference_threshold: int = 50
    num_features: int = 63
    extract_threshold: int = 2


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    """LINEMOD detector parameters (linemod.hpp:294-413).

    ``t_at_level`` is the spreading / match-grid stride T per pyramid level;
    the oracle default (getDefaultLINEMOD) is ``(5, 8)`` with 2 levels.
    """

    t_at_level: Tuple[int, ...] = (5, 8)

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_at_level)


@dataclasses.dataclass(frozen=True)
class ICPParams:
    """Point-to-plane ICP parameters (icp.hpp:90-98, 117).

    ``solves_per_assoc`` is TPU-specific (no oracle analog): in the
    projective-association path (refine/projective.py) each iteration
    associates once (the scene gather — the stage's entire device cost)
    and then runs this many Gauss-Newton solves on the fixed
    correspondence set. The correspondence field only changes when
    points cross pixel boundaries, so a second solve on fixed pairs
    recovers most of a fresh association's progress at zero gather
    cost. Ignored by the brute-force NN path (refine/icp.py).

    ``finest_assoc`` is TPU-specific too: if > 0 it caps the number of
    associations run at the FINEST pyramid level (the full model
    cloud — ~half the stage's gather rows since every coarser level
    strides the model by 2^level). By the time the finest level runs,
    the stride-2 level has already converged the pose to sub-pixel
    projection error, so the finest level's correspondence field is
    static from its first association; its job is the final polish
    solves and the full-cloud residual/inlier census, which one or two
    associations deliver. 0 = no cap (finest level runs the same
    budget as every other level).
    """

    iterations: int = 250
    tolerance: float = 0.005
    rejection_scale: float = 2.5
    num_levels: int = 6
    solves_per_assoc: int = 1
    finest_assoc: int = 0


@dataclasses.dataclass(frozen=True)
class DetectParams:
    """End-to-end detect() pipeline parameters (reference L6 glue).

    ``match_threshold`` is the LINEMOD similarity threshold in percent;
    ``max_hypotheses`` bounds the per-frame ICP hypothesis batch (static
    shape under jit); ``nms_radius_px`` deduplicates hypotheses whose match
    centers are closer than this in pixels.
    """

    match_threshold: float = 80.0
    max_hypotheses: int = 16
    nms_radius_px: float = 24.0
    # post-ICP hypothesis scoring (north_star "hypothesis scoring and
    # NMS"): detections whose mean point-to-plane residual exceeds this
    # are rejected. Correct poses on these sensors score ~0.3-1.5 mm;
    # a smaller template latched onto part of a larger object refines to
    # ~5 mm [measured] and would otherwise out-vote genuine detections.
    max_residual: float = 0.004
    icp: ICPParams = dataclasses.field(
        default_factory=lambda: ICPParams(iterations=100)
    )
    # Survivor compaction for the fine ICP phase (config-4 regime): when
    # > 0 and < max_hypotheses, only the fine_compact best candidates by
    # coarse-phase residual (finite first) run the fine pyramid levels;
    # the rest are dropped exactly like candidates beyond
    # max_hypotheses. At 64 hypothesis slots most candidates die at the
    # coarse residual/inlier gate, and the fine levels are ~80% of ICP
    # point-iterations — capacity semantics, same spirit as
    # max_candidates (PARITY.md deviation 2). 0 = off (every lane runs
    # fine).
    fine_compact: int = 0
    # Depth seeds per match candidate: the hypothesis lift takes the
    # first ``num_seeds`` of the (q25, q50, q75) window-depth quantiles
    # as translation seeds; the coarse ICP phase runs K*num_seeds lanes
    # and each candidate keeps its best seed by residual. 2 drops the
    # q75 seed (ablation: 2.4 ms/batch-16 at the headline shape) — keep
    # 3 for heavy-occlusion workloads, where the object surface sits in
    # the window's UPPER depth quantiles behind a foreground occluder.
    num_seeds: int = 3
    # Windowed MXU association for the fine ICP phase (refine/projective
    # _associate_window): per surviving candidate, one static crop of
    # the packed scene around the match center replaces the latency-
    # bound full-scene row gather with two dense one-hot contractions
    # (exact gather; the only deviation is that correspondences beyond
    # the window margin are rejected — which the distance cap mostly
    # rejects anyway). -1 = auto-size from the template bank's largest
    # bbox plus a 64 px pose-drift margin (pipeline.py); 0 = off
    # (full-scene gather everywhere); > 0 = explicit window size in px.
    # DEFAULT OFF: the 2026-08-21 ablation (tools/prof_detect_ablate.py)
    # measured the one-hot contraction formulation 8.3 ms/batch-16
    # SLOWER than the row gather at the headline shapes — the HIGHEST-
    # precision matmul (needed for exactness) costs 6 bf16 MXU passes
    # over the full [n, window^2] one-hot volume, which exceeds the
    # latency-bound gather it replaces. Kept as an opt-in: the
    # formulation wins only if the window is small (<= ~128 px).
    icp_window: int = 0
