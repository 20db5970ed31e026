"""End-to-end 6D detection (port of object_detector_6d_tpu/api/pipeline.py
``PoseDetector``, fused path).

    PoseDetector(detector=Detector(), device="cuda")
    .add_view(class_id, depth, K, mask, rgb[, view_pose])   training
    .detect_fused_batch(depths [B, H, W], K, rgbs [B, H, W, 3])
                                                  -> [[Pose]] per frame

The default Detector has the reference's two modalities (ColorGradient on
the u8 BGR frames, DepthNormal on the u16 depth); a detector with
ColorGradient needs ``rgb`` / ``rgbs`` and raises ValueError without
them, a depth-only one (``Detector(modalities=("DepthNormal",))``) takes
none. Training (``add_view``) runs on the host: LINEMOD templates through
Detector.add_template, plus the view's masked cloud + FALS normals
(sampled to ``model_points``) as the ICP model. Detection runs the fused
program of api/detect_program.py on ``device`` and unpacks the device
cluster-NMS records into Pose objects.

``device`` defaults to the card ("cuda"); ``device="cpu"`` asks for the
plain twins on the host. Without a card, a detect call on the default
device raises: it never carries on on the CPU. A frame whose
coarse candidates overflow ``max_hypotheses`` raises: the reference falls
back to its host-orchestrated ``detect`` there, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.core.config import DetectParams
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics
from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d
from object_detector_6d_tpu_torch.geom.normals import normals_fals
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.refine.pose import Pose
from object_detector_6d_tpu_torch.utils.metrics import PipelineCounters, validate_frame


@dataclasses.dataclass
class _ViewRecord:
    """Per-template training-view metadata for hypothesis lifting."""

    model_cloud: np.ndarray  # [N, 6] xyz+normal, training camera frame
    bbox: Tuple[int, int, int, int]  # (x, y, w, h) at level 0
    anchor_point: np.ndarray  # 3D point of the bbox center at model depth
    view_pose: Optional[np.ndarray]  # model -> training camera, or None


class CandidateOverflow(RuntimeError):
    """More above-threshold coarse candidates than max_hypotheses."""


class PoseDetector:
    """Template-based 6D object detector, fused path."""

    def __init__(
        self,
        detector: Optional[Detector] = None,
        params: Optional[DetectParams] = None,
        model_points: int = 1024,
        scene_window: int = 160,
        lift_impl: str = "hist",
        device="cuda",
    ):
        self.detector = detector or Detector()
        self.params = params or DetectParams()
        self.model_points = model_points
        self.scene_window = scene_window
        self.lift_impl = lift_impl
        self.device = torch.device(device)
        self.views: Dict[Tuple[str, int], _ViewRecord] = {}
        self.counters = PipelineCounters()
        self._cache: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def add_view(
        self,
        class_id: str,
        depth_u16: np.ndarray,
        K: np.ndarray,
        object_mask: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        view_pose: Optional[np.ndarray] = None,
    ) -> int:
        """Register one training view; returns the template id or -1."""
        depth_u16 = np.asarray(depth_u16)
        sources = self._sources(rgb, depth_u16)
        tid, bbox = self.detector.add_template(sources, class_id, object_mask)
        if tid < 0:
            return -1
        d = torch.as_tensor(depth_u16.astype(np.int32))
        cloud_t = depth_to_3d(d, K)
        cloud = cloud_t.numpy()
        normals = normals_fals(cloud_t, K).numpy()
        mask = ((np.asarray(object_mask) > 0) & np.isfinite(cloud).all(-1)
                & np.isfinite(normals).all(-1))
        ys, xs = np.nonzero(mask)
        if len(ys) == 0:
            return -1
        sel = np.linspace(0, len(ys) - 1, min(self.model_points, len(ys))).astype(int)
        pts = cloud[ys[sel], xs[sel]]
        nrm = normals[ys[sel], xs[sel]]
        model = np.concatenate([pts, nrm], -1).astype(np.float32)
        # pad with NaN rows (masked out of the ICP sample)
        if len(model) < self.model_points:
            pad = np.full((self.model_points - len(model), 6), np.nan, np.float32)
            model = np.concatenate([model, pad], 0)
        bx, by, bw, bh = bbox
        z = float(np.nanmedian(pts[:, 2]))
        intr = Intrinsics.from_matrix(np.asarray(K))
        anchor = intr.reproject(bx + bw / 2.0, by + bh / 2.0, z).numpy()
        self.views[(class_id, tid)] = _ViewRecord(
            model, bbox, anchor.astype(np.float32),
            None if view_pose is None else np.asarray(view_pose, np.float32),
        )
        return tid

    def _sources(self, rgb, depth):
        """One source per modality, in the detector's order."""
        sources = []
        for name in self.detector.modality_names:
            if name == "ColorGradient":
                if rgb is None:
                    raise ValueError("detector has a ColorGradient modality; rgb required")
                sources.append(rgb)
            else:
                sources.append(depth)
        return sources

    # ------------------------------------------------------------------
    # detection
    # ------------------------------------------------------------------

    def detect_fused(self, depth_u16, K, rgb=None,
                     class_ids: Optional[Sequence[str]] = None,
                     match_threshold: Optional[float] = None) -> List[Pose]:
        """One frame through the fused program."""
        return self.detect_fused_batch(
            np.asarray(depth_u16)[None], K,
            None if rgb is None else np.asarray(rgb)[None],
            class_ids, match_threshold)[0]

    def detect_fused_batch(self, depths, K, rgbs=None,
                           class_ids: Optional[Sequence[str]] = None,
                           match_threshold: Optional[float] = None) -> List[List[Pose]]:
        """B frames sharing one camera through one program call: depths
        [B, H, W] u16, rgbs [B, H, W, 3] u8 BGR (numpy or tensors)."""
        return self.detect_fused_finalize(
            self.detect_fused_dispatch(depths, K, rgbs, class_ids, match_threshold))

    def program(self, H: int, W: int, K):
        """The fused detect program for (H, W, K) on this detector's device
        (cached) and its candidate capacity."""
        p = self.params
        kb = np.ascontiguousarray(np.asarray(K, np.float64)).tobytes()
        K_cap = max(8, p.max_hypotheses)
        key = ("prog", (H, W), kb, K_cap, p.fine_compact, self.lift_impl,
               p.icp, p.num_seeds)
        prog = self._cache.get(key)
        if prog is None:
            prog = dp.make_detect_program(
                self.detector.modality_names, self.detector.t_at_level, (H, W),
                self.detector.dn_params, self.detector.cg_params,
                np.asarray(K, np.float64),
                max_candidates=K_cap, icp=p.icp, lift_window=self.scene_window,
                num_seeds=p.num_seeds, fine_compact=p.fine_compact,
                lift_impl=self.lift_impl, device=self.device)
            self._cache[key] = prog
        return prog, K_cap

    def bank_tensors(self, bank):
        """The bank's arrays (match.program.BankArgs), packed views and
        template -> class-index table on the device, built once per bank."""
        key = ("bank", self.detector.bank_version, id(bank), len(self.views),
               self.model_points)
        hit = self._cache.get(key)
        if hit is None:
            index: Dict[str, int] = {}
            cls = np.empty(len(bank.class_ids), np.int64)
            for g, cid in enumerate(bank.class_ids):
                cls[g] = index.setdefault(cid, len(index))
            hit = (mp.bank_args(bank, self.device),
                   dp.pack_views(bank, self.views, self.model_points, self.device),
                   torch.as_tensor(cls, device=self.device))
            self._cache = {k: v for k, v in self._cache.items() if k[0] != "bank"}
            self._cache[key] = hit
        return hit

    def _nms_device_args(self, bank, K):
        """The cluster stage's template -> class-index table and its
        (max_residual, translation threshold) scalars."""
        p = self.params
        fx = float(np.asarray(K)[0, 0])
        return self.bank_tensors(bank)[2], p.max_residual, p.nms_radius_px / fx

    def detect_fused_dispatch(self, depths, K, rgbs=None,
                              class_ids: Optional[Sequence[str]] = None,
                              match_threshold: Optional[float] = None):
        """Launch the fused program; returns a handle for
        :meth:`detect_fused_finalize` (PyTorch queues the device work, so
        the call returns before the card finishes)."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"PoseDetector on {self.device}: no CUDA card is visible; pass "
                "device='cpu' to run the plain twins on the host")
        if isinstance(depths, torch.Tensor):
            validate_frame(np.empty(tuple(depths.shape[1:3])), K,
                           None if rgbs is None else np.empty(tuple(rgbs.shape[1:])))
            d = depths.to(self.device)
        else:
            depths = np.asarray(depths)
            validate_frame(depths[0], K, None if rgbs is None else np.asarray(rgbs)[0])
            d = torch.as_tensor(depths.astype(np.int32)).to(self.device)
        if rgbs is not None and "ColorGradient" in self.detector.modality_names:
            rgbs = torch.as_tensor(rgbs, dtype=torch.uint8).to(self.device)
        sources = self._sources(rgbs, d)
        B, H, W = d.shape
        p = self.params
        threshold = p.match_threshold if match_threshold is None else match_threshold
        bank = self.detector.get_bank(class_ids)
        if bank is None:
            return ("empty", B)
        prog, K_cap = self.program(H, W, K)
        bargs, views, _ = self.bank_tensors(bank)
        flat = prog(sources, bargs, views, threshold, *self._nms_device_args(bank, K))
        return (flat, B, K_cap, bank)

    def detect_fused_finalize(self, handle) -> List[List[Pose]]:
        """Wait for a dispatch handle and unpack its cluster records."""
        if isinstance(handle[0], str):  # "empty": no templates registered
            return [[] for _ in range(handle[1])]
        flat, B, K_cap, bank = handle
        slots, n_raw, n_pass = dp.unflatten_cluster_outputs(
            flat.cpu().numpy().reshape(B, -1), K_cap)
        results: List[List[Pose]] = []
        for b in range(B):
            if int(n_raw[b]) > K_cap:
                self.counters.inc("overflow")
                raise CandidateOverflow(
                    f"frame {b}: {int(n_raw[b])} coarse candidates > "
                    f"max_hypotheses capacity {K_cap}; the host-orchestrated "
                    "detect path the reference falls back to is ROADMAP "
                    "queue 1 item 11 (raise max_hypotheses meanwhile)")
            self.counters.inc("frames")
            self.counters.inc("matches", int(n_pass[b]))
            out: List[Pose] = []
            for k in range(K_cap):
                s = slots[b, k]
                if s[0] <= 0:
                    break  # valid clusters sort first
                tid = int(s[3])
                out.append(Pose(
                    pose=np.asarray(s[8:24], np.float64).reshape(4, 4),
                    residual=float(s[6]),
                    num_votes=int(round(s[1])),
                    class_id=bank.class_ids[tid],
                    template_id=int(bank.local_tids[tid]),
                    match_x=int(s[4]),
                    match_y=int(s[5]),
                    match_similarity=float(s[2]),
                ))
                self.counters.observe("icp_residual", float(s[6]))
            self.counters.inc("detections", len(out))
            results.append(out)
        return results
