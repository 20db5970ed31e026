"""End-to-end 6D detection (port of object_detector_6d_tpu/api/pipeline.py
``PoseDetector``).

    PoseDetector(detector=Detector(), device="cuda")
    .add_view(class_id, depth, K, mask, rgb[, view_pose])   training
    .detect_fused_batch(depths [B, H, W], K, rgbs [B, H, W, 3])
                                                  -> [[Pose]] per frame
    .detect_fused_dispatch / detect_fused_finalize          the same, split
    .detect_fused_dispatch_multi(depths [G, B, H, W], K, rgbs [G, B, H, W, 3])
    .detect_fused_finalize_multi(handle)          -> [[[Pose]]] per batch
    .detect_fused_finalize_many([handle, ...])    one copy for many handles
    .detect(depth [H, W], K, rgb [H, W, 3])       -> [Pose], host-orchestrated

The default Detector has the reference's two modalities (ColorGradient on
the u8 BGR frames, DepthNormal on the u16 depth); a detector with
ColorGradient needs ``rgb`` / ``rgbs`` and raises ValueError without
them, a depth-only one (``Detector(modalities=("DepthNormal",))``) takes
none. Training (``add_view``) runs on ``device``: LINEMOD templates through
Detector.add_template (K1 / K2 quantize the view; features are picked on
the host), plus the view's masked cloud + FALS normals (sampled to
``model_points``) as the ICP model; only the finished view record comes
back to numpy. ``detect_fused_batch``
runs the fused program of api/detect_program.py on ``device`` and unpacks
the device cluster-NMS records into Pose objects. A frame with more
coarse candidates than ``max_hypotheses`` slots falls back, as in the
reference, to ``detect``: Detector.match (the capacity ladder, then the
host-orchestrated matcher) -> cloud + FALS normals -> window depth
quantiles lift each match to up to three translation seeds ->
nearest-neighbour point-to-plane ICP (refine/icp.py) per hypothesis ->
best seed per match -> residual gate -> pose-cluster NMS on the host.

``device`` defaults to the card ("cuda"); ``device="cpu"`` asks for the
plain twins on the host. Without a card, a detect call on the default
device raises: it never carries on on the CPU.

With ``mesh`` (parallel/sharding.make_mesh; every rank builds the same
PoseDetector and makes the same calls) ``detect_fused_batch`` shards the
whole fused program over it, frames over ``data``, the template bank and
the ICP hypothesis lanes over ``model``, for batches of more than one
frame that divide the data axis; other batches run unsharded on each rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.api.detector import Detector, Match
from object_detector_6d_tpu_torch.core.config import DetectParams
from object_detector_6d_tpu_torch.core.device import checked_device
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics
from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d
from object_detector_6d_tpu_torch.geom.normals import normals_fals
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.parallel.sharding import axis_size
from object_detector_6d_tpu_torch.refine.icp import (
    ICP,
    _nanmedian,
    nanquantile,
    refine_one,
    split_scene,
)
from object_detector_6d_tpu_torch.refine.pose import Pose, cluster_poses
from object_detector_6d_tpu_torch.utils.metrics import PipelineCounters, validate_frame


@dataclasses.dataclass
class _ViewRecord:
    """Per-template training-view metadata for hypothesis lifting."""

    model_cloud: np.ndarray  # [N, 6] xyz+normal, training camera frame
    bbox: Tuple[int, int, int, int]  # (x, y, w, h) at level 0
    anchor_point: np.ndarray  # 3D point of the bbox center at model depth
    view_pose: Optional[np.ndarray]  # model -> training camera, or None


def _geometry_single(depth: torch.Tensor, K) -> torch.Tensor:
    """Cloud + FALS normals [H, W, 6] of one depth frame [H, W], on the
    frame's device (the normal estimator is cached per shape and K)."""
    cloud = depth_to_3d(depth, K)
    return torch.cat([cloud, normals_fals(cloud, K)], -1)


def _window_quantiles(z_img, centers, bboxes_wh, win: int) -> torch.Tensor:
    """NaN-aware depth quantiles (q25, q50, q75) [n, 3] of the ``win``-sized
    windows of ``z_img`` [H, W] around ``centers`` [n, 2] (x, y), restricted
    to the match bboxes ``bboxes_wh`` [n, 2] grown by one pixel. Several
    depth seeds make the lift robust to occluders inside the window; the
    bbox restriction keeps the quantiles on objects much smaller than the
    window. A window without a finite cell gives NaN."""
    H, W = z_img.shape
    dev = z_img.device
    cx, cy = centers[:, 0], centers[:, 1]
    x0 = torch.clamp(cx - win // 2, 0, W - win)
    y0 = torch.clamp(cy - win // 2, 0, H - win)
    step = torch.arange(win, device=dev)
    xs_g = x0[:, None] + step  # [n, win]
    ys_g = y0[:, None] + step
    w = z_img[ys_g[:, :, None], xs_g[:, None, :]]  # [n, win, win]
    bw, bh = bboxes_wh[:, 0:1], bboxes_wh[:, 1:2]
    inx = (xs_g >= cx[:, None] - bw // 2 - 1) & (xs_g <= cx[:, None] + bw // 2 + 1)
    iny = (ys_g >= cy[:, None] - bh // 2 - 1) & (ys_g <= cy[:, None] + bh // 2 + 1)
    w = torch.where(iny[:, :, None] & inx[:, None, :], w, float("nan"))
    qs = torch.tensor([0.25, 0.5, 0.75], dtype=torch.float32, device=dev)
    return nanquantile(w.reshape(w.shape[0], -1), qs)


class PoseDetector:
    """Template-based 6D object detector (mirrors the reference API)."""

    def __init__(
        self,
        detector: Optional[Detector] = None,
        params: Optional[DetectParams] = None,
        model_points: int = 1024,
        scene_window: int = 160,
        scene_points_stride: int = 2,
        mesh=None,
        lift_impl: str = "hist",
        device="cuda",
    ):
        """``mesh``: an optional 2D (data, model) DeviceMesh on ``device``'s
        type (parallel/sharding.make_mesh), see the module's docstring."""
        self.detector = detector or Detector()
        self.params = params or DetectParams()
        self.model_points = model_points
        self.scene_window = scene_window
        self.scene_stride = scene_points_stride
        self.lift_impl = lift_impl
        self.device = torch.device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a mesh of {mesh.device_type!r} devices for a detector on "
                             f"{self.device}")
        self.mesh = mesh
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
        """Register one training view on this detector's device; returns
        the template id or -1."""
        dev = checked_device(self.device)
        depth_u16 = np.asarray(depth_u16)
        sources = self._sources(rgb, depth_u16)
        tid, bbox = self.detector.add_template(sources, class_id, object_mask, dev)
        if tid < 0:
            return -1
        cloud = depth_to_3d(torch.as_tensor(depth_u16.astype(np.int32), device=dev), K)
        normals = normals_fals(cloud, K)
        mask = (torch.as_tensor(np.asarray(object_mask) > 0, device=dev)
                & torch.isfinite(cloud).all(-1) & torch.isfinite(normals).all(-1))
        ys, xs = torch.nonzero(mask, as_tuple=True)
        if len(ys) == 0:
            return -1
        sel = torch.as_tensor(np.linspace(0, len(ys) - 1, min(self.model_points, len(ys)))
                              .astype(int), device=dev)
        model = torch.cat([cloud[ys[sel], xs[sel]], normals[ys[sel], xs[sel]]], -1)
        # pad with NaN rows (masked out of the ICP sample)
        if len(model) < self.model_points:
            model = torch.cat([model, torch.full((self.model_points - len(model), 6),
                                                 float("nan"), device=dev)])
        bx, by, bw, bh = bbox
        # np.nanmedian's rule (the middle pair averaged), in float32
        z = float(_nanmedian(model[:len(sel), 2]))
        intr = Intrinsics.from_matrix(np.asarray(K), device=dev)
        anchor = intr.reproject(bx + bw / 2.0, by + bh / 2.0, z)
        self.views[(class_id, tid)] = _ViewRecord(
            model.cpu().numpy(), bbox, anchor.cpu().numpy(),
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
        """One frame through the fused program (``detect`` on
        coarse-candidate overflow)."""
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

    def program(self, H: int, W: int, K, bank=None, mesh=None):
        """The fused detect program for (H, W, K) on this detector's device
        (cached; it takes a batch of any size, a multiple of the data axis
        under ``mesh``, and returns the device NMS record) and its candidate
        capacity. ``bank`` sizes the automatic ICP window
        (``resolve_icp_window``); the detector's full bank when None."""
        p = self.params
        kb = np.ascontiguousarray(np.asarray(K, np.float64)).tobytes()
        K_cap, fine_compact = self._capacities(mesh)
        icp_window = resolve_icp_window(
            p.icp_window, self.detector.get_bank() if bank is None else bank, H, W)
        key = ("prog", (H, W), kb, K_cap, fine_compact, self.lift_impl,
               p.icp, p.num_seeds, mesh, icp_window)
        prog = self._cache.get(key)
        if prog is None:
            prog = self.build_program(H, W, K, batch=-1, device_nms=True,
                                      icp_window=icp_window, mesh=mesh)
            self._cache[key] = prog
        return prog, K_cap

    def build_program(self, H: int, W: int, K, **forms):
        """A new (uncached) detect program with this detector's settings
        on its device, in the form ``forms`` selects (make_detect_program's
        batch / mesh / flat_output / device_nms / icp_window)."""
        p = self.params
        K_cap, fine_compact = self._capacities(forms.get("mesh"))
        return dp.make_detect_program(
            self.detector.modality_names, self.detector.t_at_level, (H, W),
            self.detector.dn_params, self.detector.cg_params, np.asarray(K, np.float64),
            max_candidates=K_cap, icp=p.icp,
            lift_window=self.scene_window, num_seeds=p.num_seeds,
            fine_compact=fine_compact, lift_impl=self.lift_impl, device=self.device,
            **forms)

    def _capacities(self, mesh):
        """(max_candidates, fine_compact) of the program: under a mesh both
        rounded up to multiples of its model axis, as the reference does."""
        p = self.params
        tp = 1 if mesh is None else axis_size(mesh, "model")
        return -(-max(8, p.max_hypotheses) // tp) * tp, -(-p.fine_compact // tp) * tp

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
        checked_device(self.device)
        frames = (depths, rgbs)  # as given, for the overflow fallback
        if isinstance(depths, torch.Tensor):
            validate_frame(np.empty(tuple(depths.shape[1:3])), K,
                           None if rgbs is None else np.empty(tuple(rgbs.shape[1:])))
            d = depths.to(self.device)
        else:
            depths = np.asarray(depths)
            validate_frame(depths[0], K, None if rgbs is None else np.asarray(rgbs)[0])
            d = torch.as_tensor(depths.astype(np.int32)).to(self.device)
        if rgbs is not None and "ColorGradient" in self.detector.modality_names:
            if not isinstance(rgbs, torch.Tensor):
                # a BGR view of RGB frames ([..., ::-1]) has a negative stride
                rgbs = np.ascontiguousarray(rgbs, np.uint8)
            rgbs = torch.as_tensor(rgbs, dtype=torch.uint8).to(self.device)
        sources = self._sources(rgbs, d)
        B, H, W = d.shape
        p = self.params
        threshold = p.match_threshold if match_threshold is None else match_threshold
        # the mesh's rules: shard a batch of more than one frame that divides
        # the data axis, with a bank padded to the model axis
        mesh = self.mesh
        if mesh is not None and (B == 1 or B % axis_size(mesh, "data")):
            mesh = None
        tp = 1 if mesh is None else axis_size(mesh, "model")
        bank = self.detector.get_bank(class_ids, pad_to=tp)
        if bank is None:
            return ("empty", B)
        prog, K_cap = self.program(H, W, K, bank, mesh)
        bargs, views, _ = self.bank_tensors(bank)
        flat = prog(sources, bargs, views, threshold, *self._nms_device_args(bank, K))
        return (flat, B, K_cap, bank, *frames, K, class_ids, match_threshold)

    def detect_fused_dispatch_multi(self, depths_g, K, rgbs_g=None,
                                    class_ids: Optional[Sequence[str]] = None,
                                    match_threshold: Optional[float] = None):
        """Dispatch G frame batches (depths_g [G, B, H, W] u16, rgbs_g [G, B,
        H, W, 3] u8 BGR) back to back: G runs of the cached program, queued
        on the card before any result is read (the reference scans them
        inside one execution). A throughput shape, not a low-latency one.
        Each run resolves ``icp_window`` as detect_fused_dispatch does.
        Finalize with :meth:`detect_fused_finalize_multi`."""
        G, B = depths_g.shape[:2]
        if self.detector.get_bank(class_ids) is None:
            return ("empty", G, B)
        return ("multi", [self.detect_fused_dispatch(
            depths_g[g], K, None if rgbs_g is None else rgbs_g[g], class_ids,
            match_threshold) for g in range(G)])

    def detect_fused_finalize_multi(self, handle) -> List[List[List[Pose]]]:
        """One device-to-host copy for the G batches, then the host
        unpacking per batch."""
        if handle[0] == "empty":
            return [[[] for _ in range(handle[2])] for _ in range(handle[1])]
        return self.detect_fused_finalize_many(handle[1])

    def detect_fused_finalize(self, handle) -> List[List[Pose]]:
        """Wait for a dispatch handle and unpack its cluster records."""
        if isinstance(handle[0], str):  # "empty": no templates registered
            return [[] for _ in range(handle[1])]
        return self._finalize_host(handle[0].cpu().numpy(), handle)

    def detect_fused_finalize_many(self, handles) -> List[List[List[Pose]]]:
        """Finalize several same-shape dispatch handles with one
        ``torch.stack`` and one device-to-host copy; an "empty" handle
        keeps its place. One result list per handle, in order."""
        out: List = [None] * len(handles)
        real = []
        for i, h in enumerate(handles):
            if isinstance(h[0], str):
                out[i] = [[] for _ in range(h[1])]
            else:
                real.append((i, h))
        if real:
            stacked = torch.stack([h[0] for _, h in real]).cpu().numpy()
            for (i, h), flat in zip(real, stacked):
                out[i] = self._finalize_host(flat, h)
        return out

    def _finalize_host(self, flat: np.ndarray, handle) -> List[List[Pose]]:
        """Unpack one transferred block of device cluster records; a frame
        whose coarse candidates overflowed goes through ``detect``."""
        _flat, B, K_cap, bank, depths, rgbs, K, class_ids, match_threshold = handle
        slots, n_raw, n_pass = dp.unflatten_cluster_outputs(flat.reshape(B, -1), K_cap)
        results: List[List[Pose]] = []
        for b in range(B):
            if int(n_raw[b]) > K_cap:
                # coarse-candidate overflow: the host path keeps parity
                self.counters.inc("overflow_fallback")
                results.append(self.detect(
                    _host(depths[b]), K, None if rgbs is None else _host(rgbs[b]),
                    class_ids, match_threshold))
                continue
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

    def detect(self, depth_u16, K, rgb=None,
               class_ids: Optional[Sequence[str]] = None,
               match_threshold: Optional[float] = None) -> List[Pose]:
        """Host-orchestrated pipeline on one frame: match -> lift -> ICP
        per hypothesis -> score -> NMS."""
        dev = checked_device(self.device)
        validate_frame(depth_u16, K, rgb)
        p = self.params
        threshold = p.match_threshold if match_threshold is None else match_threshold
        sources = self._sources(rgb, depth_u16)
        matches = self.detector.match(sources, threshold, class_ids, device=dev)
        self.counters.inc("frames")
        self.counters.inc("matches", len(matches))
        matches = matches[: p.max_hypotheses]
        for m in matches:
            self.counters.observe("match_similarity", m.similarity)
        if not matches:
            return []

        depth = torch.as_tensor(np.asarray(depth_u16).astype(np.int32)).to(dev)
        scene6 = _geometry_single(depth, K)
        intr = Intrinsics.from_matrix(np.asarray(K))

        # --- lift hypotheses (window depth quantiles on the device) ---
        pre = []
        centers = []
        whs = []
        for m in matches:
            rec = self.views.get((m.class_id, m.template_id))
            if rec is None:
                continue
            bw, bh = rec.bbox[2], rec.bbox[3]
            pre.append((m, rec))
            centers.append((int(m.x + bw // 2), int(m.y + bh // 2)))
            whs.append((bw, bh))
        if not pre:
            return []
        zqs = _window_quantiles(
            scene6[..., 2],
            torch.as_tensor(np.asarray(centers, np.int64), device=dev),
            torch.as_tensor(np.asarray(whs, np.int64), device=dev),
            self.scene_window).cpu().numpy()
        # one hypothesis per distinct depth quantile (occluders in the
        # window skew any single statistic)
        hyps: List[Tuple[Match, _ViewRecord, np.ndarray, int]] = []
        for mi, ((m, rec), zq) in enumerate(zip(pre, zqs)):
            zs_u: List[float] = []
            for z in (float(z) for z in zq if np.isfinite(z)):
                if all(abs(z - z2) > 0.015 for z2 in zs_u):
                    zs_u.append(z)
            bw, bh = rec.bbox[2], rec.bbox[3]
            for z in zs_u:
                target = intr.reproject(m.x + bw / 2.0, m.y + bh / 2.0, z).numpy()
                pose0 = np.eye(4, dtype=np.float32)
                pose0[:3, 3] = target - rec.anchor_point
                hyps.append((m, rec, pose0, mi))
        if not hyps:
            return []

        # --- ICP per hypothesis with its own model cloud ---
        models = np.stack([h[1].model_cloud for h in hyps])
        poses0 = np.stack([h[2] for h in hyps])
        scene_sub = scene6[:: self.scene_stride, :: self.scene_stride].reshape(-1, 6)
        residuals, poses = _batched_icp(ICP.from_params(p.icp, dev), models,
                                        scene_sub, poses0)

        # keep the best-residual hypothesis per match (the first on ties)
        best_by_match: Dict[int, int] = {}
        for i, h in enumerate(hyps):
            mi = h[3]
            if mi not in best_by_match or residuals[i] < residuals[best_by_match[mi]]:
                best_by_match[mi] = i
        keep_idx = sorted(best_by_match.values())
        hyps = [hyps[i] for i in keep_idx]
        residuals = residuals[keep_idx]
        poses = poses[keep_idx]

        # --- score + NMS ---
        out: List[Pose] = []
        for i, (m, rec, _p0, _mi) in enumerate(hyps):
            pose = poses[i]
            if rec.view_pose is not None:
                pose = pose @ rec.view_pose
            out.append(Pose(
                pose=np.asarray(pose, np.float64),
                residual=float(residuals[i]),
                num_votes=int(round(m.similarity * 100)),
                class_id=m.class_id,
                template_id=m.template_id,
                match_x=m.x,
                match_y=m.y,
                match_similarity=m.similarity,
            ))
        for r in residuals:
            self.counters.observe("icp_residual", float(r))
        out = [q for q in out if q.residual <= p.max_residual]
        clusters = cluster_poses(
            out, translation_threshold=p.nms_radius_px / float(intr.fx))
        self.counters.inc("detections", len(clusters))
        return [c.mean_pose() for c in clusters]


def resolve_icp_window(icp_window: int, bank, H: int, W: int) -> int:
    """DetectParams.icp_window as the program takes it: -1 sizes the
    window from the bank's largest level-0 template side plus a 64 px
    pose-drift margin, rounded up to 8 and held to 96..256 px, then to the
    frame; any other value is returned as it is."""
    if icp_window >= 0:
        return icp_window
    mb = int(np.max(bank.sizes[0])) if len(bank.sizes[0]) else 0
    return min(min(256, max(96, -(-(mb + 64) // 8) * 8)), H, W)


def _host(a) -> np.ndarray:
    """One frame of a dispatch handle as numpy (batches may be tensors)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _batched_icp(icp: ICP, models: np.ndarray, scene: torch.Tensor,
                 poses0: np.ndarray):
    """ICP of each (model, pose) pair against the scene [M, 6] on the
    scene's device -> numpy (residuals [B], poses [B, 4, 4])."""
    dev = scene.device
    res, ps = _icp_run_multi(
        torch.as_tensor(models, device=dev), scene,
        torch.as_tensor(poses0, device=dev),
        icp.iterations, *icp.scalars(), icp.num_levels)
    return res.cpu().numpy(), ps.cpu().numpy()


def _icp_run_multi(models, scene_pc, poses, iterations, tolerance,
                   rejection_scale, num_levels):
    """ICP where each hypothesis has its own model cloud [B, N, 6];
    correspondences are capped at 0.015 * 2^level metres. The hypotheses
    run one after another, so one [rows, M] distance block is alive at a
    time."""
    scene = split_scene(scene_pc)
    out = [refine_one(model_pc, pose0, *scene, iterations, tolerance,
                      rejection_scale, num_levels, corr_cap=0.015)
           for model_pc, pose0 in zip(models, poses)]
    return torch.stack([r for r, _ in out]), torch.stack([p for _, p in out])
