"""Fused frame-batched detect: match -> geometry -> lift -> ICP -> NMS
(port of object_detector_6d_tpu/api/detect_program.py), on one device or
sharded over a (data, model) device mesh.

    sources (one batch per modality: [B, H, W, 3] u8 BGR, [B, H, W] depth)
        -> match program (match/program.py, top-K candidates)
        -> fused geometry (K5): cloud + FALS normals + packed scene
        -> hypothesis lift: per candidate, depth quantiles of the match
           window seed up to S translation hypotheses
        -> coarsest ICP level on all B*K*S lanes, best seed per candidate
        -> optional survivor compaction, fine ICP levels (optionally
           inside one window around each match centre, icp_window)
        -> raw outputs (packed, poses, res, keep), flat (flatten_outputs)
           or the device pose-cluster NMS record (make_cluster_stage)

The template bank's view tensors (model clouds, anchors, bboxes, view
poses) are packed once per bank by ``pack_views`` in the bank's global
template order. No gradients: the whole path runs under no_grad.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.config import ICPParams
from object_detector_6d_tpu_torch.core.exact import norm3, norm4
from object_detector_6d_tpu_torch.core.reduce import fixed_sum
from object_detector_6d_tpu_torch.core.se3 import SE3, small_matmul
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.ops.geometry import FusedScene, planes_to_scene8
from object_detector_6d_tpu_torch.parallel.sharding import all_gather_cat, axis_size
from object_detector_6d_tpu_torch.refine.projective import icp_levels
from object_detector_6d_tpu_torch.utils.debug import nan_watch
from object_detector_6d_tpu_torch.utils.profiling import scope


class PackedViews(NamedTuple):
    """Per-template training-view tensors in bank order."""

    model_bank: torch.Tensor  # [nT, N, 6] f32, NaN-padded
    anchors: torch.Tensor  # [nT, 3] f32 bbox-center anchor points
    bbox_wh: torch.Tensor  # [nT, 2] int64 level-0 (w, h)
    view_poses: torch.Tensor  # [nT, 4, 4] f32 (identity when unknown)
    views_ok: torch.Tensor  # [nT] bool: the template has a registered view


def pack_views(bank: "mp.PackedBank", views: Dict, model_points: int,
               device="cuda") -> PackedViews:
    """Stack PoseDetector.views records into bank-ordered tensors.

    ``views`` maps (class_id, local_tid) -> a record with model_cloud
    [N, 6], bbox (x, y, w, h), anchor_point [3] and view_pose (4x4 or None).
    """
    nT = bank.num_templates
    models = np.full((nT, model_points, 6), np.nan, np.float32)
    anchors = np.zeros((nT, 3), np.float32)
    bbox_wh = np.zeros((nT, 2), np.int64)
    poses = np.tile(np.eye(4, dtype=np.float32), (nT, 1, 1))
    ok = np.zeros(nT, bool)
    for g in range(nT):
        rec = views.get((bank.class_ids[g], int(bank.local_tids[g])))
        if rec is None:
            continue
        m = np.asarray(rec.model_cloud, np.float32)
        n = min(model_points, m.shape[0])
        models[g, :n] = m[:n]
        anchors[g] = rec.anchor_point
        bbox_wh[g] = (rec.bbox[2], rec.bbox[3])
        if rec.view_pose is not None:
            poses[g] = rec.view_pose
        ok[g] = True

    def t(a):
        return torch.as_tensor(a, device=device)

    return PackedViews(t(models), t(anchors), t(bbox_wh), t(poses), t(ok))


def flatten_outputs(packed, poses, res, keep, K_cap: int) -> torch.Tensor:
    """(packed [.., 5, K+1], poses [.., K, 4, 4], res [.., K], keep
    [.., K]) -> one f32 tensor [.., 5*(K+1) + 16K + 2K]."""
    lead = tuple(packed.shape[:-2])
    return torch.cat(
        [
            packed.reshape(lead + (5 * (K_cap + 1),)),
            poses.reshape(lead + (16 * K_cap,)),
            res.reshape(lead + (K_cap,)),
            keep.to(torch.float32).reshape(lead + (K_cap,)),
        ],
        dim=-1,
    )


def unflatten_outputs(flat: np.ndarray, K_cap: int):
    """Inverse of flatten_outputs (host side, numpy)."""
    lead = flat.shape[:-1]
    o = 5 * (K_cap + 1)
    packed = flat[..., :o].reshape(lead + (5, K_cap + 1))
    poses = flat[..., o:o + 16 * K_cap].reshape(lead + (K_cap, 4, 4))
    o += 16 * K_cap
    res = flat[..., o:o + K_cap]
    keep = flat[..., o + K_cap:o + 2 * K_cap] > 0
    return packed, poses, res, keep


CLUSTER_SLOT = 24  # per-cluster f32 record width (see make_cluster_stage)


def make_cluster_stage(K_cap: int, rot_thr_rad: float = float(np.deg2rad(15.0))):
    """Hypothesis scoring + greedy pose-cluster NMS on the device.

    The semantics of refine/pose.py cluster_poses + PoseCluster.mean_pose:
    filter (keep & finite & residual <= max_residual), stable sort by
    (-votes, residual), merge each pose into the FIRST existing cluster
    whose representative is within both thresholds (same class), average
    each cluster (hemisphere-aligned quaternion mean + translation mean),
    sort clusters by total votes.

    Returns ``cluster(packed [B,5,K+1], poses [B,K,4,4], res [B,K],
    keep [B,K], cls_of_tid [nT], max_residual, trans_thr) -> [B,
    K*CLUSTER_SLOT + 2]``. Slot layout: [valid, votes_total, sim_max,
    rep_tid, rep_x, rep_y, residual_mean, n_members, pose 4x4 row-major];
    trailer [n_raw_candidates, n_poses_pre_nms].
    """
    K = K_cap
    cos_half = float(np.float32(np.cos(rot_thr_rad / 2.0)))

    def cluster(packed, poses, res, keep, cls_of_tid, max_residual, trans_thr):
        B = packed.shape[0]
        dev = packed.device
        ar = torch.arange(K, device=dev)
        sim = torch.nan_to_num(packed[:, 2, :-1])
        votes = torch.round(sim * 100.0).to(torch.int64)
        tids = packed[:, 3, :-1].to(torch.int64)
        xs = packed[:, 0, :-1]
        ys = packed[:, 1, :-1]
        cls = cls_of_tid[tids]
        valid = keep & torch.isfinite(res) & (res <= max_residual)

        # stable sort by (-votes, residual): residual ranks (stable ties by
        # lane index) packed under the vote key
        inf = torch.full_like(res, float("inf"))
        rank_res = torch.argsort(torch.argsort(torch.where(valid, res, inf),
                                               dim=1, stable=True),
                                 dim=1, stable=True)
        key = torch.where(valid, votes * K + (K - 1 - rank_res), -1)
        order = torch.argsort(-key, dim=1, stable=True)

        def take(a):
            return torch.gather(a, 1, order.reshape(B, K, *([1] * (a.dim() - 2)))
                                .expand(B, K, *a.shape[2:]))

        valid_s = take(valid)
        q_all = SE3.to_quat(poses)
        vq = valid_s[..., None]
        q_s = torch.where(vq, torch.nan_to_num(take(q_all)), 0.0)
        t_s = torch.where(vq, torch.nan_to_num(take(poses[:, :, :3, 3])), 0.0)
        res_s = torch.where(valid_s, torch.nan_to_num(take(res)), 0.0)
        sim_s = torch.where(valid_s, take(sim), 0.0)
        votes_s = torch.where(valid_s, take(votes), 0)
        cls_s = take(cls)
        tid_s = take(tids)
        x_s = take(xs)
        y_s = take(ys)

        # pairwise compatibility (rotation via quaternion dot:
        # angle <= thr  <=>  |q_i . q_j| >= cos(thr/2))
        qq = small_matmul(q_s, q_s.transpose(1, 2))
        qd = torch.abs(qq) >= cos_half
        td = norm3(t_s[:, :, None] - t_s[:, None, :]) <= trans_thr
        compat0 = (qd & td & (cls_s[:, :, None] == cls_s[:, None, :])
                   & valid_s[:, :, None] & valid_s[:, None, :])

        # greedy first-fit
        is_rep = torch.zeros((B, K), dtype=torch.bool, device=dev)
        cluster_of = torch.full((B, K), -1, dtype=torch.int64, device=dev)
        for i in range(K):
            compat = compat0[:, i] & (ar < i)[None] & is_rep
            has = compat.any(dim=1)
            j0 = torch.argmax(compat.to(torch.int32), dim=1)  # first True
            vi = valid_s[:, i]
            is_rep[:, i] = vi & ~has
            cluster_of[:, i] = torch.where(vi, torch.where(has, j0, i), -1)

        # per-cluster aggregation ([rep j, member i] membership)
        M = (cluster_of[:, None, :] == ar[None, :, None]) & valid_s[:, None, :]
        Mf = M.to(res_s.dtype)
        cnt = Mf.sum(-1)
        denom = torch.clamp(cnt, min=1.0)
        votes_tot = (M * votes_s[:, None, :]).sum(-1)
        res_mean = fixed_sum(Mf * res_s[:, None, :], -1) / denom
        sim_max = torch.max(torch.where(M, sim_s[:, None, :], float("-inf")), dim=-1).values
        sign = torch.sign(qq)
        sign = torch.where(sign == 0, 1.0, sign)  # hemisphere-align to rep
        q_mean = fixed_sum((Mf * sign)[..., None] * q_s[:, None, :, :], 2)
        q_mean = q_mean / torch.clamp(norm4(q_mean, keepdim=True), min=1e-32)
        t_mean = fixed_sum(Mf[..., None] * t_s[:, None, :, :], 2) / denom[..., None]
        pose_mean = SE3.from_quat(q_mean, t_mean)

        # clusters sorted by total votes (stable: creation order ties)
        key2 = torch.where(is_rep, votes_tot * K + (K - 1 - ar)[None], -1)
        ord2 = torch.argsort(-key2, dim=1, stable=True)

        def take2(a):
            return torch.gather(a, 1, ord2.reshape(B, K, *([1] * (a.dim() - 2)))
                                .expand(B, K, *a.shape[2:]))

        f32 = torch.float32
        slots = torch.cat(
            [
                take2(is_rep)[..., None].to(f32),
                take2(votes_tot)[..., None].to(f32),
                take2(torch.where(is_rep, sim_max, 0.0))[..., None],
                take2(tid_s)[..., None].to(f32),
                take2(x_s)[..., None],
                take2(y_s)[..., None],
                take2(res_mean)[..., None],
                take2(cnt)[..., None],
                take2(pose_mean).reshape(B, K, 16),
            ],
            dim=-1,
        )  # [B, K, CLUSTER_SLOT]
        trailer = torch.stack([packed[:, 0, -1], valid.sum(1).to(f32)], dim=-1)
        return torch.cat([slots.reshape(B, -1), trailer], dim=-1)

    return cluster


def unflatten_cluster_outputs(flat: np.ndarray, K_cap: int):
    """Host inverse of make_cluster_stage's flat record.

    Returns (slots [.., K, CLUSTER_SLOT], n_raw [..], n_pass [..])."""
    lead = flat.shape[:-1]
    slots = flat[..., : K_cap * CLUSTER_SLOT].reshape(lead + (K_cap, CLUSTER_SLOT))
    return slots, flat[..., -2], flat[..., -1]


LIFT_HIST_BINS = 128
LIFT_HIST_SPAN_CAP = 1.0  # metres: bounds the bin width (see _hist_quantiles)


def _hist_quantiles(w: torch.Tensor, qlevels: torch.Tensor) -> torch.Tensor:
    """NaN-aware depth quantiles of windows [..., h, w] -> [..., S] via a
    fixed 128-bin histogram CDF over [zmin, zmin + min(span, 1 m)], with
    linear interpolation inside the selected bin (nanquantile's order
    position q*(n-1)); all-NaN windows give NaN. Same arithmetic as the
    reference; the bin counts are exact integer sums."""
    lead = w.shape[:-2]
    flat = w.reshape(*lead, -1)
    fin = torch.isfinite(flat)
    vals = torch.where(fin, flat, 0.0)
    finf = fin.to(torch.float32)
    n = finf.sum(-1)
    big = 3.4e38
    zmin = torch.where(fin, flat, big).amin(-1)
    zmax = torch.where(fin, flat, -big).amax(-1)
    zmax = torch.minimum(zmax, zmin + LIFT_HIST_SPAN_CAP)
    width = torch.clamp(zmax - zmin, min=1e-9) / LIFT_HIST_BINS
    idx = ((vals - zmin[..., None]) / width[..., None])
    idx = idx.clamp(-1.0, float(LIFT_HIST_BINS)).to(torch.int64)
    idx = idx.clamp(0, LIFT_HIST_BINS - 1)
    counts = torch.zeros(*lead, LIFT_HIST_BINS, dtype=torch.float32, device=w.device)
    counts.scatter_add_(-1, idx, finf)
    cdf = torch.cumsum(counts, -1)
    pos = qlevels * torch.clamp(n - 1.0, min=0.0)[..., None]  # [..., S]
    # first bin whose inclusive cdf exceeds pos = the bin holding it
    b = (cdf[..., None, :] <= pos[..., :, None]).sum(-1)
    b = b.clamp(0, LIFT_HIST_BINS - 1)
    c_at = torch.gather(counts, -1, b)
    c_b = torch.clamp(c_at, min=1.0)
    below = torch.gather(cdf, -1, b) - c_at
    v = zmin[..., None] + (b.to(torch.float32) + (pos - below + 0.5) / c_b) * width[..., None]
    v = torch.minimum(torch.maximum(v, zmin[..., None]), zmax[..., None])
    return torch.where(n[..., None] > 0, v, float("nan"))


def make_detect_program(
    modality_names: Sequence[str],
    t_at_level: Sequence[int],
    frame_shape: Tuple[int, int],
    dn_params,
    cg_params,
    K_mat: np.ndarray,
    max_candidates: int = 16,
    icp: Optional[ICPParams] = None,
    lift_window: int = 160,
    num_seeds: int = 3,
    seed_min_gap: float = 0.015,
    min_inlier_frac: float = 0.25,
    batch: Optional[int] = None,
    mesh=None,
    flat_output: bool = False,
    device_nms: bool = False,
    fine_compact: int = 0,
    lift_impl: str = "hist",
    icp_window: int = 0,
    device="cuda",
):
    """Build the detect program for one (frame shape, K) pair.

    Returns ``run(sources, bank_args, views, threshold, *nms_args)``.
    ``sources`` holds one source per modality, in ``modality_names``
    order; geometry reads the first one that is not ColorGradient (the
    depth). ``bank_args`` is a match.program.BankArgs on the same device.

    With ``batch=None`` the sources are one frame ([H, W] depth, [H, W, 3]
    u8 BGR) and the outputs have no leading axis; with an int ``batch``
    they are [batch, ...] and any other leading size raises; ``batch=-1``
    takes [B, ...] sources of any B (nothing in the program depends on B:
    every float sum over a lane's points is a ``core/reduce.py``
    ``fixed_sum`` tree, so a frame's output is the same bits alone and at
    any position of any batch, tests/test_torch_batch_size.py and
    chip_smoke.py phase 15; PoseDetector caches one such program for every
    batch size). Outputs:

    - default: ``(packed [.., 5, K+1], poses [.., K, 4, 4] f32, res [.., K]
      f32, keep [.., K] bool)``; ``poses`` compose the template's
      training-view pose (model -> scene camera);
    - ``flat_output=True``: the same as one f32 tensor per frame
      (flatten_outputs / unflatten_outputs);
    - ``device_nms=True``: the device cluster-NMS record of
      make_cluster_stage, [.., K*CLUSTER_SLOT+2] f32; ``nms_args`` are
      then ``(cls_of_tid [nT], max_residual, trans_thr)``.

    ``icp_window`` > 0 runs the fine ICP phase inside one [icp_window,
    icp_window] window of the scene around each surviving candidate's
    match centre (refine/projective.py ``_associate_window``); the
    coarse phase keeps the full gather. 0 keeps it everywhere.

    With ``mesh`` (a 2D (data, model) DeviceMesh, parallel/sharding.py
    make_mesh) the same program shards: frames over ``data``, the template
    bank over ``model`` in the match stage, and each frame's ICP hypothesis
    lanes over ``model`` in the refine stage. Every rank is given the whole
    batch and bank and returns the whole output, equal to the unsharded
    program's. It needs a batch (B divisible by the data axis), and
    ``max_candidates``, ``max_candidates * num_seeds`` and a compacting
    ``fine_compact`` divisible by the model axis, and a bank whose size
    divides by it (pack_bank's ``pad_to``).
    """
    if lift_impl not in ("hist", "sort"):
        raise ValueError(f"lift_impl {lift_impl!r}")
    icp = icp or ICPParams(iterations=100)
    H, W = frame_shape
    if icp_window > min(H, W):
        raise ValueError(f"icp_window {icp_window} exceeds the {H}x{W} frame")
    K_cap = max_candidates
    S = num_seeds
    K_mat = np.asarray(K_mat, np.float64)
    fx, fy = float(np.float32(K_mat[0, 0])), float(np.float32(K_mat[1, 1]))
    cx, cy = float(np.float32(K_mat[0, 2])), float(np.float32(K_mat[1, 2]))
    # the lift divides by fx, fy as the reference's XLA does (and PyTorch's
    # CUDA division by a Python scalar): a product with the f32 reciprocal,
    # the same bits on the card and the CPU
    inv_fx, inv_fy = (float(np.float32(1.0) / np.float32(f)) for f in (fx, fy))
    win = lift_window
    dev = torch.device(device)
    qlevels = torch.tensor([0.25, 0.5, 0.75][:S], dtype=torch.float32, device=dev)
    depth_idx = next(i for i, n in enumerate(modality_names) if n != "ColorGradient")
    match_prog = mp.make_match_program(modality_names, t_at_level, frame_shape,
                                       dn_params, cg_params, max_candidates, mesh)
    fscene = FusedScene(H, W, K_mat, device=dev)

    all_levels = list(range(icp.num_levels - 1, -1, -1))
    # the coarsest level runs on every (candidate, seed) lane; the rest
    # on the K surviving lanes
    if icp.num_levels >= 2:
        coarse_levels, fine_levels = all_levels[:1], all_levels[1:]
    else:
        coarse_levels, fine_levels = all_levels, []
    M_fine = fine_compact if (0 < fine_compact < K_cap) else K_cap
    if mesh is not None:
        dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
        di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        if batch is None or (batch > 0 and batch % dp):
            raise ValueError(f"a sharded program needs a batch divisible by the mesh's "
                             f"data axis ({batch} vs {dp})")
        if (K_cap * S) % tp or K_cap % tp:
            raise ValueError(f"max_candidates ({K_cap}) and max_candidates*num_seeds "
                             f"({K_cap * S}) must divide the model axis ({tp})")
        if M_fine < K_cap and M_fine % tp:
            raise ValueError(f"fine_compact ({M_fine}) must divide the model axis ({tp})")
    n_solves = max(1, icp.solves_per_assoc)
    iters = max(1, icp.iterations // icp.num_levels // n_solves)
    fine_iters = [
        min(iters, icp.finest_assoc) if (lvl == 0 and icp.finest_assoc > 0)
        else iters
        for lvl in fine_levels
    ]
    # the projective update-norm early exit (not icp.tolerance; see the
    # reference's note)
    proj_tol = 3e-4
    cluster_stage = make_cluster_stage(K_cap) if device_nms else None

    def lift(z_img, packed, views: PackedViews):
        """[B, 5, K+1] match arrays -> ICP-ready hypotheses and the fine
        phase's window origins [B, K]."""
        B = packed.shape[0]
        xs = packed[:, 0, :-1].to(torch.int64)
        ys = packed[:, 1, :-1].to(torch.int64)
        tids = packed[:, 3, :-1].to(torch.int64)
        keep = packed[:, 4, :-1] > 0

        bw = views.bbox_wh[tids, 0]
        bh = views.bbox_wh[tids, 1]
        cx_i = xs + bw // 2
        cy_i = ys + bh // 2
        x0 = torch.clamp(cx_i - win // 2, 0, W - win)
        y0 = torch.clamp(cy_i - win // 2, 0, H - win)
        step = torch.arange(0, win, 2, device=z_img.device)
        xs_g = x0[..., None] + step  # [B, K, win/2]
        ys_g = y0[..., None] + step
        bidx = torch.arange(B, device=z_img.device)[:, None, None, None]
        wdw = z_img[bidx, ys_g[..., :, None], xs_g[..., None, :]]  # [B, K, h, w]
        # restrict the quantiles to the matched template's bbox
        inx = (xs_g >= (cx_i - bw // 2 - 1)[..., None]) & (xs_g <= (cx_i + bw // 2 + 1)[..., None])
        iny = (ys_g >= (cy_i - bh // 2 - 1)[..., None]) & (ys_g <= (cy_i + bh // 2 + 1)[..., None])
        wdw = torch.where(iny[..., :, None] & inx[..., None, :], wdw, float("nan"))
        if lift_impl == "sort":
            zq = torch.nanquantile(wdw.reshape(B, K_cap, -1), qlevels, dim=-1)
            zq = zq.permute(1, 2, 0)  # [B, K, S]
        else:
            zq = _hist_quantiles(wdw, qlevels)
        finite = torch.isfinite(zq)
        # first-occurrence dedup: seed j drops if a valid earlier seed sits
        # within seed_min_gap
        close = torch.abs(zq[..., :, None] - zq[..., None, :]) < seed_min_gap
        seed_ok = torch.ones_like(finite)
        for j in range(1, S):
            earlier = torch.stack(
                [finite[..., i] & seed_ok[..., i] & close[..., j, i] for i in range(j)],
                -1).any(-1)
            seed_ok[..., j] = ~earlier
        seed_ok = seed_ok & finite & keep[..., None] & views.views_ok[tids][..., None]

        # translation seed: the match-bbox centre reprojected at the window
        # depth, shifted by the training view's anchor point
        cxf = xs.to(torch.float32) + bw.to(torch.float32) / 2.0
        cyf = ys.to(torch.float32) + bh.to(torch.float32) / 2.0
        zq_s = torch.nan_to_num(zq, nan=1.0)
        tx = zq_s * ((cxf - cx) * inv_fx)[..., None]
        ty = zq_s * ((cyf - cy) * inv_fy)[..., None]
        target = torch.stack([tx, ty, zq_s], -1)  # [B, K, S, 3]
        t0 = target - views.anchors[tids][..., None, :]
        pose0 = torch.eye(4, dtype=torch.float32, device=z_img.device).repeat(B, K_cap, S, 1, 1)
        pose0[..., :3, 3] = t0
        models = views.model_bank[tids]  # [B, K, N, 6]
        n_model_valid = torch.clamp(
            torch.isfinite(models[..., 0]).sum(-1).to(torch.float32), min=1.0)
        # fine-phase window origins (icp_window > 0), clamped into the frame
        wy0 = torch.clamp(cy_i - icp_window // 2, 0, max(H - icp_window, 0))
        wx0 = torch.clamp(cx_i - icp_window // 2, 0, max(W - icp_window, 0))
        return tids, keep, seed_ok, pose0, models, n_model_valid, wy0, wx0

    def icp_lanes(scenes, levels, iters_l, models, poses, wy0=None, wx0=None):
        """ICP of lanes [B, L] (models [B, L, N, 6], start poses [B, L, 4,
        4]; window origins [B, L] in the fine phase) against their frames'
        scenes -> (res [B, L], poses [B, L, 4, 4], n_inliers [B, L])."""
        B, L, N = models.shape[:3]
        frame_of = torch.arange(B, device=models.device).repeat_interleave(L)
        window = (None if wy0 is None or icp_window <= 0
                  else (wy0.reshape(-1), wx0.reshape(-1), icp_window))
        res, poses, nin = icp_levels(
            models.reshape(-1, N, 6), poses.reshape(-1, 4, 4), scenes, frame_of,
            fx, fy, cx, cy, H, W, levels=levels, iters_per_level=iters_l,
            tolerance=proj_tol, solves=n_solves, window=window)
        return res.reshape(B, L), poses.reshape(B, L, 4, 4), nin.reshape(B, L)

    def spread_lanes(scenes, levels, iters_l, *lanes):
        """``icp_lanes`` on one device, or under a mesh on this rank's
        contiguous L/tp lanes of every frame, gathered over the model axis."""
        if mesh is None:
            return icp_lanes(scenes, levels, iters_l, *lanes)
        part = lanes[0].shape[1] // tp
        mine = slice(mi * part, (mi + 1) * part)
        out = icp_lanes(scenes, levels, iters_l, *(a[:, mine] for a in lanes))
        return tuple(all_gather_cat(o, mesh, "model", dim=1) for o in out)

    def lift_and_refine(z_img, scenes, packed, views: PackedViews):
        B = packed.shape[0]
        tids, keep, seed_ok, pose0, models, n_model_valid, wy0, wx0 = lift(
            z_img, packed, views)
        N = models.shape[2]
        # phase 1: the coarsest level on every (frame, candidate, seed) lane
        res1, poses1, nin1 = spread_lanes(
            scenes, coarse_levels, iters,
            models[:, :, None].expand(B, K_cap, S, N, 6).reshape(B, K_cap * S, N, 6),
            pose0.reshape(B, K_cap * S, 4, 4))
        res1 = res1.reshape(B, K_cap, S)
        nin1 = nin1.reshape(B, K_cap, S)
        poses1 = poses1.reshape(B, K_cap, S, 4, 4)
        # best seed per candidate; only seeds whose last coarse step kept
        # a sizable inlier fraction are eligible
        last_coarse = coarse_levels[-1] if coarse_levels else 0
        n_coarse = n_model_valid / (1 << last_coarse)
        enough1 = nin1 >= min_inlier_frac * n_coarse[..., None]
        res_sel = torch.where(seed_ok & enough1, res1, float("inf"))
        best = torch.argmin(res_sel, dim=2)  # first minimum
        best_res = torch.gather(res_sel, 2, best[..., None])[..., 0]
        best_pose = torch.gather(
            poses1, 2, best[..., None, None, None].expand(B, K_cap, 1, 4, 4))[:, :, 0]
        if fine_levels:
            # survivor compaction: the M_fine best candidates by coarse
            # residual (stable: lane order breaks ties) run the fine levels;
            # the rest drop like coarse failures (with M_fine == K_cap, sel
            # only reorders independent lanes; so it serves the reference's
            # branch without compaction too). A lane's window follows its sel
            # entry. Under a mesh every rank computes the same sel from the
            # gathered residuals and refines its share of it.
            rank = torch.where(torch.isfinite(best_res), best_res, float("inf"))
            sel = torch.argsort(rank, dim=1, stable=True)[:, :M_fine]  # [B, M]
            m_sel = torch.gather(models, 1, sel[..., None, None].expand(B, M_fine, N, 6))
            p_sel = torch.gather(best_pose, 1, sel[..., None, None].expand(B, M_fine, 4, 4))
            res2, poses2, nin2 = spread_lanes(
                scenes, fine_levels, fine_iters, m_sel, p_sel,
                torch.gather(wy0, 1, sel), torch.gather(wx0, 1, sel))
            nmv_sel = torch.gather(n_model_valid, 1, sel)
            enough2 = nin2 >= min_inlier_frac * nmv_sel
            res_f = torch.where(torch.isfinite(torch.gather(best_res, 1, sel)) & enough2,
                                res2, float("inf"))
            best_res = torch.full_like(best_res, float("inf")).scatter(1, sel, res_f)
            best_pose = best_pose.scatter(
                1, sel[..., None, None].expand(B, M_fine, 4, 4), poses2)
        final = SE3.compose(best_pose, views.view_poses[tids])
        keep_out = keep & torch.isfinite(best_res)
        # debug mode only (no sync otherwise): NaN in a KEPT pose is a bug,
        # NaN is legal only as the masked-invalid value inside the program
        final = nan_watch(final, "detect.poses", mask=keep_out[..., None, None])
        return final, best_res, keep_out

    def check_sources(sources):
        """The sources as [B, ...] batches, after checking their leading
        axes against ``batch``."""
        if batch is None:
            if sources[depth_idx].dim() != 2:
                raise ValueError(f"a one-frame program takes an [H, W] depth, got "
                                 f"{tuple(sources[depth_idx].shape)}")
            return [s[None] for s in sources]
        for s in sources:
            if batch != -1 and s.shape[0] != batch:
                raise ValueError(f"a program for batch={batch} got a source of "
                                 f"shape {tuple(s.shape)}")
        return sources

    def frame_shard(sources):
        """Under a mesh: this rank's contiguous share of the frames."""
        if mesh is None:
            return sources
        bl = sources[0].shape[0] // dp
        return [s[di * bl:(di + 1) * bl] for s in sources]

    def gather_frames(out):
        """Under a mesh: every rank's frames of each output, in frame order."""
        if mesh is None:
            return out
        if isinstance(out, torch.Tensor):
            return all_gather_cat(out, mesh, "data")
        return tuple(all_gather_cat(o, mesh, "data") for o in out)

    @torch.no_grad()
    def run(sources, bank_args, views: PackedViews, threshold, *nms_args):
        sources = check_sources(sources)
        # named spans (utils/profiling.py): off unless profiling.enable(True),
        # then in torch.profiler traces and in profiling.take_spans()
        with scope("detect.match"):
            if mesh is None:
                packed = match_prog(sources, *bank_args, threshold)
            else:  # this rank's frames, merged over the model axis
                packed = match_prog.local(sources, *bank_args, threshold)[:, :5]
        depths = frame_shard(sources)[depth_idx]
        with scope("detect.geometry"):
            planes = fscene(depths)  # [B, 8, H, W]
            z_img = planes[:, 2]
            scenes = planes_to_scene8(planes)
        with scope("detect.lift_icp"):
            poses, res, keep = lift_and_refine(z_img, scenes, packed, views)
        if device_nms:
            cls_of_tid, max_residual, trans_thr = nms_args
            with scope("detect.cluster"):
                out = cluster_stage(packed, poses, res, keep, cls_of_tid,
                                    float(np.float32(max_residual)),
                                    float(np.float32(trans_thr)))
        elif nms_args:
            raise TypeError("the NMS arguments are taken only with device_nms=True")
        elif flat_output:
            out = flatten_outputs(packed, poses, res, keep, K_cap)
        else:
            out = (packed, poses, res, keep)
        out = gather_frames(out)
        if batch is None:
            return out[0] if isinstance(out, torch.Tensor) else tuple(o[0] for o in out)
        return out

    run.match_program = match_prog
    run.fused_scene = fscene
    return run
