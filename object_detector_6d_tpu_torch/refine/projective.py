"""Projective-association point-to-plane ICP (port of
object_detector_6d_tpu/refine/projective.py), batched over lanes.

Each model point is projected through the lane's pose into the organized
scene's pixel grid; the scene point/normal stored there is its
correspondence (a row gather instead of a nearest-neighbour search).
Rejection: a per-level distance cap and a normal-compatibility gate.
The solve is the centroid-conjugated point-to-plane linearization with
an unrolled, Levenberg-damped 6x6 Cholesky; its sums over points are
``core/reduce.py`` ``fixed_sum`` trees, so a lane's bits do not depend
on the lanes beside it (the reference's matmuls and sums, reordered).

Everything is written once for a leading lane axis L (the reference
``vmap``s a single-lane function). Scenes are [S, H*W, C] packed rows
[x, y, z, nx, ny, nz, valid, ...]; ``scene_of_lane`` [L] picks each
lane's scene. An optional per-lane window ``(wy0 [L], wx0 [L], iw)``
limits the correspondences to each lane's [iw, iw] crop of its scene
(the reference's windowed association, ``_associate_window``).

The reference's ``lax.while_loop`` ends each lane on its own: the step
whose twist-update norm falls below ``tolerance`` is applied, then the
lane freezes. Here every level runs its full budget with a per-lane
active mask that reproduces exactly that.
"""

from __future__ import annotations

from typing import Sequence

import torch

from object_detector_6d_tpu_torch.core.exact import sqrt_rn
from object_detector_6d_tpu_torch.core.reduce import fixed_sum
from object_detector_6d_tpu_torch.core.se3 import SE3, cross


def pack_scene7(scene6_img: torch.Tensor) -> torch.Tensor:
    """Organized [..., H, W, 6] cloud+normals -> flat [..., H*W, 7] with validity."""
    flat = scene6_img.reshape(*scene6_img.shape[:-3], -1, 6)
    valid = torch.isfinite(flat).all(-1, keepdim=True).to(flat.dtype)
    return torch.cat([torch.nan_to_num(flat), valid], -1)


def _chol_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Damped SPD 6x6 solves [L, 6, 6], [L, 6] -> [L, 6] via an unrolled
    Cholesky, in the reference's operation order."""
    lam = 1e-6 * (A[:, 0, 0] + A[:, 1, 1] + A[:, 2, 2] + A[:, 3, 3]
                  + A[:, 4, 4] + A[:, 5, 5]) + 1e-12
    a = [[A[:, i, j] + lam if i == j else A[:, i, j] for j in range(6)]
         for i in range(6)]
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = sqrt_rn(torch.clamp(s, min=1e-20))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, 6):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * 6
    for i in range(6):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def _associate(pose, model_pc, mask, scenes, scene_of_lane, fx, fy, cx, cy,
               H, W, max_corr_dist, min_normal_cos, window=None):
    """Projective data association for [L] lanes of [n] model rows; with
    ``window`` = (wy0 [L], wx0 [L], iw), only inside each lane's window
    (``_associate_window``).

    Returns scene points [L, n, 3], normals [L, n, 3] and weights [L, n]."""
    mp = SE3.apply(pose, model_pc[..., :3])
    mn = SE3.rotate(pose, model_pc[..., 3:6])
    z = mp[..., 2]
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    # clamp before the cast (in-frame values are unaffected): a float
    # beyond int32 range has no defined conversion
    u = torch.round(fx * mp[..., 0] / zs + cx).clamp(-1e6, 1e6).to(torch.int64)
    v = torch.round(fy * mp[..., 1] / zs + cy).clamp(-1e6, 1e6).to(torch.int64)
    inb = (z > 1e-6) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    pix = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
    HW = scenes.shape[1]
    rows = scenes.reshape(-1, scenes.shape[-1])
    q = rows[scene_of_lane[:, None] * HW + pix]  # [L, n, C]
    if window is not None:
        inb, q = _associate_window(u, v, inb, q, window)
    qp = q[..., :3]
    qn = q[..., 3:6]
    d2 = fixed_sum((mp - qp) ** 2, -1)
    ncos = fixed_sum(mn * qn, -1)
    w = (mask & inb & (q[..., 6] > 0) & (d2 <= max_corr_dist * max_corr_dist)
         & (ncos >= min_normal_cos)).to(torch.float32)
    return qp, qn, w


def _associate_window(u, v, inb, q, window):
    """The reference's windowed association on the row gather: a model
    point whose pixel (u, v) [L, n] lies outside its lane's [iw, iw]
    window at (wy0, wx0) [L] gets weight 0 (``inb`` [L, n] cleared) and a
    zero scene row (``q`` [L, n, C]).

    The reference crops the window from the packed scene and gathers
    from the crop with two one-hot contractions at HIGHEST precision.
    That equals this masked row gather exactly: the crop's origin is
    clamped into the frame, so an in-window pixel is in the frame and its
    crop entry is the scene row at (v, u); each contraction output is one
    product 1.0 * value plus products 0.0 * value, which are zero because
    the scene holds no NaN or infinity (planes_to_scene8 applies
    nan_to_num); and a point outside the window, or behind the camera,
    gets an all-zero one-hot row, so a zero scene row."""
    wy0, wx0, iw = window
    du = u - wx0[:, None]
    dv = v - wy0[:, None]
    inb = inb & (du >= 0) & (du < iw) & (dv >= 0) & (dv < iw)
    return inb, torch.where(inb[..., None], q, torch.zeros_like(q))


def _gn_solve(pose, model_pc, qp, qn, w):
    """One point-to-plane Gauss-Newton solve per lane on fixed pairs.

    Every sum over the point axis is a ``fixed_sum``, so a lane's bits do
    not depend on how many lanes share the call. Two trees a solve: r does
    not depend on the centroid c, so the first sums [w, mp w, |r| w] (5
    channels) and the second, after c, [Jw_i J_j for i >= j, Jw r] (21 +
    6 channels); A is mirrored from its lower triangle."""
    mp = SE3.apply(pose, model_pc[..., :3])
    r = fixed_sum((mp - qp) * qn, -1)  # [L, n]
    s1 = fixed_sum(torch.cat([w[..., None], mp * w[..., None], (torch.abs(r) * w)[..., None]],
                             dim=-1), 1)  # [L, 5]
    wsum = torch.clamp(s1[:, 0], min=1.0)  # [L]
    c = s1[:, 1:4] / wsum[:, None]  # [L, 3]
    J = torch.cat([cross(mp - c[:, None, :], qn), qn], dim=-1)  # [L, n, 6]
    Jw = J * w[..., None]
    ti, tj = torch.tril_indices(6, 6, device=J.device)  # the 21 entries i >= j
    s2 = fixed_sum(torch.cat([Jw[..., ti] * J[..., tj], Jw * r[..., None]], dim=-1), 1)
    A = J.new_zeros((J.shape[0], 6, 6))
    A[:, ti, tj] = s2[:, :21]
    A[:, tj, ti] = s2[:, :21]
    b = -s2[:, 21:]
    x = _chol_solve6(A, b)
    dT = SE3.exp(x)
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(c.shape[0], 3, 3)
    shift = SE3.from_rt(eye, c)
    unshift = SE3.from_rt(eye, -c)
    new_pose = SE3.compose(shift, SE3.compose(dT, SE3.compose(unshift, pose)))
    residual = s1[:, 4] / wsum
    return new_pose, sqrt_rn(fixed_sum(x * x, 1)), residual


def _proj_step(pose, model_pc, mask, scenes, scene_of_lane, fx, fy, cx, cy,
               H, W, max_corr_dist, min_normal_cos, solves: int = 1, window=None):
    """Associate once (inside ``window`` when given), then ``solves``
    Gauss-Newton updates on the fixed pairs; the residual returned is the
    last solve's, the update norm the sum over solves."""
    qp, qn, w = _associate(pose, model_pc, mask, scenes, scene_of_lane,
                           fx, fy, cx, cy, H, W, max_corr_dist, min_normal_cos,
                           window)
    new_pose, upd, residual = _gn_solve(pose, model_pc, qp, qn, w)
    for _ in range(solves - 1):
        new_pose, upd2, residual = _gn_solve(new_pose, model_pc, qp, qn, w)
        upd = upd + upd2
    return new_pose, upd, residual, torch.sum(w, dim=-1)


def icp_levels(
    model_pc: torch.Tensor,  # [L, N, 6] (NaN rows = padding)
    pose0: torch.Tensor,  # [L, 4, 4]
    scenes: torch.Tensor,  # [S, H*W, C] packed scenes
    scene_of_lane: torch.Tensor,  # [L] int64
    fx: float, fy: float, cx: float, cy: float,
    H: int,
    W: int,
    levels: Sequence[int],
    iters_per_level,
    tolerance: float = 1e-4,
    corr_dist_base: float = 0.015,
    min_normal_cos: float = 0.5,
    solves: int = 1,
    window=None,  # (wy0 [L], wx0 [L], iw): the windowed association
):
    """Run the given pyramid levels on every lane; returns (residual [L],
    pose [L, 4, 4], n_inliers [L]). With ``window``, every association
    keeps only the correspondences inside each lane's [iw, iw] window at
    (wy0, wx0) (``_associate_window``)."""
    Ln, N = model_pc.shape[0], model_pc.shape[1]
    dev = model_pc.device
    pose = pose0
    residual = torch.full((Ln,), float("inf"), dtype=torch.float32, device=dev)
    n_in = torch.zeros((Ln,), dtype=torch.float32, device=dev)
    if isinstance(iters_per_level, int):
        iters_per_level = [iters_per_level] * len(levels)
    for level, lvl_iters in zip(levels, iters_per_level):
        stride = 1 << level
        n_lvl = max(1, N // stride)
        sample = model_pc[:, ::stride][:, :n_lvl]
        mask = torch.isfinite(sample[..., :3]).all(-1)
        sample = torch.nan_to_num(sample)
        cap = float(torch.tensor(corr_dist_base, dtype=torch.float32)) * (1 << level)
        upd = torch.full((Ln,), 1e9, dtype=torch.float32, device=dev)
        for _ in range(lvl_iters):
            active = upd >= tolerance
            new_pose, new_upd, res, nin = _proj_step(
                pose, sample, mask, scenes, scene_of_lane, fx, fy, cx, cy,
                H, W, cap, min_normal_cos, solves=solves, window=window)
            pose = torch.where(active[:, None, None], new_pose, pose)
            residual = torch.where(active, res, residual)
            n_in = torch.where(active, nin, n_in)
            upd = torch.where(active, new_upd, upd)
    return residual, pose, n_in


def projective_icp(
    model_pc: torch.Tensor,  # [N, 6] (NaN rows = padding)
    pose0: torch.Tensor,  # [4, 4]
    scene_flat: torch.Tensor,  # [H*W, 6] NaNs zeroed, or [H*W, 7] packed
    s_valid,  # [H*W] bool (ignored when scene_flat already has 7 columns)
    fx: float, fy: float, cx: float, cy: float,
    H: int,
    W: int,
    iterations: int = 100,
    tolerance: float = 1e-4,
    rejection_scale: float = 2.5,  # kept for signature parity; unused
    num_levels: int = 6,
    corr_dist_base: float = 0.015,
    solves: int = 1,
):
    """Coarse-to-fine refinement of one pose (the reference's
    single-hypothesis wrapper over ``icp_levels``), on the inputs' device.

    Returns (residual, pose, n_inliers) as 0-dim, [4, 4] and 0-dim
    tensors; ``residual`` is the mean absolute point-to-plane distance of
    the inliers at the finest level."""
    if scene_flat.shape[-1] == 6:
        scene7 = torch.cat([scene_flat, s_valid[:, None].to(scene_flat.dtype)], -1)
    else:
        scene7 = scene_flat
    res, pose, n_in = icp_levels(
        model_pc[None], pose0[None], scene7[None],
        torch.zeros(1, dtype=torch.int64, device=scene7.device),
        fx, fy, cx, cy, H, W,
        levels=tuple(range(num_levels - 1, -1, -1)),
        iters_per_level=max(1, iterations // num_levels // max(1, solves)),
        tolerance=tolerance,
        corr_dist_base=corr_dist_base,
        solves=solves,
    )
    return res[0], pose[0], n_in[0]
