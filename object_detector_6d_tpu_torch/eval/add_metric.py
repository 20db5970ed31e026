"""Pose-accuracy metrics: ADD / ADD-S / ADD-0.1d (port of
object_detector_6d_tpu/eval/add_metric.py).

ADD (Hinterstoisser et al.): mean distance between model points under the
estimated and ground-truth poses. ADD-S (symmetric objects): mean
closest-point distance. A pose is "correct" at threshold k*d if its
ADD(-S) is below k times the model diameter (k = 0.1 for the standard
ADD-0.1d accuracy the reference reports).

Batched PyTorch on the inputs' device: tensors stay where they are; numpy
inputs go to ``device``, the card unless the caller asks for the CPU.
Products are float32 with TF32 off (the reference's
``Precision.HIGHEST``). ADD-S and the diameter keep the reference's
``|a|^2 + |b|^2 - 2 a.b`` squared distances, clamped at 0, so both
packages carry the same cancellation. Its squared norms are evaluated as
the reference's jitted ``jnp.sum(v * v, -1)`` runs on XLA:CPU, ``x*x``
then two fused multiply-adds: that order moves the reference's own ADD-S
by ~1e-6 m against the plain one (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import checked_device, no_tf32
from object_detector_6d_tpu_torch.core.exact import norm3, sqrt_rn


def _tensors(*xs, device):
    """float32 tensors on the first tensor's device, else on ``device``."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    dev = checked_device(device) if dev is None else dev
    return [torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32),
                            dtype=torch.float32, device=dev) for x in xs]


def _sqnorm(v):
    """|v|^2 over the last axis (3 entries): fma(z, z, fma(y, y, x*x)) in
    float32, each fused step emulated in float64 and rounded to float32."""
    d = v.to(torch.float64)
    s = (d[..., 0] * d[..., 0]).float().double()
    s = (s + d[..., 1] * d[..., 1]).float().double()
    return (s + d[..., 2] * d[..., 2]).float()


def _apply(T, pts):
    return torch.matmul(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def add_distance(pose_est, pose_gt, model_pts, device="cuda") -> torch.Tensor:
    """ADD: mean ||T_e x - T_g x||. Broadcasts over leading pose axes."""
    pose_est, pose_gt, model_pts = _tensors(pose_est, pose_gt, model_pts, device=device)
    with no_tf32():
        pe = _apply(pose_est, model_pts)
        pg = _apply(pose_gt, model_pts)
    return norm3(pe - pg).mean(-1)


def adds_distance(pose_est, pose_gt, model_pts, device="cuda") -> torch.Tensor:
    """ADD-S: mean closest-point distance (symmetric objects)."""
    pose_est, pose_gt, model_pts = _tensors(pose_est, pose_gt, model_pts, device=device)
    with no_tf32():
        pe = _apply(pose_est, model_pts)
        pg = _apply(pose_gt, model_pts)
        d2 = (_sqnorm(pe)[..., :, None] + _sqnorm(pg)[..., None, :]
              - 2.0 * torch.matmul(pe, pg.transpose(-1, -2)))
    return sqrt_rn(torch.clamp(d2.amin(-1), min=0.0)).mean(-1)


def model_diameter(model_pts, device="cuda") -> float:
    """Max pairwise distance (object diameter)."""
    (pts,) = _tensors(model_pts, device=device)
    sq = _sqnorm(pts)
    with no_tf32():
        d2 = sq[:, None] + sq[None, :] - 2.0 * torch.matmul(pts, pts.T)
    return float(sqrt_rn(torch.clamp(d2.max(), min=0.0)))


def add_accuracy(
    poses_est,
    poses_gt,
    model_pts,
    diameter: float | None = None,
    k: float = 0.1,
    symmetric: bool = False,
    device="cuda",
) -> float:
    """ADD(-S)-k*d accuracy over a batch of frames (fraction correct)."""
    poses_est, poses_gt, model_pts = _tensors(poses_est, poses_gt, model_pts, device=device)
    if diameter is None:
        diameter = model_diameter(model_pts)
    fn = adds_distance if symmetric else add_distance
    d = fn(poses_est, poses_gt, model_pts)
    return float((d < k * diameter).to(torch.float64).mean())
