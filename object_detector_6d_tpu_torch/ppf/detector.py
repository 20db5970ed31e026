"""PPF global 6D detector (port of object_detector_6d_tpu/ppf/detector.py;
PPF3DDetector; Drost et al. 2010).

Point-pair features F(p1, n1, p2, n2) = (|d|, angle(n1, d), angle(n2, d),
angle(n1, n2)) vote in a Hough space over (model point, in-plane angle
alpha).

* training: every ordered model pair's quantized key and alpha, in
  blocks of model rows; the table is sorted once on the host (stable),
  the reference's sorted key table + binary search;
* matching: blocks of scene reference points at a time, each against
  the whole sampled scene: a left-sided ``searchsorted`` into the key
  table, a capped range read of ``matches_per_pair`` entries, and an
  int32 scatter-add of the votes into the block's (model point, alpha)
  tables, which stay within ``VOTE_BLOCK_BYTES``;
* pose clustering on the host (refine/pose.cluster_poses).

The trained state (the "weights") is numpy and written as the
reference's npz, so either package reads the other's file.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import checked_device
from object_detector_6d_tpu_torch.core.exact import arccos_rn, atan2_rn, dot3, norm3, sincos_rn
from object_detector_6d_tpu_torch.core.se3 import SE3, cross, small_matmul, so3_exp
from object_detector_6d_tpu_torch.ppf.helpers import sample_pc_by_quantization
from object_detector_6d_tpu_torch.refine.pose import Pose, cluster_poses

_NUM_ANGLE_BINS = 30
# one block of training rows holds at most this many model pairs
PAIR_BLOCK = 1 << 22
# one block of scene reference points keeps its int32 vote tables within
# this many bytes, and its key lookups within MATCH_BLOCK_LOOKUPS entries
VOTE_BLOCK_BYTES = 256 << 20
MATCH_BLOCK_LOOKUPS = 1 << 23


def _recip(step: float, dev) -> torch.Tensor:
    """float32 1/step as a device tensor: the reference's division by a
    constant step, which XLA runs as a product with its float32
    reciprocal."""
    return torch.tensor(np.float32(1.0) / np.float32(step), device=dev)


def _rotate(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3] @ p [..., 3] in a fixed order on every device."""
    return small_matmul(R, p[..., None])[..., 0]


def _align_to_x(p: torch.Tensor, n: torch.Tensor):
    """(R [..., 3, 3], t [..., 3]) taking p to the origin and the normal n
    onto +x: a rotation about n x ex by angle(n, ex)."""
    n = n / (norm3(n, keepdim=True) + 1e-12)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device).expand_as(n)
    axis = cross(n, ex)
    axis_norm = norm3(axis, keepdim=True)
    # degenerate: n parallel to ex
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    safe_axis = torch.where(axis_norm > 1e-7, axis / (axis_norm + 1e-12), ey)
    ang = arccos_rn(torch.clamp(dot3(n, ex), -1.0, 1.0))
    R = so3_exp(safe_axis * ang[..., None])
    t = -_rotate(R, p)
    return R, t


def _features(p1, n1, p2, n2, dist_step, inv_angle_step):
    """The quantized pair key ((kd * 64 + k1) * 64 + k2) * 64 + k3."""
    d = p2 - p1
    dist = norm3(d)
    dn = d / (dist[..., None] + 1e-12)

    def ang(a, b):
        return arccos_rn(torch.clamp(dot3(a, b), -1.0, 1.0))

    kd = (dist / dist_step).to(torch.int32)
    k1 = (ang(n1, dn) * inv_angle_step).to(torch.int32)
    k2 = (ang(n2, dn) * inv_angle_step).to(torch.int32)
    k3 = (ang(n1, n2) * inv_angle_step).to(torch.int32)
    return ((kd * 64 + k1) * 64 + k2) * 64 + k3


def _alpha(R: torch.Tensor, t: torch.Tensor, p_i: torch.Tensor) -> torch.Tensor:
    """In-plane angle of p_i after the alignment (R, t) of a reference point."""
    q = _rotate(R, p_i) + t
    return atan2_rn(-q[..., 2], q[..., 1])


@torch.no_grad()
def _train_pairs(model: torch.Tensor, dist_step: float, num_angles: int):
    """Every ordered pair's key (-1 on the diagonal), alpha and first
    index, [N, N] each, in blocks of rows."""
    dev = model.device
    xyz, nrm = model[:, :3], model[:, 3:6]
    N = xyz.shape[0]
    step = torch.tensor(np.float32(dist_step), device=dev)
    inv_a = _recip(math.pi / num_angles, dev)
    R, t = _align_to_x(xyz, nrm)
    keys, alphas = [], []
    rows = max(1, PAIR_BLOCK // max(1, N))
    for s in range(0, N, rows):
        e = min(N, s + rows)
        key = _features(xyz[s:e, None], nrm[s:e, None], xyz[None], nrm[None], step, inv_a)
        eye = torch.arange(s, e, device=dev)[:, None] == torch.arange(N, device=dev)[None]
        keys.append(torch.where(eye, -1, key))
        alphas.append(_alpha(R[s:e, None], t[s:e, None], xyz[None]))
    idx_i = torch.arange(N, dtype=torch.int32, device=dev)[:, None].expand(N, N)
    return torch.cat(keys), torch.cat(alphas), idx_i


@torch.no_grad()
def _match_refs(scene, ref_idx, model, keys_sorted, vals_i, vals_alpha, dist_step: float,
                num_angles: int, matches_per_pair: int):
    """Per scene reference point: its best (model point, alpha) vote count
    [R] and the pose it implies [R, 4, 4]; and the largest block's vote
    table bytes."""
    dev = scene.device
    s_xyz, s_nrm = scene[:, :3], scene[:, 3:6]
    m_xyz, m_nrm = model[:, :3], model[:, 3:6]
    Nm, Ns, nK = m_xyz.shape[0], s_xyz.shape[0], keys_sorted.shape[0]
    n_alpha = 2 * num_angles
    n_bins = Nm * n_alpha + 1  # the last bin takes the misses
    step = torch.tensor(np.float32(dist_step), device=dev)
    inv_a = _recip(math.pi / num_angles, dev)
    inv_bin = _recip(2 * math.pi / n_alpha, dev)
    two_pi = torch.tensor(np.float32(2 * math.pi), device=dev)
    bin_width = torch.tensor(np.float32(2 * math.pi / n_alpha), device=dev)
    offs = torch.arange(matches_per_pair, device=dev)
    rows = max(1, min(VOTE_BLOCK_BYTES // (4 * n_bins),
                      MATCH_BLOCK_LOOKUPS // max(1, Ns * matches_per_pair)))
    votes, poses = [], []
    for s in range(0, ref_idx.shape[0], rows):
        r = ref_idx[s:s + rows]
        Rc = r.shape[0]
        p_r, n_r = s_xyz[r], s_nrm[r]
        key = _features(p_r[:, None], n_r[:, None], s_xyz[None], s_nrm[None], step, inv_a)
        R_s, t_s = _align_to_x(p_r, n_r)
        alpha_s = _alpha(R_s[:, None], t_s[:, None], s_xyz[None])  # [Rc, Ns]
        start = torch.searchsorted(keys_sorted, key)  # left-sided
        idx = start[..., None] + offs
        idx_c = torch.clamp(idx, 0, nK - 1)
        hit = (keys_sorted[idx_c] == key[..., None]) & (idx < nK)
        # vote bin: alpha = alpha_m - alpha_s in [-2pi, 2pi] -> [0, n_alpha)
        da = torch.remainder(vals_alpha[idx_c] - alpha_s[..., None] + two_pi, two_pi)
        a_bin = torch.clamp((da * inv_bin).to(torch.int32), max=n_alpha - 1)
        flat = torch.where(hit, vals_i[idx_c] * n_alpha + a_bin, n_bins - 1)
        acc = torch.zeros((Rc, n_bins), dtype=torch.int32, device=dev)
        acc.scatter_add_(1, flat.reshape(Rc, -1).to(torch.int64),
                         torch.ones((Rc, Ns * matches_per_pair), dtype=torch.int32, device=dev))
        acc = acc[:, :-1]
        best = torch.argmax(acc, 1)  # the first of equal counts
        votes.append(torch.gather(acc, 1, best[:, None])[:, 0])
        best_i = best // n_alpha
        best_a = (best % n_alpha).to(torch.float32) * bin_width
        # pose: T = T_sg^-1 . Rx(alpha) . T_mg
        R_m, t_m = _align_to_x(m_xyz[best_i], m_nrm[best_i])
        sa, ca = sincos_rn(best_a)
        one, zero = torch.ones_like(ca), torch.zeros_like(ca)
        Rx = torch.stack([torch.stack([one, zero, zero], -1),
                          torch.stack([zero, ca, -sa], -1),
                          torch.stack([zero, sa, ca], -1)], -2)
        T_x = SE3.from_rt(Rx, torch.zeros((Rc, 3), dtype=torch.float32, device=dev))
        T = SE3.compose(SE3.inverse(SE3.from_rt(R_s, t_s)),
                        SE3.compose(T_x, SE3.from_rt(R_m, t_m)))
        poses.append(T)
    return torch.cat(votes), torch.cat(poses), 4 * n_bins * min(rows, ref_idx.shape[0])


@dataclasses.dataclass
class PPFDetector:
    """Mirrors ppf_match_3d::PPF3DDetector(relative_sampling_step,
    relative_distance_step, num_angles). Training and matching run on
    ``device`` (the card unless the caller asks for the CPU)."""

    relative_sampling_step: float = 0.05
    relative_distance_step: float = 0.05
    num_angles: int = _NUM_ANGLE_BINS
    device: str = "cuda"

    # trained state
    model_sampled: Optional[np.ndarray] = None
    model_diameter: float = 0.0
    _keys_sorted: Optional[np.ndarray] = None
    _vals_i: Optional[np.ndarray] = None
    _vals_alpha: Optional[np.ndarray] = None
    # bytes of the largest block of vote tables in the last match
    vote_table_bytes: int = dataclasses.field(default=0, init=False)

    def _dist_step(self) -> float:
        return float(np.float32(self.relative_distance_step * self.model_diameter))

    def train_model(self, model_pc: np.ndarray) -> None:
        """Build the sorted pair-feature table from a [N, 6] model cloud."""
        dev = checked_device(self.device)
        model = sample_pc_by_quantization(np.asarray(model_pc, np.float32),
                                          self.relative_sampling_step)
        self.model_sampled = model
        xyz = model[:, :3]
        self.model_diameter = float(np.linalg.norm(xyz.max(0) - xyz.min(0)))
        keys, alphas, idx_i = (x.reshape(-1).cpu().numpy() for x in _train_pairs(
            torch.as_tensor(model, device=dev), self._dist_step(), self.num_angles))
        valid = keys >= 0
        keys, alphas, idx_i = keys[valid], alphas[valid], idx_i[valid]
        order = np.argsort(keys, kind="stable")
        self._keys_sorted = keys[order]
        self._vals_i = idx_i[order].astype(np.int32)
        self._vals_alpha = alphas[order].astype(np.float32)

    def write(self, path: str) -> None:
        """Serialize the trained state as the reference's npz (the oracle
        library declares PPF3DDetector::write but implements none)."""
        if self._keys_sorted is None:
            raise ValueError("detector is untrained; nothing to write")
        np.savez_compressed(
            path,
            relative_sampling_step=self.relative_sampling_step,
            relative_distance_step=self.relative_distance_step,
            num_angles=self.num_angles,
            model_sampled=self.model_sampled,
            model_diameter=self.model_diameter,
            keys_sorted=self._keys_sorted,
            vals_i=self._vals_i,
            vals_alpha=self._vals_alpha,
        )

    @classmethod
    def read(cls, path: str, device="cuda") -> "PPFDetector":
        """Load a detector written by :meth:`write` (either package's)."""
        g = np.load(path)
        det = cls(
            relative_sampling_step=float(g["relative_sampling_step"]),
            relative_distance_step=float(g["relative_distance_step"]),
            num_angles=int(g["num_angles"]),
            device=device,
        )
        det.model_sampled = g["model_sampled"]
        det.model_diameter = float(g["model_diameter"])
        det._keys_sorted = g["keys_sorted"]
        det._vals_i = g["vals_i"]
        det._vals_alpha = g["vals_alpha"]
        return det

    def match(
        self,
        scene_pc: np.ndarray,
        relative_scene_sample_step: float = 0.2,
        relative_scene_distance: float = 0.03,
        max_results: int = 8,
        matches_per_pair: int = 8,
    ) -> List[Pose]:
        """Detect the trained model in a [M, 6] scene cloud."""
        assert self.model_sampled is not None, "train_model first"
        dev = checked_device(self.device)
        scene = sample_pc_by_quantization(np.asarray(scene_pc, np.float32),
                                          relative_scene_distance)
        stride = max(1, int(round(1.0 / relative_scene_sample_step)))
        ref_idx = np.arange(0, len(scene), stride)

        def t(x):
            return torch.as_tensor(x, device=dev)

        votes, pose_params, self.vote_table_bytes = _match_refs(
            t(scene), t(ref_idx), t(self.model_sampled), t(self._keys_sorted),
            t(self._vals_i), t(self._vals_alpha), self._dist_step(), self.num_angles,
            matches_per_pair)
        votes = votes.cpu().numpy()
        pose_params = pose_params.cpu().numpy()
        poses = [Pose(pose=pose_params[r].astype(np.float64), num_votes=int(votes[r]))
                 for r in range(len(ref_idx)) if votes[r] > 0]
        clusters = cluster_poses(poses, rotation_threshold_rad=np.deg2rad(30.0),
                                 translation_threshold=0.1 * self.model_diameter,
                                 per_class=False)
        return [c.mean_pose() for c in clusters[:max_results]]
