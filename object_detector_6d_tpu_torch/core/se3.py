"""SE(3) rigid transforms (port of object_detector_6d_tpu/core/se3.py).

Rodrigues ``exp`` (the ICP update) and ``so3_log`` / ``log``,
``apply``/``rotate`` (association), ``compose``, ``inverse`` (odometry,
PPF) and the quaternion forms (device cluster NMS). Poses are
[..., 4, 4] float32 tensors; every function broadcasts over leading
batch axes. Matrix products run in full
float32: ``torch.backends.cuda.matmul.allow_tf32`` is False by default
and this package never turns it on.

``apply``, ``rotate``, ``compose``, ``inverse`` and ``exp`` sum their
products over 3 or 4 terms with ``core/reduce.py`` ``fixed_sum``
(``small_matmul``): a CUDA batched matmul or sum picks its kernel and
order by the number of matrices, and a lane's bits then changed with the
lanes beside it, and from the CPU's. Their square roots, sines, cosines,
arccosines and quaternion norms are ``core/exact.py``'s, the same bits
on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.exact import (arccos_rn, norm4, sin_rn, sincos_rn,
                                                      sqrt_rn)
from object_detector_6d_tpu_torch.core.reduce import fixed_sum

# 1/6, 1/12 and 1/24 as float32 reciprocals: XLA, and PyTorch's CUDA
# division by a Python scalar, divide by a constant as a product with its
# reciprocal
_SIXTH = float(np.float32(1.0) / np.float32(6.0))
_TWELFTH = float(np.float32(1.0) / np.float32(12.0))
_TWENTY_FOURTH = float(np.float32(1.0) / np.float32(24.0))


def small_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A [..., m, k] @ B [..., k, n] (leading axes broadcast) for a small k:
    the products A[..., i, j] B[..., j, l] summed over j by fixed_sum, so
    the same bits for any leading shape on every device."""
    return fixed_sum(A[..., :, :, None] * B[..., None, :, :], -2)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w`` [..., 3] -> [..., 3, 3]."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor, sincos=None) -> torch.Tensor:
    """Rodrigues: rotation vector [..., 3] -> rotation matrix [..., 3, 3].
    ``sincos`` gives (sin, cos) of the angle (core/exact.py; by default
    the correctly rounded ``sincos_rn``)."""
    theta2 = fixed_sum(w * w, -1)
    theta = sqrt_rn(theta2 + 1e-32)
    small = theta2 < 1e-12
    sin, cos = (sincos or sincos_rn)(theta)
    a = torch.where(small, 1.0 - theta2 * _SIXTH, sin / theta)
    b = torch.where(small, 0.5 - theta2 * _TWENTY_FOURTH, (1.0 - cos) / theta2)
    W = hat(w)
    WW = small_matmul(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> rotation vector [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = arccos_rn(cos_theta)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-6
    scale = torch.where(small, 0.5 + theta * theta * _TWELFTH,
                        theta / (2.0 * sin_rn(torch.where(small, 1.0, theta))))
    return vee * scale[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (the textbook component formula)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


class SE3:
    """Namespace of pure functions over [..., 4, 4] homogeneous transforms."""

    @staticmethod
    def identity(dtype=torch.float32, batch_shape=(), device=None) -> torch.Tensor:
        return torch.eye(4, dtype=dtype, device=device).expand(*batch_shape, 4, 4)

    @staticmethod
    def rotation(T: torch.Tensor) -> torch.Tensor:
        return T[..., :3, :3]

    @staticmethod
    def translation(T: torch.Tensor) -> torch.Tensor:
        return T[..., :3, 3]

    @staticmethod
    def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Rotation [..., 3, 3] + translation [..., 3] -> [..., 4, 4]."""
        batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
        R = R.expand(*batch, 3, 3)
        t = t.expand(*batch, 3)
        top = torch.cat([R, t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(*batch, 1, 4)
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def exp(twist: torch.Tensor, sincos=None) -> torch.Tensor:
        """Twist [..., 6] (rotation w, translation v) -> [..., 4, 4];
        translation taken verbatim (the ICP's linearized update)."""
        return SE3.from_rt(so3_exp(twist[..., :3], sincos), twist[..., 3:])

    @staticmethod
    def log(T: torch.Tensor) -> torch.Tensor:
        """[..., 4, 4] -> twist [..., 6]: rotation vector and raw translation."""
        return torch.cat([so3_log(T[..., :3, :3]), T[..., :3, 3]], dim=-1)

    @staticmethod
    def inverse(T: torch.Tensor) -> torch.Tensor:
        Rt = T[..., :3, :3].transpose(-1, -2)
        return SE3.from_rt(Rt, -small_matmul(Rt, T[..., :3, 3, None])[..., 0])

    @staticmethod
    def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        return small_matmul(A, B)

    @staticmethod
    def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """Transform points [..., N, 3] by T [..., 4, 4]."""
        return SE3.rotate(T, pts) + T[..., None, :3, 3]

    @staticmethod
    def rotate(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
        """Rotate direction vectors [..., N, 3] without translating."""
        return small_matmul(vecs, T[..., :3, :3].transpose(-1, -2))

    @staticmethod
    def to_quat(T: torch.Tensor) -> torch.Tensor:
        """[..., 4, 4] -> unit quaternion [..., 4] (w, x, y, z), w >= 0
        (Shepperd's method, branch-free, as the reference)."""
        R = T[..., :3, :3]
        m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
        m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
        m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
        tr = m00 + m11 + m22
        zero = torch.zeros_like(tr)
        qw0 = sqrt_rn(torch.maximum(zero, 1.0 + tr)) / 2
        q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0 + 1e-32),
                          (m02 - m20) / (4 * qw0 + 1e-32),
                          (m10 - m01) / (4 * qw0 + 1e-32)], dim=-1)
        qx1 = sqrt_rn(torch.maximum(zero, 1.0 + m00 - m11 - m22)) / 2
        q1 = torch.stack([(m21 - m12) / (4 * qx1 + 1e-32), qx1,
                          (m01 + m10) / (4 * qx1 + 1e-32),
                          (m02 + m20) / (4 * qx1 + 1e-32)], dim=-1)
        qy2 = sqrt_rn(torch.maximum(zero, 1.0 - m00 + m11 - m22)) / 2
        q2 = torch.stack([(m02 - m20) / (4 * qy2 + 1e-32),
                          (m01 + m10) / (4 * qy2 + 1e-32), qy2,
                          (m12 + m21) / (4 * qy2 + 1e-32)], dim=-1)
        qz3 = sqrt_rn(torch.maximum(zero, 1.0 - m00 - m11 + m22)) / 2
        q3 = torch.stack([(m10 - m01) / (4 * qz3 + 1e-32),
                          (m02 + m20) / (4 * qz3 + 1e-32),
                          (m12 + m21) / (4 * qz3 + 1e-32), qz3], dim=-1)
        cond0 = (tr > 0.0)[..., None]
        cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
        cond2 = (m11 >= m22)[..., None]
        q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
        q = q / norm4(q, keepdim=True)
        return torch.where(q[..., :1] < 0, -q, q)

    @staticmethod
    def from_quat(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Unit quaternion [..., 4] (w, x, y, z) + t [..., 3] -> [..., 4, 4]."""
        q = q / norm4(q, keepdim=True)
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        R = torch.stack(
            [
                torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
                torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
                torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
            ],
            dim=-2,
        )
        return SE3.from_rt(R, t)
