"""Fused geometry: kernel K5 and its plain twin (port of
object_detector_6d_tpu/ops/geometry_pallas.py ``FusedScene``).

    z      = depth * 0.001 (0 -> invalid)
    cloud  = (z*(u-cx)*(1/fx), z*(v-cy)*(1/fy), z)
    inv_r  = 1 / |cloud|
    b      = boxsum_5x5(unit_ray * inv_r)   rows, then columns, zero fill
    n      = M^-1 b, normalized, flipped toward the camera, NaN-masked

One [8, H, W] plane stack per frame: cloud xyz, normal xyz (NaN where
invalid), validity, zero pad. M^-1 and the unit rays are built on the
host exactly as geom/normals.FalsNormals builds them (float64 inversion).
A CPU tensor goes to the plain twin; a CUDA tensor launches
csrc/fused_scene.cu or raises. Any frame size.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.exact import sqrt_rn
from object_detector_6d_tpu_torch.geom.normals import FalsNormals
from object_detector_6d_tpu_torch.ops import kernels

HALO = 2  # box-sum radius (window 5)


def _box5_rows_cols(comp: torch.Tensor) -> torch.Tensor:
    """5x5 box sum of [..., H, W], rows then columns, each left to right
    with zero fill (the reference's accumulation order)."""
    H, W = comp.shape[-2:]
    p = torch.nn.functional.pad(comp, (0, 0, HALO, HALO))
    rows = p[..., 0:H, :]
    for k in range(1, 2 * HALO + 1):
        rows = rows + p[..., k:k + H, :]
    p = torch.nn.functional.pad(rows, (HALO, HALO))
    acc = p[..., 0:W]
    for k in range(1, 2 * HALO + 1):
        acc = acc + p[..., k:k + W]
    return acc


class FusedScene:
    """Per-(H, W, K) fused geometry: depth batch -> [B, 8, H, W] planes."""

    def __init__(self, height: int, width: int, K, window_size: int = 5,
                 device="cuda"):
        if window_size != 5:
            raise ValueError("the fused geometry is specialised to window 5")
        self.height, self.width = height, width
        self.device = torch.device(device)
        K = np.asarray(K, dtype=np.float64)
        # the reference kernel divides by the constants fx, fy, which XLA
        # rewrites to a multiply by their float32 reciprocals; so do we
        self.rfx = float(np.float32(1.0) / np.float32(K[0, 0]))
        self.rfy = float(np.float32(1.0) / np.float32(K[1, 1]))
        est = FalsNormals(height, width, K, window_size)
        minv = est.minv.reshape(height, width, 9).transpose(2, 0, 1)
        u, v = np.meshgrid(np.arange(width, dtype=np.float32),
                           np.arange(height, dtype=np.float32))
        rays = np.empty((5, height, width), np.float32)
        # (u - cx) exactly as depth_to_3d: f32 grid minus f32 scalar
        rays[0] = u - np.float32(K[0, 2])
        rays[1] = v - np.float32(K[1, 2])
        rays[2:5] = est.rays.transpose(2, 0, 1)
        self.rays = torch.as_tensor(rays, device=self.device)  # [5, H, W]
        self.minv = torch.as_tensor(np.ascontiguousarray(minv), device=self.device)

    def plain(self, depths: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch twin of kernel K5: [B, H, W] -> [B, 8, H, W]."""
        rays = self.rays.to(depths.device)
        minv = self.minv.to(depths.device)
        d = depths.to(torch.int32)
        valid = d > 0
        # python scalars enter the float32 multiplies as float32 (0.001
        # rounds as the reference's jnp.float32(0.001); rfx, rfy are
        # float32 values)
        z = d.to(torch.float32) * 0.001
        x = z * rays[0] * self.rfx
        y = z * rays[1] * self.rfy
        rr = sqrt_rn(x * x + y * y + z * z)
        inv_r = torch.where(valid, 1.0 / rr, torch.zeros_like(rr))
        comp = rays[None, 2:5] * inv_r[:, None]  # [B, 3, H, W]
        bs = _box5_rows_cols(comp)
        n = [minv[3 * i] * bs[:, 0] + minv[3 * i + 1] * bs[:, 1]
             + minv[3 * i + 2] * bs[:, 2] for i in range(3)]
        norm = sqrt_rn(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
        norm_ok = (norm > 0) & torch.isfinite(norm)
        n = [c / norm for c in n]
        flip = (n[0] * rays[2] + n[1] * rays[3] + n[2] * rays[4]) > 0
        n = [torch.where(flip, -c, c) for c in n]
        nan = float("nan")
        bad = ~valid | ~norm_ok
        planes = [torch.where(valid, c, nan) for c in (x, y, z)]
        planes += [torch.where(bad, nan, c) for c in n]
        planes += [(valid & ~bad).to(torch.float32), torch.zeros_like(z)]
        return torch.stack(planes, dim=1)

    def __call__(self, depths: torch.Tensor) -> torch.Tensor:
        """[B, H, W] depth (mm, any int dtype) -> [B, 8, H, W] f32 planes."""
        if depths.dim() != 3 or tuple(depths.shape[1:]) != (self.height, self.width):
            raise ValueError(f"depth batch {tuple(depths.shape)} does not match "
                             f"the scene's {(self.height, self.width)}")
        if depths.device.type == "cpu":
            return self.plain(depths)
        d = depths.to(torch.int32).contiguous()
        if self.rays.device != d.device:
            self.rays = self.rays.to(d.device)
            self.minv = self.minv.to(d.device)
        kernels.require_cuda("FusedScene", d, self.rays, self.minv)
        B = d.shape[0]
        out = torch.empty((B, 8, self.height, self.width), dtype=torch.float32,
                          device=d.device)
        lib = kernels.library()
        code = lib.odc_fused_scene(
            d.data_ptr(), self.rays.data_ptr(), self.minv.data_ptr(),
            out.data_ptr(), B, self.height, self.width, self.rfx, self.rfy,
            kernels.stream_ptr(d.device))
        kernels.check(code, "FusedScene")
        FusedScene.launches += 1
        return out


FusedScene.launches = 0


def planes_to_scene8(planes: torch.Tensor) -> torch.Tensor:
    """[B, 8, H, W] plane stacks -> [B, H*W, 8] packed scene rows
    [x, y, z, nx, ny, nz, valid, 0] with invalid entries zeroed."""
    B = planes.shape[0]
    return torch.nan_to_num(planes.reshape(B, 8, -1)).transpose(1, 2).contiguous()
