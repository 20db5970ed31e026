"""Batched quantize of both modalities: kernels K1 and K2 and their plain
twins (port of object_detector_6d_tpu/ops/quantize_pallas.py
``cg_quantize_batched`` and ``dn_quantize_batched``).

``cg_quantize_batched`` takes [B, H, W, 3] u8 BGR frames and returns
[B, H, W] u8 one-hot orientations, bit-identical to
quant/color_gradient.quantized_orientations; ``dn_quantize_batched``
takes [B, H, W] raw depth and returns [B, H, W] u8 one-hot bins,
bit-identical to quant/depth_normal.quantized_normals. A CPU tensor goes
to the plain twin; a CUDA tensor launches the hand-written kernel
(csrc/cg_quantize.cu, csrc/dn_quantize.cu) or raises. Any frame size.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.ops import kernels
from object_detector_6d_tpu_torch.quant.color_gradient import quantized_orientations
from object_detector_6d_tpu_torch.quant.depth_normal import quantized_normals


def cg_quantize_plain(bgr: torch.Tensor, weak_threshold: float = 10.0) -> torch.Tensor:
    """The plain PyTorch twin of kernel K1."""
    return quantized_orientations(bgr, weak_threshold)[0]


def cg_quantize_batched(bgr: torch.Tensor, weak_threshold: float = 10.0) -> torch.Tensor:
    """[B, H, W, 3] u8 BGR -> [B, H, W] u8 quantized orientations."""
    if bgr.dim() != 4 or bgr.shape[-1] != 3 or bgr.dtype != torch.uint8:
        raise ValueError(f"bgr must be [B, H, W, 3] u8, got {bgr.dtype} {tuple(bgr.shape)}")
    if bgr.device.type == "cpu":
        return cg_quantize_plain(bgr, weak_threshold)
    bgr = bgr.contiguous()
    kernels.require_cuda("cg_quantize_batched", bgr)
    B, H, W, _ = bgr.shape
    out = torch.empty((B, H, W), dtype=torch.uint8, device=bgr.device)
    lib = kernels.library()
    code = lib.odc_cg_quantize(
        bgr.data_ptr(), out.data_ptr(), B, H, W,
        float(np.float32(weak_threshold) ** 2), kernels.stream_ptr(bgr.device))
    kernels.check(code, "cg_quantize_batched")
    cg_quantize_batched.launches += 1
    return out


cg_quantize_batched.launches = 0


def dn_quantize_plain(depth: torch.Tensor, distance_threshold: int = 2000,
                      difference_threshold: int = 50) -> torch.Tensor:
    """The plain PyTorch twin of kernel K2."""
    return quantized_normals(depth, distance_threshold, difference_threshold)


def dn_quantize_batched(depth: torch.Tensor, distance_threshold: int = 2000,
                        difference_threshold: int = 50) -> torch.Tensor:
    """[B, H, W] depth (any int dtype) -> [B, H, W] u8 quantized normals."""
    if depth.dim() != 3:
        raise ValueError(f"depth must be [B, H, W], got {tuple(depth.shape)}")
    if depth.device.type == "cpu":
        return dn_quantize_plain(depth, distance_threshold, difference_threshold)
    d = depth.to(torch.int32).contiguous()
    kernels.require_cuda("dn_quantize_batched", d)
    B, H, W = d.shape
    out = torch.empty((B, H, W), dtype=torch.uint8, device=d.device)
    lib = kernels.library()
    code = lib.odc_dn_quantize(
        d.data_ptr(), out.data_ptr(), B, H, W,
        int(distance_threshold), int(difference_threshold),
        kernels.stream_ptr(d.device))
    kernels.check(code, "dn_quantize_batched")
    dn_quantize_batched.launches += 1
    return out


dn_quantize_batched.launches = 0
