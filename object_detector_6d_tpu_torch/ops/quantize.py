"""Batched depth-normal quantize: kernel K2 and its plain twin (port of
object_detector_6d_tpu/ops/quantize_pallas.py ``dn_quantize_batched``).

``dn_quantize_batched`` takes [B, H, W] raw depth and returns [B, H, W]
u8 one-hot bins, bit-identical to quant/depth_normal.quantized_normals.
A CPU tensor goes to that plain twin; a CUDA tensor launches the
hand-written kernel (csrc/dn_quantize.cu) or raises. Any frame size.
"""

from __future__ import annotations

import torch

from object_detector_6d_tpu_torch.ops import kernels
from object_detector_6d_tpu_torch.quant.depth_normal import quantized_normals


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
    scratch = torch.empty((B, H, W), dtype=torch.uint8, device=d.device)
    out = torch.empty((B, H, W), dtype=torch.uint8, device=d.device)
    lib = kernels.library()
    code = lib.odc_dn_quantize(
        d.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, H, W,
        int(distance_threshold), int(difference_threshold),
        kernels.stream_ptr(d.device))
    kernels.check(code, "dn_quantize_batched")
    dn_quantize_batched.launches += 1
    return out


dn_quantize_batched.launches = 0
