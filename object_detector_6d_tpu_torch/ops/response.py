"""Fused spread + response maps: kernel K3 and its plain twin (port of
object_detector_6d_tpu/ops/response_pallas.py ``response_spread_batched``
and its one-frame form ``response_spread``).

[B, H, W] u8 quantized orientations -> [B, 8, H, W] u8 response maps
(values 0..4), equal to ``response_maps(spread(q, t))`` of
match/response.py. A CPU tensor goes to that plain twin; a CUDA tensor
launches csrc/response_spread.cu or raises. Integer only: bit-exact.

The kernel spreads over at most MAX_T. A wider T on the card first
spreads q over T - MAX_T + 1 with the plain ``spread`` and then launches
the kernel at MAX_T: a forward OR spread over [0, a) followed by one over
[0, b) is a spread over [0, a + b - 1), and both fill zero past the
frame, so the maps are those of T.
"""

from __future__ import annotations

import torch

from object_detector_6d_tpu_torch.match.response import dist_vals, response_maps, spread
from object_detector_6d_tpu_torch.ops import kernels

MAX_T = 16  # a lane's window reaches at most 4 words past its own in the kernel


def response_spread_plain(q: torch.Tensor, t: int) -> torch.Tensor:
    """The plain PyTorch twin of kernel K3."""
    return response_maps(spread(q, t))


def response_spread_batched(q: torch.Tensor, t: int) -> torch.Tensor:
    """[B, H, W] u8 -> [B, 8, H, W] u8 response maps; any T >= 1 (beyond
    MAX_T the kernel runs at MAX_T on q spread over T - MAX_T + 1)."""
    if q.dim() != 3 or q.dtype != torch.uint8:
        raise ValueError(f"q must be [B, H, W] u8, got {q.dtype} {tuple(q.shape)}")
    if q.device.type == "cpu":
        return response_spread_plain(q, t)
    if t < 1:
        raise ValueError(f"spread T={t} < 1")
    if t > MAX_T:
        q, t = spread(q, t - MAX_T + 1), MAX_T
    q = q.contiguous()
    kernels.require_cuda("response_spread_batched", q)
    B, H, W = q.shape
    out = torch.empty((B, 8, H, W), dtype=torch.uint8, device=q.device)
    lib = kernels.library()
    code = lib.odc_response_spread(
        q.data_ptr(), out.data_ptr(), B, H, W, int(t), *dist_vals(),
        kernels.stream_ptr(q.device))
    kernels.check(code, "response_spread_batched")
    response_spread_batched.launches += 1
    return out


response_spread_batched.launches = 0


def response_spread(q: torch.Tensor, t: int) -> torch.Tensor:
    """One frame: [H, W] u8 -> [8, H, W] u8 (its launch counts on
    ``response_spread_batched``)."""
    return response_spread_batched(q[None], t)[0]
