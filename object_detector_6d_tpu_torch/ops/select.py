"""The exact top-K of the match program's thresholded score grid: kernel
K7 (csrc/select_topk.cu) and its plain twin.

    vals[b], idx[b] = the k largest of x[b] by (value descending, index
                      ascending)

which is lax.top_k's order and that of a stable descending sort: ties go
to the lower flat index, and slots of value -1 (below the threshold)
carry the lowest indices at -1. The template ids and positions of those
slots are part of the match record, so the order is part of the contract.

The grid holds -1 or a K6 sum of responses 0..4 over at most F features,
so every value lies in [-1, vmax] with vmax = 4 F; the kernel counts
values in vmax + 2 bins instead of sorting. A CPU tensor goes to the twin
(a stable sort, after a check that raises on a value outside the range); a
CUDA tensor launches the kernel, three launches for the whole batch, or
raises. The wrapper reads nothing back from the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from object_detector_6d_tpu_torch.ops import kernels

# csrc/select_topk.cu's constants
TILE = 8192  # cells a block of the histogram and collect launches
CHUNKS = 8  # chunks of a tile, each with its max
MAX_BINS = 12000  # vmax + 2 histogram bins in a block's shared memory


def exact_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis in lax.top_k's order: descending value,
    ties broken by the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _check_args(x: torch.Tensor, k: int, vmax: int) -> None:
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"select_topk: expected an int32 [B, N] grid, got {x.dtype} "
                         f"{tuple(x.shape)}")
    B, N = x.shape
    if N < k:
        raise ValueError(f"select_topk: {N} cells a row, fewer than k = {k}")
    if k < 0:
        raise ValueError(f"select_topk: k = {k} < 0")
    if not 0 <= vmax <= MAX_BINS - 2:
        raise ValueError(f"select_topk: vmax = {vmax} needs {vmax + 2} histogram bins; "
                         f"at most {MAX_BINS} fit")
    if N >= 2 ** 30 or B > 65535:
        raise ValueError(f"select_topk: a grid of {B} x {N} cells is too large")


def select_topk_plain(x: torch.Tensor, k: int, vmax: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of kernel K7: ``exact_topk`` of a grid whose values
    must lie in [-1, vmax]."""
    if x.numel() and (int(x.min()) < -1 or int(x.max()) > vmax):
        raise ValueError(f"select_topk: a value outside [-1, {vmax}]")
    return exact_topk(x, k)


def select_topk(x: torch.Tensor, k: int, vmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, k] int32 values, [B, k] int64 indices) of the int32 grid x
    [B, N], every value in [-1, vmax], in ``exact_topk``'s order."""
    _check_args(x, k, vmax)
    if x.device.type == "cpu":
        return select_topk_plain(x, k, vmax)
    kernels.require_cuda("select_topk", x)
    B, N = x.shape
    vals = torch.empty((B, k), dtype=torch.int32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int64, device=x.device)
    if B == 0 or k == 0:
        return vals, idx
    T, nbins = -(-N // TILE), vmax + 2
    # int32: the tiles' histograms and their prefixes [B, T+1, nbins], the
    # counts of greater values [B, nbins], the chunks' maxima [B, T, CHUNKS],
    # v* and r [B, 2]; every entry is written before it is read
    scratch = torch.empty(B * ((T + 2) * nbins + T * CHUNKS + 2), dtype=torch.int32,
                          device=x.device)
    vec = int(x.data_ptr() % 16 == 0 and N % 4 == 0)
    code = kernels.library().odc_select_topk(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), scratch.data_ptr(), B, N, k, vmax,
        vec, kernels.stream_ptr(x.device))
    kernels.check(code, "select_topk")
    select_topk.launches += 1
    return vals, idx


select_topk.launches = 0
