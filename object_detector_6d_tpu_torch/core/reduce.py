"""The detect path's one float sum: a fixed-order pairwise tree.

``torch.sum`` and ``torch.matmul`` on a CUDA card split a reduction by
the size of the whole tensor (cuBLAS picks its batched GEMM and CUDA's
reduction its block shape by the number of lanes), so a lane's sum
changed in its last bits with the lanes beside it: a frame's poses
depended on the batch it came in. ``fixed_sum`` adds in an order that
depends only on the length of the summed axis. Every add is one
elementwise, correctly rounded IEEE float32 operation, so a lane gives
the same bits alone or among any others, on the card and on the CPU.
"""

from __future__ import annotations

import torch


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``x`` over ``dim`` as a pairwise tree of elementwise adds.

    ``dim`` is zero-padded to the next power of two, then halved by
    adding its upper half to its lower half until one entry is left: each
    term passes through ceil(log2 n) adds, so the result is within about
    ceil(log2 n) * eps * sum |x| of the exact sum. The order never
    depends on the other axes or the device."""
    dim %= x.dim()
    n = x.shape[dim]
    size = 1 << max(0, (n - 1).bit_length())
    if size != n:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1 - dim) + (0, size - n))
    while size > 1:
        size //= 2
        x = x.narrow(dim, 0, size) + x.narrow(dim, size, size)
    return x.squeeze(dim)
