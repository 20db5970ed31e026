"""Template sweeps of the host-orchestrated matcher (port of
object_detector_6d_tpu/match/sweep.py).

The reference computes both sums as bf16 convolutions of the response
maps with dense one-hot template kernels. The same sums are sparse sweeps
over the T-decimated response planes (match/program.py ``decimate``): a
feature (x, y, label) of a template anchored at (x0, y0) reads

    R[label, y0 + y, x0 + x] = D[label*T^2 + (Y%T)*T + X%T, Y//T, X//T]

with X = x0 + x, Y = y0 + y. So the full-grid coarse sum is kernel K6
(``coarse_sweep``) and the 16x16 local sum per candidate is kernel K4
(``refine_sweep_batched``), on the card; on the CPU their plain twins.
No convolution library runs here. Planes read zero past the frame, as the
reference's zero padding does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.match.program import decimate
from object_detector_6d_tpu_torch.ops.refine import coarse_sweep, refine_sweep_batched
from object_detector_6d_tpu_torch.quant.features import Template

WIN = 16  # the local window (linemod.cpp similarityLocal), K4's tile


def feature_tables(templates: Sequence[Template], device) -> Tuple[torch.Tensor, ...]:
    """Templates (one pyramid level, one modality) -> their features as
    int32 tables x, y, label [n, F] (zero past a template's count) and the
    counts [n], on ``device``. A repeated feature is listed twice, as the
    reference's kernel counts it twice."""
    n = len(templates)
    F = max((len(t.features) for t in templates), default=1) or 1
    xyl = np.zeros((3, n, F), np.int32)
    counts = np.zeros(n, np.int32)
    for i, t in enumerate(templates):
        counts[i] = len(t.features)
        for j, f in enumerate(t.features):
            xyl[:, i, j] = (f.x, f.y, f.label)
    return tuple(torch.as_tensor(a, device=device) for a in (*xyl, counts))


def template_sizes(templates: Sequence[Template]) -> np.ndarray:
    """[n, 2] (w, h) int32, as the reference's ``pack_kernels`` returns them."""
    return np.array([(t.width, t.height) for t in templates], np.int32).reshape(-1, 2)


def _planes(responses: torch.Tensor, t: int, hd: int, wd: int) -> torch.Tensor:
    """[8, H, W] u8 responses -> [1, 8*t^2, hd, wd] int8 decimated planes
    (responses are 0..4: the int8 view holds the same values)."""
    return decimate(responses[None].view(torch.int8), t, hd, wd).contiguous()


def conv_sweep(responses: torch.Tensor, tables, t_stride: int, grid_h: int,
               grid_w: int) -> torch.Tensor:
    """Raw similarity sums [n, grid_h, grid_w] int32 at the T-grid anchors
    (r*T, c*T): score[t, r, c] = sum_f R[label_f, r*T + y_f, c*T + x_f].
    ``tables`` from :func:`feature_tables`. One K6 launch."""
    x, y, label, n = tables
    t = t_stride
    H, W = responses.shape[1:]
    plane = label * (t * t) + (y % t) * t + x % t
    D = _planes(responses, t, -(-H // t), -(-W // t))
    return coarse_sweep(D, plane, y // t, x // t, n, grid_h, grid_w)[0]


def local_scores(responses: torch.Tensor, tables, tids: torch.Tensor,
                 anchors: torch.Tensor, t_stride: int,
                 kernel_hw: Tuple[int, int]) -> torch.Tensor:
    """Per-candidate local sweep [n_cand, 16, 16] int32 over the anchors
    (x0 + c*T, y0 + r*T), candidate i with template ``tids[i]`` and
    top-left ``anchors[i]`` = (x0, y0). One K4 launch.

    The reference cuts each window of (15T + kh) x (15T + kw) from the
    maps zero-padded by as much, ``kernel_hw`` = (kh, kw) being its
    one-hot kernels' extent (the largest template + 1), with
    ``dynamic_slice``: a negative start counts from the padded maps' end,
    then the start is clamped into [0, H] x [0, W]. The same start is
    taken here."""
    fx, fy, label, n = (a[tids] for a in tables)
    t = t_stride
    H, W = responses.shape[1:]
    kh, kw = kernel_hw

    def start(a, size, pad):
        return torch.where(a < 0, a + (size + pad), a).clamp(0, size)[:, None]

    x0 = start(anchors[:, 0], W, (WIN - 1) * t + kw)
    y0 = start(anchors[:, 1], H, (WIN - 1) * t + kh)
    X = x0 % t + fx
    Y = y0 % t + fy
    plane = label * (t * t) + (Y % t) * t + X % t
    r0 = y0 // t + Y // t
    c0 = x0 // t + X // t
    # planes tall and wide enough for every tile (zero past the frame)
    hd = max(-(-H // t), int(r0.max()) + WIN) if r0.numel() else -(-H // t)
    wd = max(-(-W // t), int(c0.max()) + WIN) if c0.numel() else -(-W // t)
    D = _planes(responses, t, hd, wd)
    return refine_sweep_batched(D, plane[None], r0[None], c0[None], n[None])[0]


def span_mask(
    sizes: np.ndarray, t_stride: int, height: int, width: int, grid_h: int, grid_w: int
) -> np.ndarray:
    """Bool [n, grid_h, grid_w]: anchors where the template fits the image.

    Oracle span: r <= H/T - hf, c <= W/T - wf with wf = (w-1)/T + 1
    (linemod.cpp similarity(): span_x = W - wf, inclusive).
    """
    gw = width // t_stride
    gh = height // t_stride
    wf = (sizes[:, 0] - 1) // t_stride + 1
    hf = (sizes[:, 1] - 1) // t_stride + 1
    span_x = gw - wf  # inclusive max c
    span_y = gh - hf
    r = np.arange(grid_h)[None, :, None]
    c = np.arange(grid_w)[None, None, :]
    return (r <= span_y[:, None, None]) & (c <= span_x[:, None, None])
