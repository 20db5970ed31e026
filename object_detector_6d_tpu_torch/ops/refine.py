"""The two sparse sweeps of the match program: kernels K4 and K6 and
their plain twins (port of object_detector_6d_tpu/ops/refine_pallas.py
``refine_sweep_batched``, its one-frame form ``refine_sweep``, and
``coarse_sweep``).

K4, the 16x16 local refinement at level 0:

    out[b, k] = sum_{f < nfeat[b, k]} D[b, plane[b,k,f], r0:r0+16, c0:c0+16]

K6, the full-grid coarse sweep at level 1:

    out[b, t, r, c] = sum_{f < nfeat[t]} D[b, plane[t,f], r+dr[t,f], c+dc[t,f]]

A CPU tensor goes to the plain twin; a CUDA tensor launches
csrc/refine_sweep.cu or csrc/coarse_sweep.cu, or raises. Unlike the TPU
kernels, D's plane sizes need not be powers of two. K4's wrapper checks
that every swept tile lies inside its plane; K6 reads zero outside its
planes (the zero padding of the reference main path's coarse conv), so
its columns never wrap as the TPU kernel's do.

Both kernels stage at most MAX_F features a candidate or template; a
wider table goes through ``chunked_sweep`` on either device, one launch a
chunk of MAX_F features, and the int32 sums of the chunks add up to
those of one sweep over every feature.
"""

from __future__ import annotations

import torch

from object_detector_6d_tpu_torch.ops import kernels
from object_detector_6d_tpu_torch.utils import profiling

MAX_F = 256  # features per candidate (K4) or template (K6) a kernel launch stages


def _check_args(d_planes, plane_idx, r0, c0, nfeat):
    if d_planes.dim() != 4 or plane_idx.dim() != 3 or nfeat.dim() != 2:
        raise ValueError("expected D [B,P,Hp,Wp], tables [B,K,F], nfeat [B,K]")
    B, P, Hp, Wp = d_planes.shape
    if plane_idx.shape[0] != B or r0.shape != plane_idx.shape or c0.shape != plane_idx.shape:
        raise ValueError(f"table shapes {tuple(plane_idx.shape)}, {tuple(r0.shape)}, "
                         f"{tuple(c0.shape)} do not match D {tuple(d_planes.shape)}")
    if nfeat.shape != plane_idx.shape[:2]:
        raise ValueError(f"nfeat {tuple(nfeat.shape)} vs tables {tuple(plane_idx.shape)}")
    F = plane_idx.shape[2]
    live = torch.arange(F, device=nfeat.device)[None, None, :] < nfeat[:, :, None]
    bad = (live & ((plane_idx < 0) | (plane_idx >= P) | (r0 < 0) | (r0 > Hp - 16)
                   | (c0 < 0) | (c0 > Wp - 16))).any()
    with profiling.host_read("k4_bounds"):
        leaves = bool(bad)
    if leaves:
        raise ValueError("refine sweep: a feature tile leaves its plane")


def refine_sweep_plain(d_planes, plane_idx, r0, c0, nfeat) -> torch.Tensor:
    """The plain PyTorch twin of kernel K4 (gathers all F tiles, masks
    the features beyond nfeat, and sums in int32)."""
    B, P, Hp, Wp = d_planes.shape
    K, F = plane_idx.shape[1], plane_idx.shape[2]
    ar = torch.arange(16, device=d_planes.device)
    rows = r0[..., None] + ar  # [B, K, F, 16]
    cols = c0[..., None] + ar
    live = torch.arange(F, device=d_planes.device)[None, None, :] < nfeat[:, :, None]
    bidx = torch.arange(B, device=d_planes.device)[:, None, None, None, None]
    tiles = d_planes[bidx, plane_idx[..., None, None],
                     rows.clamp(0, Hp - 1)[..., :, None],
                     cols.clamp(0, Wp - 1)[..., None, :]].to(torch.int32)
    tiles = tiles * live[..., None, None].to(torch.int32)
    return tiles.sum(dim=2, dtype=torch.int32)


def chunked_sweep(sweep, tables, nfeat, chunk: int = MAX_F) -> torch.Tensor:
    """``sweep(*tables, nfeat)`` over feature tables of any width F (the
    last axis of every table), as the sum of one call a chunk of
    ``chunk`` features: chunk j takes the columns [j*chunk, (j+1)*chunk)
    and counts nfeat_j = clamp(nfeat - j*chunk, 0, its width). A chunk
    whose counts are all 0 is skipped (the first always runs). The sums
    are int32, so the result equals one sweep over all F, bitwise."""
    F = tables[0].shape[-1]
    if F <= chunk:
        return sweep(*tables, nfeat)
    most = 0
    if nfeat.numel():
        most_t = nfeat.max()
        with profiling.host_read("chunk_max"):
            most = int(most_t)
    out = None
    for j in range(min(-(-F // chunk), max(1, -(-most // chunk)))):
        part = [t[..., j * chunk:(j + 1) * chunk] for t in tables]
        s = sweep(*part, (nfeat - j * chunk).clamp(0, part[0].shape[-1]))
        out = s if out is None else out + s
    return out


def _refine_sweep_launch(d_planes, plane_idx, r0, c0, nfeat) -> torch.Tensor:
    """One K4 launch (or its twin on the CPU) over at most MAX_F features."""
    if d_planes.device.type == "cpu":
        return refine_sweep_plain(d_planes, plane_idx, r0, c0, nfeat)
    args = [d_planes.to(torch.int8).contiguous()] + [
        t.to(torch.int32).contiguous() for t in (plane_idx, r0, c0, nfeat)]
    kernels.require_cuda("refine_sweep_batched", *args)
    B, P, Hp, Wp = d_planes.shape
    K, F = plane_idx.shape[1], plane_idx.shape[2]
    if P * Hp * Wp >= 2 ** 31:
        raise ValueError(f"refine sweep: a frame's D {P}x{Hp}x{Wp} exceeds int32 offsets")
    out = torch.empty((B, K, 16, 16), dtype=torch.int32, device=d_planes.device)
    lib = kernels.library()
    code = lib.odc_refine_sweep(
        *(a.data_ptr() for a in args), out.data_ptr(), B, P, Hp, Wp, K, F,
        kernels.stream_ptr(d_planes.device))
    kernels.check(code, "refine_sweep_batched")
    refine_sweep_batched.launches += 1
    return out


def refine_sweep_batched(d_planes, plane_idx, r0, c0, nfeat) -> torch.Tensor:
    """[B, K, 16, 16] int32 local similarity sums (one launch a chunk of
    MAX_F features)."""
    _check_args(d_planes, plane_idx, r0, c0, nfeat)
    return chunked_sweep(lambda *t: _refine_sweep_launch(d_planes, *t),
                         (plane_idx, r0, c0), nfeat)


refine_sweep_batched.launches = 0


def refine_sweep(d_planes, plane_idx, r0, c0, nfeat=None) -> torch.Tensor:
    """One frame: D [P, Hp, Wp], tables [K, F] -> [K, 16, 16] int32;
    ``nfeat`` [K] defaults to all F features (its launch counts on
    ``refine_sweep_batched``)."""
    if nfeat is None:
        nfeat = torch.full((plane_idx.shape[0],), plane_idx.shape[1], dtype=torch.int32,
                           device=plane_idx.device)
    return refine_sweep_batched(d_planes[None], plane_idx[None], r0[None], c0[None],
                                nfeat[None])[0]


def coarse_sweep_plain(d_planes, plane_idx, dr, dc, nfeat, out_h: int,
                       out_w: int) -> torch.Tensor:
    """The plain PyTorch twin of kernel K6: one gather of every template's
    [out_h, out_w] window per feature slot, zero outside the planes."""
    B, P, Hp, Wp = d_planes.shape
    nT, F = plane_idx.shape
    dev = d_planes.device
    flat = d_planes.reshape(B, P * Hp * Wp)
    rows = torch.arange(out_h, device=dev)
    cols = torch.arange(out_w, device=dev)
    out = torch.zeros((B, nT, out_h, out_w), dtype=torch.int32, device=dev)
    for f in range(F):
        p, r, c = plane_idx[:, f], rows + dr[:, f, None], cols + dc[:, f, None]
        live = (f < nfeat) & (p >= 0) & (p < P)  # [nT]
        ok = (live[:, None, None] & ((r >= 0) & (r < Hp))[:, :, None]
              & ((c >= 0) & (c < Wp))[:, None, :])
        idx = ((p.clamp(0, P - 1)[:, None, None] * Hp + r.clamp(0, Hp - 1)[:, :, None])
               * Wp + c.clamp(0, Wp - 1)[:, None, :])
        out += torch.where(ok, flat[:, idx].to(torch.int32), 0)
    return out


def _coarse_sweep_launch(d_planes, plane_idx, dr, dc, nfeat, out_h: int, out_w: int
                         ) -> torch.Tensor:
    """One K6 launch (or its twin on the CPU) over at most MAX_F features."""
    if d_planes.device.type == "cpu":
        return coarse_sweep_plain(d_planes, plane_idx, dr, dc, nfeat, out_h, out_w)
    args = [d_planes.to(torch.int8).contiguous()] + [
        t.to(torch.int32).contiguous() for t in (plane_idx, dr, dc, nfeat)]
    kernels.require_cuda("coarse_sweep", *args)
    B, P, Hp, Wp = d_planes.shape
    nT, F = plane_idx.shape
    if max(Hp, Wp, out_h, out_w) >= 2 ** 24 \
            or ((P + 2) * Hp + out_h + 1024) * Wp + out_w + 64 >= 2 ** 31:
        raise ValueError(f"coarse sweep: a frame's D {P}x{Hp}x{Wp} swept over "
                         f"{out_h}x{out_w} exceeds int32 offsets")
    out = torch.empty((B, nT, out_h, out_w), dtype=torch.int32, device=d_planes.device)
    lib = kernels.library()
    code = lib.odc_coarse_sweep(
        *(a.data_ptr() for a in args), out.data_ptr(), B, P, Hp, Wp, nT, F,
        int(out_h), int(out_w), kernels.stream_ptr(d_planes.device))
    kernels.check(code, "coarse_sweep")
    coarse_sweep.launches += 1
    return out


def coarse_sweep(d_planes, plane_idx, dr, dc, nfeat, out_h: int, out_w: int
                 ) -> torch.Tensor:
    """[B, nT, out_h, out_w] int32 raw coarse similarity grid (one launch a
    chunk of MAX_F features)."""
    if d_planes.dim() != 4 or plane_idx.dim() != 2 or nfeat.dim() != 1:
        raise ValueError("expected D [B,P,Hp,Wp], tables [nT,F], nfeat [nT]")
    if dr.shape != plane_idx.shape or dc.shape != plane_idx.shape \
            or nfeat.shape[0] != plane_idx.shape[0]:
        raise ValueError(f"table shapes {tuple(plane_idx.shape)}, {tuple(dr.shape)}, "
                         f"{tuple(dc.shape)}, nfeat {tuple(nfeat.shape)} disagree")
    return chunked_sweep(lambda *t: _coarse_sweep_launch(d_planes, *t, out_h, out_w),
                         (plane_idx, dr, dc), nfeat)


coarse_sweep.launches = 0
