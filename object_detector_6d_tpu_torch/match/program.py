"""Fused frame-batched match program (port of
object_detector_6d_tpu/match/program.py, depth-only).

    depth [B, H, W] -> quantize (K2) -> level-1 subsample -> spread +
    response maps at both levels (K3) -> coarse sweep of the packed
    template bank (float32 conv2d over the T1-decimated planes) -> span
    mask, raw threshold, exact top-K -> 16x16 level-0 refinement (K4)
    -> [B, 5, K+1] packed candidates

Rows of the output: x, y, similarity, global template id, keep; the last
column carries the frame's count of above-threshold coarse candidates
(overflow when > K). Same semantics, tie orders and integer paddings as
the reference (``build_D`` pads to the reference's Hp2/Wp2, so tile
indices are identical).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.ops.quantize import dn_quantize_batched
from object_detector_6d_tpu_torch.ops.refine import refine_sweep_batched
from object_detector_6d_tpu_torch.ops.response import response_spread_batched


@dataclasses.dataclass
class PackedBank:
    """Global template bank packed for the fused program (2 levels), numpy."""

    class_ids: List[str]  # per global template id
    local_tids: np.ndarray  # [nT] local id within class
    # coarse level: per modality one-hot kernels over the T1-decimated
    # response planes, [nT, 8*t1^2, kd, kd] (small integer counts)
    kernels_low: List[np.ndarray]
    # level-0 sparse features per modality: plane/dr/dc [nT, F], counts [nT]
    feat_plane: List[np.ndarray]
    feat_dr: List[np.ndarray]
    feat_dc: List[np.ndarray]
    feat_n: List[np.ndarray]
    nfeat: List[np.ndarray]  # per level: [nT] total features (all mods)
    sizes: List[np.ndarray]  # per level: [nT, 2] (w, h)

    @property
    def num_templates(self) -> int:
        return len(self.class_ids)


class BankArgs(NamedTuple):
    """A PackedBank's arrays as tensors on one device."""

    kernels_low: List[torch.Tensor]  # f32
    feat_arrays: Tuple[List[torch.Tensor], ...]  # plane, dr, dc, n (i32)
    nfeat_l0: torch.Tensor
    nfeat_l1: torch.Tensor
    sizes_l0: torch.Tensor
    sizes_l1: torch.Tensor


def pack_bank(
    class_templates: Dict[str, list], num_mod: int, levels: int, t0: int = 5,
    t1: int = 8,
) -> PackedBank:
    """Concatenate every class's template pyramids into one bank."""
    class_ids: List[str] = []
    local_tids: List[int] = []
    all_tps = []
    for cid, tps in class_templates.items():
        for i, tp in enumerate(tps):
            class_ids.append(cid)
            local_tids.append(i)
            all_tps.append(tp)
    nT = len(all_tps)
    nfeat: List[np.ndarray] = []
    sizes: List[np.ndarray] = []
    for lvl in range(levels):
        nf = np.zeros(nT, np.int32)
        sz = np.zeros((nT, 2), np.int32)
        for mod in range(num_mod):
            for i, t in enumerate(tp[lvl * num_mod + mod] for tp in all_tps):
                sz[i] = (t.width, t.height)
                nf[i] += len(t.features)
        nfeat.append(nf)
        sizes.append(sz)

    # coarse one-hot kernels over the t1-decimated plane layout: channel =
    # label*t1^2 + (fy%t1)*t1 + fx%t1, spatial offset (fy//t1, fx//t1)
    lowest = levels - 1
    kernels_low: List[np.ndarray] = []
    for mod in range(num_mod):
        tmpls = [tp[lowest * num_mod + mod] for tp in all_tps]
        kh = max((t.height for t in tmpls), default=0) + 1
        kw = max((t.width for t in tmpls), default=0) + 1
        kd = (max(kh, kw) - 1) // t1 + 1
        K = np.zeros((nT, 8 * t1 * t1, kd, kd), np.float32)
        for i, t in enumerate(tmpls):
            for f in t.features:
                plane = f.label * t1 * t1 + (f.y % t1) * t1 + (f.x % t1)
                K[i, plane, f.y // t1, f.x // t1] += 1.0
        kernels_low.append(K)

    feat_plane, feat_dr, feat_dc, feat_n = [], [], [], []
    for mod in range(num_mod):
        tmpls = [tp[mod] for tp in all_tps]
        F = max((len(t.features) for t in tmpls), default=1)
        pla = np.zeros((nT, F), np.int32)
        dra = np.zeros((nT, F), np.int32)
        dca = np.zeros((nT, F), np.int32)
        na = np.zeros((nT,), np.int32)
        for i, t in enumerate(tmpls):
            na[i] = len(t.features)
            for j, f in enumerate(t.features):
                pla[i, j] = f.label * t0 * t0 + (f.y % t0) * t0 + (f.x % t0)
                dra[i, j] = f.y // t0
                dca[i, j] = f.x // t0
        feat_plane.append(pla)
        feat_dr.append(dra)
        feat_dc.append(dca)
        feat_n.append(na)

    return PackedBank(class_ids, np.array(local_tids, np.int32), kernels_low,
                      feat_plane, feat_dr, feat_dc, feat_n, nfeat, sizes)


def bank_args(bank: PackedBank, device) -> BankArgs:
    def t(a):
        return torch.as_tensor(a, device=device)

    return BankArgs(
        [t(k) for k in bank.kernels_low],
        tuple([t(a) for a in arrs] for arrs in
              (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n)),
        t(bank.nfeat[0]), t(bank.nfeat[1]), t(bank.sizes[0]), t(bank.sizes[1]),
    )


def exact_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis in lax.top_k's order: descending value,
    ties broken by the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def make_match_program(
    modality_names: Sequence[str],
    t_at_level: Sequence[int],
    frame_shape: Tuple[int, int],
    dn_params,
    max_candidates: int = 64,
):
    """Build the frame-batched matcher.

    Returns ``run(sources, kernels_low, feat_arrays, nfeat_l0, nfeat_l1,
    sizes_l0, sizes_l1, threshold) -> [B, 5, K+1] f32`` where ``sources``
    holds one [B, H, W] depth batch per modality.
    """
    if tuple(modality_names) != ("DepthNormal",):
        raise NotImplementedError(
            f"modalities {tuple(modality_names)}: this package matches the "
            "DepthNormal modality only; ColorGradient is ROADMAP queue 1 "
            "item 2 (K1 cg_quantize_batched + pyr_down_u8)")
    levels = len(t_at_level)
    if levels != 2:
        raise ValueError("the fused program supports 2-level pyramids")
    num_mod = len(modality_names)
    H0, W0 = frame_shape
    H1, W1 = H0 // 2, W0 // 2
    t0, t1 = t_at_level
    gh, gw = H1 // t1, W1 // t1
    off0 = t0 // 2 + (t0 % 2 - 1)
    off1 = t1 // 2 + (t1 % 2 - 1)
    K_cap = max_candidates
    Hd, Wd = -(-H0 // t0), -(-W0 // t0)

    def npow2(x):
        return 1 << (x - 1).bit_length()

    # the reference's padded plane size (a Mosaic constraint there); kept
    # so every tile index is identical
    Hp2 = npow2(max(Hd + 17, 32))
    Wp2 = npow2(max(Wd + 17, 128))
    Hd1, Wd1 = -(-H1 // t1), -(-W1 // t1)

    def decimate(R, t, hd, wd):
        """[B, 8, h, w] -> [B, 8*t^2, hd, wd] (zero-padded partial cells)."""
        B, _, h, w = R.shape
        R = torch.nn.functional.pad(R, (0, wd * t - w, 0, hd * t - h))
        return (R.reshape(B, 8, hd, t, wd, t).permute(0, 1, 3, 5, 2, 4)
                .reshape(B, 8 * t * t, hd, wd))

    def compute_responses(sources_b):
        """Quantize (K2) + spread/response (K3) at both levels."""
        R0_b, R1_b = [], []
        for src in sources_b:
            q0 = dn_quantize_batched(src, int(dn_params.distance_threshold),
                                     int(dn_params.difference_threshold))
            q1 = q0[:, ::2, ::2].contiguous()
            R0_b.append(response_spread_batched(q0, t0))
            R1_b.append(response_spread_batched(q1, t1))
        return R0_b, R1_b

    def coarse_stage(R1_b, kernels_low, nfeat_l1, sizes_l1, threshold):
        raw = None
        for mod in range(num_mod):
            k = kernels_low[mod]  # [nT, 8*t1^2, kd, kd] f32
            kd = k.shape[3]
            # stride-T1 sweep == stride-1 conv over the decimated planes:
            # score[t,r,c] = sum_f D[l*t1^2+(fy%t1)*t1+fx%t1, r+fy//t1, c+fx//t1]
            D = decimate(R1_b[mod], t1, Hd1, Wd1).to(torch.float32)
            need_h = gh + kd - 1
            need_w = gw + kd - 1
            D = torch.nn.functional.pad(
                D, (0, max(0, need_w - Wd1), 0, max(0, need_h - Hd1)))
            # float32 holds these sums exactly: responses are 0..4 and
            # kernel cells small counts, so every partial sum stays far
            # below 2^24. TF32 is switched off for the call (it would be
            # exact too; this does not rely on it). cuDNN may still pick a
            # Winograd or FFT algorithm, whose results sit within a small
            # fraction of the integer: round, never truncate.
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                s = torch.nn.functional.conv2d(D, k)[:, :, :gh, :gw]
            finally:
                torch.backends.cudnn.allow_tf32 = prev
            s = torch.round(s).to(torch.int32)
            raw = s if raw is None else raw + s
        B, nT = raw.shape[0], raw.shape[1]
        dev = raw.device
        wf = (sizes_l1[:, 0] - 1) // t1 + 1
        hf = (sizes_l1[:, 1] - 1) // t1 + 1
        span_x = (W1 // t1) - wf  # inclusive
        span_y = (H1 // t1) - hf
        rgrid = torch.arange(gh, device=dev)[None, :, None]
        cgrid = torch.arange(gw, device=dev)[None, None, :]
        in_span = (rgrid <= span_y[:, None, None]) & (cgrid <= span_x[:, None, None])
        raw = torch.where(in_span[None], raw, 0)
        # raw threshold: int(2nf + thr/100*2nf + 0.5), float32 exact
        nf2 = (2 * nfeat_l1).to(torch.float32)
        raw_thr = (nf2 + threshold / 100.0 * nf2 + 0.5).to(torch.int32)
        above = raw > raw_thr[None, :, None, None]
        n_above = above.reshape(B, -1).sum(dim=1, dtype=torch.int32)
        flat_score = torch.where(above, raw, -1).reshape(B, -1)
        top_vals, top_idx = exact_topk(flat_score, K_cap)
        valid = top_vals > -1
        tids = top_idx // (gh * gw)
        rc = top_idx % (gh * gw)
        xs = (rc % gw) * t1 + off1
        ys = (rc // gw) * t1 + off1
        return tids, valid, n_above, xs, ys

    def anchors_stage(tids, xs, ys, sizes_l0):
        border = 8 * t0
        tw = sizes_l0[tids, 0]
        th = sizes_l0[tids, 1]
        x2 = torch.minimum(torch.clamp(xs * 2 + 1, min=border), W0 - tw - border)
        y2 = torch.minimum(torch.clamp(ys * 2 + 1, min=border), H0 - th - border)
        return x2, y2, x2 // t0 - 8, y2 // t0 - 8

    def build_D(R):
        """[B, 8, H0, W0] u8 -> decimated int8 planes [B, 8*t0^2, Hp2, Wp2]."""
        D = decimate(R.to(torch.int8), t0, Hd, Wd)
        return torch.nn.functional.pad(D, (0, Wp2 - Wd, 0, Hp2 - Hd))

    def post_stage(total16, tids, valid, n_above, x2, y2, nfeat_l0, threshold):
        B = total16.shape[0]
        nf0 = nfeat_l0[tids].to(torch.float32)
        pct16 = total16 * 100.0 / (4.0 * nf0[:, :, None, None])
        flat = pct16.reshape(B, K_cap, 256)
        best_flat = torch.argmax(flat, dim=2)  # first maximum
        best = torch.gather(flat, 2, best_flat[..., None])[..., 0]
        best_r = best_flat // 16
        best_c = best_flat % 16
        nx = (x2 // t0 - 8 + best_c) * t0 + off0
        ny = (y2 // t0 - 8 + best_r) * t0 + off0
        keep = valid & (best >= threshold)
        packed = torch.stack([nx.to(torch.float32), ny.to(torch.float32), best,
                              tids.to(torch.float32), keep.to(torch.float32)],
                             dim=1)  # [B, 5, K]
        n_col = n_above.to(torch.float32)[:, None, None].expand(B, 5, 1)
        return torch.cat([packed, n_col], dim=2)

    def run(sources, kernels_low, feat_arrays, nfeat_l0, nfeat_l1, sizes_l0,
            sizes_l1, threshold):
        threshold = float(np.float32(threshold))
        R0_b, R1_b = compute_responses(sources)
        tids, valid, n_above, xs, ys = coarse_stage(
            R1_b, kernels_low, nfeat_l1, sizes_l1, threshold)
        x2, y2, base_c, base_r = anchors_stage(tids, xs, ys, sizes_l0)
        feat_plane, feat_dr, feat_dc, feat_n = feat_arrays
        total16 = None
        for mod in range(num_mod):
            D = build_D(R0_b[mod])
            plane = feat_plane[mod][tids]
            r0i = base_r[:, :, None] + feat_dr[mod][tids]
            c0i = base_c[:, :, None] + feat_dc[mod][tids]
            # invalid top-K slots sweep zero features
            nfe = torch.where(valid, feat_n[mod][tids], 0)
            s16 = refine_sweep_batched(D, plane, r0i, c0i, nfe).to(torch.float32)
            total16 = s16 if total16 is None else total16 + s16
        return post_stage(total16, tids, valid, n_above, x2, y2, nfeat_l0,
                          threshold)

    return run
