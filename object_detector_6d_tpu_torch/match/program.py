"""Fused frame-batched match program (port of
object_detector_6d_tpu/match/program.py), one or two modalities.

    sources (per modality: [B, H, W, 3] u8 BGR or [B, H, W] depth)
    -> quantize both pyramid levels (quantize_pyramids_batched: K1 for
       ColorGradient at level 0 and on pyr_down_u8 at level 1; K2 for
       DepthNormal, subsampled [::2, ::2] at level 1)
    -> spread + response maps per level and modality (K3)
    -> coarse sweep of the packed bank's sparse level-1 feature tables
       over the T1-decimated planes of every modality (K6)
    -> span mask, raw threshold, exact top-K (K7 over the whole batch)
    -> 16x16 level-0 refinement per modality (K4)
    -> [B, 5, K+1] packed candidates

Rows of the output: x, y, similarity, global template id, keep; the last
column carries the frame's count of above-threshold coarse candidates
(overflow when > K). Under a device mesh (parallel/sharding.py) each rank
runs the same path on its frames and its template shard, with a sixth row,
the raw coarse score, by which ``merge_shard_candidates`` re-ranks the
shards' candidates. Same semantics, tie orders and integer paddings as
the reference: K6's raw grid equals the reference main path's int8 conv
over its one-hot ``kernels_low``, and ``build_D`` pads to the reference's
Hp2/Wp2, so tile indices are identical.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.ops.quantize import cg_quantize_batched, dn_quantize_batched
from object_detector_6d_tpu_torch.ops.refine import coarse_sweep, refine_sweep_batched
from object_detector_6d_tpu_torch.ops.response import response_spread_batched
from object_detector_6d_tpu_torch.ops.select import exact_topk, select_topk
from object_detector_6d_tpu_torch.parallel.sharding import all_gather_cat, axis_size
from object_detector_6d_tpu_torch.quant.features import Template
from object_detector_6d_tpu_torch.quant.pyramid import pyr_down_u8
from object_detector_6d_tpu_torch.utils.profiling import scope


@dataclasses.dataclass
class PackedBank:
    """Global template bank packed for the fused program (2 levels), numpy."""

    class_ids: List[str]  # per global template id
    local_tids: np.ndarray  # [nT] local id within class
    # coarse level (K6): one sparse table over every modality's T1-decimated
    # response planes stacked along the plane axis, per template its
    # modality-0 features, then its modality-1 features: plane =
    # (8*mod + label)*t1^2 + (y%t1)*t1 + x%t1, cell offset (y//t1, x//t1);
    # plane/dr/dc [nT, F1], counts [nT]
    coarse: Tuple[np.ndarray, ...]
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

    coarse_tables: Tuple[torch.Tensor, ...]  # K6 plane, dr, dc [nT, F], n [nT]
    feat_arrays: Tuple[List[torch.Tensor], ...]  # plane, dr, dc, n (i32)
    nfeat_l0: torch.Tensor
    nfeat_l1: torch.Tensor
    sizes_l0: torch.Tensor
    sizes_l1: torch.Tensor


def _sparse_tables(feats, t: int):
    """Per-template tables of (x, y, label) features over the t-decimated
    plane layout: plane = label*t^2 + (y%t)*t + x%t, dr = y//t, dc = x//t,
    and counts."""
    nT = len(feats)
    F = max((len(fs) for fs in feats), default=1)
    pla = np.zeros((nT, F), np.int32)
    dra = np.zeros((nT, F), np.int32)
    dca = np.zeros((nT, F), np.int32)
    na = np.zeros((nT,), np.int32)
    for i, fs in enumerate(feats):
        na[i] = len(fs)
        for j, (x, y, label) in enumerate(fs):
            pla[i, j] = label * t * t + (y % t) * t + (x % t)
            dra[i, j] = y // t
            dca[i, j] = x // t
    return pla, dra, dca, na


def pack_bank(
    class_templates: Dict[str, list], num_mod: int, levels: int, t0: int = 5,
    t1: int = 8, pad_to: int = 1,
) -> PackedBank:
    """Concatenate every class's template pyramids into one bank.

    ``pad_to``: round the bank size up to a multiple (template-axis
    sharding over a mesh). Padding templates (class id "", local id -1)
    have no features, so their raw coarse score is 0 and the strict
    > threshold rule (raw threshold >= 0) never makes them candidates.
    """
    class_ids: List[str] = []
    local_tids: List[int] = []
    all_tps = []
    for cid, tps in class_templates.items():
        for i, tp in enumerate(tps):
            class_ids.append(cid)
            local_tids.append(i)
            all_tps.append(tp)
    while pad_to > 1 and len(all_tps) % pad_to:
        class_ids.append("")
        local_tids.append(-1)
        all_tps.append([Template(0, 0, lvl, []) for lvl in range(levels)
                        for _ in range(num_mod)])
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
    lowest = levels - 1
    # modality m's labels offset by 8*m: its planes follow modality m-1's
    coarse = _sparse_tables(
        [[(f.x, f.y, 8 * mod + f.label) for mod in range(num_mod)
          for f in tp[lowest * num_mod + mod].features] for tp in all_tps], t1)
    f_plane, f_dr, f_dc, f_n = zip(*(
        _sparse_tables([[(f.x, f.y, f.label) for f in tp[mod].features] for tp in all_tps],
                       t0) for mod in range(num_mod)))
    return PackedBank(
        class_ids=class_ids, local_tids=np.array(local_tids, np.int32), coarse=coarse,
        feat_plane=list(f_plane), feat_dr=list(f_dr), feat_dc=list(f_dc),
        feat_n=list(f_n), nfeat=nfeat, sizes=sizes)


def bank_args(bank: PackedBank, device) -> BankArgs:
    def t(a):
        return torch.as_tensor(a, device=device)

    return BankArgs(
        tuple(t(a) for a in bank.coarse),
        tuple([t(a) for a in arrs] for arrs in
              (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n)),
        t(bank.nfeat[0]), t(bank.nfeat[1]), t(bank.sizes[0]), t(bank.sizes[1]),
    )


def bank_max_dr(feat_arrays) -> torch.Tensor:
    """The bank's largest level-0 feature cell offset, max(y // t0, x // t0)
    over every modality's features (the reference's ``PackedBank.max_dr``),
    as a 0-dim tensor on the tables' device (no host sync)."""
    _, feat_dr, feat_dc, _ = feat_arrays
    return torch.cat([a.reshape(-1) for a in (*feat_dr, *feat_dc)]
                     + [feat_dr[0].new_zeros(1)]).max()


def quantize_pyramids_batched(sources_b, modality_names, levels, dn_params, cg_params):
    """Quantized images [level][modality], each [B, H, W] u8: K1 per
    ColorGradient level (``pyr_down_u8`` in between), K2 once per
    DepthNormal source, subsampled [::2, ::2] per level. Any frame size."""
    qs_b = [[None] * len(modality_names) for _ in range(levels)]
    for m, (name, src_b) in enumerate(zip(modality_names, sources_b)):
        if name == "ColorGradient":
            img_b = src_b
            for lvl in range(levels):
                qs_b[lvl][m] = cg_quantize_batched(img_b, float(cg_params.weak_threshold))
                if lvl + 1 < levels:
                    img_b = pyr_down_u8(img_b)
        elif name == "DepthNormal":
            q_b = dn_quantize_batched(src_b, int(dn_params.distance_threshold),
                                      int(dn_params.difference_threshold))
            for lvl in range(levels):
                qs_b[lvl][m] = q_b
                if lvl + 1 < levels:
                    q_b = q_b[:, ::2, ::2].contiguous()
        else:
            raise ValueError(f"unknown modality {name!r}")
    return qs_b


def decimate(R: torch.Tensor, t: int, hd: int, wd: int) -> torch.Tensor:
    """[B, 8, h, w] responses -> [B, 8*t^2, hd, wd] T-decimated planes,
    plane label*t^2 + (y%t)*t + x%t at cell (y//t, x//t) (zero-padded
    partial cells)."""
    B, _, h, w = R.shape
    R = torch.nn.functional.pad(R, (0, wd * t - w, 0, hd * t - h))
    return (R.reshape(B, 8, hd, t, wd, t).permute(0, 1, 3, 5, 2, 4)
            .reshape(B, 8 * t * t, hd, wd))


def make_match_program(
    modality_names: Sequence[str],
    t_at_level: Sequence[int],
    frame_shape: Tuple[int, int],
    dn_params,
    cg_params,
    max_candidates: int = 64,
    mesh=None,
):
    """Build the frame-batched matcher.

    Returns ``run(sources, coarse_tables, feat_arrays, nfeat_l0, nfeat_l1,
    sizes_l0, sizes_l1, threshold) -> [B, 5, K+1] f32`` where ``sources``
    holds one batch per modality: [B, H, W, 3] u8 BGR for ColorGradient,
    [B, H, W] depth for DepthNormal (the rest is a BankArgs).

    With ``mesh`` (parallel/sharding.make_mesh) every rank is given the
    whole batch and bank and returns the whole [B, 5, K+1]: it matches its
    contiguous frame shard (the data axis) against its contiguous template
    shard (the model axis), the model axis merges the candidates
    (``merge_shard_candidates``) and the data axis gathers the frames. B
    must divide by the data axis and the bank size by the model axis
    (pack_bank's ``pad_to``). ``run.local`` returns only this rank's
    frames, merged, with the raw score row: [B/dp, 6, K+1].
    """
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

    def coarse_stage(R1_b, coarse_tables, nfeat_l1, sizes_l1, threshold):
        # stride-T1 sweep == sparse sweep over the decimated planes:
        # score[t,r,c] = sum_f D[l*t1^2+(fy%t1)*t1+fx%t1, r+fy//t1, c+fx//t1]
        # with every modality's planes stacked along the plane axis (K6).
        # Responses are 0..4, so their u8 bytes read as int8 are the same
        # values: a view, not a copy
        D = torch.cat([decimate(R.view(torch.int8), t1, Hd1, Wd1) for R in R1_b], dim=1)
        raw = coarse_sweep(D, *coarse_tables, gh, gw)
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
        return flat_score, n_above

    anchor_luts = {}

    def topk_stage(flat_score, vmax):
        """The exact top-K of the thresholded grid (K7 over the whole batch;
        every value in [-1, vmax]), as template ids and level-1 anchors."""
        top_vals, top_idx = select_topk(flat_score, K_cap, vmax)
        valid = top_vals > -1
        tids = top_idx // (gh * gw)
        # each grid cell's (x, y) anchor, made once a device: one gather a
        # batch in place of six integer passes
        dev = flat_score.device
        if dev not in anchor_luts:
            rc = torch.arange(gh * gw, device=dev)
            anchor_luts[dev] = torch.stack([(rc % gw) * t1 + off1, (rc // gw) * t1 + off1], 1)
        xy = anchor_luts[dev][top_idx % (gh * gw)]
        return tids, valid, xy[..., 0], xy[..., 1], top_vals

    def anchors_stage(tids, xs, ys, sizes_l0, window):
        """Level-0 anchors x2, y2 and the rows / columns where the 16x16
        sweep starts, as the reference's conv path takes them.

        A template taller (wider) than the frame less two borders puts
        the base y2 // t0 - 8 below 0. The reference cuts its window of
        ``window`` = 16 + max_dr cells (max_dr: the bank's largest level-0
        feature cell offset) with ``dynamic_slice``, which counts a
        negative start from the end of the planes and then clamps it into
        [0, Hp2 - window]; the same start is taken here. x2, y2 (and so
        post_stage's reported position) stay unclamped, as there. A base
        >= 0 is swept where it is: there the reference's clamp is its
        fault (ROADMAP queue 3 item 1c) and its TPU path sums at the base.

        No tile leaves its plane for a template no larger than the frame.
        Feature f (0 <= f.y <= th, f.y // t0 <= max_dr) puts its tile's
        last row at start + f.y // t0 + 15. From a base >= 0, y2 + f.y <=
        H0 - border gives (y2 + f.y) // t0 + 7 <= H0 // t0 - 1 < Hd < Hp2.
        From a negative base, start <= Hp2 - 16 - max_dr gives <= Hp2 - 1,
        or start = 0 (a window taller than the planes, which the
        reference cannot cut) gives th // t0 + 15 <= Hd + 15 < Hp2, as
        Hp2 >= Hd + 17. Columns likewise, with Wp2 >= Wd + 17.
        """
        border = 8 * t0
        tw = sizes_l0[tids, 0]
        th = sizes_l0[tids, 1]
        x2 = torch.minimum(torch.clamp(xs * 2 + 1, min=border), W0 - tw - border)
        y2 = torch.minimum(torch.clamp(ys * 2 + 1, min=border), H0 - th - border)

        def start(base, size):
            wrapped = torch.minimum(base + size, size - window).clamp(min=0)
            return torch.where(base < 0, wrapped, base)

        return x2, y2, start(x2 // t0 - 8, Wp2), start(y2 // t0 - 8, Hp2)

    def build_D(R):
        """[B, 8, H0, W0] u8 -> decimated int8 planes [B, 8*t0^2, Hp2, Wp2]
        (responses are 0..4: the int8 view holds the same values)."""
        D = decimate(R.view(torch.int8), t0, Hd, Wd)
        return torch.nn.functional.pad(D, (0, Wp2 - Wd, 0, Hp2 - Hd))

    def post_stage(total16, tids, valid, n_above, x2, y2, nfeat_l0, threshold,
                   raw_vals, tid_offset):
        """[B, 6, K+1]: row 5 carries the raw coarse score, by which a
        sharded caller re-ranks the shards' top-Ks as the flat top-K did;
        ``tid_offset`` relabels a template shard's ids to global ids."""
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
                              (tids + tid_offset).to(torch.float32),
                              keep.to(torch.float32), raw_vals.to(torch.float32)],
                             dim=1)  # [B, 6, K]
        n_col = n_above.to(torch.float32)[:, None, None].expand(B, 6, 1)
        return torch.cat([packed, n_col], dim=2)

    def core(sources, coarse_tables, feat_arrays, nfeat_l0, nfeat_l1, sizes_l0,
             sizes_l1, threshold, tid_offset=0, max_dr=None, rows=6):
        """The whole path on the given frames and (part of the) bank ->
        [B, rows, K+1] (the first ``rows`` of the 6); ``max_dr`` is the
        whole bank's (by default that of ``feat_arrays``). Each stage runs
        under its ``match.*`` span (utils/profiling.py)."""
        if len(sources) != num_mod:
            raise ValueError(f"{len(sources)} sources for modalities {tuple(modality_names)}")
        threshold = float(np.float32(threshold))
        with scope("match.quantize"):
            qs_b = quantize_pyramids_batched(sources, modality_names, levels,
                                             dn_params, cg_params)
        with scope("match.responses"):
            R0_b = [response_spread_batched(q, t0) for q in qs_b[0]]
            R1_b = [response_spread_batched(q, t1) for q in qs_b[1]]
        with scope("match.coarse"):
            flat_score, n_above = coarse_stage(R1_b, coarse_tables, nfeat_l1, sizes_l1,
                                               threshold)
        with scope("match.topk"):
            # K6 sums responses 0..4 over at most F features a template
            tids, valid, xs, ys, raw_vals = topk_stage(flat_score,
                                                       4 * coarse_tables[0].shape[1])
        feat_plane, feat_dr, feat_dc, feat_n = feat_arrays
        with scope("match.refine"):
            if max_dr is None:
                max_dr = bank_max_dr(feat_arrays)
            x2, y2, base_c, base_r = anchors_stage(tids, xs, ys, sizes_l0, 16 + max_dr)
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
        with scope("match.post"):
            out = post_stage(total16, tids, valid, n_above, x2, y2, nfeat_l0,
                             threshold, raw_vals, tid_offset)
            return out if rows == 6 else out[:, :rows].contiguous()

    if mesh is None:
        def run(sources, *bank_and_threshold):
            return core(sources, *bank_and_threshold, rows=5)

        return run

    dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")

    def local(sources, coarse_tables, feat_arrays, nfeat_l0, nfeat_l1, sizes_l0,
              sizes_l1, threshold):
        B, nT = sources[0].shape[0], nfeat_l0.shape[0]
        if B % dp:
            raise ValueError(f"a batch of {B} frames does not divide the mesh's data "
                             f"axis ({dp})")
        if nT % tp:
            raise ValueError(f"a bank of {nT} templates does not divide the mesh's model "
                             f"axis ({tp}): pack it with pad_to={tp}")
        bl, nl = B // dp, nT // tp
        frames = slice(di * bl, (di + 1) * bl)
        shard = slice(mi * nl, (mi + 1) * nl)
        packed_l = core(
            [s[frames] for s in sources], tuple(a[shard] for a in coarse_tables),
            tuple([a[shard] for a in arrs] for arrs in feat_arrays), nfeat_l0[shard],
            nfeat_l1[shard], sizes_l0[shard], sizes_l1[shard], threshold,
            tid_offset=mi * nl, max_dr=bank_max_dr(feat_arrays))  # [B/dp, 6, K+1]
        packed_all = all_gather_cat(packed_l[None], mesh, "model")  # [tp, B/dp, 6, K+1]
        return merge_shard_candidates(packed_all, K_cap)

    def run(sources, *bank_and_threshold):
        return all_gather_cat(local(sources, *bank_and_threshold)[:, :5].contiguous(),
                              mesh, "data")

    run.local = local
    return run


def merge_shard_candidates(packed_all: torch.Tensor, K_cap: int) -> torch.Tensor:
    """Merge model-axis candidate shards: [tp, ..., 6, K+1] -> [..., 6, K+1].

    Selects the global top-K by raw coarse score (row 5), the criterion
    of the single-rank program's flat top-K, in its tie order: the shards
    are concatenated in global template order and ``exact_topk`` prefers
    the lower index, so ties go to the lower template id as in the flat
    scan. Empty slots (raw score -1) still take places, as on one rank.
    ``n_above`` (the overflow count in the last column) sums across shards.
    """
    tp = packed_all.shape[0]
    lead = tuple(packed_all.shape[1:-2])
    cands = packed_all[..., :-1].movedim(0, -2).reshape(lead + (6, tp * K_cap))
    _, sel = exact_topk(cands[..., 5, :], K_cap)
    merged = torch.gather(cands, -1, sel.unsqueeze(-2).expand(lead + (6, K_cap)))
    n_above = packed_all[..., 0, -1].sum(0)
    return torch.cat([merged, n_above[..., None, None].expand(lead + (6, 1))], -1)
