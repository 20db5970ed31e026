"""LINEMOD's two-level match of one frame against a template bank,
written from the algorithm, returning the match program's record.

A bank is the benchmark's (``bench_port/bank.py``): templates in global
order, each with its level-0 and level-1 size and, per level and
modality, an int [n, 3] array of (x, y, label) features relative to the
template's corner.

For each frame:

1. quantize both modalities at both levels (``quantize.py``; colour at
   level 1 on the pyrDown image, depth normals by taking every other
   pixel of level 0);
2. spread each quantized image over the level's T x T forward window
   (OR of the bits, zero past the frame) and take the response map of
   each of the 8 orientations: the best of 4 - circular distance to a
   bit of the spread byte, 0 for an empty byte or a distance of 4;
3. level 1: score every template at every grid position (r, c), r < H1 //
   T1, c < W1 // T1, as the sum of its features' responses at (c T1 +
   x, r T1 + y), zero past the frame; positions where the template
   overhangs the grid's span score 0; a template is a candidate where its
   score exceeds int(2 n + thr / 100 * 2 n + 0.5) (n its level-1
   features, float32);
4. the K best candidates, by score and then by the lower flat index
   (template, row, column); slots beyond the candidates take the lowest
   flat indices that are not candidates, and sweep nothing;
5. level 0: each slot's anchor (2 x + 1, 2 y + 1 of its grid point
   (c T1 + o1, r T1 + o1), o = T // 2 + T % 2 - 1, clamped to a border
   of 8 T0 and to the frame less the template and that border) and its
   16 x 16 positions (T0 cells from 8 cells before the anchor's cell);
   the similarity of a position is 100 x the summed responses over 4
   times the level-0 features, in float32; the first best position wins;
6. the record: x, y, similarity, template, kept (similarity >= thr and a
   real candidate) for each slot; its last column holds the frame's
   count of candidates.

A negative window start (a template taller or wider than the frame less
two borders) is taken as the bank's match program takes it: counted from
the end of the program's padded planes (cells ``npow2(max(H0 / T0 + 17,
32))`` high, ``npow2(max(W0 / T0 + 17, 128))`` wide) and clamped into them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bench_port.reference.quantize import color_gradient, depth_normal, pyr_down, rounding


def _offset(t: int) -> int:
    return t // 2 + (t % 2 - 1)


def _npow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def spread(q: torch.Tensor, t: int) -> torch.Tensor:
    """OR over the forward t x t window of [n, H, W] u8, zero past the frame."""
    H, W = q.shape[-2:]
    p = torch.nn.functional.pad(q, (0, t - 1, 0, t - 1))
    out = torch.zeros_like(q)
    for r in range(t):
        for c in range(t):
            out |= p[..., r:r + H, c:c + W]
    return out


def responses(s: torch.Tensor) -> torch.Tensor:
    """[n, H, W] spread bytes -> [n, 8, H, W] u8 responses."""
    out = []
    for i in range(8):
        best = torch.zeros_like(s)
        for j in range(8):
            dist = min(abs(i - j), 8 - abs(i - j))
            if dist < 4:
                has = ((s >> j) & 1).bool()
                best = torch.where(has, torch.clamp(best, min=4 - dist), best)
        out.append(best)
    return torch.stack(out, dim=-3)


class BankTables:
    """The bank's features as padded tensors on a device: per level, the
    (x, y, plane) of every feature over both modalities' response planes
    (plane = 8 modality + label) and the features' count."""

    def __init__(self, bank, modalities: Sequence[str], device):
        self.nT = len(bank)
        self.modalities = tuple(modalities)
        self.sizes = [torch.as_tensor(np.array([tp["size"][lvl] for tp in bank]),
                                      device=device) for lvl in (0, 1)]
        self.tables = []
        for lvl in (0, 1):
            feats = [np.concatenate([np.c_[f[:, :2], f[:, 2] + 8 * m]
                                     for m, f in enumerate(tp["features"][lvl])])
                     for tp in bank]
            n = np.array([len(f) for f in feats])
            tab = np.zeros((self.nT, max(n.max(), 1), 3), np.int64)
            for i, f in enumerate(feats):
                tab[i, :len(f)] = f
            self.tables.append((torch.as_tensor(tab, device=device),
                                torch.as_tensor(n, device=device)))
        # the largest level-0 feature cell offset over the bank (for a
        # negative window start)
        self.level0_xy = [np.concatenate([f[:, :2] for f in tp["features"][0]])
                          for tp in bank]


class Matcher:
    """Matches frames against one bank; see the module docstring."""

    def __init__(self, bank, modalities: Sequence[str], t_at_level, frame_shape,
                 weak_threshold: float, distance_threshold: int,
                 difference_threshold: int, max_candidates: int, device,
                 precision: str = "float32"):
        self.bank = BankTables(bank, modalities, device)
        self.t0, self.t1 = t_at_level
        self.H0, self.W0 = frame_shape
        self.K = max_candidates
        self.weak, self.dist_thr, self.diff_thr = (weak_threshold, distance_threshold,
                                                   difference_threshold)
        self.fl = rounding(precision)
        self.device = torch.device(device)
        most = max((int(xy.max()) for xy in self.bank.level0_xy if len(xy)), default=0)
        self.window = 16 + most // self.t0
        self.Hp = _npow2(max(-(-self.H0 // self.t0) + 17, 32))
        self.Wp = _npow2(max(-(-self.W0 // self.t0) + 17, 128))

    def _planes(self, depth, bgr):
        """Both levels' response planes [n, 8 x modalities, h, w] (int32)."""
        q = [[], []]
        for name in self.bank.modalities:
            if name == "ColorGradient":
                q[0].append(color_gradient(bgr, self.weak, self.fl))
                q[1].append(color_gradient(pyr_down(bgr), self.weak, self.fl))
            elif name == "DepthNormal":
                n0 = depth_normal(depth, self.dist_thr, self.diff_thr, self.fl)
                q[0].append(n0)
                q[1].append(n0[..., ::2, ::2])
            else:
                raise ValueError(f"unknown modality {name!r}")
        return [torch.cat([responses(spread(x, t)) for x in qs], dim=-3).to(torch.int32)
                for qs, t in zip(q, (self.t0, self.t1))]

    @staticmethod
    def _sum_at(R, tab, n, ys, xs):
        """sum over each row's first n features f of R[plane_f, ys + y_f,
        xs + x_f], zero past R's edge. R [P, h, w]; tab [m, F, 3]; ys [m, a],
        xs [m, b] -> [m, a, b] int32."""
        P, h, w = R.shape
        out = torch.zeros((tab.shape[0], ys.shape[1], xs.shape[1]), dtype=torch.int32,
                          device=R.device)
        for f in range(tab.shape[1]):
            live = f < n
            x, y, plane = tab[:, f, 0], tab[:, f, 1], tab[:, f, 2]
            rr = ys + y[:, None]
            cc = xs + x[:, None]
            inside = ((rr >= 0) & (rr < h))[:, :, None] & ((cc >= 0) & (cc < w))[:, None, :]
            v = R[plane[:, None, None], rr.clamp(0, h - 1)[:, :, None],
                  cc.clamp(0, w - 1)[:, None, :]]
            out += torch.where(inside & live[:, None, None], v, 0)
        return out

    def _start(self, base: torch.Tensor, cells: int) -> torch.Tensor:
        wrapped = torch.clamp(torch.minimum(base + cells, torch.full_like(base, cells - self.window)),
                              min=0)
        return torch.where(base < 0, wrapped, base)

    def _one(self, R0, R1, threshold: float) -> np.ndarray:
        t0, t1, K = self.t0, self.t1, self.K
        dev = R0.device
        H1, W1 = self.H0 // 2, self.W0 // 2
        gh, gw = H1 // t1, W1 // t1
        tab1, n1 = self.bank.tables[1]
        nT = self.bank.nT
        score = self._sum_at(R1, tab1, n1, (torch.arange(gh, device=dev) * t1)[None].expand(nT, -1),
                             (torch.arange(gw, device=dev) * t1)[None].expand(nT, -1))
        w1, h1 = self.bank.sizes[1][:, 0], self.bank.sizes[1][:, 1]
        span_c = gw - ((w1 - 1) // t1 + 1)
        span_r = gh - ((h1 - 1) // t1 + 1)
        in_span = ((torch.arange(gh, device=dev)[None, :, None] <= span_r[:, None, None])
                   & (torch.arange(gw, device=dev)[None, None, :] <= span_c[:, None, None]))
        score = torch.where(in_span, score, 0).reshape(-1)
        nf2 = (2 * n1).to(torch.float32)
        thr = torch.tensor(float(np.float32(threshold / 100.0)), dtype=torch.float32,
                           device=dev)
        limit = ((nf2 + thr * nf2) + 0.5).to(torch.int64)
        cand = score > limit.repeat_interleave(gh * gw)
        n_cand = int(cand.sum())
        idx = torch.nonzero(cand).reshape(-1)  # ascending flat index
        order = torch.sort(-score[idx], stable=True).indices
        slots = idx[order][:K]
        rest = torch.nonzero(~cand).reshape(-1)[:K - len(slots)]
        real = torch.arange(K, device=dev) < len(slots)
        slots = torch.cat([slots, rest])
        tid = slots // (gh * gw)
        r, c = (slots % (gh * gw)) // gw, slots % gw
        x1, y1 = c * t1 + _offset(t1), r * t1 + _offset(t1)
        border = 8 * t0
        w0, h0 = self.bank.sizes[0][tid, 0], self.bank.sizes[0][tid, 1]
        ax = torch.minimum(torch.clamp(2 * x1 + 1, min=border), self.W0 - w0 - border)
        ay = torch.minimum(torch.clamp(2 * y1 + 1, min=border), self.H0 - h0 - border)
        bx, by = ax // t0 - 8, ay // t0 - 8
        sx, sy = self._start(bx, self.Wp), self._start(by, self.Hp)
        tab0, n0 = self.bank.tables[0]
        steps = torch.arange(16, device=dev)
        total = self._sum_at(R0, tab0[tid], torch.where(real, n0[tid], 0),
                             (sy[:, None] + steps) * t0, (sx[:, None] + steps) * t0)
        fl = self.fl
        sim = fl(fl(total.to(torch.float32) * 100.0)
                 / fl(4.0 * n0[tid].to(torch.float32))[:, None, None]).reshape(K, 256)
        best = sim.argmax(dim=1)  # the first best position
        best_sim = sim.gather(1, best[:, None])[:, 0]
        x = (bx + best % 16) * t0 + _offset(t0)
        y = (by + best // 16) * t0 + _offset(t0)
        kept = real & (best_sim >= float(np.float32(threshold)))
        rec = torch.stack([x.to(torch.float32), y.to(torch.float32), best_sim,
                           tid.to(torch.float32), kept.to(torch.float32)])
        count = torch.full((5, 1), float(n_cand), dtype=torch.float32, device=dev)
        return torch.cat([rec, count], dim=1).cpu().numpy()

    @torch.no_grad()
    def match(self, depth: torch.Tensor, bgr: torch.Tensor, threshold: float,
              block: int = 4) -> np.ndarray:
        """Frames [n, H, W] depth and [n, H, W, 3] u8 BGR (any device) ->
        [n, 5, K+1] float32 records, ``block`` frames at a time."""
        threshold = float(np.float32(threshold))
        out = []
        for s in range(0, depth.shape[0], block):
            d = depth[s:s + block].to(self.device)
            c = bgr[s:s + block].to(self.device)
            R0, R1 = self._planes(d, c)
            out += [self._one(R0[i], R1[i], threshold) for i in range(d.shape[0])]
        return np.stack(out)
