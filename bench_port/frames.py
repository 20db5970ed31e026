"""The traffic generator: two-object 480x640 frames made from a seed.

A torch copy of the repo's detect-benchmark frames (``chip_smoke.py``
``make_frames`` over ``tools/scenes.py``'s ``snowman_scene``,
``render_translated`` and ``merge_scenes``) that renders on any device, in
chunks of frames at once. Every float step is the numpy original's, one
separately rounded float64 operation, so depth and masks equal the
original's; where two source pixels of one object land on the same target
pixel at the same depth the original keeps whichever its unstable argsort
put last, and this copy keeps the one with the highest source index, so
the gray texture can differ on such pixels
(``bench_port/tests/test_frames.py`` states how many).

The object placements come from the traffic file: per placed object a
class id, a centre and a half-width per axis; frame after frame each
object draws ``centre + uniform(-half, half)`` per axis, in the original's
order, from a numpy RandomState seeded by ``seed_state(seed)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# tools/scenes.py's camera
K_DEFAULT = np.array(
    [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]],
    dtype=np.float64,
)
BG_MM = 1500


def seed_state(seed: int) -> np.random.RandomState:
    """A RandomState for any whole-number seed (RandomState itself takes
    only 0 <= seed < 2**32; a seed and its negative draw alike)."""
    return np.random.RandomState(np.random.MT19937(np.random.SeedSequence(abs(int(seed)))))


def snowman_scene(scale: float = 1.0, width: int = 640, height: int = 480,
                  bg_mm: int = BG_MM, cx: int = 330, cy: int = 250,
                  checker_px: int = 16, device="cpu"):
    """``tools/scenes.py`` ``snowman_scene``: depth [H, W] int32 (mm), gray
    [H, W] u8 and mask [H, W] bool of two overlapping sphere bulges and a
    side ridge (no rotational symmetry)."""
    f64 = torch.float64
    yy, xx = torch.meshgrid(torch.arange(height, dtype=f64, device=device),
                            torch.arange(width, dtype=f64, device=device), indexing="ij")

    def bulge(bx, by, r_px, h_mm):
        r2 = (xx - bx) ** 2 + (yy - by) ** 2
        return torch.sqrt(torch.clamp(r_px ** 2 - r2, min=0.0)) / r_px * h_mm

    b1 = bulge(cx, cy, 80 * scale, 300)
    b2 = bulge(cx + int(55 * scale), cy - int(35 * scale), 45 * scale, 380)
    b3 = bulge(cx - int(40 * scale), cy + int(50 * scale), 30 * scale, 200)
    total = torch.maximum(torch.maximum(b1, b2), b3)
    inside = total > 0
    depth = torch.where(inside, float(bg_mm) - total, torch.full_like(total, float(bg_mm)))
    depth_mm = torch.round(depth).to(torch.int32)
    checker = ((xx.long() // checker_px) + (yy.long() // checker_px)) % 2
    gray = torch.where(inside, 60 + 140 * checker, 128).to(torch.uint8)
    return depth_mm, gray, inside


class ObjectSplat:
    """One object's masked surface, ready to be translated and re-rendered
    by z-buffer splatting (``tools/scenes.py`` ``render_translated``)."""

    def __init__(self, depth_mm: torch.Tensor, mask: torch.Tensor, K: np.ndarray):
        self.H, self.W = depth_mm.shape
        self.fx, self.fy, self.cx, self.cy = (float(K[0, 0]), float(K[1, 1]),
                                              float(K[0, 2]), float(K[1, 2]))
        ys, xs = torch.nonzero(mask, as_tuple=True)
        self.src = ys * self.W + xs  # source index, row-major as np.nonzero
        z = depth_mm[ys, xs].to(torch.float64) / 1000.0
        f64 = torch.float64
        # X = (xs - cx) / fx * z + t: the translation-free part once
        self.xz = (xs.to(f64) - self.cx) / self.fx * z
        self.yz = (ys.to(f64) - self.cy) / self.fy * z
        self.z = z
        checker = (xs // 16 + ys // 16) % 2
        self.tex = (60 + 140 * checker).to(torch.uint8)

    def render(self, t: torch.Tensor):
        """t [F, 3] float64 metres -> (depth [F, H*W] float64 m with the
        background at BG_MM, mask [F, H*W] bool, gray [F, H*W] u8)."""
        F = t.shape[0]
        HW = self.H * self.W
        X = self.xz[None] + t[:, 0:1]
        Y = self.yz[None] + t[:, 1:2]
        Z = self.z[None] + t[:, 2:3]
        u = torch.round(X / Z * self.fx + self.cx).to(torch.int64)
        v = torch.round(Y / Z * self.fy + self.cy).to(torch.int64)
        ok = (u >= 0) & (u < self.W) & (v >= 0) & (v < self.H) & (Z > 0)
        flat = torch.where(ok, v * self.W + u, HW)  # HW: a dump slot
        zkey = torch.where(ok, Z, torch.inf)
        zmin = torch.full((F, HW + 1), torch.inf, dtype=torch.float64, device=t.device)
        zmin.scatter_reduce_(1, flat, zkey, reduce="amin")
        # the nearest point wins each target pixel; among equally near
        # ones, the highest source index
        win = ok & (zkey == torch.gather(zmin, 1, flat))
        src = torch.where(win, self.src[None].expand(F, -1), -1)
        best = torch.full((F, HW + 1), -1, dtype=torch.int64, device=t.device)
        best.scatter_reduce_(1, flat, src, reduce="amax")
        zmin, best = zmin[:, :HW], best[:, :HW]
        mask = best >= 0
        depth = torch.where(mask, zmin, BG_MM / 1000.0)
        lut = torch.full((self.H * self.W,), 128, dtype=torch.uint8, device=t.device)
        lut[self.src] = self.tex
        gray = torch.where(mask, lut[best.clamp(min=0)], 128).to(torch.uint8)
        return depth, mask, gray


def draw_translations(rng: np.random.RandomState, placements, n: int) -> np.ndarray:
    """[n, objects, 3] translations, drawn frame by frame and object by
    object in ``make_frames``' order: centre + uniform(-half, half)."""
    out = np.empty((n, len(placements), 3))
    for f in range(n):
        for o, p in enumerate(placements):
            for a in range(3):
                out[f, o, a] = p["center"][a] + rng.uniform(-p["half"][a], p["half"][a])
    return out


class FrameMaker:
    """Renders two-object frames on ``device``: ``objects`` maps a class id
    to its snowman scale (the configuration's), ``placements`` lists the
    placed objects (the traffic's), in z-merge order."""

    def __init__(self, objects: dict, placements, K=K_DEFAULT, device="cpu"):
        self.placements = placements
        self.splats = []
        for p in placements:
            dep, _, mask = snowman_scene(objects[p["class_id"]], device=device)
            self.splats.append(ObjectSplat(dep, mask, K))
        self.H, self.W = self.splats[0].H, self.splats[0].W
        self.K = np.asarray(K, dtype=np.float64)
        self.device = device

    def render(self, t: np.ndarray):
        """t [F, objects, 3] -> depth [F, H, W] int32 mm, BGR [F, H, W, 3] u8
        (the composed gray x3), as ``merge_scenes`` of the rendered objects."""
        tt = torch.as_tensor(t, dtype=torch.float64, device=self.device)
        F = tt.shape[0]
        depth = torch.full((F, self.H * self.W), float(BG_MM), dtype=torch.float64,
                           device=self.device)
        gray = torch.full((F, self.H * self.W), 128, dtype=torch.uint8, device=self.device)
        for o, sp in enumerate(self.splats):
            d_m, m, g = sp.render(tt[:, o])
            df = torch.round(d_m * 1000)  # render_translated's u16 mm
            nearer = m & (df < depth)
            depth = torch.where(nearer, df, depth)
            gray = torch.where(nearer, g, gray)
        depth = torch.round(depth).to(torch.int32).reshape(F, self.H, self.W)
        gray = gray.reshape(F, self.H, self.W)
        return depth, gray[..., None].expand(F, self.H, self.W, 3).contiguous()


class Pool(NamedTuple):
    """A cell's frames, made from the seed: depth [n, H, W] int32 mm and BGR
    [n, H, W, 3] u8 on the host, the placed objects' ground-truth
    translations [n, objects, 3] (metres, camera frame, in the traffic's
    placement order) and the camera K [3, 3] they were rendered with."""

    depth: torch.Tensor
    bgr: torch.Tensor
    translations: np.ndarray
    K: np.ndarray


def make_pool(maker: FrameMaker, n: int, seed: int, chunk: int = 64, pin: bool = False) -> Pool:
    """n frames from ``seed`` on the host, in page-locked memory with
    ``pin``; rendered on the maker's device ``chunk`` frames at a time."""
    t = draw_translations(seed_state(seed), maker.placements, n)
    depth = torch.empty((n, maker.H, maker.W), dtype=torch.int32, pin_memory=pin)
    bgr = torch.empty((n, maker.H, maker.W, 3), dtype=torch.uint8, pin_memory=pin)
    for s in range(0, n, chunk):
        d, c = maker.render(t[s:s + chunk])
        depth[s:s + chunk].copy_(d)
        bgr[s:s + chunk].copy_(c)
    return Pool(depth, bgr, t, maker.K)
