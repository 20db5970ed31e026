"""The template bank of a configuration, made by the benchmark and handed
alike to the program and to the reference; the program never makes it.

A bank is a list of templates in global order. A template is a dict:
``class`` (its class id), ``size`` ([(w, h) at level 0, (w, h) at level
1]) and ``features`` ([level][modality] int arrays of (x, y, label) rows,
relative to the template's corner, labels 0..7).

- Synthetic classes (``bank``: ``n_classes`` x ``per_class``): square
  templates of ``bbox_px`` x uniform(0.8, 1.2) pixels (half that at level
  1), ``num_features`` features a modality at level 0 and half as many at
  level 1, drawn without repeats from a lattice of the level's spacing at
  a random offset, with random labels.
- Objects (``objects``: class id -> snowman scale): one view each, rendered
  by ``frames.snowman_scene`` and quantized by the reference's quantizers;
  colour features on the object's pixels with a label, depth features on
  the object eroded by ``erode_depth_px``; ``num_features`` a modality at
  level 0 and half at level 1, picked in a random order at least
  ``spacing`` pixels apart (the spacing relaxed by one pixel until enough
  are found); the template is the object's bounding box at each level.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import frames
from bench_port.reference.quantize import color_gradient, depth_normal, pyr_down, rounding


def _lattice(rng, n: int, w: int, h: int, spacing: int) -> np.ndarray:
    ox, oy = rng.integers(0, spacing, 2)
    gx, gy = np.meshgrid(np.arange(ox, w + 1, spacing), np.arange(oy, h + 1, spacing))
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    if len(grid) < n:
        raise ValueError(f"a {w}x{h} template holds {len(grid)} lattice points, not {n}")
    pick = grid[rng.choice(len(grid), n, replace=False)]
    return np.c_[pick, rng.integers(0, 8, n)].astype(np.int64)


def synthetic(spec: dict, n_mod: int) -> list:
    rng = np.random.default_rng(spec["seed"])
    out = []
    for c in range(spec["n_classes"]):
        for _ in range(spec["per_class"]):
            s = int(spec["bbox_px"] * rng.uniform(0.8, 1.2))
            size = [(s, s), (s // 2, s // 2)]
            feats = [[_lattice(rng, spec["num_features"] >> lvl, *size[lvl],
                               spec["spacing"][lvl]) for _ in range(n_mod)]
                     for lvl in (0, 1)]
            out.append({"class": f"class_{c:02d}", "size": size, "features": feats})
    return out


def _erode(mask: np.ndarray, px: int) -> np.ndarray:
    for _ in range(px):
        p = np.pad(mask, 1, mode="edge")
        mask = np.logical_and.reduce([p[i:i + mask.shape[0], j:j + mask.shape[1]]
                                      for i in range(3) for j in range(3)])
    return mask


def _scattered(rng, xy: np.ndarray, n: int, spacing: int) -> np.ndarray:
    """Indices of n rows of ``xy`` taken in a random order, each at least
    ``spacing`` from those taken before (relaxed while too few)."""
    order = rng.permutation(len(xy))
    for d in range(spacing, -1, -1):
        taken = []
        for i in order:
            if not taken or ((xy[taken] - xy[i]) ** 2).sum(1).min() >= d * d:
                taken.append(i)
                if len(taken) == n:
                    return np.array(taken)
    raise ValueError(f"{len(xy)} candidates, fewer than {n} features")


def object_view(scale: float, cfg: dict, rng, device="cpu") -> dict:
    depth, gray, mask = frames.snowman_scene(scale, device=device)
    bgr = gray[..., None].expand(*gray.shape, 3)[None].contiguous()
    fl = rounding("float32")
    cgp, dnp, spec = cfg["color_gradient"], cfg["depth_normal"], cfg["object_features"]
    q_cg = [color_gradient(bgr, cgp["weak_threshold"], fl)[0]]
    q_cg.append(color_gradient(pyr_down(bgr), cgp["weak_threshold"], fl)[0])
    dn = depth_normal(depth[None], dnp["distance_threshold"], dnp["difference_threshold"], fl)[0]
    q_dn = [dn, dn[::2, ::2]]
    q_cg, q_dn = [q.cpu() for q in q_cg], [q.cpu() for q in q_dn]
    m = [mask.cpu().numpy(), mask.cpu().numpy()[::2, ::2]]
    size, feats = [], []
    for lvl in (0, 1):
        ys, xs = np.nonzero(m[lvl])
        x0, y0 = xs.min(), ys.min()
        size.append((int(xs.max() - x0), int(ys.max() - y0)))
        spacing = max(spec["spacing"] >> lvl, 1)
        per_mod = []
        for name in cfg["modalities"]:
            if name == "ColorGradient":
                q, region = q_cg[lvl].numpy(), m[lvl]
            else:
                q, region = q_dn[lvl].numpy(), _erode(m[lvl], spec["erode_depth_px"])
            cy, cx = np.nonzero(region & (q != 0))
            pick = _scattered(rng, np.c_[cx, cy], spec["num_features"] >> lvl, spacing)
            label = np.log2(q[cy[pick], cx[pick]]).astype(np.int64)
            per_mod.append(np.c_[cx[pick] - x0, cy[pick] - y0, label].astype(np.int64))
        feats.append(per_mod)
    return {"size": size, "features": feats}


def make_bank(cfg: dict, device="cpu") -> list:
    """The configuration's bank: the synthetic classes, then the objects
    (rendered and quantized on ``device``)."""
    out = synthetic(cfg["bank"], len(cfg["modalities"]))
    rng = np.random.default_rng(cfg["object_features"]["seed"])
    with torch.no_grad():
        for cid, scale in cfg["objects"].items():
            out.append({"class": cid, **object_view(scale, cfg, rng, device)})
    return out


def feature_counts(bank: list, level: int) -> list:
    """Features a template at ``level``, over every modality."""
    return [sum(len(f) for f in tp["features"][level]) for tp in bank]
