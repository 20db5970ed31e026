"""LINEMOD Detector: training side, packed bank and ``match`` (port of
object_detector_6d_tpu/api/detector.py).

``add_template`` / ``add_synthetic_template`` build per-class template
pyramids (the images quantized on the given device by K1 / K2, the
features extracted on the host); ``write_classes`` / ``read_classes`` /
``write`` / ``read`` keep them and the configuration in the oracle's
store formats (io/yaml_store.py, io/native.py); ``get_bank`` packs every
class into the global bank the fused program sweeps. ``match`` returns the sorted, de-duplicated
``Match`` list of one frame (linemod.cpp matchClass semantics: anchor
offset T/2 + (T%2-1), candidate x2+1 upsampling with an 8T border clamp,
score = 100 * raw / (4 * num_features), strict > at the coarse level, >=
threshold after refinement), through one of two matchers:

* the fused match program (match/program.py) at B=1, over a power-of-two
  capacity ladder;
* the host-orchestrated matcher ``_match_reference``: per level and
  modality the quantized image's response maps (K1/K2, K3), per class
  the coarse sum over the lowest level's T-grid (K6, match/sweep.py), the
  span mask and raw threshold on the host, then level by level a 16x16
  local sum per candidate (K4). ``match`` takes it with ``fused=False``,
  with another pyramid depth than 2, or when the ladder runs out.

Templates are stored interleaved per level ([mod0 L0, mod1 L0, mod0 L1,
...]), the oracle's TemplatePyramid layout. The modalities default to the
reference's ("ColorGradient", "DepthNormal"); either may be left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu_torch.core.device import checked_device
from object_detector_6d_tpu_torch.io import native, yaml_store
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.match import sweep
from object_detector_6d_tpu_torch.ops.response import response_spread_batched
from object_detector_6d_tpu_torch.quant.features import Template, crop_templates
from object_detector_6d_tpu_torch.quant.pyramid import ColorGradientPyramid, DepthNormalPyramid

MODALITIES = ("ColorGradient", "DepthNormal")


@dataclasses.dataclass
class Match:
    """One detection (linemod.hpp:259-287)."""

    x: int
    y: int
    similarity: float
    class_id: str
    template_id: int

    def sort_key(self):
        # similarity desc, then template_id asc (Match::operator<)
        return (-self.similarity, self.template_id)


def _offset(t: int) -> int:
    return t // 2 + (t % 2 - 1)


class Detector:
    """Template bank + training for the LINEMOD detector."""

    def __init__(
        self,
        modalities: Sequence[str] = MODALITIES,
        t_at_level: Sequence[int] = (5, 8),
        color_gradient_params: Optional[ColorGradientParams] = None,
        depth_normal_params: Optional[DepthNormalParams] = None,
    ):
        for name in modalities:
            if name not in MODALITIES:
                raise ValueError(f"unknown modality {name!r}")
        self.modality_names = tuple(modalities)
        self.t_at_level = tuple(t_at_level)
        self.cg_params = color_gradient_params or ColorGradientParams()
        self.dn_params = depth_normal_params or DepthNormalParams()
        # class_id -> list of template pyramids (interleaved level-major)
        self.class_templates: Dict[str, List[List[Template]]] = {}
        self._bank_cache: Dict[tuple, mp.PackedBank] = {}
        # match programs per (frame shape, capacity) and bank tensors per
        # (bank, device); both dropped by _store
        self._match_cache: Dict[tuple, object] = {}
        # the host matcher's feature tables per (class, level, modality,
        # device); _store drops the stored class's
        self._kernel_cache: Dict[tuple, tuple] = {}
        self.bank_version = 0  # bumped by _store; cache-key salt

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_at_level)

    def num_templates(self, class_id: Optional[str] = None) -> int:
        if class_id is not None:
            return len(self.class_templates.get(class_id, []))
        return sum(len(v) for v in self.class_templates.values())

    def class_ids(self) -> List[str]:
        return list(self.class_templates.keys())

    def num_classes(self) -> int:
        """linemod.hpp:387 numClasses."""
        return len(self.class_templates)

    def get_templates(self, class_id: str, template_id: int) -> List[Template]:
        """The stored template pyramid, interleaved level-major like the
        oracle's getTemplates (linemod.hpp:389)."""
        return self.class_templates[class_id][template_id]

    def add_template(
        self, sources: Sequence[np.ndarray], class_id: str, object_mask: np.ndarray,
        device="cuda",
    ) -> Tuple[int, Optional[Tuple[int, int, int, int]]]:
        """Returns (template_id, bbox) or (-1, None) on failure; ``sources``
        holds one image per modality (BGR u8 or depth u16). The images are
        quantized on ``device`` (K1, K2; their twins with "cpu")."""
        pyrs = self._build_pyramids(sources, object_mask, checked_device(device))
        tp: List[Template] = []
        for lvl in range(self.pyramid_levels):
            for p in pyrs:
                t = p.extract_template(lvl)
                if t is None:
                    return -1, None
                tp.append(t)
        bbox = crop_templates(tp)
        return self._store(tp, class_id), bbox

    def _build_pyramids(self, sources, mask, device):
        pyrs = []
        for name, src in zip(self.modality_names, sources):
            if name == "ColorGradient":
                pyrs.append(ColorGradientPyramid(src, self.cg_params,
                                                 self.pyramid_levels, mask, device))
            else:
                pyrs.append(DepthNormalPyramid(src, self.dn_params,
                                               self.pyramid_levels, mask, device))
        return pyrs

    def add_synthetic_template(self, templates: Sequence[Template],
                               class_id: str) -> int:
        """Register externally built templates (bbox-relative features)."""
        return self._store(list(templates), class_id)

    def _store(self, tp: List[Template], class_id: str) -> int:
        lst = self.class_templates.setdefault(class_id, [])
        lst.append(tp)
        self.bank_version += 1
        self._bank_cache.clear()
        self._match_cache.clear()
        self._kernel_cache = {k: v for k, v in self._kernel_cache.items()
                              if k[0] != class_id}
        return len(lst) - 1

    # ------------------------------------------------------------------
    # persistence (linemod.hpp:391-393; oracle-compatible yml.gz)
    # ------------------------------------------------------------------

    def write_classes(self, path_format: str = "templates_%s.yml.gz",
                      class_ids: Optional[Sequence[str]] = None) -> None:
        for cid in class_ids or self.class_ids():
            yaml_store.write_class(path_format % cid, cid, self.modality_names,
                                   self.pyramid_levels, self.class_templates.get(cid, []))

    def read_classes(self, class_ids: Sequence[str],
                     path_format: str = "templates_%s.yml.gz") -> None:
        """Each class from its store: ``.npz`` (yaml_store.load_npz), else
        the yml(.gz) through the native reader, or the Python reader where
        the native library cannot be built."""
        for cid in class_ids:
            path = path_format % cid
            if path.endswith(".npz"):
                result = yaml_store.load_npz(path)
            else:
                result = native.read_class_native(path)
                if result is None:  # no toolchain: pure-Python fallback
                    result = yaml_store.read_class(path)
            read_cid, mods, levels, tps = result
            if list(mods) != list(self.modality_names) or levels != self.pyramid_levels:
                raise ValueError(
                    f"store {path} was built for modalities={mods}, "
                    f"levels={levels}; detector has {self.modality_names}, "
                    f"{self.pyramid_levels}"
                )
            for tp in tps:
                self._store(tp, read_cid)

    def write(self, path: str) -> None:
        """Detector parameter document (oracle Detector::write format)."""
        with open(path, "w") as f:
            f.write(yaml_store.emit_yaml(yaml_store.detector_doc(self)))

    @classmethod
    def read(cls, path: str) -> "Detector":
        with open(path) as f:
            doc = yaml_store.parse_yaml(f.read())
        names, t_at_level, cg, dn = yaml_store.parse_detector_doc(doc)
        return cls(names, t_at_level, cg, dn)

    def get_bank(self, class_ids: Optional[Sequence[str]] = None, pad_to: int = 1):
        """Packed global template bank (cached; invalidated by _store).
        None when no selected class has templates. ``pad_to``: round the
        bank up to a multiple (template-axis sharding over a mesh)."""
        key = tuple(sorted(class_ids)) if class_ids else None
        bank = self._bank_cache.get((key, pad_to))
        if bank is None:
            selected = {
                cid: tps for cid, tps in self.class_templates.items()
                if (key is None or cid in class_ids) and tps
            }
            if not selected:
                return None
            bank = mp.pack_bank(selected, len(self.modality_names),
                                self.pyramid_levels, t0=self.t_at_level[0],
                                t1=self.t_at_level[1], pad_to=pad_to)
            self._bank_cache[(key, pad_to)] = bank
        return bank

    # largest candidate capacity of the fused match program
    MAX_FUSED_CANDIDATES = 1024

    def match(
        self,
        sources: Sequence[np.ndarray],
        threshold: float,
        class_ids: Optional[Sequence[str]] = None,
        fused: bool = True,
        max_candidates: int = 64,
        device="cuda",
    ) -> List[Match]:
        """Match all templates against one frame (linemod.hpp:330) on
        ``device``; ``sources`` holds one image per modality ([H, W, 3] u8
        BGR or [H, W] u16 depth).

        ``fused=True`` (default) runs the match program (match/program.py)
        at B=1. When the frame's coarse candidates overflow
        ``max_candidates`` the call runs a wider program from a
        power-of-two capacity ladder (built once per capacity, cached).
        Beyond MAX_FUSED_CANDIDATES, with another pyramid depth than 2, or
        with ``fused=False``, the host-orchestrated matcher answers, as in
        the reference."""
        device = checked_device(device)
        if fused and self.pyramid_levels == 2:
            K = max_candidates
            while K <= self.MAX_FUSED_CANDIDATES:
                result = self._match_fused(sources, threshold, class_ids, K, device)
                if isinstance(result, int):  # overflow: n_above returned
                    K = max(2 * K, 1 << (result - 1).bit_length())
                    continue
                return result
        return self._match_reference(sources, threshold, class_ids, device)

    def _source_tensors(self, sources, device) -> List[torch.Tensor]:
        """One [1, ...] tensor per modality on ``device``: u8 BGR or int32
        depth."""
        srcs = []
        for name, s in zip(self.modality_names, sources):
            s = np.asarray(s)
            s = s.astype(np.uint8) if name == "ColorGradient" else s.astype(np.int32)
            srcs.append(torch.as_tensor(s[None]).to(device))
        return srcs

    def _match_fused(self, sources, threshold, class_ids, max_candidates, device):
        """One run of the capacity-``max_candidates`` program: the Match
        list, or the candidate count (an int) when it overflows."""
        bank = self.get_bank(class_ids)
        if bank is None:
            return []
        shape = tuple(np.asarray(sources[0]).shape[:2])
        prog_key = ("prog", shape, max_candidates)
        prog = self._match_cache.get(prog_key)
        if prog is None:
            prog = mp.make_match_program(
                self.modality_names, self.t_at_level, shape, self.dn_params,
                self.cg_params, max_candidates)
            self._match_cache[prog_key] = prog
        akey = ("bank_args", id(bank), str(device))
        bargs = self._match_cache.get(akey)
        if bargs is None:
            bargs = mp.bank_args(bank, device)
            self._match_cache[akey] = bargs
        with torch.no_grad():
            packed = prog(self._source_tensors(sources, device), *bargs,
                          threshold)[0].cpu().numpy()
        n_above = int(packed[0, -1])
        if n_above > max_candidates:
            return n_above  # the caller retries a wider capacity
        xs = packed[0, :-1].astype(np.int32)
        ys = packed[1, :-1].astype(np.int32)
        score = packed[2, :-1]
        tids = packed[3, :-1].astype(np.int32)
        keep = packed[4, :-1] > 0
        matches = [
            Match(int(xs[i]), int(ys[i]), float(score[i]),
                  bank.class_ids[tids[i]], int(bank.local_tids[tids[i]]))
            for i in range(len(keep)) if keep[i]
        ]
        return self._sort_dedup(matches)

    @staticmethod
    def _sort_dedup(matches: List[Match]) -> List[Match]:
        """Sort by (similarity desc, template id asc), then keep the first
        of each (x, y, similarity, class): set-based, as the reference."""
        matches.sort(key=Match.sort_key)
        out: List[Match] = []
        seen = set()
        for m in matches:
            key = (m.x, m.y, m.similarity, m.class_id)
            if key in seen:
                continue
            seen.add(key)
            out.append(m)
        return out

    # ------------------------------------------------------------------
    # the host-orchestrated matcher
    # ------------------------------------------------------------------

    def _kernels(self, class_id: str, level: int, modality: int, device):
        """The sparse feature tables of (class, level, modality) on
        ``device`` (match/sweep.py ``feature_tables``), the templates'
        (w, h) sizes and feature counts; cached."""
        key = (class_id, level, modality, str(device))
        hit = self._kernel_cache.get(key)
        if hit is None:
            num_mod = len(self.modality_names)
            tmpls = [tp[level * num_mod + modality] for tp in self.class_templates[class_id]]
            nfeat = np.array([len(t.features) for t in tmpls], np.int32)
            hit = (sweep.feature_tables(tmpls, device), sweep.template_sizes(tmpls), nfeat)
            self._kernel_cache[key] = hit
        return hit

    def _match_reference(
        self,
        sources: Sequence[np.ndarray],
        threshold: float,
        class_ids: Optional[Sequence[str]] = None,
        device="cuda",
    ) -> List[Match]:
        """Quantize every level (K1 / K2 at B=1), spread + response maps
        per level and modality (K3), then each class's sweeps."""
        device = checked_device(device)
        levels = self.pyramid_levels
        with torch.no_grad():
            qs = mp.quantize_pyramids_batched(
                self._source_tensors(sources, device), self.modality_names, levels,
                self.dn_params, self.cg_params)
            responses = [[response_spread_batched(q, self.t_at_level[lvl])[0]
                          for q in qs[lvl]] for lvl in range(levels)]
            sizes = [tuple(qs[lvl][-1].shape[1:]) for lvl in range(levels)]

            matches: List[Match] = []
            ids = list(class_ids) if class_ids else self.class_ids()
            for cid in ids:
                if cid in self.class_templates and self.class_templates[cid]:
                    matches.extend(self._match_class(cid, responses, sizes, threshold,
                                                     device))
        return self._sort_dedup(matches)

    def _match_class(self, class_id, responses, sizes, threshold, device) -> List[Match]:
        num_mod = len(self.modality_names)
        levels = self.pyramid_levels
        lowest = levels - 1
        t_low = self.t_at_level[lowest]
        H, W = sizes[lowest]
        gh, gw = H // t_low, W // t_low

        # --- coarse sweep over all templates at the lowest level (K6) ---
        total = None
        nfeat_total = None
        mask_all = None
        for mod in range(num_mod):
            tables, tsize, nfeat = self._kernels(class_id, lowest, mod, device)
            scores = sweep.conv_sweep(responses[lowest][mod], tables, t_low, gh,
                                      gw).cpu().numpy()
            m = sweep.span_mask(tsize, t_low, H, W, gh, gw)
            total = scores if total is None else total + scores
            nfeat_total = nfeat if nfeat_total is None else nfeat_total + nfeat
            mask_all = m if mask_all is None else (mask_all & m)

        # raw score strictly above int(2nf + (threshold/100)*2nf + 0.5)
        # (linemod.cpp matchClass), in float32 as the reference
        nf2 = (2 * nfeat_total).astype(np.float32)
        raw_thr = (
            nf2 + np.float32(threshold) / np.float32(100.0) * nf2 + np.float32(0.5)
        ).astype(np.int32)
        raw = np.where(mask_all, total, 0)
        tid_idx, rr, cc = np.nonzero(raw > raw_thr[:, None, None])
        off = _offset(t_low)
        candidates = [
            Match(
                int(c) * t_low + off,
                int(r) * t_low + off,
                float(
                    np.float32(raw[t, r, c])
                    * np.float32(100.0)
                    / np.float32(4 * nfeat_total[t])
                ),
                class_id,
                int(t),
            )
            for t, r, c in zip(tid_idx, rr, cc)
        ]

        # --- local refinement up the pyramid (K4) ---
        for lvl in range(levels - 2, -1, -1):
            if not candidates:
                break
            t = self.t_at_level[lvl]
            H, W = sizes[lvl]
            border = 8 * t
            off = _offset(t)
            tps = self.class_templates[class_id]
            start = lvl * num_mod

            packed = [self._kernels(class_id, lvl, mod, device) for mod in range(num_mod)]
            anchors = np.zeros((len(candidates), 2), np.int32)
            xs = np.zeros(len(candidates), np.int32)
            ys = np.zeros(len(candidates), np.int32)
            for i, mch in enumerate(candidates):
                x = mch.x * 2 + 1
                y = mch.y * 2 + 1
                tw = tps[mch.template_id][start].width
                th = tps[mch.template_id][start].height
                x = max(x, border)
                y = max(y, border)
                x = min(x, W - tw - border)
                y = min(y, H - th - border)
                xs[i], ys[i] = x, y
                anchors[i] = ((x // t - 8) * t, (y // t - 8) * t)

            tid_arr = np.array([m.template_id for m in candidates], np.int32)
            tids_dev = torch.as_tensor(tid_arr.astype(np.int64), device=device)
            anchors_dev = torch.as_tensor(anchors, device=device)
            total16 = None
            nfeat_lvl = None
            for mod in range(num_mod):
                tables, tsize, nfeat = packed[mod]
                kernel_hw = (int(tsize[:, 1].max()) + 1, int(tsize[:, 0].max()) + 1)
                s16 = sweep.local_scores(responses[lvl][mod], tables, tids_dev,
                                         anchors_dev, t, kernel_hw).cpu().numpy()
                total16 = s16 if total16 is None else total16 + s16
                nf = nfeat[tid_arr]
                nfeat_lvl = nf if nfeat_lvl is None else nfeat_lvl + nf

            refined: List[Match] = []
            for i, mch in enumerate(candidates):
                grid = total16[i]
                pct = (grid * 100.0).astype(np.float32) / (4.0 * nfeat_lvl[i])
                # first strict max in row-major order
                best_flat = int(np.argmax(pct))
                best_r, best_c = divmod(best_flat, pct.shape[1])
                best = float(pct[best_r, best_c])
                nx = (xs[i] // t - 8 + best_c) * t + off
                ny = (ys[i] // t - 8 + best_r) * t + off
                if best >= threshold:
                    refined.append(Match(nx, ny, best, class_id, mch.template_id))
            candidates = refined

        return candidates
