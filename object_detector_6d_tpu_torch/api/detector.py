"""LINEMOD Detector: training side, packed bank and ``match`` (port of
object_detector_6d_tpu/api/detector.py).

``add_template`` / ``add_synthetic_template`` build per-class template
pyramids on the host; ``get_bank`` packs every class into the global bank
the fused program sweeps; ``match`` runs that program on one frame and
returns the sorted, de-duplicated ``Match`` list (linemod.cpp matchClass
semantics: strict > at the coarse level, >= threshold after refinement).
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
from object_detector_6d_tpu_torch.match import program as mp
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


class MatchCapacityError(NotImplementedError):
    """A frame needs the reference's host-orchestrated matcher
    (``_match_reference`` over match/sweep.py), which this package does
    not carry yet (ROADMAP.md queue 1, item 11's second part)."""


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
        self.bank_version = 0  # bumped by _store; cache-key salt

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_at_level)

    def num_templates(self, class_id: Optional[str] = None) -> int:
        if class_id is not None:
            return len(self.class_templates.get(class_id, []))
        return sum(len(v) for v in self.class_templates.values())

    def add_template(
        self, sources: Sequence[np.ndarray], class_id: str, object_mask: np.ndarray
    ) -> Tuple[int, Optional[Tuple[int, int, int, int]]]:
        """Returns (template_id, bbox) or (-1, None) on failure; ``sources``
        holds one image per modality (BGR u8 or depth u16)."""
        pyrs = self._build_pyramids(sources, object_mask)
        tp: List[Template] = []
        for lvl in range(self.pyramid_levels):
            for p in pyrs:
                t = p.extract_template(lvl)
                if t is None:
                    return -1, None
                tp.append(t)
        bbox = crop_templates(tp)
        return self._store(tp, class_id), bbox

    def _build_pyramids(self, sources, mask=None):
        pyrs = []
        for name, src in zip(self.modality_names, sources):
            if name == "ColorGradient":
                pyrs.append(ColorGradientPyramid(src, self.cg_params,
                                                 self.pyramid_levels, mask))
            else:
                pyrs.append(DepthNormalPyramid(src, self.dn_params,
                                               self.pyramid_levels, mask))
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
        return len(lst) - 1

    def get_bank(self, class_ids: Optional[Sequence[str]] = None):
        """Packed global template bank (cached; invalidated by _store).
        None when no selected class has templates."""
        key = tuple(sorted(class_ids)) if class_ids else None
        bank = self._bank_cache.get(key)
        if bank is None:
            selected = {
                cid: tps for cid, tps in self.class_templates.items()
                if (key is None or cid in class_ids) and tps
            }
            if not selected:
                return None
            bank = mp.pack_bank(selected, len(self.modality_names),
                                self.pyramid_levels, t0=self.t_at_level[0],
                                t1=self.t_at_level[1])
            self._bank_cache[key] = bank
        return bank

    # largest candidate capacity of the fused match program
    MAX_FUSED_CANDIDATES = 1024

    def match(
        self,
        sources: Sequence[np.ndarray],
        threshold: float,
        class_ids: Optional[Sequence[str]] = None,
        max_candidates: int = 64,
        device="cuda",
    ) -> List[Match]:
        """Match all templates against one frame (linemod.hpp:330);
        ``sources`` holds one image per modality ([H, W, 3] u8 BGR or
        [H, W] u16 depth). Runs the match program (match/program.py) at
        B=1 on ``device``. When the frame's coarse candidates overflow
        ``max_candidates`` the call runs a wider program from a
        power-of-two capacity ladder (built once per capacity, cached).
        Beyond MAX_FUSED_CANDIDATES, or with another pyramid depth than
        2, the reference turns to its host-orchestrated matcher; this
        package raises MatchCapacityError there."""
        device = checked_device(device)
        if self.pyramid_levels != 2:
            raise MatchCapacityError(
                f"{self.pyramid_levels} pyramid levels: the fused match program "
                "takes 2 (ROADMAP.md queue 1 item 11: _match_reference)")
        K = max_candidates
        while K <= self.MAX_FUSED_CANDIDATES:
            result = self._match_fused(sources, threshold, class_ids, K, device)
            if isinstance(result, int):  # overflow: n_above returned
                K = max(2 * K, 1 << (result - 1).bit_length())
                continue
            return result
        raise MatchCapacityError(
            f"more than {self.MAX_FUSED_CANDIDATES} coarse candidates above "
            f"threshold {threshold}: the host-orchestrated matcher the "
            "reference falls back to is not ported (ROADMAP.md queue 1 item "
            "11: _match_reference); raise the threshold meanwhile")

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
        srcs = []
        for name, s in zip(self.modality_names, sources):
            s = np.asarray(s)
            s = s.astype(np.uint8) if name == "ColorGradient" else s.astype(np.int32)
            srcs.append(torch.as_tensor(s[None]).to(device))
        with torch.no_grad():
            packed = prog(srcs, *bargs, threshold)[0].cpu().numpy()
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
