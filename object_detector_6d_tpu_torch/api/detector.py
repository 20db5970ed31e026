"""LINEMOD Detector, training side + packed bank (port of
object_detector_6d_tpu/api/detector.py).

``add_template`` / ``add_synthetic_template`` build per-class template
pyramids on the host; ``get_bank`` packs every class into the global bank
the fused program sweeps. Templates are stored interleaved per level
([mod0 L0, mod1 L0, mod0 L1, ...]), the oracle's TemplatePyramid layout.
The modalities default to the reference's ("ColorGradient",
"DepthNormal"); either may be left out.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.quant.features import Template, crop_templates
from object_detector_6d_tpu_torch.quant.pyramid import ColorGradientPyramid, DepthNormalPyramid

MODALITIES = ("ColorGradient", "DepthNormal")


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
