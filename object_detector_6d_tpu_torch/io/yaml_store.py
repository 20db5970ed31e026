"""Template store: the oracle's templates_%s.yml.gz format (reference L5).
A copy of object_detector_6d_tpu/io/yaml_store.py (numpy only).

Reads and writes the exact OpenCV FileStorage YAML schema the reference
uses (linemod.hpp:391-393; format dumped from the oracle, SURVEY.md
section 3.4):

    %YAML:1.0
    ---
    class_id: obj
    modalities: [ ColorGradient, DepthNormal ]
    pyramid_levels: 2
    template_pyramids:
       -
          template_id: 0
          templates:
             -
                width: 179
                height: 179
                pyramid_level: 0
                features:
                   - [ 32, 23, 0 ]
                   ...

plus the detector-level parameter document (pyramid_levels, T, modality
params). A minimal purpose-built parser/emitter — no external YAML
dependency; files we write are parseable by OpenCV's FileStorage and
vice versa (round-trip verified against the committed oracle-written
golden and by cross-reading in tests).

``save_npz``/``load_npz`` provide the native fast-path store: packed
feature tensors in a single compressed npz per class.
"""

from __future__ import annotations

import gzip
import io
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from object_detector_6d_tpu_torch.quant.features import Feature, Template


# ----------------------------------------------------------------------
# minimal OpenCV-FileStorage-YAML subset parser
# ----------------------------------------------------------------------

def _tokenize_yaml(text: str):
    """Yield (indent, content) lines, skipping header/comments."""
    for raw in text.splitlines():
        if raw.startswith("%YAML") or raw.strip() in ("---", ""):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        yield indent, raw.strip()


def _parse_scalar(s: str):
    s = s.strip()
    if re.fullmatch(r"-?\d+", s):
        return int(s)
    if re.fullmatch(r"-?\d*\.\d*(e[-+]?\d+)?", s, re.IGNORECASE):
        return float(s if not s.endswith(".") else s + "0")
    return s


def _parse_flow_list(s: str):
    inner = s.strip()[1:-1].strip()
    if not inner:
        return []
    return [_parse_scalar(x) for x in inner.split(",")]


def parse_yaml(text: str):
    """Parse the FileStorage YAML subset into nested dict/list structures."""
    lines = list(_tokenize_yaml(text))
    pos = 0

    def parse_block(indent):
        nonlocal pos
        # decide mapping vs sequence by first line
        if pos >= len(lines):
            return {}
        first_indent, first = lines[pos]
        if first_indent < indent:
            return {}
        if first.startswith("-"):
            return parse_seq(first_indent)
        return parse_map(first_indent)

    def parse_map(indent):
        nonlocal pos
        out = {}
        while pos < len(lines):
            ind, line = lines[pos]
            if ind < indent or line.startswith("-"):
                break
            key, _, rest = line.partition(":")
            rest = rest.strip()
            pos += 1
            if rest == "":
                out[key.strip()] = parse_block(indent + 1)
            elif rest.startswith("["):
                out[key.strip()] = _parse_flow_list(rest)
            else:
                out[key.strip()] = _parse_scalar(rest)
        return out

    def parse_seq(indent):
        nonlocal pos
        out = []
        while pos < len(lines):
            ind, line = lines[pos]
            if ind < indent or not line.startswith("-"):
                break
            rest = line[1:].strip()
            pos += 1
            if rest == "":
                out.append(parse_block(indent + 1))
            elif rest.startswith("["):
                out.append(_parse_flow_list(rest))
            else:
                out.append(_parse_scalar(rest))
        return out

    return parse_block(0)


# ----------------------------------------------------------------------
# emitter (matches OpenCV FileStorage output formatting)
# ----------------------------------------------------------------------

def _fmt_scalar(v) -> str:
    if isinstance(v, float):
        if v == int(v):
            return f"{int(v)}."
        return repr(v)
    return str(v)


class _Emitter:
    def __init__(self):
        self.out = io.StringIO()
        self.out.write("%YAML:1.0\n---\n")

    def emit_map(self, d: dict, indent: int = 0):
        pad = " " * indent
        for k, v in d.items():
            if isinstance(v, dict):
                self.out.write(f"{pad}{k}:\n")
                self.emit_map(v, indent + 3)
            elif isinstance(v, list) and v and isinstance(v[0], (dict, list)) and not self._flow(v):
                self.out.write(f"{pad}{k}:\n")
                self.emit_seq(v, indent + 3)
            elif isinstance(v, list):
                self.out.write(f"{pad}{k}: [ " + ", ".join(_fmt_scalar(x) for x in v) + " ]\n")
            else:
                self.out.write(f"{pad}{k}: {_fmt_scalar(v)}\n")

    @staticmethod
    def _flow(v) -> bool:
        return all(isinstance(x, (int, float, str)) for x in v)

    def emit_seq(self, seq: list, indent: int):
        pad = " " * indent
        for item in seq:
            if isinstance(item, dict):
                self.out.write(f"{pad}-\n")
                self.emit_map(item, indent + 3)
            elif isinstance(item, list):
                self.out.write(f"{pad}- [ " + ", ".join(_fmt_scalar(x) for x in item) + " ]\n")
            else:
                self.out.write(f"{pad}- {_fmt_scalar(item)}\n")

    def text(self) -> str:
        return self.out.getvalue()


def emit_yaml(doc: dict) -> str:
    e = _Emitter()
    e.emit_map(doc)
    return e.text()


# ----------------------------------------------------------------------
# class store <-> Template pyramids
# ----------------------------------------------------------------------

def class_doc(
    class_id: str,
    modality_names: Sequence[str],
    pyramid_levels: int,
    template_pyramids: Sequence[Sequence[Template]],
) -> dict:
    return {
        "class_id": class_id,
        "modalities": list(modality_names),
        "pyramid_levels": pyramid_levels,
        "template_pyramids": [
            {
                "template_id": tid,
                "templates": [
                    {
                        "width": t.width,
                        "height": t.height,
                        "pyramid_level": t.pyramid_level,
                        "features": [[f.x, f.y, f.label] for f in t.features],
                    }
                    for t in tp
                ],
            }
            for tid, tp in enumerate(template_pyramids)
        ],
    }


def parse_class_doc(doc: dict) -> Tuple[str, List[str], int, List[List[Template]]]:
    class_id = doc["class_id"]
    modalities = [str(m) for m in doc["modalities"]]
    levels = int(doc["pyramid_levels"])
    tps: List[List[Template]] = []
    for tp_doc in doc.get("template_pyramids", []):
        tp = []
        for t in tp_doc["templates"]:
            feats = [Feature(int(x), int(y), int(l)) for x, y, l in t.get("features", [])]
            tp.append(Template(int(t["width"]), int(t["height"]), int(t["pyramid_level"]), feats))
        tps.append(tp)
    return class_id, modalities, levels, tps


def write_class(path: str, class_id: str, modality_names, pyramid_levels, template_pyramids):
    text = emit_yaml(class_doc(class_id, modality_names, pyramid_levels, template_pyramids))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(text)


def read_class(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return parse_class_doc(parse_yaml(f.read()))


# ----------------------------------------------------------------------
# detector-level parameter document
# ----------------------------------------------------------------------

def detector_doc(detector) -> dict:
    mods = []
    for name in detector.modality_names:
        if name == "ColorGradient":
            p = detector.cg_params
            mods.append(
                {
                    "type": "ColorGradient",
                    "weak_threshold": float(p.weak_threshold),
                    "num_features": int(p.num_features),
                    "strong_threshold": float(p.strong_threshold),
                }
            )
        elif name == "DepthNormal":
            p = detector.dn_params
            mods.append(
                {
                    "type": "DepthNormal",
                    "distance_threshold": int(p.distance_threshold),
                    "difference_threshold": int(p.difference_threshold),
                    "num_features": int(p.num_features),
                    "extract_threshold": int(p.extract_threshold),
                }
            )
    return {
        "pyramid_levels": len(detector.t_at_level),
        "T": list(detector.t_at_level),
        "modalities": mods,
    }


def parse_detector_doc(doc: dict):
    """Returns (modality_names, t_at_level, cg_params, dn_params)."""
    from object_detector_6d_tpu_torch.core.config import (
        ColorGradientParams,
        DepthNormalParams,
    )

    names = []
    cg = None
    dn = None
    for m in doc["modalities"]:
        if m["type"] == "ColorGradient":
            names.append("ColorGradient")
            cg = ColorGradientParams(
                weak_threshold=float(m["weak_threshold"]),
                num_features=int(m["num_features"]),
                strong_threshold=float(m["strong_threshold"]),
            )
        elif m["type"] == "DepthNormal":
            names.append("DepthNormal")
            dn = DepthNormalParams(
                distance_threshold=int(m["distance_threshold"]),
                difference_threshold=int(m["difference_threshold"]),
                num_features=int(m["num_features"]),
                extract_threshold=int(m["extract_threshold"]),
            )
    return names, tuple(int(t) for t in doc["T"]), cg, dn


# ----------------------------------------------------------------------
# native fast-path store (packed tensors, one npz per class)
# ----------------------------------------------------------------------

def save_npz(path: str, class_id: str, modality_names, pyramid_levels, template_pyramids):
    """Native store: features packed as one [n_entries, 6] int32 tensor
    (template_id, slot, x, y, label, pad) + per-slot sizes."""
    rows = []
    meta = []
    for tid, tp in enumerate(template_pyramids):
        for slot, t in enumerate(tp):
            meta.append((tid, slot, t.width, t.height, t.pyramid_level))
            for f in t.features:
                rows.append((tid, slot, f.x, f.y, f.label, 0))
    np.savez_compressed(
        path,
        class_id=np.array(class_id),
        modalities=np.array(list(modality_names)),
        pyramid_levels=np.array(pyramid_levels),
        features=np.array(rows, np.int32).reshape(-1, 6),
        meta=np.array(meta, np.int32).reshape(-1, 5),
    )


def load_npz(path: str):
    d = np.load(path, allow_pickle=False)
    class_id = str(d["class_id"])
    modalities = [str(m) for m in d["modalities"]]
    levels = int(d["pyramid_levels"])
    meta = d["meta"]
    feats = d["features"]
    n_tids = int(meta[:, 0].max()) + 1 if len(meta) else 0
    n_slots = int(meta[:, 1].max()) + 1 if len(meta) else 0
    tps: List[List[Template]] = [[None] * n_slots for _ in range(n_tids)]
    for tid, slot, w, h, lvl in meta:
        tps[tid][slot] = Template(int(w), int(h), int(lvl), [])
    for tid, slot, x, y, lbl, _ in feats:
        tps[tid][slot].features.append(Feature(int(x), int(y), int(lbl)))
    return class_id, modalities, levels, tps
