"""ctypes bindings for the repo's native C++ codecs (native/odc_native.cpp):
the templates_%s.yml.gz store reader (``odc_store_*``) and the PLY reader
(``odc_ply_*``). Port of object_detector_6d_tpu/io/native.py.

The library is built with g++ at first use,

    g++ -O2 -shared -fPIC native/odc_native.cpp -lz -o <build>/libodc_native.so

into ``build/odc_native/<hash>/`` at the repo root, named by a hash of the
source and the flags (the way ops/kernels.py builds the CUDA kernels), so
an edited source rebuilds and nothing is written under ``native/``.
``build_info`` records the library's path and the seconds the first
``get_lib`` took. Every entry point has a pure-Python counterpart
(io/yaml_store.py, io/ply.py); ``get_lib`` returns None where the library
cannot be built or loaded, and the readers here then return None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time
from typing import List, Optional

import numpy as np

from object_detector_6d_tpu_torch.quant.features import Feature, Template

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "odc_native.cpp"
BUILD_ROOT = _ROOT / "build" / "odc_native"
FLAGS = ["-O2", "-shared", "-fPIC"]
LIBS = ["-lz"]

_lock = threading.Lock()
_lib = None
_failed = False
build_info: dict = {}


def _build() -> pathlib.Path:
    """The library for this source and these flags, built if it is not
    there yet (raises on a failed build)."""
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libodc_native.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".tmp-{os.getpid()}.so"
        subprocess.run(["g++", *FLAGS, str(SRC), *LIBS, "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        t0 = time.time()
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError) as e:
            build_info.update(error=str(e))
            _failed = True
            return None
        lib.odc_store_open.restype = ctypes.c_void_p
        lib.odc_store_open.argtypes = [ctypes.c_char_p]
        lib.odc_store_counts.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.odc_store_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.odc_store_close.argtypes = [ctypes.c_void_p]
        lib.odc_ply_open.restype = ctypes.c_void_p
        lib.odc_ply_open.argtypes = [ctypes.c_char_p]
        lib.odc_ply_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.odc_ply_fill.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.odc_ply_close.argtypes = [ctypes.c_void_p]
        for name in ("odc_store_counts", "odc_store_fill", "odc_ply_info", "odc_ply_fill"):
            getattr(lib, name).restype = ctypes.c_int
        lib.odc_store_close.restype = None
        lib.odc_ply_close.restype = None
        build_info.update(path=lib._name, seconds=time.time() - t0)
        _lib = lib
        return _lib


def read_class_native(path: str):
    """Native templates_%s.yml.gz reader; returns the same tuple as
    yaml_store.read_class or None if the native path is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.odc_store_open(path.encode())
    if not h:
        return None
    try:
        n_meta = ctypes.c_int64()
        n_feats = ctypes.c_int64()
        levels = ctypes.c_int()
        n_mods = ctypes.c_int()
        if lib.odc_store_counts(h, n_meta, n_feats, levels, n_mods) != 0:
            return None
        meta = np.zeros((n_meta.value, 5), np.int32)
        feats = np.zeros((n_feats.value, 5), np.int32)
        cid = ctypes.create_string_buffer(256)
        mods = ctypes.create_string_buffer(512)
        lib.odc_store_fill(
            h,
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            feats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cid,
            256,
            mods,
            512,
        )
    finally:
        lib.odc_store_close(h)

    modalities = mods.value.decode().split(",") if mods.value else []
    n_tids = int(meta[:, 0].max()) + 1 if len(meta) else 0
    n_slots = int(meta[:, 1].max()) + 1 if len(meta) else 0
    tps: List[List[Template]] = [[None] * n_slots for _ in range(n_tids)]
    for tid, slot, w, hgt, lvl in meta:
        tps[tid][slot] = Template(int(w), int(hgt), int(lvl), [])
    for tid, slot, x, y, lbl in feats:
        tps[tid][slot].features.append(Feature(int(x), int(y), int(lbl)))
    return cid.value.decode(), modalities, int(levels.value), tps


def load_ply_native(path: str) -> Optional[np.ndarray]:
    """Native PLY reader: [N, 3] or [N, 6] f32, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.odc_ply_open(path.encode())
    if not h:
        return None
    try:
        n = ctypes.c_int64()
        n_cols = ctypes.c_int()
        if lib.odc_ply_info(h, n, n_cols) != 0:
            return None
        out = np.zeros((n.value, n_cols.value), np.float32)
        lib.odc_ply_fill(h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    finally:
        lib.odc_ply_close(h)
