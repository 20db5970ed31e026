"""Build and bind the package's hand-written Hopper kernels (``csrc/``).

At first use every ``csrc/*.cu`` file is compiled by its own ``nvcc``
process, all started together, and the objects are linked into ONE shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o <build>/libodc_torch_kernels.so *.o

The library lands in ``build/odc_torch_kernels/<hash>/`` at the repo root,
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once. ``-fmad=false`` keeps every float
multiply and add separately rounded, as the JAX reference rounds them;
fast math is never used.

Each C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches;
``check`` turns a non-zero code into an exception. Nothing here falls
back to the plain PyTorch twins: a kernel that cannot build or launch
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "odc_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
LINK_FLAGS = [*ARCH, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every entry returns int (a cudaError_t)
_SIGNATURES = {
    # bgr u8 [B,H,W,3], out u8, B, H, W, weak_threshold^2, stream
    "odc_cg_quantize": [_P, _P, _I, _I, _I, ctypes.c_float, _P],
    # depth i32, out u8, B, H, W, distance_thr, difference_thr, stream
    "odc_dn_quantize": [_P, _P, _I, _I, _I, _I, _I, _P],
    # q u8, out u8, B, H, W, T, dist_vals[5] (packed as 5 ints), stream
    "odc_response_spread": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # D i8, plane i32, r0 i32, c0 i32, nfeat i32, out i32, B, P, Hp, Wp, K, F, stream
    "odc_refine_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # depth i32, rays f32, minv f32, out f32, B, H, W, 1/fx, 1/fy, stream
    "odc_fused_scene": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                        ctypes.c_float, _P],
    # D i8, plane i32, dr i32, dc i32, nfeat i32, out i32, B, P, Hp, Wp, nT, F,
    # out_h, out_w, stream
    "odc_coarse_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x i32, vals i32, idx i64, scratch i32, B, N, K, vmax, vec (16-byte loads), stream
    "odc_select_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _sources(src_dir: pathlib.Path):
    return sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if cuda_home:
        cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "object_detector_6d_tpu_torch are built from csrc/ at first use"
    )


def source_hash(src_dir: pathlib.Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in _sources(src_dir):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(src_dir: pathlib.Path = CSRC, root: pathlib.Path = None):
    """Compile ``src_dir/*.cu`` into ``root/<hash>/libodc_torch_kernels.so``
    unless it is there already; returns (path, nvcc's output)."""
    out_dir = (BUILD_ROOT if root is None else root) / source_hash(src_dir)
    so = out_dir / "libodc_torch_kernels.so"
    log = ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".tmp-{os.getpid()}"
        nvcc = _nvcc()
        jobs = []
        for cu in sorted(src_dir.glob("*.cu")):
            obj = f"{tmp}-{cu.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(src_dir), "-c", "-o", obj, str(cu)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        outs = [(obj, proc.communicate()[0], proc.returncode) for obj, proc in jobs]
        log = "".join(out for _, out, _ in outs)
        if any(rc != 0 for _, _, rc in outs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        cmd = [nvcc, *LINK_FLAGS, "-o", f"{tmp}.so", *(obj for obj, _, _ in outs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(f"{tmp}.so", so)
        for obj, _, _ in outs:
            os.remove(obj)
        (out_dir / "nvcc.log").write_text(log)
    return so, log


def load(so) -> ctypes.CDLL:
    """A built kernel library with its C signatures set."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA kernels need a CUDA build of PyTorch and a visible GPU")
        t0 = time.time()
        so, log = build()
        _lib = load(so)
        build_info.update(path=str(so), seconds=time.time() - t0, log=log)
        return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernel path takes contiguous CUDA tensors on one device only."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: kernel path got a {t.device} tensor; "
                               "only CPU tensors use the plain twin")
        if t.device != dev:
            raise RuntimeError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise RuntimeError(f"{name}: non-contiguous input")
