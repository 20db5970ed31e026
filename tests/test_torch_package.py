"""Package rules of object_detector_6d_tpu_torch: it never imports JAX or
the JAX package, and a kernel wrapper never falls back to its plain twin
for a tensor that is not on the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import object_detector_6d_tpu_torch
from object_detector_6d_tpu_torch.ops import kernels
from object_detector_6d_tpu_torch.ops.geometry import FusedScene
from object_detector_6d_tpu_torch.ops.quantize import cg_quantize_batched, dn_quantize_batched
from object_detector_6d_tpu_torch.ops.refine import coarse_sweep, refine_sweep_batched
from object_detector_6d_tpu_torch.ops.response import response_spread_batched

torch.set_num_threads(1)

PKG = pathlib.Path(object_detector_6d_tpu_torch.__file__).parent
ROOT = PKG.parent


def test_importing_the_pipeline_loads_no_jax():
    code = ("import sys, object_detector_6d_tpu_torch.api.pipeline, "
            "object_detector_6d_tpu_torch.api.streaming, "
            "object_detector_6d_tpu_torch.io.convert, "
            "object_detector_6d_tpu_torch.data.synthetic, parity_torch, "
            "object_detector_6d_tpu_torch.geom.cleaner, "
            "object_detector_6d_tpu_torch.geom.plane, "
            "object_detector_6d_tpu_torch.geom.registration, "
            "object_detector_6d_tpu_torch.odometry.odometry, "
            "object_detector_6d_tpu_torch.ppf.detector, "
            "object_detector_6d_tpu_torch.utils.debug, "
            "object_detector_6d_tpu_torch.utils.profiling, "
            "object_detector_6d_tpu_torch.version\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'object_detector_6d_tpu' or m.startswith('object_detector_6d_tpu.')]\n"
            "assert not bad, bad\nprint('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _assert_no_jax_import(file, path):
    tree = ast.parse(file.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "object_detector_6d_tpu"), (path, n)


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_module_imports_jax(path):
    _assert_no_jax_import(PKG / path, path)


@pytest.mark.parametrize("path", ["chip_smoke.py", "kernel_ab.py", "batch_probe.py",
                                  "parity_torch.py"])
def test_no_card_script_imports_jax(path):
    """The scripts that drive the port on the card, at the repo's root
    (parity_torch.py reaches the JAX package only through
    tools/parity_add.py's detector, with --reference)."""
    _assert_no_jax_import(ROOT / path, path)


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel path, which
    takes CUDA tensors only: it raises, it never runs the twin."""
    with pytest.raises(RuntimeError, match="kernel path"):
        cg_quantize_batched(_meta(1, 16, 16, 3, dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="kernel path"):
        dn_quantize_batched(_meta(1, 16, 16, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="kernel path"):
        response_spread_batched(_meta(1, 16, 16, dtype=torch.uint8), 5)
    fs = FusedScene(16, 16, np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]]), device="cpu")
    with pytest.raises(RuntimeError, match="kernel path"):
        fs(_meta(1, 16, 16, dtype=torch.int32))
    i32 = torch.int32
    with pytest.raises(RuntimeError):
        refine_sweep_batched(_meta(1, 2, 32, 32, dtype=torch.int8), _meta(1, 2, 3, dtype=i32),
                             _meta(1, 2, 3, dtype=i32), _meta(1, 2, 3, dtype=i32),
                             _meta(1, 2, dtype=i32))
    with pytest.raises(RuntimeError, match="kernel path"):
        coarse_sweep(_meta(1, 2, 8, 8, dtype=torch.int8), _meta(3, 4, dtype=i32),
                     _meta(3, 4, dtype=i32), _meta(3, 4, dtype=i32), _meta(3, dtype=i32), 4, 4)


def test_kernel_library_raises_without_cuda_build(monkeypatch, tmp_path):
    """No CUDA build: building the kernels raises; so does a missing nvcc
    when a card is visible."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA build is present")
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.library()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.library()


def test_kernel_source_hash_tracks_sources():
    h = kernels.source_hash()
    assert len(h) == 16 and h == kernels.source_hash()
    names = {p.name for p in kernels.CSRC.glob("*.cu")}
    assert names == {"cg_quantize.cu", "dn_quantize.cu", "response_spread.cu",
                     "refine_sweep.cu", "fused_scene.cu", "coarse_sweep.cu", "select_topk.cu"}


def _entry_points():
    """Each new entry point called on numpy input with its default device."""
    from object_detector_6d_tpu_torch.geom import normals
    from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d_sparse
    from object_detector_6d_tpu_torch.geom.cleaner import clean_depth
    from object_detector_6d_tpu_torch.geom.plane import extract_planes
    from object_detector_6d_tpu_torch.geom.registration import register_depth, warp_frame
    from object_detector_6d_tpu_torch.odometry.odometry import OdometryFrame
    from object_detector_6d_tpu_torch.ppf import helpers
    from object_detector_6d_tpu_torch.ppf.detector import PPFDetector

    K = np.array([[500.0, 0, 16], [0, 500.0, 12], [0, 0, 1]])
    dep = np.full((24, 32), 1000, np.uint16)
    cloud = np.ones((24, 32, 3), np.float32)
    pc = np.random.RandomState(0).uniform(-1, 1, (50, 6)).astype(np.float32)
    return {
        "clean_depth": lambda: clean_depth(dep),
        "register_depth": lambda: register_depth(dep, K, K, np.eye(4), (24, 32)),
        "warp_frame": lambda: warp_frame(dep, K, np.eye(4)),
        "extract_planes": lambda: extract_planes(cloud, block_size=8),
        "normals_linemod": lambda: normals.normals_linemod(dep, K),
        "normals_cross": lambda: normals.normals_cross(cloud),
        "normals_sri": lambda: normals.normals_sri(cloud, K),
        "depth_to_3d_sparse": lambda: depth_to_3d_sparse([1], [2], [1.0], K),
        "OdometryFrame.create": lambda: OdometryFrame.create(dep, K, levels=2),
        "knn": lambda: helpers.knn(pc[:, :3], pc[:, :3], 2),
        "compute_normals_pc3d": lambda: helpers.compute_normals_pc3d(pc, k=4),
        "PPFDetector.train_model": lambda: PPFDetector().train_model(pc),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_new_entry_points_raise_without_a_card(name):
    """Numpy input with the default device asks for the card: without one
    the call raises, it never carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _entry_points()[name]()


def test_ppf_match_raises_without_a_card(tmp_path):
    """A detector trained (or read) for the CPU and asked for the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    from object_detector_6d_tpu_torch.ppf.detector import PPFDetector

    pc = np.random.RandomState(0).uniform(-1, 1, (60, 6)).astype(np.float32)
    det = PPFDetector(device="cpu")
    det.train_model(pc)
    det.write(str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PPFDetector.read(str(tmp_path / "m.npz")).match(pc)
