"""The port's native codecs (io/native.py over native/odc_native.cpp,
built into build/odc_native/) equal the port's Python readers and the
JAX package's."""

import pathlib

import numpy as np
import pytest

from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.io import yaml_store as ref_yaml_store
from object_detector_6d_tpu.io.ply import load_ply as ref_load_ply
from object_detector_6d_tpu.io.ply import write_ply as ref_write_ply
from object_detector_6d_tpu_torch.io import native, yaml_store
from object_detector_6d_tpu_torch.io.ply import load_ply, write_ply

GOLDEN = pathlib.Path(__file__).parent / "golden"
ORACLE = str(GOLDEN / "oracle_templates_obj.yml.gz")


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no toolchain)")
    return lib


def _fields(tps):
    return [[(t.width, t.height, t.pyramid_level, t.feature_array().tolist()) for t in tp]
            for tp in tps]


def test_library_is_built_under_build_not_native(lib):
    path = pathlib.Path(native.build_info["path"])
    assert path.name == "libodc_native.so"
    assert path.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parts[-2:] == ("build", "odc_native")
    assert native.build_info["seconds"] >= 0


@pytest.mark.parametrize("source", ["oracle", "reference_writer"])
def test_native_store_reader_equals_python_readers(lib, tmp_path, source):
    path = ORACLE
    if source == "reference_writer":
        det = RefDetector()
        det.read_classes(["obj"], str(GOLDEN / "oracle_templates_%s.yml.gz"))
        det.read_classes(["obj"], str(GOLDEN / "oracle_templates_%s.yml.gz"))
        det.write_classes(str(tmp_path / "templates_%s.yml.gz"))
        path = str(tmp_path / "templates_obj.yml.gz")
    got = native.read_class_native(path)
    assert got is not None
    py = yaml_store.read_class(path)
    ref = ref_yaml_store.read_class(path)
    assert got[:3] == py[:3] == ref[:3]
    assert _fields(got[3]) == _fields(py[3]) == _fields(ref[3])
    assert len(got[3]) == (1 if source == "oracle" else 2)


@pytest.mark.parametrize("binary", [True, False])
def test_native_ply_reader_equals_python_readers(lib, tmp_path, binary):
    rng = np.random.RandomState(0)
    pc = rng.uniform(-1, 1, (500, 6)).astype(np.float32)
    p = tmp_path / f"port_{binary}.ply"
    q = tmp_path / f"ref_{binary}.ply"
    write_ply(str(p), pc, binary=binary)
    ref_write_ply(str(q), pc, binary=binary)
    assert p.read_bytes() == q.read_bytes()
    got = native.load_ply_native(str(p))
    assert got is not None and got.shape == (500, 6)
    np.testing.assert_allclose(got, pc, atol=1e-5)
    np.testing.assert_allclose(got, load_ply(str(p)), atol=1e-5)
    np.testing.assert_array_equal(load_ply(str(p)), ref_load_ply(str(p)))


def test_native_ply_xyz_only(lib, tmp_path):
    pc = np.arange(30, dtype=np.float32).reshape(10, 3)
    p = tmp_path / "xyz.ply"
    write_ply(str(p), pc, binary=True)
    np.testing.assert_allclose(native.load_ply_native(str(p)), pc)
    np.testing.assert_array_equal(load_ply(str(p)), pc)
