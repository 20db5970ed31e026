"""The port's template store (io/yaml_store.py, Detector.write_classes /
read_classes / write / read) against the JAX package's: the oracle's
golden store read by both, the oracle's bytes written, and classes and
configurations carried from one package to the other exactly."""

import functools
import gzip
import pathlib
import sys

import numpy as np
import pytest

from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.core.config import DepthNormalParams as RefDNParams
from object_detector_6d_tpu.io import yaml_store as ref_yaml_store
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.core.config import DepthNormalParams
from object_detector_6d_tpu_torch.io import native, yaml_store

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
ORACLE = str(GOLDEN / "oracle_templates_obj.yml.gz")


def _fields(tps):
    """Every template of every pyramid as plain tuples."""
    return [[(t.width, t.height, t.pyramid_level, t.feature_array().tolist()) for t in tp]
            for tp in tps]


@functools.lru_cache(maxsize=1)
def _ref_trained():
    """A reference Detector with two classes trained by add_template (the
    snowman at two scales, three templates in all)."""
    ref = RefDetector()
    for cid, scale in (("objA", 1.0), ("objA", 0.9), ("objB", 0.78)):
        dep, gray, mask = scenes.snowman_scene(scale=scale)
        bgr = np.repeat(gray[..., None], 3, 2)
        assert ref.add_template([bgr, dep], cid, mask.astype(np.uint8) * 255)[0] >= 0
    return ref


def test_oracle_store_read_by_both_packages_equal():
    cid, mods, levels, tps = yaml_store.read_class(ORACLE)
    rcid, rmods, rlevels, rtps = ref_yaml_store.read_class(ORACLE)
    assert (cid, mods, levels) == (rcid, rmods, rlevels) == (
        "obj", ["ColorGradient", "DepthNormal"], 2)
    assert _fields(tps) == _fields(rtps)
    assert [len(t.features) for t in tps[0]] == [63, 63, 31, 31]
    g = np.load(GOLDEN / "template_sphere.npz")
    for i, t in enumerate(tps[0]):
        np.testing.assert_array_equal(t.feature_array(), g[f"feat{i}"])


def test_writer_gives_the_oracles_bytes(tmp_path):
    cid, mods, levels, tps = yaml_store.read_class(ORACLE)
    oracle_text = gzip.open(ORACLE, "rt").read()
    assert yaml_store.emit_yaml(yaml_store.class_doc(cid, mods, levels, tps)) == oracle_text
    out = tmp_path / "templates_obj.yml.gz"
    yaml_store.write_class(str(out), cid, mods, levels, tps)
    assert gzip.open(out, "rt").read() == oracle_text


@pytest.mark.parametrize("ext", [".yml.gz", ".yml"])
def test_class_written_by_reference_read_by_port(tmp_path, ext):
    ref = _ref_trained()
    fmt = str(tmp_path / f"templates_%s{ext}")
    ref.write_classes(fmt)
    port = Detector()
    port.read_classes(["objA", "objB"], fmt)
    assert port.class_ids() == ["objA", "objB"]
    for cid in ("objA", "objB"):
        assert _fields(port.class_templates[cid]) == _fields(ref.class_templates[cid])


def test_class_written_by_port_read_by_reference(tmp_path):
    ref = _ref_trained()
    port = Detector()
    for cid, tps in ref.class_templates.items():
        for tp in tps:
            port.add_synthetic_template(tp, cid)
    port.write_classes(str(tmp_path / "port_%s.yml.gz"))
    ref.write_classes(str(tmp_path / "ref_%s.yml.gz"))
    for cid in ("objA", "objB"):
        assert (gzip.open(tmp_path / f"port_{cid}.yml.gz", "rt").read()
                == gzip.open(tmp_path / f"ref_{cid}.yml.gz", "rt").read())
    back = RefDetector()
    back.read_classes(["objA", "objB"], str(tmp_path / "port_%s.yml.gz"))
    for cid in ("objA", "objB"):
        assert _fields(back.class_templates[cid]) == _fields(ref.class_templates[cid])


def test_read_classes_native_and_python_readers_agree(tmp_path, monkeypatch):
    fmt = str(tmp_path / "templates_%s.yml.gz")
    _ref_trained().write_classes(fmt)
    with_native = Detector()
    with_native.read_classes(["objA", "objB"], fmt)
    monkeypatch.setattr(native, "read_class_native", lambda path: None)
    python_only = Detector()
    python_only.read_classes(["objA", "objB"], fmt)
    for cid in ("objA", "objB"):
        assert _fields(with_native.class_templates[cid]) == _fields(
            python_only.class_templates[cid]) == _fields(_ref_trained().class_templates[cid])


def test_npz_store_roundtrip_and_cross_package(tmp_path):
    ref = _ref_trained()
    for cid, tps in ref.class_templates.items():
        ref_yaml_store.save_npz(str(tmp_path / f"ref_{cid}.npz"), cid, ref.modality_names,
                                ref.pyramid_levels, tps)
    port = Detector()
    port.read_classes(["objA", "objB"], str(tmp_path / "ref_%s.npz"))
    for cid, tps in port.class_templates.items():
        yaml_store.save_npz(str(tmp_path / f"port_{cid}.npz"), cid, port.modality_names,
                            port.pyramid_levels, tps)
        back = ref_yaml_store.load_npz(str(tmp_path / f"port_{cid}.npz"))
        assert back[:3] == (cid, list(port.modality_names), 2)
        assert _fields(back[3]) == _fields(ref.class_templates[cid]) == _fields(tps)


def test_read_classes_checks_modalities_and_levels():
    det = Detector(modalities=("DepthNormal",))
    with pytest.raises(ValueError, match="was built for modalities"):
        det.read_classes(["obj"], str(GOLDEN / "oracle_templates_%s.yml.gz"))
    with pytest.raises(ValueError, match="levels=2"):
        Detector(t_at_level=(5, 8, 8)).read_classes(
            ["obj"], str(GOLDEN / "oracle_templates_%s.yml.gz"))


def test_detector_write_read_keeps_the_configuration(tmp_path):
    port = Detector(modalities=("DepthNormal",), t_at_level=(4, 8),
                    depth_normal_params=DepthNormalParams(distance_threshold=1500,
                                                          num_features=40))
    ref = RefDetector(modalities=("DepthNormal",), t_at_level=(4, 8),
                      depth_normal_params=RefDNParams(distance_threshold=1500,
                                                      num_features=40))
    port.write(str(tmp_path / "port.yml"))
    ref.write(str(tmp_path / "ref.yml"))
    assert (tmp_path / "port.yml").read_text() == (tmp_path / "ref.yml").read_text()
    for back in (Detector.read(str(tmp_path / "port.yml")),
                 Detector.read(str(tmp_path / "ref.yml"))):
        assert back.modality_names == ("DepthNormal",)
        assert back.t_at_level == (4, 8)
        assert back.dn_params == port.dn_params
    rback = RefDetector.read(str(tmp_path / "port.yml"))
    assert rback.t_at_level == (4, 8) and rback.dn_params.num_features == 40
    default = Detector()
    default.write(str(tmp_path / "default.yml"))
    again = Detector.read(str(tmp_path / "default.yml"))
    assert (again.modality_names, again.t_at_level, again.cg_params, again.dn_params) == (
        default.modality_names, default.t_at_level, default.cg_params, default.dn_params)


def test_written_classes_read_back_equal(tmp_path):
    det = Detector()
    det.read_classes(["obj"], str(GOLDEN / "oracle_templates_%s.yml.gz"))
    det.write_classes(str(tmp_path / "templates_%s.yml.gz"))
    det2 = Detector()
    det2.read_classes(["obj"], str(tmp_path / "templates_%s.yml.gz"))
    assert det2.num_templates("obj") == 1
    assert _fields(det2.class_templates["obj"]) == _fields(det.class_templates["obj"])
