"""Port parity: ``Detector.match`` against the JAX package's, exactly.

The reference trained on the snowman (test_torch_detect.py's setup), or
on tools/parity_add.py's two classes, its templates handed to the port as
plain numpy; on tools/scenes.py frames the sorted, de-duplicated Match
lists must be equal field by field: x, y, class and template ids exactly,
the similarity as the same float (both packages divide the same
integers). Both modalities and depth-only; one call per configuration
whose first capacity overflows, so that ``match`` climbs the power-of-two
ladder as the reference does; and the host-orchestrated matcher
(``fused=False``, a ladder that runs out, pyramid depths 1 and 3).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api.detector import Detector as RefDetector

from object_detector_6d_tpu_torch.api.detector import Detector, Match
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from object_detector_6d_tpu_torch.quant.features import Feature, Template
from test_torch_detect import BOTH, DEPTH_ONLY, _bgr, _state, _trained

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import parity_add  # noqa: E402

torch.set_num_threads(1)


def _pair(modalities):
    ref, depths, rgbs = _trained(modalities)
    templates, views = _state(ref)
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(ref.params), model_points=512,
                                    device="cpu")
    return ref.detector, port.detector, depths, rgbs


def _sources(modalities, depth, rgb):
    return [rgb if name == "ColorGradient" else depth for name in modalities]


def _fields(matches):
    return [(m.x, m.y, m.similarity, m.class_id, m.template_id) for m in matches]


def _programs(detector):
    """Capacities of the match programs a port Detector has built."""
    return sorted(k[2] for k in detector._match_cache if k[0] == "prog")


@pytest.mark.parametrize("modalities", [DEPTH_ONLY, BOTH], ids=["depth", "both"])
def test_match_equals_reference(modalities):
    ref, port, depths, rgbs = _pair(modalities)
    for b in range(2):
        src = _sources(modalities, depths[b], rgbs[b])
        for threshold in (80.0, 60.0):
            want = ref.match(src, threshold)
            got = port.match(src, threshold, device="cpu")
            assert _fields(got) == _fields(want)
            assert all(isinstance(m, Match) for m in got)
        assert want, "the reference matched nothing at 60"
    assert _programs(port)[0] == 64


@pytest.mark.parametrize("modalities", [DEPTH_ONLY, BOTH], ids=["depth", "both"])
def test_match_climbs_the_capacity_ladder(modalities):
    ref, port, depths, rgbs = _pair(modalities)
    src = _sources(modalities, depths[0], rgbs[0])
    threshold = 50.0
    # the frame's count of coarse candidates, from a program wide enough
    n_above = ref._match_fused(src, threshold, None, 1)
    assert isinstance(n_above, int) and n_above > 2, "no overflow of 2 slots"
    assert port._match_fused(src, threshold, None, 1, torch.device("cpu")) == n_above
    port._match_cache.clear()
    want = ref.match(src, threshold, max_candidates=2)
    got = port.match(src, threshold, max_candidates=2, device="cpu")
    assert _fields(got) == _fields(want) and want
    # one overflowing run at 2 slots, then the rung that holds the count
    rung = max(4, 1 << (n_above - 1).bit_length())
    assert _programs(port) == [2, rung]
    # a second call reuses both programs
    progs = {k: v for k, v in port._match_cache.items() if k[0] == "prog"}
    port.match(src, threshold, max_candidates=2, device="cpu")
    assert all(port._match_cache[k] is v for k, v in progs.items())


def test_match_class_subset_and_empty():
    ref, port, depths, rgbs = _pair(DEPTH_ONLY)
    src = _sources(DEPTH_ONLY, depths[1], rgbs[1])
    assert _fields(port.match(src, 70.0, class_ids=["obj"], device="cpu")) == \
        _fields(ref.match(src, 70.0, class_ids=["obj"]))
    assert port.match(src, 70.0, class_ids=["nothing"], device="cpu") == []
    assert Detector(modalities=DEPTH_ONLY).match(src, 70.0, device="cpu") == []


def _textured(gray, mask, cell=20, amp=100):
    """A checkerboard over the object, so that ColorGradient finds
    features at pyramid level 2 (the snowman's smooth shading has too few
    there for a template)."""
    yy, xx = np.mgrid[:gray.shape[0], :gray.shape[1]]
    chk = ((yy // cell + xx // cell) % 2) * amp - amp // 2
    return np.where(mask > 0, np.clip(gray.astype(int) + chk, 0, 255), gray).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _two_class_frames():
    """tools/parity_add.py's two-class training views (objA, the snowman;
    objB, its 0.78-scale copy) and its first two-class frame, textured."""
    K, train, scene_list = parity_add.scene_set_two()
    _poses, depth, gray, mask = scene_list[0]
    train = {cid: (dep, _textured(g, m), m) for cid, (dep, g, m) in train.items()}
    return K, train, depth, _bgr(_textured(gray, mask))


@functools.lru_cache(maxsize=6)
def _two_class_pair(modalities, t_at_level=(5, 8)):
    """A reference Detector with objA and objB trained by add_template at
    the given pyramid depth, and the port's Detector holding its
    templates."""
    K, train, _d, _r = _two_class_frames()
    ref = RefDetector(modalities=modalities, t_at_level=t_at_level)
    for cid in ("objA", "objB"):
        dep, gray, mask = train[cid]
        src = _sources(modalities, dep, _bgr(gray))
        assert ref.add_template(src, cid, mask.astype(np.uint8) * 255)[0] == 0
    port = Detector(modalities=modalities, t_at_level=t_at_level)
    for cid, pyramids in ref.class_templates.items():
        for tp in pyramids:
            port.add_synthetic_template(
                [Template(t.width, t.height, t.pyramid_level,
                          [Feature(f.x, f.y, f.label) for f in t.features]) for t in tp], cid)
    return ref, port


CASES = {
    # case: (pyramid depth, thresholds)
    "unfused": ((5, 8), (75.0, 55.0)),
    "exhausted": ((5, 8), (50.0,)),
    "depth3": ((5, 8, 8), (75.0, 55.0)),
    "depth1": ((5,), (75.0, 60.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("modalities", [DEPTH_ONLY, BOTH], ids=["depth", "both"])
def test_host_matcher_equals_reference(modalities, case):
    """Where the reference answers through its host-orchestrated matcher
    (fused=False, a capacity ladder that runs out, a pyramid depth other
    than 2), the port's match returns the same list exactly: x, y,
    similarity, class and template id, for two classes."""
    t_at_level, thresholds = CASES[case]
    ref, port = _two_class_pair(modalities, t_at_level)
    _K, _train, depth, rgb = _two_class_frames()
    src = _sources(modalities, depth, rgb)
    port._match_cache.clear()
    for thr in thresholds:
        if case == "exhausted":
            n_above = port._match_fused(src, thr, None, 2, torch.device("cpu"))
            assert isinstance(n_above, int) and n_above > 2, "the ladder does not run out"
            port._match_cache.clear()
            ref.MAX_FUSED_CANDIDATES = port.MAX_FUSED_CANDIDATES = 2
            try:
                want = ref.match(src, thr, max_candidates=2)
                got = port.match(src, thr, max_candidates=2, device="cpu")
            finally:
                del ref.MAX_FUSED_CANDIDATES, port.MAX_FUSED_CANDIDATES
            assert _programs(port) == [2]  # one overflowing rung, then the host
        else:
            want = ref.match(src, thr, fused=case != "unfused")
            got = port.match(src, thr, fused=case != "unfused", device="cpu")
            assert not _programs(port)
        assert _fields(got) == _fields(want)
        assert want, f"the reference matched nothing at {thr}"
    assert {m.class_id for m in want} <= {"objA", "objB"}
    if case != "exhausted":
        assert {m.class_id for m in want} == {"objA", "objB"}


def test_host_matcher_takes_features_past_the_bbox():
    """With a 24-pixel checkerboard, objA's level-2 ColorGradient template
    holds features at x == width + 1 (quant/features.py crop_templates).
    The reference's dense kernels are one column too narrow for them and
    its host matcher raises IndexError (match/sweep.py pack_kernels); the
    port's sparse tables take any offset, and it answers."""
    K, train, scene_list = parity_add.scene_set_two()
    dep, gray, mask = train["objA"]
    view = _bgr(_textured(gray, mask, cell=24, amp=60))
    ref = RefDetector(t_at_level=(5, 8, 8))
    assert ref.add_template([view, dep], "objA", mask.astype(np.uint8) * 255)[0] == 0
    lvl2 = ref.class_templates["objA"][0][4]
    assert max(f.x - lvl2.width for f in lvl2.features) == 1
    port = Detector(t_at_level=(5, 8, 8))
    port.add_synthetic_template(
        [Template(t.width, t.height, t.pyramid_level,
                  [Feature(f.x, f.y, f.label) for f in t.features])
         for t in ref.class_templates["objA"][0]], "objA")
    _poses, depth, g2, m2 = scene_list[0]
    src = [_bgr(_textured(g2, m2, cell=24, amp=60)), depth]
    with pytest.raises(IndexError):
        ref.match(src, 60.0)
    got = port.match(src, 60.0, device="cpu")
    assert got and {m.class_id for m in got} == {"objA"}


@pytest.mark.parametrize("modalities", [DEPTH_ONLY, BOTH], ids=["depth", "both"])
def test_fused_overflow_equals_host_matcher(modalities):
    """The reference's claim (tests/test_match_bank.py): a frame whose
    coarse candidates overflow the first capacity climbs the ladder, and
    the answer equals the host-orchestrated matcher's exactly."""
    _ref, port = _two_class_pair(modalities)
    _K, _train, depth, rgb = _two_class_frames()
    src = _sources(modalities, depth, rgb)
    cpu = torch.device("cpu")
    for thr in (60.0, 55.0, 50.0, 45.0):
        probe = port._match_fused(src, thr, None, 8, cpu)
        if isinstance(probe, int):
            break
    assert isinstance(probe, int) and probe > 8, f"no coarse overflow at {thr}"
    fused = port.match(src, thr, max_candidates=8, device="cpu")
    host = port._match_reference(src, thr, None, cpu)
    # the fused program's similarity is float32, the host's float64 (the
    # reference's own test rounds both to 3 places)
    assert [(m.x, m.y, round(m.similarity, 3), m.class_id, m.template_id) for m in fused] \
        == [(m.x, m.y, round(m.similarity, 3), m.class_id, m.template_id) for m in host]
    assert fused


def test_sort_dedup_order():
    """Similarity descending, then template id ascending; the first of
    each (x, y, similarity, class) stays."""
    ms = [Match(1, 1, 90.0, "a", 3), Match(1, 1, 90.0, "a", 1), Match(2, 1, 95.0, "b", 7),
          Match(1, 1, 90.0, "b", 2), Match(5, 5, 90.0, "a", 0)]
    out = Detector._sort_dedup(ms)
    assert [(m.class_id, m.template_id) for m in out] == \
        [("b", 7), ("a", 0), ("a", 1), ("b", 2)]
