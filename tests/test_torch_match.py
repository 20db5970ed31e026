"""Port parity: ``Detector.match`` against the JAX package's, exactly.

The reference trained on the snowman (test_torch_detect.py's setup), its
templates handed to the port as plain numpy; on tools/scenes.py frames
the sorted, de-duplicated Match lists must be equal field by field: x, y,
class and template ids exactly, the similarity as the same float32 (both
packages divide the same integers). Both modalities and depth-only, and
one call per configuration whose first capacity overflows, so that
``match`` climbs the power-of-two ladder as the reference does.
"""

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.api.detector import Detector, Match, MatchCapacityError
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from test_torch_detect import BOTH, DEPTH_ONLY, _state, _trained

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


def test_match_beyond_the_fused_capacity_raises(monkeypatch):
    """Above MAX_FUSED_CANDIDATES the reference turns to its
    host-orchestrated matcher, which the port does not carry: a named
    error, not another answer."""
    _ref, port, depths, rgbs = _pair(DEPTH_ONLY)
    src = _sources(DEPTH_ONLY, depths[0], rgbs[0])
    monkeypatch.setattr(Detector, "MAX_FUSED_CANDIDATES", 2)
    with pytest.raises(MatchCapacityError, match="_match_reference"):
        port.match(src, 50.0, max_candidates=2, device="cpu")
    three = Detector(modalities=DEPTH_ONLY, t_at_level=(5, 8, 8))
    with pytest.raises(MatchCapacityError, match="pyramid levels"):
        three.match(src, 50.0, device="cpu")


def test_sort_dedup_order():
    """Similarity descending, then template id ascending; the first of
    each (x, y, similarity, class) stays."""
    ms = [Match(1, 1, 90.0, "a", 3), Match(1, 1, 90.0, "a", 1), Match(2, 1, 95.0, "b", 7),
          Match(1, 1, 90.0, "b", 2), Match(5, 5, 90.0, "a", 0)]
    out = Detector._sort_dedup(ms)
    assert [(m.class_id, m.template_id) for m in out] == \
        [("b", 7), ("a", 0), ("a", 1), ("b", 2)]
