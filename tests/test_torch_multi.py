"""The multi-batch and many-handle entry points against the single-batch
path and the JAX package's.

A reference PoseDetector trained on the snowman, depth-only
(test_torch_detect.py's setup, the promoted schedule) hands its state to
the port. G=2 batches of B=2 tools/scenes.py frames go through
``detect_fused_dispatch_multi`` + ``detect_fused_finalize_multi`` and,
batch by batch, through ``detect_fused_dispatch`` +
``detect_fused_finalize_many`` with an empty-bank handle between them.
The port's answers must equal its own ``detect_fused_batch`` per batch
exactly, and the reference's multi / many within 1 mm / 0.5 deg with the
same class, template and match fields.
"""

import functools

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)

from test_torch_detect import (DEPTH_ONLY, K, SCHEDULES, T_FRAMES, _rot_deg, _state, _trained,
                               scenes)

torch.set_num_threads(1)

G, B = 2, 2
T_MORE = (np.array([0.01, 0.03, -0.04]), np.array([-0.045, -0.02, 0.035]))


@functools.lru_cache(maxsize=1)
def _setup():
    """The trained reference, the port holding its state, and G batches
    of depths [G, B, H, W] (no colour frames: depth-only)."""
    ref, depths, _rgbs = _trained(DEPTH_ONLY)
    ref.params = SCHEDULES["promoted"]
    templates, views = _state(ref)
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(ref.params), model_points=512, device="cpu")
    dep, _gray, mask = scenes.snowman_scene()
    more = [scenes.render_translated(dep, mask, K, t) for t in T_MORE]
    depths = np.concatenate([depths, np.stack([r[0] for r in more])])
    return ref, port, depths.reshape(G, B, *depths.shape[1:])


def _key(poses):
    return [(p.class_id, p.template_id, p.match_x, p.match_y, p.num_votes) for p in poses]


def _same(got, want, exact):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for gf, wf in zip(gb, wb):
            assert _key(gf) == _key(wf)
            for g, w in zip(gf, wf):
                if exact:
                    np.testing.assert_array_equal(g.pose, w.pose)
                    assert g.residual == w.residual
                else:
                    assert np.abs(g.pose[:3, 3] - w.pose[:3, 3]).max() < 1e-3
                    assert _rot_deg(g.pose[:3, :3], w.pose[:3, :3]) < 0.5


@pytest.mark.parametrize("entry", ["multi", "many"])
def test_multi_and_many_equal_single_batches_and_reference(entry):
    ref, port, depths_g = _setup()
    single = [port.detect_fused_batch(depths_g[g], K) for g in range(G)]
    assert sum(len(f) for b in single for f in b) >= G * B, "the port found too little"
    if entry == "multi":
        got = port.detect_fused_finalize_multi(
            port.detect_fused_dispatch_multi(depths_g, K))
        want = ref.detect_fused_finalize_multi(
            ref.detect_fused_dispatch_multi(depths_g, K))
    else:
        def handles(pd):
            return [pd.detect_fused_dispatch(depths_g[0], K),
                    pd.detect_fused_dispatch(depths_g[0], K, None, ["absent"]),
                    pd.detect_fused_dispatch(depths_g[1], K)]

        got = port.detect_fused_finalize_many(handles(port))
        want = ref.detect_fused_finalize_many(handles(ref))
        # the empty-bank handle keeps its place: B empty lists
        assert got[1] == want[1] == [[] for _ in range(B)]
        got, want = [got[0], got[2]], [want[0], want[2]]
    _same(got, single, exact=True)
    _same(got, want, exact=False)
    # and each frame's snowman is where it was put
    truths = list(T_FRAMES) + list(T_MORE)
    for g in range(G):
        for b in range(B):
            assert np.abs(got[g][b][0].pose[:3, 3] - truths[g * B + b]).max() < 0.01


def test_multi_on_an_empty_bank():
    """No class selected: ("empty", G, B), finalized as G x B empty lists,
    as the reference's."""
    _ref, port, depths_g = _setup()
    h = port.detect_fused_dispatch_multi(depths_g, K, class_ids=["absent"])
    assert h == ("empty", G, B)
    assert port.detect_fused_finalize_multi(h) == [[[] for _ in range(B)] for _ in range(G)]
