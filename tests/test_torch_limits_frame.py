"""The port against the JAX package at 480x640 where its kernels' limits
lie: a bank of more than 256 features a template (K4 and K6 in chunks),
colour frames whose three BGR channels differ, and a fault of the
reference's conv path (ROADMAP.md queue 3 item 1c).

- Over 256 features: ``synthetic_bank(2, 2, bbox_px=200,
  num_features=300)`` (300 + 300 features at level 0, 150 + 150 at level
  1: K4 runs 2 chunks a modality, K6 2), on two snowman frames coloured
  as below: the match program's record equals the reference conv
  program's (test_torch_limits.py's bounds), and ``Detector.match`` with
  ``fused=False`` (the host matcher, match/sweep.py on the same
  wrappers) returns the reference's list exactly.
- Colour: the snowman trained by ``add_view`` on a coloured view, the
  blue channel its gray, green a dimmer gray, red a gray with a
  sinusoidal pattern of its own, so ColorGradient's channel select picks
  different channels across the frame (the other end-to-end tests use
  gray x3, where every channel ties). The templates equal the
  reference's; ``detect_fused_batch`` on two coloured frames at the
  promoted schedule agrees as tests/test_torch_detect.py holds it.
- Fault 1c: the reference's conv path sizes its padded planes without
  its window of 16 + max_dr cells (reference match/program.py:316), so
  for a bank with a 241 px template (max_dr 48) it clamps the window of
  in-plane candidates near the bottom of a 480-row frame and reports
  another cell's sum. The port sums at the candidate's own anchor: every
  live slot equals the LINEMOD sum, recomputed in numpy from the port's
  level-0 response maps, at the T-grid cell it reports (no base lies
  outside the planes here), while the reference's record differs on
  slots near the bottom (reported y >= 327, the least a clamped window's
  slot can report), with the same template ids and keep flags.
"""

import functools
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import torch

from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu.data.synthetic import synthetic_bank as ref_synthetic_bank
from object_detector_6d_tpu.match import program as ref_mp
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.ops import refine
from object_detector_6d_tpu_torch.ops.quantize import cg_quantize_batched
from object_detector_6d_tpu_torch.ops.response import response_spread_batched
from test_torch_detect import SCHEDULES, T_FRAMES, _rot_deg, _state
from test_torch_limits import _both_banks, _pyramid, assert_match_equal

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

K = scenes.K_DEFAULT
H, W = 480, 640
BOTH = ("ColorGradient", "DepthNormal")


def _colour(gray):
    """[H, W] u8 gray -> [H, W, 3] u8 BGR with three different channels."""
    yy, xx = np.mgrid[:gray.shape[0], :gray.shape[1]]
    g = gray.astype(np.float64)
    red = 0.8 * g + 45 * np.sin(xx / 9.0) * np.cos(yy / 13.0) + 30
    return np.clip(np.stack([g, 0.55 * g + 60, red], -1), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _frames():
    """Two snowman frames (tools/scenes.py, test_torch_detect.py's
    translations), coloured, and the coloured training view."""
    dep, gray, mask = scenes.snowman_scene()
    rendered = [scenes.render_translated(dep, mask, K, t) for t in T_FRAMES]
    depths = np.stack([r[0] for r in rendered])
    bgrs = np.stack([_colour(r[2]) for r in rendered])
    assert (bgrs[..., 0] != bgrs[..., 2]).mean() > 0.5
    # the channel select matters: the orientations differ from those of the
    # blue channel alone (gray x3)
    q = cg_quantize_batched(torch.as_tensor(bgrs), 10.0)
    q_blue = cg_quantize_batched(torch.as_tensor(np.repeat(bgrs[..., :1], 3, -1)), 10.0)
    assert (q != q_blue).float().mean() > 0.01
    return depths, bgrs, (dep, _colour(gray), mask)


def _ref_match_program(ref_det, frame_shape, batch, K_cap, bank, sources, threshold):
    prog = ref_mp.make_match_program(
        ref_det.modality_names, ref_det.t_at_level, frame_shape, ref_det.dn_params,
        ref_det.cg_params, max_candidates=K_cap, max_dr=((bank.max_dr // 16) + 1) * 16,
        refine_impl="conv", batch=batch)
    return np.asarray(prog(
        tuple(jnp.asarray(s) for s in sources), bank.kernels_low, bank.kernels_dec,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]), jnp.asarray(bank.sizes[0]),
        jnp.asarray(bank.sizes[1]), jnp.float32(threshold)))


def _port_match_program(det, frame_shape, K_cap, sources, threshold):
    bank = mp.pack_bank(det.class_templates, len(det.modality_names), 2)
    prog = mp.make_match_program(det.modality_names, det.t_at_level, frame_shape,
                                 det.dn_params, det.cg_params, K_cap)
    srcs = [torch.as_tensor(np.asarray(s, np.int32) if s.dtype == np.uint16 else s)
            for s in sources]
    return bank, prog(srcs, *mp.bank_args(bank, "cpu"), threshold).numpy()


# ----------------------------------------------------------------------
# more than MAX_F features a template
# ----------------------------------------------------------------------

def test_bank_over_max_f_equals_reference(monkeypatch):
    depths, bgrs, _ = _frames()
    det = synthetic_bank(2, 2, bbox_px=200, num_features=300, seed=0)
    ref_det = ref_synthetic_bank(2, 2, bbox_px=200, num_features=300, seed=0)
    sources = (bgrs, depths)
    widths = []
    for name in ("refine_sweep_plain", "coarse_sweep_plain"):
        plain = getattr(refine, name)

        def counted(*a, _plain=plain, _name=name, **kw):
            widths.append((_name, a[1].shape[-1]))
            return _plain(*a, **kw)

        monkeypatch.setattr(refine, name, counted)
    bank, got = _port_match_program(det, (H, W), 8, sources, 40.0)
    assert bank.feat_plane[0].shape[1] == 300 and bank.coarse[0].shape[1] == 300
    assert sorted(widths) == sorted([("coarse_sweep_plain", 256), ("coarse_sweep_plain", 44)]
                                    + [("refine_sweep_plain", 256),
                                       ("refine_sweep_plain", 44)] * 2)
    ref_bank = ref_mp.pack_bank(ref_det.class_templates, 2, 2)
    want = _ref_match_program(ref_det, (H, W), 2, 8, ref_bank, sources, 40.0)
    live = assert_match_equal(got, want, 8)
    assert (got[:, 4, :-1][live] > 0).any()
    # the host-orchestrated matcher, through the same wrappers (at 48, where
    # the reference's dense host sweep keeps to a second or so)
    found = 0
    for b in range(2):
        src = [bgrs[b], depths[b]]
        want_m = ref_det.match(src, 48.0, fused=False)
        got_m = det.match(src, 48.0, fused=False, device="cpu")
        assert [(m.x, m.y, m.similarity, m.class_id, m.template_id) for m in got_m] == \
            [(m.x, m.y, m.similarity, m.class_id, m.template_id) for m in want_m]
        found += len(want_m)
    assert found


# ----------------------------------------------------------------------
# colour frames: the three BGR channels differ
# ----------------------------------------------------------------------

def test_colour_frames_equal_reference():
    depths, bgrs, (dep, bgr_view, mask) = _frames()
    params = SCHEDULES["promoted"]
    ref = RefPoseDetector(detector=RefDetector(modalities=BOTH), model_points=512,
                          params=params)
    assert ref.add_view("obj", dep, K, mask.astype(np.uint8) * 255, rgb=bgr_view) == 0
    own = PoseDetector(detector=Detector(modalities=BOTH), model_points=512, device="cpu")
    assert own.add_view("obj", dep, K, mask.astype(np.uint8) * 255, rgb=bgr_view) == 0
    for tr, tp in zip(ref.detector.class_templates["obj"][0],
                      own.detector.class_templates["obj"][0]):
        assert (tp.width, tp.height) == (tr.width, tr.height)
        assert np.array_equal(tp.feature_array(), tr.feature_array())
    templates, views = _state(ref)
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(params), model_points=512, device="cpu")
    want = ref.detect_fused_batch(depths, K, bgrs)
    got = port.detect_fused_batch(depths, K, bgrs)
    assert all(want), "the reference found nothing on a coloured frame"
    for b, (wp, gp) in enumerate(zip(want, got)):
        assert len(gp) == len(wp)
        for w, g in zip(wp, gp):
            assert (g.class_id, g.template_id, g.match_x, g.match_y, g.num_votes) == \
                (w.class_id, w.template_id, w.match_x, w.match_y, w.num_votes)
            assert abs(g.match_similarity - w.match_similarity) <= 1e-4
            assert np.abs(g.pose[:3, 3] - w.pose[:3, 3]).max() < 1e-3
            assert _rot_deg(g.pose[:3, :3], w.pose[:3, :3]) < 0.5
        assert np.abs(gp[0].pose[:3, 3] - T_FRAMES[b]).max() < 0.01


# ----------------------------------------------------------------------
# reference fault 1c: the conv path's window clamped inside the frame
# ----------------------------------------------------------------------

def _fault_bank():
    """Six 20-23 px templates and one 241 px template (max_dr 48), both
    packages, one class each."""
    rng = np.random.RandomState(1)
    sizes = [20, 21, 22, 23, 20, 22, 241]
    return _both_banks([_pyramid(rng, s, s) for s in sizes], n_classes=len(sizes))


def test_reference_conv_window_clamp_is_its_fault():
    K_cap, threshold, t0 = 64, 20.0, 5
    det, ref_det = _fault_bank()
    rng = np.random.RandomState(0)
    bgrs = rng.randint(0, 256, (1, H, W, 3), dtype=np.int64).astype(np.uint8)
    deps = (1000 + rng.randint(0, 400, (1, H, W))).astype(np.uint16)
    bank, got = _port_match_program(det, (H, W), K_cap, (bgrs, deps), threshold)
    ref_bank = ref_mp.pack_bank(ref_det.class_templates, 2, 2)
    assert ref_bank.max_dr == 48
    # no base leaves the planes: every template within the frame less borders
    assert (bank.sizes[0] <= (W - 80, H - 80)).all()
    live = np.arange(K_cap) < got[0, 0, -1]
    assert live.all()
    # the port's level-0 response maps, per modality
    srcs = [torch.as_tensor(bgrs), torch.as_tensor(deps.astype(np.int32))]
    qs = mp.quantize_pyramids_batched(srcs, det.modality_names, 2, det.dn_params,
                                      det.cg_params)[0]
    R0 = [response_spread_batched(q, t0)[0].numpy().astype(np.int64) for q in qs]
    off0 = t0 // 2 + (t0 % 2 - 1)
    x, y, score, tid = got[0, 0, :-1], got[0, 1, :-1], got[0, 2, :-1], got[0, 3, :-1]
    for k in range(K_cap):
        cx, cy = (int(x[k]) - off0) // t0, (int(y[k]) - off0) // t0
        total = 0
        for mod, tp in enumerate(det.class_templates[bank.class_ids[int(tid[k])]][0][:2]):
            for f in tp.features:
                r, c = cy * t0 + f.y, cx * t0 + f.x
                if 0 <= r < H and 0 <= c < W:
                    total += R0[mod][f.label, r, c]
        nf = np.float32(bank.nfeat[0][int(tid[k])])
        assert score[k] == np.float32(total) * np.float32(100.0) / (np.float32(4.0) * nf), k
    want = _ref_match_program(ref_det, (H, W), 1, K_cap, ref_bank, (bgrs, deps), threshold)
    np.testing.assert_array_equal(got[0, 3:5], want[0, 3:5])
    apart = (got[0, :3, :-1] != want[0, :3, :-1]).any(0)
    assert apart.any(), "the reference's conv record equals the anchor sums"
    # the reference clamps a window that starts past Hp2 - (16 + max_dr) =
    # 128 - 64 cells, so only a slot whose base row is >= 65 can differ: its
    # reported y, (base + best row) * t0 + off0, is >= 65 * 5 + 2 = 327
    Hp2 = 1 << (max(-(-H // t0) + 17, 32) - 1).bit_length()
    y_min = (Hp2 - 16 - ref_bank.max_dr + 1) * t0 + off0
    assert y_min == 327
    assert (want[0, 1, :-1][apart] >= y_min).all() and (got[0, 1, :-1][apart] >= y_min).all()
