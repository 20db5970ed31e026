"""The reference's scale bank (bench.py:459-515, BASELINE configs 2 + 4):
synthetic_bank(n_classes=12, per_class=..., bbox_px=120) plus the snowman
(objA) and its 0.78-scale copy (objB) trained with add_view, in one
packed bank.

The port's match program against the JAX package's (its conv path) on one
480x640 two-object frame (bench.py's generator, seed 300 as chip_smoke.py
phase 18b), at the config-4 threshold 75 and 64 candidates: the [1, 5,
K+1] match record equal exactly as tests/test_torch_limits.py holds it
(every row on the slots that hold a candidate, template id and keep on
every slot, the count above the threshold; an empty slot's position and
score are each program's own filler). The templates go to the port
through io/convert.py.

The bank is cut from the reference's 100 templates a class to 20 (242
templates): the JAX package's conv match takes about a minute at 20 a
class on a CPU and over ten at 100, past the tier-1 budget. chip_smoke.py phase 18b
and 18c run 1202 and 4000 templates on the card against the CPU port.
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
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from object_detector_6d_tpu_torch.match import program as mp
from test_torch_config4 import _bgr, _frames
from test_torch_limits import assert_match_equal

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

K = scenes.K_DEFAULT
PER_CLASS = 20
THRESHOLD = 75.0
K_CAP = 64


@functools.lru_cache(maxsize=1)
def _detectors():
    """The reference's scale bank with objA and objB, and the port's
    Detector from its state."""
    ref = RefPoseDetector(detector=ref_synthetic_bank(n_classes=12, per_class=PER_CLASS,
                                                      bbox_px=120, seed=0,
                                                      detector=RefDetector()),
                          model_points=512)
    for cid, scale in (("objA", 1.0), ("objB", 0.78)):
        dep, gray, mask = scenes.snowman_scene(scale=scale)
        assert ref.add_view(cid, dep, K, mask.astype(np.uint8) * 255, rgb=_bgr(gray)) == 0
    templates = {
        cid: [[(t.width, t.height, t.pyramid_level, t.feature_array()) for t in tp]
              for tp in tps]
        for cid, tps in ref.detector.class_templates.items()}
    views = {k: dict(model_cloud=v.model_cloud, bbox=v.bbox, anchor_point=v.anchor_point,
                     view_pose=v.view_pose) for k, v in ref.views.items()}
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(ref.params), model_points=512, device="cpu")
    return ref.detector, port.detector


def test_scale_bank_match_record_equals_reference():
    ref_det, det = _detectors()
    depths, rgbs, _ = _frames(1, 300)
    H, W = depths.shape[1:]

    bank = ref_mp.pack_bank(ref_det.class_templates, 2, 2, t0=ref_det.t_at_level[0],
                            t1=ref_det.t_at_level[1])
    assert bank.num_templates == 12 * PER_CLASS + 2
    ref_prog = ref_mp.make_match_program(
        ref_det.modality_names, ref_det.t_at_level, (H, W), ref_det.dn_params,
        ref_det.cg_params, max_candidates=K_CAP, max_dr=((bank.max_dr // 16) + 1) * 16,
        refine_impl="conv", batch=1)
    want = np.asarray(ref_prog(
        (jnp.asarray(rgbs), jnp.asarray(depths)), bank.kernels_low, bank.kernels_dec,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]), jnp.asarray(bank.sizes[0]),
        jnp.asarray(bank.sizes[1]), jnp.float32(THRESHOLD)))

    port_bank = mp.pack_bank(det.class_templates, 2, 2, t0=det.t_at_level[0],
                             t1=det.t_at_level[1])
    assert port_bank.class_ids == list(bank.class_ids)
    prog = mp.make_match_program(det.modality_names, det.t_at_level, (H, W), det.dn_params,
                                 det.cg_params, max_candidates=K_CAP)
    got = prog([torch.as_tensor(rgbs), torch.as_tensor(depths.astype(np.int32))],
               *mp.bank_args(port_bank, "cpu"), THRESHOLD).numpy()

    assert got.shape == want.shape == (1, 5, K_CAP + 1)
    assert_match_equal(got, want, K_CAP)
    n_above = int(got[0, 0, -1])
    assert 0 < n_above <= K_CAP
    # objA among the candidates
    tids = got[0, 3, :min(n_above, K_CAP)].astype(int)
    assert {bank.class_ids[t] for t in tids} >= {"objA"}
