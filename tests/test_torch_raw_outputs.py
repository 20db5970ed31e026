"""Port parity: the raw, flat and one-frame forms of the detect program
(make_detect_program's device_nms=False, flat_output=True, batch=None)
against the JAX package's, on the same trained state and tools/scenes.py
frames, for both modalities at the promoted schedule.

Bounds: the match arrays ``packed`` equal bitwise wherever the reference
defines them (every row of the valid top-K slots and the overflow count,
the template id and keep flag of every slot: the reference's CPU conv
path sweeps invalid slots too, tests/test_torch_refine.py) and ``keep``
equal;
the poses of kept lanes within 1 mm / 0.5 deg (tests/test_torch_detect.py's
bound on the cluster records); the residuals of kept lanes within 2e-5 m
(tests/test_torch_icp.py's bound for one ICP call; kept residuals are
0.3-1.5 mm). The port's flat form and its one-frame form equal its own
raw batched form exactly on the CPU, and its any-batch form (batch=-1,
the one PoseDetector caches) its fixed-size form.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api import detect_program as ref_dp
from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from test_torch_detect import BOTH, K, SCHEDULES, _rot_deg, _state, _trained

torch.set_num_threads(1)

RES_TOL = 2e-5


@functools.lru_cache(maxsize=1)
def _setup():
    """The reference and the port on one trained state, both programs'
    arguments, and the reference's raw outputs on the two frames."""
    ref, depths, rgbs = _trained(BOTH)
    params = SCHEDULES["promoted"]
    ref.params = params
    templates, views = _state(ref)
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(params), model_points=512, device="cpu")
    det = ref.detector
    H, W = depths.shape[1:]
    B = len(depths)
    bank = det.get_bank()
    common = dict(max_candidates=params.max_hypotheses, icp=params.icp, lift_window=160,
                  num_seeds=params.num_seeds, fine_compact=params.fine_compact)
    ref_prog = ref_dp.make_detect_program(
        det.modality_names, det.t_at_level, (H, W), det.dn_params, det.cg_params,
        np.asarray(K, np.float64), max_dr=((bank.max_dr // 16) + 1) * 16,
        refine_impl="conv", batch=B, **common)
    ref_out = ref_prog(
        (jnp.asarray(rgbs), jnp.asarray(depths)), bank.kernels_low, bank.kernels_dec,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
        jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
        ref_dp.pack_views(bank, ref.views, 512), jnp.float32(params.match_threshold))
    pbank = port.detector.get_bank()
    bargs, pviews, cls = port.bank_tensors(pbank)
    sources = [torch.as_tensor(rgbs), torch.as_tensor(depths.astype(np.int32))]

    def make(**kw):
        return dp.make_detect_program(
            port.detector.modality_names, port.detector.t_at_level, (H, W),
            port.detector.dn_params, port.detector.cg_params, np.asarray(K, np.float64),
            device="cpu", **common, **kw)

    def run(prog, srcs, *nms):
        return prog(srcs, bargs, pviews, params.match_threshold, *nms)

    raw = run(make(batch=B), sources)
    nms_args = (cls, params.max_residual, params.nms_radius_px / float(K[0, 0]))
    return ref_out, raw, make, run, sources, nms_args, B, port


def test_raw_outputs_equal_reference():
    ref_out, raw, *_ = _setup()
    r_packed, r_poses, r_res, r_keep = (np.asarray(a) for a in ref_out)
    packed, poses, res, keep = (t.numpy() for t in raw)
    assert packed.shape == r_packed.shape and poses.shape == r_poses.shape
    n_above = r_packed[:, 0, -1]
    valid = np.concatenate([np.arange(16)[None] < n_above[:, None],
                            np.ones((len(n_above), 1), bool)], 1)[:, None]
    np.testing.assert_array_equal(np.where(valid, packed, 0), np.where(valid, r_packed, 0))
    np.testing.assert_array_equal(packed[:, [3, 4]], r_packed[:, [3, 4]])
    np.testing.assert_array_equal(keep, r_keep)
    assert keep.any(axis=1).all(), "a frame kept no lane"
    for b, k in zip(*np.nonzero(keep)):
        assert np.abs(poses[b, k, :3, 3] - r_poses[b, k, :3, 3]).max() < 1e-3
        assert _rot_deg(poses[b, k, :3, :3], r_poses[b, k, :3, :3]) < 0.5
    np.testing.assert_allclose(res[keep], r_res[keep], rtol=0, atol=RES_TOL)
    np.testing.assert_array_equal(np.isfinite(res), np.isfinite(r_res))


def test_flat_outputs_round_trip():
    ref_out, raw, make, run, sources, _, B, _ = _setup()
    flat = run(make(batch=B, flat_output=True), sources)
    assert flat.dtype == torch.float32 and flat.shape == (B, 5 * 17 + 18 * 16)
    torch.testing.assert_close(flat, dp.flatten_outputs(*raw, 16), rtol=0, atol=0,
                               equal_nan=True)
    for got, want in zip(dp.unflatten_outputs(flat.numpy(), 16), raw):
        np.testing.assert_array_equal(got, want.numpy())
    # the port's host inverse reads the reference's flat record
    ref_flat = np.asarray(ref_dp.flatten_outputs(*ref_out, 16))
    for got, want in zip(dp.unflatten_outputs(ref_flat, 16), ref_out):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_cluster_of_raw_outputs_is_the_nms_record():
    _, raw, make, run, sources, nms_args, B, _ = _setup()
    record = run(make(batch=B, device_nms=True), sources, *nms_args)
    cls, max_res, trans_thr = nms_args
    stage = dp.make_cluster_stage(16)(*raw, cls, float(np.float32(max_res)),
                                      float(np.float32(trans_thr)))
    torch.testing.assert_close(record, stage, rtol=0, atol=0, equal_nan=True)
    slots, n_raw, n_pass = dp.unflatten_cluster_outputs(record.numpy(), 16)
    assert (slots[:, 0, 0] > 0).all() and (n_pass > 0).all()


def test_one_frame_equals_batch_row():
    _, raw, make, run, sources, nms_args, _, _ = _setup()
    prog = make()  # batch=None
    one = run(prog, [s[0] for s in sources])
    assert one[0].shape == (5, 17) and one[1].shape == (16, 4, 4)
    for got, want in zip(one, raw):
        torch.testing.assert_close(got, want[0], rtol=0, atol=0, equal_nan=True)
    rec = run(make(device_nms=True), [s[1] for s in sources], *nms_args)
    assert rec.shape == (16 * dp.CLUSTER_SLOT + 2,)
    torch.testing.assert_close(rec, dp.make_cluster_stage(16)(
        *(t[1:2] for t in raw), nms_args[0], float(np.float32(nms_args[1])),
        float(np.float32(nms_args[2])))[0], rtol=0, atol=0, equal_nan=True)


def test_any_batch_program_serves_every_batch_size():
    """batch=-1 (PoseDetector's cached form) takes a batch of any size:
    its records equal the fixed-size form's rows, and detect_fused_batch
    at B=2 and B=1 runs one cached program."""
    _, raw, make, run, sources, nms_args, B, port = _setup()
    prog = make(batch=-1, device_nms=True)
    full = run(make(batch=B, device_nms=True), sources, *nms_args)
    torch.testing.assert_close(run(prog, sources, *nms_args), full, rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(run(prog, [s[1:] for s in sources], *nms_args), full[1:],
                               rtol=0, atol=0, equal_nan=True)
    _, depths, rgbs = _trained(BOTH)
    both = port.detect_fused_batch(depths, K, rgbs)
    one = port.detect_fused_batch(depths[1:], K, rgbs[1:])[0]
    assert len([k for k in port._cache if k[0] == "prog"]) == 1
    assert [(p.class_id, p.template_id, p.match_x, p.match_y) for p in one] == \
        [(p.class_id, p.template_id, p.match_x, p.match_y) for p in both[1]]
    for a, b in zip(one, both[1]):
        np.testing.assert_array_equal(a.pose, b.pose)


def test_leading_axis_is_checked():
    _, _, make, run, sources, nms_args, B, _ = _setup()
    with pytest.raises(ValueError, match="batch=3"):
        run(make(batch=3), sources)
    with pytest.raises(ValueError, match="one-frame"):
        run(make(), sources)
    with pytest.raises(TypeError, match="device_nms"):
        run(make(batch=B), sources, *nms_args)
    with pytest.raises(ValueError, match="icp_window"):
        make(batch=B, icp_window=481)
