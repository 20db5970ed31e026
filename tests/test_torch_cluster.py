"""The port's device cluster NMS (api/detect_program.make_cluster_stage)
on its own, on the CPU.

As tests/test_cluster_device.py holds the reference's stage, this holds
the port's against its copied host path (refine/pose.py cluster_poses +
PoseCluster.mean_pose) on randomized hypothesis sets with forced vote
ties, near-duplicates and rejects, and on an all-invalid set; and
against the reference's stage on the same inputs. Bounds: the discrete
fields (validity, votes, template, match x / y, member count, the counts
in the trailer) equal; similarity equal to float32; residual means
within rtol 1e-5 and mean poses within 2e-6 (the reference test's
bounds: float32 sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api import detect_program as ref_dp
from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.refine.pose import Pose, cluster_poses
from test_cluster_device import MAX_RESIDUAL, TRANS_THR, _random_case

torch.set_num_threads(1)

K_CAP = 16


def _port_stage(cases, K_cap=K_CAP):
    """One batched call of the port's stage over [B] cases."""
    packed, poses, res, keep, cls = (np.stack(a) for a in zip(*cases))
    flat = dp.make_cluster_stage(K_cap)(
        torch.as_tensor(packed), torch.as_tensor(poses), torch.as_tensor(res),
        torch.as_tensor(keep), torch.as_tensor(cls[0].astype(np.int64)),
        float(np.float32(MAX_RESIDUAL)), float(np.float32(TRANS_THR)))
    assert flat.shape == (len(cases), K_cap * dp.CLUSTER_SLOT + 2)
    return dp.unflatten_cluster_outputs(flat.numpy(), K_cap)


def _host(packed, poses, res, keep, cls_of_tid, K_cap=K_CAP):
    """The port's copied host path on one case."""
    out = []
    for k in range(K_cap):
        if not keep[k] or not np.isfinite(res[k]) or res[k] > MAX_RESIDUAL:
            continue
        tid = int(packed[3, k])
        out.append(Pose(pose=np.asarray(poses[k], np.float64), residual=float(res[k]),
                        num_votes=int(round(packed[2, k] * 100)),
                        class_id=f"cls{cls_of_tid[tid]}", template_id=tid,
                        match_x=int(packed[0, k]), match_y=int(packed[1, k]),
                        match_similarity=float(packed[2, k])))
    return len(out), [c.mean_pose() for c in cluster_poses(out, translation_threshold=TRANS_THR)]


def _cases(seed, n=25):
    rng = np.random.default_rng(seed)
    return [_random_case(rng, K_CAP) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_equals_host_cluster_poses(seed):
    cases = _cases(seed)
    slots, n_raw, n_pass = _port_stage(cases)
    n_nonempty = 0
    for i, case in enumerate(cases):
        packed, _, _, _, cls_of_tid = case
        n_ref_pass, ref = _host(*case)
        assert n_raw[i] == packed[0, -1]
        assert int(n_pass[i]) == n_ref_pass, f"case {i}"
        got = slots[i][slots[i, :, 0] > 0]
        assert not np.any(slots[i, len(got):, 0] > 0)  # valid slots first
        assert len(got) == len(ref), f"case {i}"
        n_nonempty += bool(len(ref))
        for s, r in zip(got, ref):
            assert int(round(s[1])) == r.num_votes
            assert float(s[2]) == np.float32(r.match_similarity)
            assert f"cls{cls_of_tid[int(s[3])]}" == r.class_id
            assert int(s[4]) == r.match_x and int(s[5]) == r.match_y
            np.testing.assert_allclose(s[6], r.residual, rtol=1e-5)
            np.testing.assert_allclose(s[8:24].reshape(4, 4), r.pose, atol=2e-6)
    assert n_nonempty >= 20  # the generator produced real work


@pytest.mark.parametrize("seed", [0, 2])
def test_stage_equals_reference_stage(seed):
    cases = _cases(seed)
    slots, n_raw, n_pass = _port_stage(cases)
    ref = jax.jit(ref_dp.make_cluster_stage(K_CAP))
    nms = np.asarray([MAX_RESIDUAL, TRANS_THR], np.float32)
    for i, (packed, poses, res, keep, cls) in enumerate(cases):
        r_slots, r_raw, r_pass = ref_dp.unflatten_cluster_outputs(
            np.asarray(ref(packed, poses, res, keep, cls, nms)), K_CAP)
        assert (n_raw[i], n_pass[i]) == (r_raw, r_pass)
        for col in (0, 1, 3, 4, 5, 7):  # valid, votes, tid, x, y, members
            np.testing.assert_array_equal(slots[i, :, col], r_slots[:, col])
        ok = r_slots[:, 0] > 0
        np.testing.assert_array_equal(slots[i, ok, 2], r_slots[ok, 2])
        np.testing.assert_allclose(slots[i, ok, 6], r_slots[ok, 6], rtol=1e-5)
        np.testing.assert_allclose(slots[i, ok, 8:], r_slots[ok, 8:], rtol=0, atol=2e-6)


def test_stage_all_invalid():
    K_cap = 8
    packed = np.zeros((5, K_cap + 1), np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K_cap, 1, 1))
    res = np.full(K_cap, np.inf, np.float32)
    keep = np.zeros(K_cap, bool)
    slots, n_raw, n_pass = _port_stage([(packed, poses, res, keep, np.zeros(4, np.int32))],
                                       K_cap)
    assert n_pass[0] == 0 and n_raw[0] == 0 and not np.any(slots[..., 0] > 0)
    assert _host(packed, poses, res, keep, np.zeros(4, np.int32), K_cap) == (0, [])
