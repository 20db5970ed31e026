"""The port's copied pose binary IO (refine/pose.py ``read_pose``,
``write_pose``, ``read_pose_cluster``, ``write_pose_cluster``) against the
oracle's golden files, as tests/test_pose_io.py holds the reference's,
and against the reference's own writer, byte for byte.

The goldens (tests/golden/oracle_pose3d.bin, oracle_pose_cluster.bin)
come from the compiled OpenCV surface_matching library: a Pose3D with
alpha 0.42, modelIndex 7, numVotes 1234, R = [[.36,.48,-.8],[-.8,.6,0],
[.48,.64,.6]], t = (0.1, -0.2, 0.3), residual 0.00321; the cluster holds
that pose and an identity pose (modelIndex 3, numVotes 99) under id 5.
"""

import io
import pathlib
import struct

import numpy as np

from object_detector_6d_tpu.refine.pose import Pose as RefPose
from object_detector_6d_tpu.refine.pose import PoseCluster as RefPoseCluster
from object_detector_6d_tpu_torch.refine.pose import Pose, PoseCluster

GOLD = pathlib.Path(__file__).parent / "golden"

R_REF = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]])
T_REF = np.array([0.1, -0.2, 0.3])


def _bytes(write, obj) -> bytes:
    buf = io.BytesIO()
    write(obj, buf)
    return buf.getvalue()


def test_read_oracle_pose3d():
    p = Pose.read_pose(str(GOLD / "oracle_pose3d.bin"))
    assert p.num_votes == 1234 and p.model_index == 7
    np.testing.assert_allclose(p.pose[:3, :3], R_REF, atol=1e-12)
    np.testing.assert_allclose(p.pose[:3, 3], T_REF, atol=1e-12)
    assert abs(p.residual - 0.00321) < 1e-12
    ref = RefPose.read_pose(str(GOLD / "oracle_pose3d.bin"))
    np.testing.assert_array_equal(p.pose, ref.pose)
    assert (p.residual, p.num_votes, p.model_index) == \
        (ref.residual, ref.num_votes, ref.model_index)


def test_write_matches_oracle_bytes():
    """The oracle's bytes, but for the t field [148:172) (the pose's real
    translation, where the oracle dumps a stale member: the reference's
    documented deviation) and the angle, recomputed from the matrix to
    1e-12; and the reference writer's bytes exactly."""
    p = Pose.read_pose(str(GOLD / "oracle_pose3d.bin"))
    ours = _bytes(Pose.write_pose, p)
    ref = (GOLD / "oracle_pose3d.bin").read_bytes()
    assert len(ours) == len(ref) == 212
    assert ours[:4] == ref[:4]
    assert ours[12:148] == ref[12:148]
    assert ours[172:] == ref[172:]
    a_ours, = struct.unpack_from("<d", ours, 4)
    a_ref, = struct.unpack_from("<d", ref, 4)
    assert abs(a_ours - a_ref) < 1e-12
    np.testing.assert_array_equal(struct.unpack_from("<3d", ours, 148), T_REF)
    assert ours == _bytes(RefPose.write_pose,
                          RefPose.read_pose(str(GOLD / "oracle_pose3d.bin")))


def test_pose_roundtrip():
    p = Pose(pose=np.diag([1.0, -1.0, -1.0, 1.0]), residual=0.5, num_votes=9, model_index=2)
    p.pose[:3, 3] = (0.01, 0.02, 0.03)
    raw = _bytes(Pose.write_pose, p)
    q = Pose.read_pose(io.BytesIO(raw))
    np.testing.assert_allclose(q.pose, p.pose, atol=0)
    assert q.num_votes == 9 and q.model_index == 2 and q.residual == 0.5
    r = RefPose(pose=p.pose.copy(), residual=0.5, num_votes=9, model_index=2)
    assert raw == _bytes(RefPose.write_pose, r)


def test_read_oracle_cluster_and_roundtrip():
    c = PoseCluster.read_pose_cluster(str(GOLD / "oracle_pose_cluster.bin"))
    assert c.id == 5 and c.num_votes == 1234 + 99
    assert len(c.poses) == 2
    np.testing.assert_allclose(c.poses[0].pose[:3, :3], R_REF, atol=1e-12)
    np.testing.assert_allclose(c.poses[1].pose, np.eye(4), atol=1e-12)
    raw = _bytes(PoseCluster.write_pose_cluster, c)
    c2 = PoseCluster.read_pose_cluster(io.BytesIO(raw))
    assert c2.id == c.id and c2.num_votes == c.num_votes
    np.testing.assert_allclose(c2.poses[0].pose, c.poses[0].pose, atol=0)
    ref = RefPoseCluster.read_pose_cluster(str(GOLD / "oracle_pose_cluster.bin"))
    assert raw == _bytes(RefPoseCluster.write_pose_cluster, ref)
    # the oracle's cluster bytes: the same header (magic, id, votes,
    # count), then each 212-byte pose record as in
    # test_write_matches_oracle_bytes, except that for the identity pose
    # the oracle writes q = (1, 0, 0, 0) where both packages' conjugate
    # (1, -q) gives (1, -0.0, -0.0, -0.0): equal as numbers, not as bytes
    gold = (GOLD / "oracle_pose_cluster.bin").read_bytes()
    assert len(raw) == len(gold) == 16 + 2 * 212
    assert raw[:16] == gold[:16]
    for k in range(2):
        ours, want = raw[16 + 212 * k:16 + 212 * (k + 1)], gold[16 + 212 * k:16 + 212 * (k + 1)]
        assert ours[:4] == want[:4] and ours[12:148] == want[12:148]
        assert ours[204:] == want[204:]  # the residual
        q_ours, q_want = struct.unpack_from("<4d", ours, 172), struct.unpack_from("<4d", want, 172)
        assert q_ours == q_want
        assert (ours[172:204] == want[172:204]) == (k == 0)
        assert abs(struct.unpack_from("<d", ours, 4)[0]
                   - struct.unpack_from("<d", want, 4)[0]) < 1e-12
