"""A frame's answer must not depend on the batch it came in.

Every float sum of the port's projective ICP over points is
``core/reduce.py`` ``fixed_sum``, a pairwise tree of elementwise adds
whose order depends only on the number of points (on a CUDA card
``torch.matmul`` and ``torch.sum`` split a reduction by the number of
lanes, and a frame's poses moved in their last bits with the batch;
``batch_probe.py`` names the stage where a frame's bits first differ).
So a lane gives the same bits alone or among any others, and a frame the
same flat NMS record alone or at any position of any batch.

CPU: ``fixed_sum`` lane by lane and against a float64 sum; the port's
``_gn_solve`` against the reference's, vmapped over lanes; a frame alone
against its slot in a batch of 4. Card: ``_gn_solve`` on 1, 2, 256 and
1024 lanes; frames 0 and B-1 alone and in batches of 2, 4 and 32, the
flat record bit for bit. The CPU test of a known motion holds the
solve itself.
"""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams
from object_detector_6d_tpu_torch.core.reduce import fixed_sum
from object_detector_6d_tpu_torch.refine.projective import _gn_solve

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

K = scenes.K_DEFAULT


def test_gn_solve_recovers_a_known_motion():
    """One solve on exact pairs recovers a small translation per lane,
    leaves an unmoved lane alone and reports the weighted mean |r|."""
    rng = np.random.RandomState(0)
    L, n = 3, 256
    pts = torch.as_tensor(rng.uniform(-0.1, 0.1, (L, n, 3)).astype(np.float32))
    pts[..., 2] += 1.0
    nrm = torch.nn.functional.normalize(torch.as_tensor(rng.randn(L, n, 3).astype(np.float32)),
                                        dim=-1)
    model = torch.cat([pts, nrm], -1)
    pose = torch.eye(4).repeat(L, 1, 1)
    shift = torch.as_tensor([[1e-3, -2e-3, 5e-4], [0.0, 0.0, 0.0], [-3e-3, 1e-3, 2e-3]])
    qp = pts + shift[:, None, :]
    w = torch.as_tensor((rng.rand(L, n) < 0.8).astype(np.float32))
    new_pose, upd, residual = _gn_solve(pose, model, qp, nrm, w)
    assert torch.allclose(new_pose[:, :3, 3], shift, atol=2e-5)
    assert torch.allclose(new_pose[:, :3, :3], torch.eye(3).expand(L, 3, 3), atol=2e-4)
    r = ((pts - qp) * nrm).sum(-1)
    assert torch.allclose(residual, (r.abs() * w).sum(-1) / w.sum(-1), rtol=1e-5, atol=1e-9)
    assert upd[1] < 1e-6 < upd[0]


@pytest.mark.parametrize("n", [1, 5, 64, 512])
@pytest.mark.parametrize("L", [1, 3, 1024])
def test_fixed_sum_is_lane_invariant_and_near_the_exact_sum(L, n):
    """A lane's sum over n is the same bits alone as among L lanes, and
    within 2 ceil(log2 n) eps sum|x| of the float64 sum."""
    rng = np.random.RandomState(L * 1000 + n)
    x = (rng.standard_normal((L, n)) * np.exp(rng.uniform(-8, 8, (L, n)))).astype(np.float32)
    got = fixed_sum(torch.as_tensor(x), 1)
    for j in sorted({0, L // 2, L - 1}):
        assert torch.equal(fixed_sum(torch.as_tensor(x[j:j + 1]), 1)[0], got[j])
        assert torch.equal(fixed_sum(torch.as_tensor(x[j]), 0), got[j])
    exact = x.astype(np.float64).sum(1)
    bound = 2 * math.ceil(math.log2(n)) * np.finfo(np.float32).eps * np.abs(x).astype(
        np.float64).sum(1)
    assert (np.abs(got.numpy().astype(np.float64) - exact) <= bound).all()


def _solve_lanes(L, n, seed=0):
    """Seeded Gauss-Newton inputs: L lanes of n points near z = 0.8 m, with
    noisy pairs, 80% weights and poses a few mm from the identity."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.1, 0.1, (L, n, 3)).astype(np.float32)
    pts[..., 2] += 0.8
    nrm = rng.randn(L, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    qp = (pts + rng.normal(0, 0.003, (L, n, 3))).astype(np.float32)
    w = (rng.rand(L, n) < 0.8).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    pose[:, :3, 3] = rng.normal(0, 0.005, (L, 3))
    return pose, np.concatenate([pts, nrm], -1), qp, nrm, w


def test_gn_solve_equals_reference():
    """The port's solve (two fixed_sum trees) against the reference's
    ``_gn_solve`` (matmuls at HIGHEST), vmapped over 64 lanes of 512 points."""
    jax = pytest.importorskip("jax")  # the card's machine has no JAX
    import jax.numpy as jnp

    from object_detector_6d_tpu.refine import projective as ref_projective

    arrays = _solve_lanes(64, 512)
    got = _gn_solve(*(torch.as_tensor(a) for a in arrays))
    want = jax.vmap(ref_projective._gn_solve)(*(jnp.asarray(a) for a in arrays))
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= 1e-6
    assert np.abs(got[2].numpy() - np.asarray(want[2])).max() <= 1e-6
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 1e-6


def _pose_detector(device):
    """The depth-only snowman detector (objA and its 0.78-scale objB) at
    bench.py's promoted schedule."""
    params = DetectParams(match_threshold=80.0, max_hypotheses=16,
                          icp=ICPParams(iterations=32, num_levels=4, solves_per_assoc=2,
                                        finest_assoc=2),
                          num_seeds=2, fine_compact=8)
    pd = PoseDetector(detector=Detector(modalities=("DepthNormal",)), params=params,
                      model_points=512, device=device)
    views = {}
    for cid, scale in (("objA", 1.0), ("objB", 0.78)):
        dep, _, mask = scenes.snowman_scene(scale=scale)
        assert pd.add_view(cid, dep, K, mask.astype(np.uint8) * 255) == 0
        views[cid] = (dep, mask)
    return pd, views


def _frames(views, n):
    """n frames of objA and objB at seeded translations."""
    rng = np.random.RandomState(1)
    frames = []
    for _ in range(n):
        tA = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                       rng.uniform(-0.04, 0.04)])
        tB = np.array([-0.26, 0.11, 0.04]) + rng.uniform(-0.03, 0.03, 3)
        rendered = [scenes.render_translated(*views[cid], K, t)
                    for cid, t in (("objA", tA), ("objB", tB))]
        frames.append(scenes.merge_scenes(rendered)[0])
    return np.stack(frames)


def _flat(pd, depths):
    """The flat NMS record [B, K*CLUSTER_SLOT+2] of one batch, on the host."""
    return pd.detect_fused_dispatch(depths, K)[0].cpu()


def _assert_alone_equals_batch(pd, depths, batches):
    """Frames 0 and B-1 alone give the flat record equal to their rows of a
    batch of B bit for bit (NaN included), and the same Pose arrays."""
    alone = {}
    for B in batches:
        flat = _flat(pd, depths[:B])
        poses = pd.detect_fused_batch(depths[:B], K)
        for f in (0, B - 1):
            if f not in alone:
                alone[f] = (_flat(pd, depths[f:f + 1])[0], pd.detect_fused_batch(
                    depths[f:f + 1], K)[0])
            assert torch.equal(flat[f].view(torch.int32), alone[f][0].view(torch.int32)), \
                f"frame {f} at B={B}"
            assert [(p.class_id, p.template_id, p.residual, p.pose.tobytes())
                    for p in poses[f]] == [(p.class_id, p.template_id, p.residual,
                                            p.pose.tobytes()) for p in alone[f][1]]
    assert any(p.class_id == "objA" for p in alone[0][1])


def test_frame_alone_equals_its_slot_in_a_batch_of_4():
    pd, views = _pose_detector("cpu")
    _assert_alone_equals_batch(pd, _frames(views, 4), (4,))


@pytest.mark.cuda
def test_gn_solve_is_bitwise_per_lane_on_the_card():
    """On the card a lane's solve is the same bits at 1, 2, 256 and 1024
    lanes (the main path's fine and coarse lane counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = [torch.as_tensor(a, device="cuda") for a in _solve_lanes(1024, 512, seed=3)]
    full = _gn_solve(*arrays)
    for L in (1, 2, 256):
        part = _gn_solve(*(a[:L] for a in arrays))
        for g, w in zip(part, full):
            assert torch.equal(g, w[:L]), L
    last = _gn_solve(*(a[-1:] for a in arrays))
    for g, w in zip(last, full):
        assert torch.equal(g[0], w[-1])


@pytest.mark.cuda
def test_detect_fused_batch_answers_a_frame_alike_at_batch_sizes_1_2_4():
    """Frames 0 and B-1 alone and in batches of 2, 4 and 32 on the card:
    the flat NMS record and the Pose arrays bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pd, views = _pose_detector("cuda:0")
    _assert_alone_equals_batch(pd, _frames(views, 32), (2, 4, 32))
