"""The port's sharding (parallel/sharding.py; the mesh paths of
match/program.py and api/detect_program.py; PoseDetector(mesh=)) in a real
spawned world of four CPU processes over gloo, mesh (data 2, model 2),
against the port's single-process programs and, for the match program,
the JAX package's mesh program on make_mesh(4) of the virtual CPU devices.

The programs run at tests/test_sharding.py's setup, 120x160 frames of
colour noise, B = 2 * data, a synthetic two-class bank of 2 * model
templates per class drawn at bbox_px=40 (up to 47 px, taller than the
frame less two 40 px borders: their refinement windows start where the
reference's conv path starts them, tests/test_torch_limits.py), threshold
60, 2 * model candidates, with one change.
The depth is a plane at 1 m with 0-3 mm of noise (the reference test's
0-400 mm of noise) and the models are 64-point planar patches facing the
camera (its random points and normals), so that ICP lanes converge and
survive: there, no lane is kept. PoseDetector(mesh=) runs at 480x640 on the
snowman objA and its 0.78-scale objB, trained here with add_view and
handed to every rank through pose_detector_from_state.

Bounds: the match record's rows x, y, template id and keep exact, the
similarity within 1e-4 (expected exact); the detect program's packed
arrays and keep exact, residuals within 1e-5, poses within 2e-3 (the
reference test's bounds; on the CPU the sharded lanes are expected to
equal the unsharded ones bitwise), the cluster record's discrete fields
exact. PoseDetector: the same classes and templates, poses within 1 mm
and 0.5 deg.

The ranks import only torch, numpy and the port (this module at its top
level); the JAX package is imported inside the tests that need it.
"""

import pathlib
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from object_detector_6d_tpu_torch.api import detect_program as dp_mod
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams
from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.parallel.sharding import make_mesh, mesh_shape

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

WORLD = 4
DP, TP = mesh_shape(WORLD)
H, W = 120, 160
B = 2 * DP
THRESHOLD = 60.0
K_SMALL = np.array([[140.0, 0, W / 2], [0, 140.0, H / 2], [0, 0, 1.0]])
NMS_ARGS = (0.05, 0.02)  # max_residual, translation threshold
# the detect program's forms run in the world (make_detect_program kwargs)
FORMS = {
    "raw": dict(),
    "raw_compact_window": dict(fine_compact=TP, icp_window=32),
    "flat": dict(flat_output=True, fine_compact=TP),
    "nms": dict(device_nms=True, fine_compact=TP),
}
POSE_PARAMS = DetectParams(match_threshold=80.0, max_hypotheses=16,
                           icp=ICPParams(iterations=16, num_levels=3), num_seeds=2,
                           fine_compact=8)
POSE_POINTS = 128
POSE_BATCH = 2 * DP  # sharded; POSE_BATCH - 1 does not divide the data axis


def _bank_and_frames():
    """tests/test_sharding.py's bank and colour frames (templates at 40 px),
    a noisy plane for depth, and planar views in bank order."""
    det = synthetic_bank(n_classes=2, per_class=2 * TP, bbox_px=40, seed=0)
    bank = mp.pack_bank(det.class_templates, 2, 2, t0=det.t_at_level[0],
                        t1=det.t_at_level[1], pad_to=TP)
    rng = np.random.RandomState(0)
    bgrs = rng.randint(0, 256, (B, H, W, 3), dtype=np.int64).astype(np.uint8)
    deps = (1000 + rng.randint(0, 4, (B, H, W))).astype(np.uint16)
    nT = bank.num_templates
    models = rng.uniform(-0.05, 0.05, (nT, 64, 6)).astype(np.float32)
    models[..., 2] = 1.0
    models[..., 3:] = (0.0, 0.0, -1.0)
    views = dp_mod.PackedViews(
        torch.as_tensor(models),
        torch.as_tensor(np.tile([0.0, 0.0, 1.0], (nT, 1)).astype(np.float32)),
        torch.full((nT, 2), 24, dtype=torch.int64),
        torch.eye(4).repeat(nT, 1, 1),
        torch.ones(nT, dtype=torch.bool))
    return det, bank, bgrs, deps, views


def _sources(bgrs, deps):
    return [torch.as_tensor(bgrs), torch.as_tensor(deps.astype(np.int32))]


def _cls_of_tid(bank):
    index = {}
    return torch.as_tensor([index.setdefault(c, len(index)) for c in bank.class_ids])


def _match_program(det, mesh=None):
    return mp.make_match_program(det.modality_names, det.t_at_level, (H, W), det.dn_params,
                                 det.cg_params, 2 * TP, mesh)


def _detect_program(det, form, mesh=None):
    return dp_mod.make_detect_program(
        det.modality_names, det.t_at_level, (H, W), det.dn_params, det.cg_params, K_SMALL,
        max_candidates=2 * TP, icp=ICPParams(iterations=9, num_levels=3), lift_window=48,
        batch=B, mesh=mesh, device="cpu", **FORMS[form])


def _run_programs(mesh=None):
    """The match program and every form of the detect program on the
    fixture, sharded over ``mesh`` or on one process."""
    det, bank, bgrs, deps, views = _bank_and_frames()
    src = _sources(bgrs, deps)
    bargs = mp.bank_args(bank, "cpu")
    out = {"match": _match_program(det, mesh)(src, *bargs, THRESHOLD)}
    for form, kw in FORMS.items():
        nms = (_cls_of_tid(bank), *NMS_ARGS) if kw.get("device_nms") else ()
        out[form] = _detect_program(det, form, mesh)(src, bargs, views, THRESHOLD, *nms)
    return out


def _pose_frames():
    """POSE_BATCH two-object 480x640 frames (objA moved, objB fixed)."""
    K = scenes.K_DEFAULT
    depA, _, maskA = scenes.snowman_scene()
    depB, _, maskB = scenes.snowman_scene(scale=0.78)
    rng = np.random.RandomState(0)
    depths, rgbs = [], []
    for _ in range(POSE_BATCH):
        tA = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                       rng.uniform(-0.04, 0.04)])
        d, _, g = scenes.merge_scenes([
            scenes.render_translated(depA, maskA, K, tA),
            scenes.render_translated(depB, maskB, K, np.array([-0.26, 0.11, 0.04]))])
        depths.append(d)
        rgbs.append(np.repeat(g[..., None], 3, axis=2))
    return np.stack(depths), np.stack(rgbs)


def _pose_state():
    """objA and objB trained with the port's add_view, as plain state."""
    K = scenes.K_DEFAULT
    pd = PoseDetector(params=POSE_PARAMS, model_points=POSE_POINTS, device="cpu")
    for cid, scale in (("objA", 1.0), ("objB", 0.78)):
        dep, gray, mask = scenes.snowman_scene(scale=scale)
        assert pd.add_view(cid, dep, K, mask.astype(np.uint8) * 255,
                           rgb=np.repeat(gray[..., None], 3, axis=2)) == 0
    templates = {cid: [[(t.width, t.height, t.pyramid_level, t.feature_array()) for t in tp]
                       for tp in tps]
                 for cid, tps in pd.detector.class_templates.items()}
    views = {k: dict(model_cloud=v.model_cloud, bbox=v.bbox, anchor_point=v.anchor_point,
                     view_pose=v.view_pose)
             for k, v in pd.views.items()}
    return detector_dict(pd.detector), templates, views, params_dict(POSE_PARAMS)


def _pose_fields(results):
    return [[(p.class_id, p.template_id, p.pose, p.residual) for p in poses]
            for poses in results]


def _raises(fn) -> str:
    """The ValueError ``fn`` raises, or "" when it raises none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _errors(mesh):
    """What the mesh paths refuse, checked on a rank (no collective runs)."""
    det = _bank_and_frames()[0]

    def program(**kw):
        return dp_mod.make_detect_program(
            det.modality_names, det.t_at_level, (H, W), det.dn_params, det.cg_params,
            K_SMALL, **{"max_candidates": 2 * TP, "batch": B, "mesh": mesh,
                        "device": "cpu", **kw})

    return {
        "make_mesh(8)": _raises(lambda: make_mesh(8, device="cpu")),
        "max_candidates": _raises(lambda: program(max_candidates=2 * TP + 1)),
        "fine_compact": _raises(lambda: program(fine_compact=TP + 1)),
        "batch=None": _raises(lambda: program(batch=None)),
        "mesh device": _raises(lambda: PoseDetector(mesh=mesh, device="cuda")),
    }


def _rank_main(rank, tmp, state, frames):
    """One rank of the world: every sharded output, saved for the test."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=WORLD,
                            rank=rank)
    try:
        mesh = make_mesh(device="cpu")
        out = _run_programs(mesh)
        pd = pose_detector_from_state(*state, model_points=POSE_POINTS, mesh=mesh,
                                      device="cpu")
        depths, rgbs = frames
        K = scenes.K_DEFAULT
        out["poses"] = _pose_fields(pd.detect_fused_batch(depths, K, rgbs))
        out["poses_odd"] = _pose_fields(pd.detect_fused_batch(depths[:-1], K, rgbs[:-1]))
        out["programs"] = [k[-2] is not None for k in pd._cache if k[0] == "prog"]
        out["errors"] = _errors(mesh)
        out["subset"] = make_mesh(2, device="cpu").get_coordinate()
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's saved outputs, after one spawned world of four."""
    tmp = tmp_path_factory.mktemp("world")
    state = _pose_state()
    frames = _pose_frames()
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(tmp), state, frames), nprocs=WORLD, join=False,
        start_method="spawn")
    deadline = time.time() + 600
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the spawned world did not finish in 600 s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], state, frames


@pytest.fixture(scope="module")
def single():
    """The same programs on one process."""
    return _run_programs()


# ----------------------------------------------------------------------
# the mesh and the merge, in this process
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_equals_reference(n):
    from object_detector_6d_tpu.parallel.sharding import make_mesh as ref_make_mesh

    assert mesh_shape(n) == ref_make_mesh(n).devices.shape


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        make_mesh(1, device="cpu")


def _shards(rng, tp, K):
    """[tp, 6, K+1] shard records as a shard's top-K leaves them: raw scores
    (row 5) descending with ties, -1 in the empty slots after them."""
    out = np.zeros((tp, 6, K + 1), np.float32)
    for s in range(tp):
        n = rng.randint(0, K + 1)
        out[s, :5, :K] = rng.randint(0, 100, (5, K))
        out[s, 5, :K] = -1
        out[s, 5, :n] = np.sort(rng.randint(0, 4, n))[::-1]
        out[s, :, K] = rng.randint(0, 3 * K)
    return out


@pytest.mark.parametrize("tp,K", [(2, 4), (4, 4), (2, 16), (4, 8)])
def test_merge_equals_reference(tp, K):
    """merge_shard_candidates, port against reference, bitwise; the port's
    batched form ([tp, b, 6, K+1]) equals it frame by frame."""
    import jax.numpy as jnp

    from object_detector_6d_tpu.match import program as ref_mp

    rng = np.random.RandomState(tp * 100 + K)
    frames = np.stack([_shards(rng, tp, K) for _ in range(3)], 1)  # [tp, 3, 6, K+1]
    got = mp.merge_shard_candidates(torch.as_tensor(frames), K).numpy()
    for b in range(frames.shape[1]):
        want = np.asarray(ref_mp.merge_shard_candidates(jnp.asarray(frames[:, b]), K))
        np.testing.assert_array_equal(mp.merge_shard_candidates(
            torch.as_tensor(frames[:, b]), K).numpy(), want)
        np.testing.assert_array_equal(got[b], want)


# ----------------------------------------------------------------------
# the world of four
# ----------------------------------------------------------------------

def test_every_rank_returns_the_whole_batch(world, single):
    ranks = world[0]
    for key in ("match", *FORMS):
        for r in ranks[1:]:
            a, b = ranks[0][key], r[key]
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=key)
        lead = (ranks[0][key][0] if isinstance(ranks[0][key], tuple) else ranks[0][key]).shape[0]
        assert lead == B, key


def test_sharded_match_equals_single_process(world, single):
    got, want = world[0][0]["match"], single["match"]
    assert got.shape == (B, 5, 2 * TP + 1)
    for row in (0, 1, 3, 4):
        assert torch.equal(got[:, row], want[:, row]), row
    torch.testing.assert_close(got[:, 2], want[:, 2], atol=1e-4, rtol=0)
    assert torch.equal(got[:, :, -1], want[:, :, -1])


def test_sharded_match_equals_reference_mesh(world):
    """The port's sharded match record against the JAX package's mesh
    program on make_mesh(4) (frames over data, templates over model): every
    row where the reference defines it (its CPU conv path sweeps the invalid
    slots too), the template id and keep of every slot, the overflow count."""
    import jax.numpy as jnp

    from object_detector_6d_tpu.data.synthetic import synthetic_bank as ref_synthetic_bank
    from object_detector_6d_tpu.match import program as ref_mp
    from object_detector_6d_tpu.parallel.sharding import make_mesh as ref_make_mesh

    _, bank, bgrs, deps, _ = _bank_and_frames()
    det = ref_synthetic_bank(n_classes=2, per_class=2 * TP, bbox_px=40, seed=0)
    ref_bank = ref_mp.pack_bank(det.class_templates, 2, 2, t0=det.t_at_level[0],
                                t1=det.t_at_level[1], pad_to=TP)
    assert ref_bank.class_ids == bank.class_ids
    prog = ref_mp.make_match_program(
        det.modality_names, det.t_at_level, (H, W), det.dn_params, det.cg_params,
        max_candidates=2 * TP, max_dr=((ref_bank.max_dr // 16) + 1) * 16,
        refine_impl="conv", batch=B, mesh=ref_make_mesh(WORLD))
    want = np.asarray(prog(
        (jnp.asarray(bgrs), jnp.asarray(deps)), ref_bank.kernels_low, ref_bank.kernels_dec,
        (ref_bank.feat_plane, ref_bank.feat_dr, ref_bank.feat_dc, ref_bank.feat_n),
        jnp.asarray(ref_bank.nfeat[0]), jnp.asarray(ref_bank.nfeat[1]),
        jnp.asarray(ref_bank.sizes[0]), jnp.asarray(ref_bank.sizes[1]),
        jnp.float32(THRESHOLD)))
    got = world[0][0]["match"].numpy()
    valid = want[:, 4, :-1] > 0
    assert valid.any()
    for row in (0, 1):
        np.testing.assert_array_equal(got[:, row, :-1][valid], want[:, row, :-1][valid])
    np.testing.assert_allclose(got[:, 2, :-1][valid], want[:, 2, :-1][valid], atol=1e-4)
    for row in (3, 4):
        np.testing.assert_array_equal(got[:, row, :-1], want[:, row, :-1])
    np.testing.assert_array_equal(got[:, :, -1], want[:, :, -1])


def _raw(out, form):
    """(packed, poses, res, keep) of one form's output."""
    if form == "flat":
        return tuple(torch.as_tensor(a) for a in dp_mod.unflatten_outputs(out.numpy(), 2 * TP))
    return out


@pytest.mark.parametrize("form", ["raw", "raw_compact_window", "flat"])
def test_sharded_detect_equals_single_process(world, single, form):
    """The raw and flat forms: every fine-phase branch (all lanes, and the
    compaction with windowed association) under the mesh."""
    packed1, poses1, res1, keep1 = _raw(single[form], form)
    packed2, poses2, res2, keep2 = _raw(world[0][0][form], form)
    assert torch.equal(packed1, packed2)
    assert torch.equal(keep1, keep2)
    assert keep1.any()
    fin = torch.isfinite(res1)
    assert torch.equal(fin, torch.isfinite(res2))
    torch.testing.assert_close(res2[fin], res1[fin], atol=1e-5, rtol=0)
    torch.testing.assert_close(poses2, poses1, atol=2e-3, rtol=0, equal_nan=True)


def test_sharded_detect_nms_equals_single_process(world, single):
    K_cap = 2 * TP
    s1, raw1, pass1 = dp_mod.unflatten_cluster_outputs(single["nms"].numpy(), K_cap)
    s2, raw2, pass2 = dp_mod.unflatten_cluster_outputs(world[0][0]["nms"].numpy(), K_cap)
    np.testing.assert_array_equal(raw1, raw2)
    np.testing.assert_array_equal(pass1, pass2)
    assert (s1[..., 0] > 0).any(), "no cluster"
    for col in (0, 1, 3, 4, 5, 7):
        np.testing.assert_array_equal(s1[..., col], s2[..., col])
    np.testing.assert_allclose(s1[..., 2], s2[..., 2], atol=1e-4)
    np.testing.assert_allclose(s1[..., 6], s2[..., 6], atol=1e-5)
    np.testing.assert_allclose(s1[..., 8:], s2[..., 8:], atol=2e-3)


def _rot_deg(Ra, Rb):
    s = np.linalg.norm(Ra - Rb) / (2 * np.sqrt(2))
    return float(np.degrees(2 * np.arcsin(min(1.0, s))))


def _same_poses(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(c, t) for c, t, _, _ in g] == [(c, t) for c, t, _, _ in w]
        for (_, _, pg, _), (_, _, pw, _) in zip(g, w):
            assert np.abs(pg[:3, 3] - pw[:3, 3]).max() <= 1e-3
            assert _rot_deg(pg[:3, :3], pw[:3, :3]) <= 0.5


def test_pose_detector_mesh_equals_single_process(world):
    """PoseDetector(mesh=) from one pose_detector_from_state on every rank:
    the sharded batch, and a batch that does not divide the data axis
    (unsharded on every rank), equal the single-process detector."""
    ranks, state, (depths, rgbs) = world
    pd = pose_detector_from_state(*state, model_points=POSE_POINTS, device="cpu")
    want = _pose_fields(pd.detect_fused_batch(depths, scenes.K_DEFAULT, rgbs))
    assert any(want), "the frames gave no detection"
    for r in ranks:
        _same_poses(r["poses"], want)
        _same_poses(r["poses_odd"], want[:-1])
        # one sharded program (the even batch), one unsharded (the odd one)
        assert sorted(r["programs"]) == [False, True]


def test_mesh_errors(world):
    errors = world[0][0]["errors"]
    assert "needs 8 ranks" in errors["make_mesh(8)"]
    assert "model axis" in errors["max_candidates"]
    assert "fine_compact" in errors["fine_compact"]
    assert "batch" in errors["batch=None"]
    assert "mesh of 'cpu'" in errors["mesh device"]


def test_make_mesh_on_fewer_ranks_than_the_world(world):
    """make_mesh(2) in the world of four: ranks 0 and 1 form (1, 2), the
    others stay out of it."""
    assert [r["subset"] for r in world[0]] == [(0, 0), (0, 1), None, None]
