"""The port where its kernels' limits lie: templates near the frame size,
feature tables wider than a kernel launch stages (K4, K6) and spreads
wider than K3's (T > 16), against the JAX package and the plain twins.

Templates taller (wider) than the frame less two 8 * T0 = 40 px borders
put the refinement's base cell above (left of) the planes. The
reference's conv path cuts its window with ``dynamic_slice``, which
counts a negative start from the planes' end and clamps it into them;
the port's match program takes the same start (match/program.py
``anchors_stage``). The programs run at tests/test_sharding.py's setup:
120x160 frames of colour noise (the three BGR channels differ), B = 4,
threshold 60, 4 candidates, ``synthetic_bank(2, 4, bbox_px)``; plus a
bank of wide, short templates (only the column base leaves the planes)
and one of templates as large as the frame with features on their
corners, at a threshold low enough that every candidate is live, where
K4's wrapper checks that every live tile lies inside its plane.

Bounds: the match record's x, y and similarity equal on every slot that
holds a coarse candidate (slot k < the frame's count n_above; the
reference's conv path also sweeps the empty slots, the port sweeps no
feature there), the template id and keep of every slot and the overflow
count equal. The raw detect program at bbox_px 40 holds
tests/test_sharding.py's bounds (match arrays within 1e-4 where defined,
keep equal, residuals within 1e-5, poses within 2e-3) on an egg-crate
depth surface with patches of it as models, where ICP converges and
keeps lanes (on that test's noise depth no lane is kept, and on a plane
the lanes slide). The chunked sweeps equal one twin call bitwise, and a
spread over T equals the spread over T - 15 spread again over 16.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api import detect_program as ref_dp
from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.data.synthetic import synthetic_bank as ref_synthetic_bank
from object_detector_6d_tpu.match import program as ref_mp
from object_detector_6d_tpu.match import response as ref_response
from object_detector_6d_tpu.quant import features as ref_features
from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.core.config import ICPParams
from object_detector_6d_tpu_torch.data.synthetic import scattered_features, synthetic_bank
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.match.response import spread
from object_detector_6d_tpu_torch.ops import refine, response
from object_detector_6d_tpu_torch.quant.features import Feature, Template

torch.set_num_threads(1)

H, W, B = 120, 160, 4
K_CAP = 4
THRESHOLD = 60.0
BORDER = 40  # 8 * T0
K_SMALL = np.array([[140.0, 0, W / 2], [0, 140.0, H / 2], [0, 0, 1.0]])


# the detect scene: an egg-crate surface z = 1 m + A sin(2 pi x / L)
# sin(2 pi y / L), whose patches are models that ICP aligns without the
# sliding freedom of a plane
CRATE_A, CRATE_L = 0.015, 0.1


def _crate(x, y):
    return CRATE_A * np.sin(2 * np.pi * x / CRATE_L) * np.sin(2 * np.pi * y / CRATE_L)


def _frames(crate=False):
    """tests/test_sharding.py's colour-noise frames and noisy depth; with
    ``crate`` the depth is the egg-crate surface."""
    rng = np.random.RandomState(0)
    bgrs = rng.randint(0, 256, (B, H, W, 3), dtype=np.int64).astype(np.uint8)
    deps = (1000 + rng.randint(0, 400, (B, H, W))).astype(np.uint16)
    if crate:
        v, u = np.mgrid[0:H, 0:W]
        z = 1.0 + _crate((u - K_SMALL[0, 2]) / K_SMALL[0, 0], (v - K_SMALL[1, 2]) / K_SMALL[1, 1])
        deps[:] = np.round(z * 1000).astype(np.uint16)
    return bgrs, deps


def _crate_models(rng, nT, n):
    """[nT, n, 6] egg-crate patches (points about 0, normals toward the
    camera)."""
    x, y = rng.uniform(-0.05, 0.05, (2, nT, n))
    k = 2 * np.pi / CRATE_L
    gx = CRATE_A * k * np.cos(k * x) * np.sin(k * y)
    gy = CRATE_A * k * np.sin(k * x) * np.cos(k * y)
    nrm = np.stack([gx, gy, -np.ones_like(gx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([np.stack([x, y, _crate(x, y)], -1), nrm], -1).astype(np.float32)


def _sources(bgrs, deps):
    return [torch.as_tensor(bgrs), torch.as_tensor(deps.astype(np.int32))]


def _both_banks(pyramids, n_classes=2):
    """A port and a reference Detector holding the same template pyramids,
    given as [(w, h, level, [(x, y, label), ...]), ...] per template, in
    ``n_classes`` classes taken in turn."""
    port, ref = Detector(), RefDetector()
    for i, tps in enumerate(pyramids):
        port.add_synthetic_template(
            [Template(w, h, lvl, [Feature(*f) for f in fs]) for w, h, lvl, fs in tps],
            f"c{i % n_classes}")
        ref.add_synthetic_template(
            [ref_features.Template(w, h, lvl, [ref_features.Feature(*f) for f in fs])
             for w, h, lvl, fs in tps], f"c{i % n_classes}")
    return port, ref


def _pyramid(rng, w, h, n0=63):
    """Two modalities' scattered features at levels 0 and 1."""
    def feats(n, ww, hh, d):
        return [(f.x, f.y, f.label) for f in scattered_features(rng, n, ww, hh, d)]

    return [(w, h, 0, feats(n0, w, h, 6)), (w, h, 0, feats(n0, w, h, 6)),
            (w // 2, h // 2, 1, feats(n0 // 2, w // 2, h // 2, 4)),
            (w // 2, h // 2, 1, feats(n0 // 2, w // 2, h // 2, 4))]


def _corner_pyramid(w, h):
    """Features on the template's corners and edge midpoints, at both
    levels: the farthest tiles a template of this size sweeps."""
    def feats(ww, hh):
        pts = [(0, 0), (ww, 0), (0, hh), (ww, hh), (ww // 2, hh), (ww, hh // 2)]
        return [(x, y, i % 8) for i, (x, y) in enumerate(pts)]

    return [(w, h, 0, feats(w, h)), (w, h, 0, feats(w, h)),
            (w // 2, h // 2, 1, feats(w // 2, h // 2)),
            (w // 2, h // 2, 1, feats(w // 2, h // 2))]


def _case(name):
    """(port Detector, reference Detector, threshold) of a bank case."""
    if name.startswith("bbox"):
        b = int(name[4:])
        return (synthetic_bank(2, 4, bbox_px=b, seed=0),
                ref_synthetic_bank(2, 4, bbox_px=b, seed=0), THRESHOLD)
    rng = np.random.RandomState(3)
    if name == "wide":  # wider than W - 80, shorter than H - 80
        pyrs = [_pyramid(rng, int(rng.randint(W - 70, W - 50)), int(rng.randint(24, 34)))
                for _ in range(8)]
        return (*_both_banks(pyrs), THRESHOLD)
    # as large as the frame (and a little less), every candidate live
    sizes = [(W, H), (W - 3, H - 1), (W // 2, H), (W, H // 2)]
    return (*_both_banks([_corner_pyramid(w, h) for w, h in sizes]), -100.0)


def _port_match(det, bgrs, deps, threshold):
    bank = mp.pack_bank(det.class_templates, 2, 2, t0=5, t1=8)
    prog = mp.make_match_program(det.modality_names, det.t_at_level, (H, W),
                                 det.dn_params, det.cg_params, K_CAP)
    return bank, prog(_sources(bgrs, deps), *mp.bank_args(bank, "cpu"), threshold).numpy()


def _ref_args(ref_bank, bgrs, deps):
    return ((jnp.asarray(bgrs), jnp.asarray(deps)), ref_bank.kernels_low,
            ref_bank.kernels_dec,
            (ref_bank.feat_plane, ref_bank.feat_dr, ref_bank.feat_dc, ref_bank.feat_n),
            jnp.asarray(ref_bank.nfeat[0]), jnp.asarray(ref_bank.nfeat[1]),
            jnp.asarray(ref_bank.sizes[0]), jnp.asarray(ref_bank.sizes[1]))


def _ref_match(ref_det, bgrs, deps, threshold):
    bank = ref_mp.pack_bank(ref_det.class_templates, 2, 2, t0=5, t1=8)
    prog = ref_mp.make_match_program(
        ref_det.modality_names, ref_det.t_at_level, (H, W), ref_det.dn_params,
        ref_det.cg_params, max_candidates=K_CAP, max_dr=((bank.max_dr // 16) + 1) * 16,
        refine_impl="conv", batch=B)
    return np.asarray(prog(*_ref_args(bank, bgrs, deps), jnp.float32(threshold)))


def assert_match_equal(got, want, K):
    """Rows x, y, similarity on every slot that holds a coarse candidate,
    template id and keep on every slot, the overflow count."""
    live = np.arange(K)[None, :] < want[:, 0, -1:]
    assert live.any()
    for row in range(3):
        np.testing.assert_array_equal(got[:, row, :-1][live], want[:, row, :-1][live])
    np.testing.assert_array_equal(got[:, 3:5, :-1], want[:, 3:5, :-1])
    np.testing.assert_array_equal(got[:, :, -1], want[:, :, -1])
    return live


@pytest.mark.parametrize("case", ["bbox40", "bbox48", "wide", "frame"])
def test_match_equals_reference_conv_at_the_frame_edge(case):
    """Every case holds live slots whose template leaves the border: the
    base row or column below 0, taken as the reference's conv path takes
    it; the record equals the reference's."""
    det, ref_det, threshold = _case(case)
    bgrs, deps = _frames()
    bank, got = _port_match(det, bgrs, deps, threshold)
    live = assert_match_equal(got, _ref_match(ref_det, bgrs, deps, threshold), K_CAP)
    size = bank.sizes[0][got[:, 3, :-1].astype(np.int64)]  # [B, K, (w, h)]
    beyond = (size[..., 0] > W - 2 * BORDER) | (size[..., 1] > H - 2 * BORDER)
    assert (beyond & live).any(), "no live slot's template leaves the border"
    if case == "wide":
        assert not (size[..., 1] > H - 2 * BORDER).any()
    if case == "frame":  # every template, every candidate, every tile
        assert live.all() and (got[:, 4, :-1] > 0).all()


@pytest.mark.parametrize("H0,W0,widths,heights", [
    (120, 160, range(1, 161, 9), (1, 39, 41, 80, 119, 120)),
    (97, 131, range(1, 132, 10), (1, 16, 17, 60, 97)),
    (480, 640, (1, 559, 560, 561, 640), (1, 399, 401, 480)),
])
def test_every_tile_stays_inside_its_plane(H0, W0, widths, heights):
    """The argument of match/program.py ``anchors_stage``, on the program
    itself: templates of every size up to the frame's, one feature at
    (w, h) and one at (0, 0), and a threshold below any score, so that
    every template at every coarse position is a live candidate; K4's
    wrapper checks every live tile against its plane."""
    det = Detector()
    for w in widths:
        for h in heights:
            det.add_synthetic_template(
                [Template(w, h, 0, [Feature(w, h, 3)]), Template(w, h, 0, [Feature(0, 0, 5)]),
                 Template(w // 2, h // 2, 1, [Feature(w // 2, h // 2, 3)]),
                 Template(w // 2, h // 2, 1, [Feature(0, 0, 5)])], "c")
    bank = mp.pack_bank(det.class_templates, 2, 2)
    n = bank.num_templates * (H0 // 2 // 8) * (W0 // 2 // 8)
    prog = mp.make_match_program(det.modality_names, det.t_at_level, (H0, W0),
                                 det.dn_params, det.cg_params, n)
    rng = np.random.RandomState(0)
    bgrs = rng.randint(0, 256, (1, H0, W0, 3), dtype=np.int64).astype(np.uint8)
    deps = (1000 + rng.randint(0, 400, (1, H0, W0))).astype(np.int32)
    out = prog([torch.as_tensor(bgrs), torch.as_tensor(deps)], *mp.bank_args(bank, "cpu"),
               -200.0)
    assert int(out[0, 0, -1]) == n
    assert (out[0, 4, :-1] > 0).all()


@functools.lru_cache(maxsize=1)
def _detect_outputs():
    """The raw detect program, port and reference, at bbox_px 40 on the
    planar scene (tests/test_torch_sharding.py's models and depth)."""
    det = synthetic_bank(2, 4, bbox_px=40, seed=0)
    ref_det = ref_synthetic_bank(2, 4, bbox_px=40, seed=0)
    bgrs, deps = _frames(crate=True)
    bank = mp.pack_bank(det.class_templates, 2, 2)
    ref_bank = ref_mp.pack_bank(ref_det.class_templates, 2, 2)
    nT = bank.num_templates
    models = _crate_models(np.random.RandomState(0), nT, 64)
    anchors = np.zeros((nT, 3), np.float32)
    icp = ICPParams(iterations=9, num_levels=3)
    prog = dp.make_detect_program(
        det.modality_names, det.t_at_level, (H, W), det.dn_params, det.cg_params, K_SMALL,
        max_candidates=K_CAP, icp=icp, lift_window=48, batch=B, device="cpu")
    views = dp.PackedViews(torch.as_tensor(models), torch.as_tensor(anchors),
                           torch.full((nT, 2), 24, dtype=torch.int64),
                           torch.eye(4).repeat(nT, 1, 1), torch.ones(nT, dtype=torch.bool))
    got = prog(_sources(bgrs, deps), mp.bank_args(bank, "cpu"), views, THRESHOLD)
    ref_prog = ref_dp.make_detect_program(
        ref_det.modality_names, ref_det.t_at_level, (H, W), ref_det.dn_params,
        ref_det.cg_params, K_SMALL, max_candidates=K_CAP,
        max_dr=((ref_bank.max_dr // 16) + 1) * 16, refine_impl="conv", icp=icp,
        lift_window=48, batch=B)
    ref_views = ref_dp.PackedViews(
        jnp.asarray(models), jnp.asarray(anchors), jnp.asarray(np.full((nT, 2), 24, np.int32)),
        jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (nT, 1, 1))),
        jnp.asarray(np.ones(nT, bool)))
    want = ref_prog(*_ref_args(ref_bank, bgrs, deps), ref_views, jnp.float32(THRESHOLD))
    return [x.numpy() for x in got], [np.asarray(x) for x in want], bank


def test_raw_detect_equals_reference_at_bbox_40():
    (packed, poses, res, keep), (rpacked, rposes, rres, rkeep), bank = _detect_outputs()
    live = np.arange(K_CAP)[None, :] < rpacked[:, 0, -1:]
    for row in range(3):
        np.testing.assert_allclose(packed[:, row, :-1][live], rpacked[:, row, :-1][live],
                                   atol=1e-4, rtol=0)
    np.testing.assert_array_equal(packed[:, 3:5, :-1], rpacked[:, 3:5, :-1])
    np.testing.assert_array_equal(packed[:, :, -1], rpacked[:, :, -1])
    np.testing.assert_array_equal(keep, rkeep)
    assert keep.any()
    # those candidates' windows start from the planes' end (the reference's
    # dynamic_slice): they sweep the zero padding there and are not kept
    th = bank.sizes[0][packed[:, 3, :-1].astype(np.int64), 1]
    assert (live & (th > H - 2 * BORDER)).any(), "no live slot from beyond the border"
    fin = np.isfinite(rres)
    np.testing.assert_array_equal(np.isfinite(res), fin)
    np.testing.assert_allclose(res[fin], rres[fin], atol=1e-5, rtol=0)
    np.testing.assert_allclose(poses, rposes, atol=2e-3, rtol=0)


# ----------------------------------------------------------------------
# K4 and K6 over more than MAX_F features: chunks of the feature axis
# ----------------------------------------------------------------------

def _sweep_tables(rng, lead, F, P, hi_r, hi_c):
    plane = torch.as_tensor(rng.randint(0, P, lead + (F,)), dtype=torch.int32)
    r = torch.as_tensor(rng.randint(0, hi_r, lead + (F,)), dtype=torch.int32)
    c = torch.as_tensor(rng.randint(0, hi_c, lead + (F,)), dtype=torch.int32)
    nfeat = torch.as_tensor(rng.randint(0, F + 1, lead), dtype=torch.int32)
    nfeat.view(-1)[0] = F
    nfeat.view(-1)[-1] = 0
    return plane, r, c, nfeat


@pytest.mark.parametrize("chunk", [1, 7, 64, 99, 300])
def test_chunked_refine_sweep_equals_one_twin_call(chunk):
    """K4's chunks: the int32 sums of the chunks, bitwise those of one
    twin call over every feature, for chunk sizes that divide F, leave a
    partial last chunk, and exceed F."""
    rng = np.random.RandomState(chunk)
    Bn, P, Hp, Wp, Kn, F = 2, 6, 37, 45, 5, 300
    D = torch.as_tensor(rng.randint(-128, 128, (Bn, P, Hp, Wp)), dtype=torch.int8)
    plane, r0, c0, nfeat = _sweep_tables(rng, (Bn, Kn), F, P, Hp - 15, Wp - 15)
    calls = []

    def one(*t):
        calls.append(t[0].shape[-1])
        return refine.refine_sweep_plain(D, *t)

    got = refine.chunked_sweep(one, (plane, r0, c0), nfeat, chunk)
    assert torch.equal(got, refine.refine_sweep_plain(D, plane, r0, c0, nfeat))
    assert calls == ([F] if chunk >= F else [min(chunk, F - j * chunk)
                                              for j in range(-(-F // chunk))])


@pytest.mark.parametrize("chunk", [1, 16, 100, 256])
def test_chunked_coarse_sweep_equals_one_twin_call(chunk):
    """K6's chunks, with offsets that reach past the planes (read as 0)."""
    rng = np.random.RandomState(100 + chunk)
    Bn, P, Hp, Wp, nT, F, oh, ow = 2, 9, 13, 17, 3, 270, 11, 15
    D = torch.as_tensor(rng.randint(-128, 128, (Bn, P, Hp, Wp)), dtype=torch.int8)
    plane, dr, dc, nfeat = _sweep_tables(rng, (nT,), F, P, Hp + 3, Wp + 3)
    got = refine.chunked_sweep(lambda *t: refine.coarse_sweep_plain(D, *t, oh, ow),
                               (plane, dr, dc), nfeat, chunk)
    assert torch.equal(got, refine.coarse_sweep_plain(D, plane, dr, dc, nfeat, oh, ow))


def test_chunked_sweep_skips_chunks_without_features():
    """Chunks past every count are not swept; the first always is."""
    rng = np.random.RandomState(5)
    D = torch.as_tensor(rng.randint(-128, 128, (1, 3, 20, 20)), dtype=torch.int8)
    plane, r0, c0, _ = _sweep_tables(rng, (1, 4), 40, 3, 5, 5)
    for counts, n_calls in (((0, 0, 0, 0), 1), ((3, 10, 0, 1), 1), ((11, 0, 25, 2), 3)):
        nfeat = torch.tensor([counts], dtype=torch.int32)
        calls = []

        def one(*t):
            calls.append(int(t[-1].max()))
            return refine.refine_sweep_plain(D, *t)

        got = refine.chunked_sweep(one, (plane, r0, c0), nfeat, 10)
        assert len(calls) == n_calls
        assert torch.equal(got, refine.refine_sweep_plain(D, plane, r0, c0, nfeat))


# ----------------------------------------------------------------------
# K3 beyond T = 16
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _quantized():
    rng = np.random.RandomState(11)
    q = (1 << rng.randint(0, 8, (2, 45, 67))) * (rng.rand(2, 45, 67) < 0.3)
    return q.astype(np.uint8)


@pytest.mark.parametrize("t", range(17, 41))
def test_spread_composes(t):
    """spread(spread(q, t - 15), 16) == spread(q, t): what K3's wrapper
    launches on the card for a T above its 16."""
    q = torch.as_tensor(_quantized())
    assert torch.equal(spread(spread(q, t - response.MAX_T + 1), response.MAX_T),
                       spread(q, t))


@pytest.mark.parametrize("t", [20, 33])
def test_response_twin_beyond_max_t_equals_reference(t):
    """The twin at T = 20 (and 33) against the reference's
    response_maps(spread(q, T)), and the card's composition on the twin."""
    q = _quantized()
    got = response.response_spread_batched(torch.as_tensor(q), t).numpy()
    for b in range(len(q)):
        want = np.asarray(ref_response.response_maps(ref_response.spread(jnp.asarray(q[b]), t)))
        np.testing.assert_array_equal(got[b], want)
    composed = response.response_spread_plain(
        spread(torch.as_tensor(q), t - response.MAX_T + 1), response.MAX_T)
    np.testing.assert_array_equal(composed.numpy(), got)
