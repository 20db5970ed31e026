"""Each hand-written kernel against its plain twin, on a CUDA card.

Marked ``cuda``: every test skips without a card (decided inside the
fixture, never at import). Run them on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q``. The twins are
themselves held against the JAX package by the other test_torch_* files.
"""

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.ops import quantize, refine, response, select
from object_detector_6d_tpu_torch.ops.geometry import FusedScene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _depth(rng, B, H, W):
    yy, xx = np.mgrid[0:H, 0:W]
    d = 900 + 3 * xx + 2 * yy + 40 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    d = np.broadcast_to(d, (B, H, W)) + rng.randint(0, 30, (B, H, W))
    d[:, H // 3:H // 2, W // 3:W // 2] = 0
    d[:, :, -W // 6:] = 2400
    return torch.as_tensor(d.astype(np.int32))


@pytest.mark.parametrize("H,W", [(48, 64), (53, 71)])
def test_dn_quantize_kernel_equals_twin(dev, H, W):
    d = _depth(np.random.RandomState(0), 3, H, W).to(dev)
    got = quantize.dn_quantize_batched(d)
    torch.cuda.synchronize()
    assert torch.equal(got, quantize.dn_quantize_plain(d))


def _dn_equal(d, distance_threshold=2000, difference_threshold=50):
    got = quantize.dn_quantize_batched(d, distance_threshold, difference_threshold)
    torch.cuda.synchronize()
    want = quantize.dn_quantize_plain(d, distance_threshold, difference_threshold)
    assert torch.equal(got, want)
    return want


# a strip is 112 output columns (4 a lane, 16-byte loads when W % 4 == 0):
# one and two strips and their vector width either side; rows either side of
# the walk lengths (10 .. 120 rows a warp) and of the 11-row ring; W < 11,
# H < 11; 479x641; B = 1; the main path's shape
@pytest.mark.parametrize("B,H,W", [
    (2, 37, 108), (2, 37, 111), (2, 37, 112), (2, 37, 113), (2, 37, 116), (1, 23, 223),
    (1, 23, 224), (1, 23, 225), (1, 23, 228), (3, 19, 120), (1, 21, 124), (1, 20, 128),
    (1, 10, 64), (1, 11, 64), (1, 12, 64), (2, 13, 9), (2, 9, 13), (1, 40, 10),
    (1, 1, 1), (1, 12, 12), (1, 121, 40), (1, 119, 40), (2, 479, 641), (1, 480, 640),
    (32, 480, 640)])
def test_dn_quantize_kernel_shapes(dev, B, H, W):
    want = _dn_equal(_depth(np.random.RandomState(B + H + W), B, H, W).to(dev))
    if H > 16 and W > 40:
        assert len(torch.unique(want)) >= 5


def test_dn_quantize_kernel_zero_and_constant_frames(dev):
    assert not _dn_equal(torch.zeros((2, 40, 130), dtype=torch.int32, device=dev)).any()
    const = _dn_equal(torch.full((2, 40, 130), 1234, dtype=torch.int32, device=dev))
    assert const[:, 10:-10, 10:-10].any()  # a flat wall has a normal


@pytest.mark.parametrize("distance_threshold,difference_threshold",
                         [(2000, 50), (1000, 8), (2000, 1), (1, 50), (2000, 100000)])
def test_dn_quantize_kernel_at_its_thresholds(dev, distance_threshold, difference_threshold):
    """Depths at and above the distance threshold, steps at the difference
    threshold (the gate is a strict <)."""
    rng = np.random.RandomState(3)
    d = (distance_threshold - 3 + rng.randint(0, 6, (2, 45, 150))).astype(np.int32)
    steps = difference_threshold * rng.randint(-1, 2, (2, 45, 150)) + rng.randint(-1, 2, (2, 45, 150))
    d[:, :, 75:] = (900 + steps[:, :, 75:]).astype(np.int32)
    _dn_equal(torch.as_tensor(d, device=dev), distance_threshold, difference_threshold)


def test_dn_quantize_kernel_wrapping_equations(dev):
    """Depths over the whole int32 range: differences, sums and products of
    the normal equations wrap modulo 2^32, in the kernel as in the twin."""
    rng = np.random.RandomState(4)
    d = rng.randint(-2**31, 2**31 - 1, (2, 40, 130), dtype=np.int64).astype(np.int32)
    _dn_equal(torch.as_tensor(d, device=dev), 2**31 - 1, 2**31 - 1)
    big = (2**30 + rng.randint(-40, 41, (2, 40, 130))).astype(np.int32)
    _dn_equal(torch.as_tensor(big, device=dev), 2**31 - 1, 50)


def test_dn_quantize_kernel_other_dtypes_and_views(dev):
    """int16 frames and a non-contiguous view go through the wrapper's
    conversion; an unaligned int32 view takes the scalar loads."""
    rng = np.random.RandomState(5)
    d = _depth(rng, 2, 40, 132)
    got = quantize.dn_quantize_batched(d.to(torch.int16).to(dev))
    assert torch.equal(got, quantize.dn_quantize_plain(d.to(dev)))
    wide = _depth(rng, 2, 40, 140).to(dev)
    _dn_equal(wide[:, :, 3:135])
    flat = torch.zeros(2 * 40 * 132 + 1, dtype=torch.int32, device=dev)
    flat[1:] = d.to(dev).reshape(-1)
    _dn_equal(flat[1:].view(2, 40, 132))  # contiguous, 4 bytes off 16-byte alignment


def _response_equal(q, t):
    got = response.response_spread_batched(q, t)
    torch.cuda.synchronize()
    assert torch.equal(got, response.response_spread_plain(q, t))


def _onehot(rng, shape, density=0.3):
    q = (1 << rng.randint(0, 8, shape)) * (rng.uniform(size=shape) < density)
    return torch.as_tensor(q.astype(np.uint8))


# every T at 37x90 (W not a multiple of 4: the byte path); one strip of
# 128 columns and its vector width either side, on aligned and unaligned
# widths; W < T and H < T; 479x641; B = 1; the main path's shapes
@pytest.mark.parametrize("B,H,W,t", [(2, 37, 90, t) for t in range(1, 17)] + [
    (2, 37, 92, 5), (2, 37, 92, 13), (1, 9, 124, 8), (1, 9, 127, 8), (1, 9, 128, 8),
    (1, 9, 129, 8), (1, 9, 132, 5), (1, 9, 256, 16), (1, 9, 260, 16), (1, 70, 3, 5),
    (1, 3, 5, 8), (2, 3, 5, 8), (1, 5, 3, 16), (2, 479, 641, 5), (2, 479, 641, 8),
    (1, 480, 640, 5), (32, 480, 640, 5), (32, 240, 320, 8)])
def test_response_kernel_equals_twin(dev, B, H, W, t):
    rng = np.random.RandomState(H * W + t)
    _response_equal(_onehot(rng, (B, H, W)).to(dev), t)


@pytest.mark.parametrize("t", [1, 5, 8, 11])
def test_response_kernel_constant_frames(dev, t):
    """All-zero and all-0xFF frames, and one frame of each."""
    for fill in ((0, 0), (255, 255), (0, 255)):
        q = torch.stack([torch.full((33, 200), f, dtype=torch.uint8) for f in fill]).to(dev)
        _response_equal(q, t)


@pytest.mark.parametrize("W", [256, 255])
def test_response_kernel_every_byte_value(dev, W):
    """At T=1 the spread byte is the input byte: a frame holding every
    value 0..255 covers the whole response table."""
    q = torch.arange(256, dtype=torch.int32).to(torch.uint8)[:W].repeat(3, 1)
    _response_equal(torch.stack([q, q.flip(1)]).to(dev), 1)


def test_response_kernel_unaligned_input(dev):
    """A view one byte into its storage takes the byte path."""
    rng = np.random.RandomState(4)
    q = _onehot(rng, (2 * 24 * 64 + 1,)).to(dev)[1:].view(2, 24, 64)
    _response_equal(q, 5)


def test_refine_kernel_equals_twin(dev):
    rng = np.random.RandomState(3)
    B, P, Hp, Wp, K, F = 2, 7, 41, 53, 6, 9
    D = torch.as_tensor(rng.randint(0, 5, (B, P, Hp, Wp)).astype(np.int8), device=dev)
    plane = torch.as_tensor(rng.randint(0, P, (B, K, F)), dtype=torch.int32, device=dev)
    r0 = torch.as_tensor(rng.randint(0, Hp - 15, (B, K, F)), dtype=torch.int32, device=dev)
    c0 = torch.as_tensor(rng.randint(0, Wp - 15, (B, K, F)), dtype=torch.int32, device=dev)
    nfeat = torch.as_tensor(rng.randint(0, F + 1, (B, K)), dtype=torch.int32, device=dev)
    got = refine.refine_sweep_batched(D, plane, r0, c0, nfeat)
    torch.cuda.synchronize()
    assert torch.equal(got, refine.refine_sweep_plain(D, plane, r0, c0, nfeat))


# a tile is 32 x 8 pixels and a block walks over 8 frames: one pixel; less
# than a tile; one column / row past a tile; 480x29; 479x641; the main
# path's frame; B of 1, 3, 9 (one past a frame group) and 32
@pytest.mark.parametrize("B,H,W", [
    (2, 48, 64), (2, 37, 90), (1, 1, 1), (3, 7, 9), (9, 9, 33), (1, 480, 29), (3, 479, 641),
    (9, 16, 64), (1, 480, 640), (32, 480, 640)])
def test_fused_scene_kernel_equals_twin(dev, B, H, W):
    K = np.array([[70.0, 0.0, W / 2 + 0.3], [0.0, 71.0, H / 2 - 0.4], [0.0, 0.0, 1.0]])
    if H >= 479:  # the detect benchmark's camera
        K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])
    fs = FusedScene(H, W, K, device=dev)
    d = _depth(np.random.RandomState(1), B, H, W)
    d[B - 1, : H // 4] = -5  # negative depth is invalid too
    d = d.to(dev)
    got = fs(d)
    torch.cuda.synchronize()
    want = fs.plain(d)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    if H > 10 and W > 10:
        assert torch.isfinite(want[:, 3]).any() and torch.isnan(want[:, 3]).any()


def test_fused_scene_kernel_all_invalid_and_flat_frames(dev):
    fs = FusedScene(40, 70, np.array([[70.0, 0.0, 35.3], [0.0, 71.0, 19.6], [0.0, 0.0, 1.0]]),
                    device=dev)
    d = torch.zeros((3, 40, 70), dtype=torch.int32, device=dev)
    d[1] = 1000
    d[2, ::2] = 1000
    got, want = fs(d), fs.plain(d)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.isnan(got[0, :6]).all() and (got[1, 6, 5:-5, 5:-5] == 1).all()


@pytest.mark.parametrize("B,H,W", [(3, 48, 64), (3, 37, 90), (1, 7, 9), (2, 479, 641),
                                   (1, 480, 29), (1, 480, 28), (1, 480, 57), (2, 65, 113),
                                   (1, 63, 40), (1, 1, 1), (3, 2, 70)])
def test_cg_quantize_kernel_equals_twin(dev, B, H, W):
    """Frames of every size class: smaller than one warp strip (28 output
    columns) or one row walk, one pixel either side of them, and the odd
    479x641; gray rows (tied channels) and noisy rows, at B = 1 and more."""
    rng = np.random.RandomState(H)
    yy, xx = np.mgrid[0:H, 0:W]
    base = ((xx // 6 + yy // 6) % 2) * 150
    bgr = np.stack([base[None] + rng.randint(0, 60, (B, H, W)) for _ in range(3)], -1)
    bgr[:, : H // 3 + 1] = bgr[:, : H // 3 + 1, :, :1]  # gray rows: tied channels
    bgr = torch.as_tensor(np.clip(bgr, 0, 255).astype(np.uint8), device=dev)  # [B, H, W, 3]
    for weak in (10.0, 40.0):
        got = quantize.cg_quantize_batched(bgr, weak)
        torch.cuda.synchronize()
        assert torch.equal(got, quantize.cg_quantize_plain(bgr, weak))


def _coarse_case(rng, dev, B, P, Hp, Wp, nT, F, nfeat, dr_range, dc_range):
    D = torch.as_tensor(rng.randint(-128, 128, (B, P, Hp, Wp)).astype(np.int8), device=dev)
    tab = [torch.as_tensor(rng.randint(lo, hi, (nT, F)), dtype=torch.int32, device=dev)
           for lo, hi in ((-1, P + 1), dr_range, dc_range)]  # some planes outside 0..P-1
    return D, *tab, torch.as_tensor(nfeat, dtype=torch.int32, device=dev)


def _coarse_equal(args, oh, ow):
    got = refine.coarse_sweep(*args, oh, ow)
    torch.cuda.synchronize()
    assert torch.equal(got, refine.coarse_sweep_plain(*args, oh, ow))
    return got


# int8 D over -128..127, negative dr / dc, planes outside 0..P-1, nfeat of
# 0 and F; grids larger than the plane (70x50 over 13x21: several row
# tiles, zero fill), wider than 32 lanes of 8 columns, one lane column;
# plane and grid widths of every residue mod 4 (the rows' alignment then
# changes from row to row); planes smaller than the careful sweep's reach
@pytest.mark.parametrize("Hp,Wp,oh,ow", [
    (13, 21, 10, 17), (13, 21, 70, 50), (30, 40, 30, 40), (31, 43, 29, 37), (11, 41, 10, 40),
    (11, 42, 10, 39), (11, 22, 10, 19), (11, 23, 10, 21), (11, 20, 10, 24), (5, 290, 3, 300),
    (40, 16, 33, 8), (1, 1, 1, 1), (2, 3, 4, 6)])
def test_coarse_sweep_kernel_equals_twin(dev, Hp, Wp, oh, ow):
    rng = np.random.RandomState(Hp * Wp + ow)
    args = _coarse_case(rng, dev, 2, 9, Hp, Wp, 5, 11, [11, 3, 0, 7, 1], (-3, 7), (-5, 9))
    got = _coarse_equal(args, oh, ow)
    if Hp > 4:
        assert (got < 0).any() and (got > 0).any()


def test_coarse_sweep_kernel_unaligned_tensors(dev):
    """D at every byte offset in its storage (the aligned words then start
    before the tensor: its first and last planes take the careful sweep)."""
    rng = np.random.RandomState(6)
    D, plane, dr, dc, nfeat = _coarse_case(rng, dev, 2, 3, 6, 10, 4, 8, [8, 8, 8, 8],
                                           (-2, 3), (-7, 8))
    plane[0, :], plane[1, :] = 0, 2
    dr[0, 0], dc[0, 0], dr[1, 0], dc[1, 0] = 0, -7, 5, 7
    for off in range(4):
        flat = torch.zeros(D.numel() + 4, dtype=torch.int8, device=dev)
        flat[off:off + D.numel()] = D.reshape(-1)
        _coarse_equal((flat[off:off + D.numel()].view(D.shape), plane, dr, dc, nfeat), 6, 10)


def test_coarse_sweep_kernel_256_features_of_extreme_bytes(dev):
    """F = MAX_F features of -128 and of 127: no carry between the packed
    16-bit fields."""
    F = refine.MAX_F
    D = torch.full((2, 3, 4, 12), 127, dtype=torch.int8, device=dev)
    D[:, 1] = -128
    D[:, 2, ::2, 1::2] = -128
    plane = torch.zeros((2, F), dtype=torch.int32, device=dev)
    plane[1] = 1
    plane[:, 200:] = 2
    zeros = torch.zeros((2, F), dtype=torch.int32, device=dev)
    nfeat = torch.tensor([F, F], dtype=torch.int32, device=dev)
    got = _coarse_equal((D, plane, zeros, zeros, nfeat), 4, 12)
    assert got.max() == 256 * 127 and got.min() == 256 * -128


def test_coarse_sweep_kernel_main_path_shape(dev):
    """D [32, 1024, 30, 40] with 122 templates of up to 62 features, bytes
    over the whole int8 range; and an empty launch."""
    rng = np.random.RandomState(7)
    args = _coarse_case(rng, dev, 32, 1024, 30, 40, 122, 62, rng.randint(0, 63, 122),
                        (0, 8), (0, 8))
    _coarse_equal(args, 30, 40)
    assert refine.coarse_sweep(*args, 0, 40).shape == (32, 122, 0, 40)


def _refine_case(rng, dev, B, P, Hp, Wp, K, F, nfeat):
    D = torch.as_tensor(rng.randint(-128, 128, (B, P, Hp, Wp)).astype(np.int8), device=dev)
    plane = torch.as_tensor(rng.randint(0, P, (B, K, F)), dtype=torch.int32, device=dev)
    r0 = torch.as_tensor(rng.randint(0, Hp - 15, (B, K, F)), dtype=torch.int32, device=dev)
    c0 = torch.as_tensor(rng.randint(0, Wp - 15, (B, K, F)), dtype=torch.int32, device=dev)
    return D, plane, r0, c0, torch.as_tensor(nfeat, dtype=torch.int32, device=dev)


def _refine_equal(D, plane, r0, c0, nfeat):
    got = refine.refine_sweep_batched(D, plane, r0, c0, nfeat)
    torch.cuda.synchronize()
    assert torch.equal(got, refine.refine_sweep_plain(D, plane, r0, c0, nfeat))


@pytest.mark.parametrize("Wp", [80, 53])
def test_refine_kernel_every_column_residue(dev, Wp):
    """c0 at every residue mod 16 (two aligned words, or one when c0 is a
    multiple of 16 on an aligned row), on aligned and odd plane widths."""
    rng = np.random.RandomState(Wp)
    B, P, Hp, K, F = 2, 3, 24, 16, 16
    D, plane, r0, c0, _ = _refine_case(rng, dev, B, P, Hp, Wp, K, F, np.zeros((B, K)))
    c0 = np.arange(F) + 16 * rng.randint(0, (Wp - 31) // 16 + 1, (B, K, F))
    c0[:, :, 0] = Wp - 16
    c0 = torch.as_tensor(c0, dtype=torch.int32, device=dev)
    nfeat = torch.full((B, K), F, dtype=torch.int32, device=dev)
    _refine_equal(D, plane, r0, c0, nfeat)


def test_refine_kernel_tiles_flush_with_the_far_edges(dev):
    """Tiles at r0 = Hp-16, c0 = Wp-16 of the last plane of the last frame:
    the last byte read is the tensor's last byte."""
    rng = np.random.RandomState(11)
    B, P, Hp, Wp, K, F = 2, 4, 19, 37, 3, 5
    D, plane, r0, c0, _ = _refine_case(rng, dev, B, P, Hp, Wp, K, F, np.full((B, K), F))
    plane[-1], r0[-1], c0[-1] = P - 1, Hp - 16, Wp - 16
    nfeat = torch.full((B, K), F, dtype=torch.int32, device=dev)
    _refine_equal(D, plane, r0, c0, nfeat)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 255, refine.MAX_F])
def test_refine_kernel_feature_counts(dev, n):
    """nfeat of 0, 1, around one round of the block's warps, and MAX_F,
    beside candidates with other counts; repeated features included."""
    rng = np.random.RandomState(n)
    B, P, Hp, Wp, K, F = 2, 5, 33, 41, 4, refine.MAX_F
    nfeat = rng.randint(0, F + 1, (B, K))
    nfeat[0, 0] = n
    nfeat[1, 3] = n
    D, plane, r0, c0, nfeat = _refine_case(rng, dev, B, P, Hp, Wp, K, F, nfeat)
    plane[0, 1, 1::2], r0[0, 1, 1::2], c0[0, 1, 1::2] = plane[0, 1, 0], r0[0, 1, 0], c0[0, 1, 0]
    _refine_equal(D, plane, r0, c0, nfeat)


def test_refine_kernel_main_path_shape(dev):
    """The two-modality main path's D [32, 200, 128, 256] with 16
    candidates of up to 63 features, response values 0..4."""
    rng = np.random.RandomState(32)
    B, P, Hp, Wp, K, F = 32, 200, 128, 256, 16, 63
    D = torch.as_tensor(rng.randint(0, 5, (B, P, Hp, Wp)).astype(np.int8), device=dev)
    _, plane, r0, c0, nfeat = _refine_case(rng, dev, B, P, 16, 16, K, F,
                                           rng.randint(0, F + 1, (B, K)))
    r0 = torch.as_tensor(rng.randint(0, 113, (B, K, F)), dtype=torch.int32, device=dev)
    c0 = torch.as_tensor(rng.randint(0, 241, (B, K, F)), dtype=torch.int32, device=dev)
    _refine_equal(D, plane, r0, c0, nfeat)


# ----------------------------------------------------------------------
# beyond a launch's limits: K4 and K6 over more than MAX_F features (one
# launch a chunk of MAX_F), K3 over a T above MAX_T (the plain spread
# over T - MAX_T + 1, then the kernel at MAX_T)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("F", [257, 600])
def test_refine_kernel_beyond_max_f_in_chunks(dev, F):
    """Bytes over the whole int8 range, counts of 0, F and in between:
    one launch a chunk up to the largest count, the sums the twin's."""
    rng = np.random.RandomState(F)
    B, P, Hp, Wp, K = 2, 5, 33, 41, 4
    nfeat = rng.randint(0, F + 1, (B, K))
    nfeat[0, 0], nfeat[1, 3] = F, 0
    args = _refine_case(rng, dev, B, P, Hp, Wp, K, F, nfeat)
    before = refine.refine_sweep_batched.launches
    _refine_equal(*args)
    assert refine.refine_sweep_batched.launches - before == -(-F // refine.MAX_F)


@pytest.mark.parametrize("F", [300, 600])
def test_coarse_kernel_beyond_max_f_in_chunks(dev, F):
    rng = np.random.RandomState(F)
    nfeat = rng.randint(0, F + 1, 5)
    nfeat[2] = F
    args = _coarse_case(rng, dev, 2, 9, 30, 40, 5, F, nfeat, (-2, 8), (-2, 8))
    before = refine.coarse_sweep.launches
    _coarse_equal(args, 30, 40)
    assert refine.coarse_sweep.launches - before == -(-F // refine.MAX_F)


@pytest.mark.parametrize("B,H,W,t", [(2, 37, 90, 17), (2, 37, 90, 33), (1, 9, 5, 40),
                                     (32, 240, 320, 20)])
def test_response_kernel_beyond_max_t(dev, B, H, W, t):
    rng = np.random.RandomState(H * W + t)
    _response_equal(_onehot(rng, (B, H, W)).to(dev), t)


# K7: the exact top-K of the thresholded grid (values in [-1, vmax])
SEL_TILE = select.TILE
SEL_VMAX = 248  # 4 x 62 features: the benchmark cell's coarse tables


def _sparse_grid(rng, B, N, n_above, lo, hi):
    """-1 grids with n_above[b] cells of values in [lo, hi] at random places."""
    x = np.full((B, N), -1, np.int32)
    for b in range(B):
        x[b, rng.choice(N, n_above[b], replace=False)] = rng.randint(lo, hi + 1, n_above[b])
    return x


def _select_equal(x, k, vmax):
    """K7 on the card == the CPU twin (the stable sort), bitwise; one launch."""
    before = select.select_topk.launches
    got_v, got_i = select.select_topk(x, k, vmax)
    torch.cuda.synchronize()
    assert select.select_topk.launches - before == (1 if x.shape[0] and k else 0)
    want_v, want_i = select.select_topk(x.cpu(), k, vmax)
    assert got_v.dtype == torch.int32 and got_i.dtype == torch.int64
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)


def _select_cases():
    rng = np.random.RandomState(11)
    T = SEL_TILE
    yield "invalid", np.full((3, 2 * T + 1000), -1, np.int32), 64, SEL_VMAX
    yield "fewer than K", _sparse_grid(rng, 3, 3 * T + 77, [0, 5, 63], 150, SEL_VMAX), 64, SEL_VMAX
    yield "exactly K", _sparse_grid(rng, 2, 2 * T + 4, [64, 64], 150, 160), 64, SEL_VMAX
    yield "ties past K", _sparse_grid(rng, 2, 3 * T, [300, 200], 190, 200), 64, SEL_VMAX
    for value in (-1, 0, 37, SEL_VMAX):
        yield f"all {value}", np.full((2, T + 5), value, np.int32), 64, SEL_VMAX
    at_vmax = _sparse_grid(rng, 2, 2 * T + 12, [40, 90], SEL_VMAX - 1, SEL_VMAX)
    at_vmax[0, :3] = SEL_VMAX
    yield "at vmax", at_vmax, 64, SEL_VMAX
    for N in (T - 1, T + 1, 3 * T + 1024 + 3, 1031, 65, 64):
        x = rng.randint(-1, 6, (2, N)).astype(np.int32)
        x[1] = np.where(rng.uniform(size=N) < 0.98, -1, x[1])
        yield f"N={N}", x, 64, 20
    N = 2 * T + 500
    yield "frames differ", np.stack([
        np.full(N, -1, np.int32), _sparse_grid(rng, 1, N, [30], 150, SEL_VMAX)[0],
        _sparse_grid(rng, 1, N, [500], 150, 170)[0],
        rng.randint(-1, SEL_VMAX + 1, N).astype(np.int32)]), 64, SEL_VMAX
    for k in (1, 7, 1024, 3 * T):
        yield f"K={k}", _sparse_grid(rng, 2, 3 * T, [k // 2, min(2 * k, 3 * T)], 10, 12), k, 12
    yield "2402 bins", rng.randint(-1, 2401, (3, 2 * T + 8)).astype(np.int32), 64, 2400
    yield "B=0", np.zeros((0, 100), np.int32), 4, 10
    yield "K=0", np.full((2, 100), -1, np.int32), 0, 10


@pytest.mark.parametrize("case", [c[0] for c in _select_cases()])
def test_select_topk_kernel_equals_twin(dev, case):
    _, x, k, vmax = next(c for c in _select_cases() if c[0] == case)
    _select_equal(torch.as_tensor(x, device=dev), k, vmax)


def test_select_topk_kernel_unaligned_rows(dev):
    """A view 4 bytes off 16-byte alignment and rows of N % 4 != 0 take the
    scalar loads."""
    rng = np.random.RandomState(12)
    x = _sparse_grid(rng, 2, 3 * SEL_TILE, [50, 80], 150, SEL_VMAX)
    flat = torch.full((x.size + 1,), -1, dtype=torch.int32, device=dev)
    flat[1:] = torch.as_tensor(x.reshape(-1), device=dev)
    _select_equal(flat[1:].view(x.shape), 64, SEL_VMAX)
    _select_equal(torch.as_tensor(x[:, :-3].copy(), device=dev), 64, SEL_VMAX)


def test_select_topk_kernel_cell_shape(dev):
    """[128, 1202 x 30 x 40]: the benchmark cell's grid, 28-55 candidates a
    frame, and two frames that overflow the 64 slots; against the twin's
    stable sort on the card."""
    rng = np.random.RandomState(13)
    B, N = 128, 1202 * 30 * 40
    x = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    for b in range(B):
        n = 300 if b in (5, 77) else rng.randint(28, 56)
        cells = torch.as_tensor(rng.choice(N, n, replace=False), device=dev)
        x[b, cells] = torch.as_tensor(rng.randint(150, 180, n), dtype=torch.int32, device=dev)
    got_v, got_i = select.select_topk(x, 64, SEL_VMAX)
    want_v, want_i = select.select_topk_plain(x, 64, SEL_VMAX)
    torch.cuda.synchronize()
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


def test_select_topk_launches_once_a_match_batch(dev):
    """make_match_program launches K7 once a batch, and its record equals
    the CPU's (the programs of tests/test_torch_tracing.py)."""
    from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank
    from object_detector_6d_tpu_torch.match import program as mp

    H, W = 120, 160
    det = synthetic_bank(2, 4, bbox_px=40, seed=0)
    bank = mp.pack_bank(det.class_templates, 2, 2, t0=5, t1=8)
    rng = np.random.RandomState(0)
    sources = [torch.as_tensor(rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)),
               torch.as_tensor((1000 + rng.randint(0, 400, (2, H, W))).astype(np.int32))]
    records = []
    for d in ("cpu", dev):
        prog = mp.make_match_program(det.modality_names, det.t_at_level, (H, W),
                                     det.dn_params, det.cg_params, 4)
        args = mp.bank_args(bank, d)
        before = select.select_topk.launches
        for _ in range(3):
            out = prog([s.to(d) for s in sources], *args, 60.0)
        records.append(out.cpu())
        assert select.select_topk.launches - before == (3 if d == dev else 0)
    assert torch.equal(records[0], records[1])
