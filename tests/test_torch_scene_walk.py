"""A thread-level numpy model of kernel K5's blocks (csrc/fused_scene.cu)
against its plain twin ``FusedScene.plain``, bit for bit.

The CUDA kernel runs only on a card. What can go wrong in it without a
card to say so is its bookkeeping: which thread owns which pixel of which
tile, which halo entry and which extra row sum it also computes (every
entry of both shared tiles exactly once), the zero fill outside the
frame, the walk of a block over its group of G frames (B need not be a
multiple of G), the constants held across that walk, and the five-term
box sums, down the rows and then along the columns, each added in order
from its first term. The model below repeats that bookkeeping step for
step, one block's 256 threads at a time, with the constants of the
source; every float step is a numpy float32 operation, rounded once, as
the kernel's ``__f*_rn`` intrinsics, and the square root is numpy's,
correctly rounded as ``__fsqrt_rn`` and the twin's ``core/exact.py``
``sqrt_rn`` are.
"""

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.ops.geometry import FusedScene

torch.set_num_threads(1)

TX, TY, R, G = 32, 8, 2, 16
NT = TX * TY
CW, CH = TX + 2 * R, TY + 2 * R
NH = CW * CH - NT
NX = TY * 2 * R
F32 = np.float32
UNWRITTEN = F32(-7777.0)


def _sqrt(x):
    return np.sqrt(x)


def _comp_of(d, ray, rfx, rfy):
    """(cloud x, y, z, unit_ray * inv_r) of pixels inside the frame;
    an invalid pixel contributes ray * 0."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        z = d.astype(F32) * F32(0.001)
        xx = z * ray[0] * rfx
        yy = z * ray[1] * rfy
        rr = _sqrt(xx * xx + yy * yy + z * z)
        inv_r = np.where(d > 0, F32(1.0) / rr, F32(0.0))
        c = ray[2:5] * inv_r[None]
    return xx, yy, z, c


def _block(depth, rays, minv, rfx, rfy, out, bx, by, bz):
    B, H, W = depth.shape
    tid = np.arange(NT)
    tx, ty = tid % TX, tid // TX
    x0, y0 = bx * TX, by * TY
    b0, b1 = bz * G, min(bz * G + G, B)

    x, y = x0 + tx, y0 + ty
    inside = (x < W) & (y < H)
    xc, yc = np.minimum(x, W - 1), np.minimum(y, H - 1)
    ray = np.where(inside, rays[:, yc, xc], F32(0.0))    # [5, NT], held across frames
    m = np.where(inside, minv[:, yc, xc], F32(0.0))      # [9, NT]

    band = R * CW
    h = tid - 2 * band
    q = h % (2 * R)
    hy = np.where(tid < band, tid // CW,
                  np.where(tid < 2 * band, TY + R + (tid - band) // CW, R + h // (2 * R)))
    hx = np.where(tid < band, tid % CW,
                  np.where(tid < 2 * band, (tid - band) % CW, np.where(q < R, q, TX + q)))
    gy, gx = y0 + hy - R, x0 + hx - R
    halo = tid < NH
    halo_inside = halo & (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
    gyc, gxc = np.clip(gy, 0, H - 1), np.clip(gx, 0, W - 1)
    hray = np.where(halo_inside, rays[:, gyc, gxc], F32(0.0))

    ey, eq = tid // (2 * R), tid % (2 * R)
    ex = np.where(eq < R, eq, TX + eq)
    extra = tid < NX

    for b in range(b0, b1):
        comp = np.full((3, CH, CW), UNWRITTEN, F32)
        written = np.zeros((CH, CW), np.int64)
        d = np.where(inside, depth[b, yc, xc], 0)
        xx, yy, zz, c = _comp_of(d, ray, rfx, rfy)
        comp[:, ty + R, tx + R] = np.where(inside, c, F32(0.0))
        np.add.at(written, (ty + R, tx + R), 1)
        dh = np.where(halo_inside, depth[b, gyc, gxc], 0)
        hc = np.where(halo_inside, _comp_of(dh, hray, rfx, rfy)[3], F32(0.0))
        comp[:, hy[halo], hx[halo]] = hc[:, halo]
        np.add.at(written, (hy[halo], hx[halo]), 1)
        assert (written == 1).all(), "a tile entry written twice or never"
        # ---- barrier ----
        rows = np.full((3, TY, CW), UNWRITTEN, F32)
        written = np.zeros((TY, CW), np.int64)
        s = comp[:, ty, tx + R]
        for k in range(1, 2 * R + 1):
            s = s + comp[:, ty + k, tx + R]
        rows[:, ty, tx + R] = s
        np.add.at(written, (ty, tx + R), 1)
        s = comp[:, ey[extra], ex[extra]]
        for k in range(1, 2 * R + 1):
            s = s + comp[:, ey[extra] + k, ex[extra]]
        rows[:, ey[extra], ex[extra]] = s
        np.add.at(written, (ey[extra], ex[extra]), 1)
        assert (written == 1).all(), "a row sum written twice or never"
        # ---- barrier ----
        bs = rows[:, ty, tx]
        for k in range(1, 2 * R + 1):
            bs = bs + rows[:, ty, tx + k]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            n = np.stack([m[3 * i] * bs[0] + m[3 * i + 1] * bs[1] + m[3 * i + 2] * bs[2]
                          for i in range(3)])
            norm = _sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
            norm_ok = (norm > 0) & np.isfinite(norm)
            n = n / norm[None]
            dot = n[0] * ray[2] + n[1] * ray[3] + n[2] * ray[4]
        n = np.where(dot > 0, -n, n)
        vc = d > 0
        bad = ~vc | ~norm_ok
        nan = F32(np.nan)
        vals = [np.where(vc, xx, nan), np.where(vc, yy, nan), np.where(vc, zz, nan),
                np.where(bad, nan, n[0]), np.where(bad, nan, n[1]), np.where(bad, nan, n[2]),
                np.where(bad, F32(0.0), F32(1.0)), np.zeros(NT, F32)]
        for j, v in enumerate(vals):
            assert (out[b, j, y[inside], x[inside]] == UNWRITTEN).all(), "a pixel written twice"
            out[b, j, y[inside], x[inside]] = v[inside]


def scene(fs: FusedScene, depth: np.ndarray) -> np.ndarray:
    """Every block of the launch. depth int32 [B, H, W] -> [B, 8, H, W]."""
    B, H, W = depth.shape
    out = np.full((B, 8, H, W), UNWRITTEN, F32)
    rays, minv = fs.rays.numpy(), fs.minv.numpy()
    for bz in range(-(-B // G)):
        for by in range(-(-H // TY)):
            for bx in range(-(-W // TX)):
                _block(depth, rays, minv, F32(fs.rfx), F32(fs.rfy), out, bx, by, bz)
    assert not (out == UNWRITTEN).any(), "a pixel was never written"
    return out


def _depth(rng, B, H, W):
    yy, xx = np.mgrid[0:H, 0:W]
    d = 900 + 3 * xx + 2 * yy + 40 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    d = np.broadcast_to(d, (B, H, W)) + rng.randint(0, 30, (B, H, W))
    d[:, H // 3:H // 2, W // 3:W // 2] = 0     # a hole: invalid pixels inside the boxes
    d[rng.rand(B, H, W) < 0.02] = 0
    d[:, :, W - W // 6:] = 2400
    d[B - 1, : H // 4] = -5                    # negative depth is invalid too
    return d.astype(np.int32)


# one pixel; smaller than a tile; one tile exactly and one row / column
# past it; several tiles with ragged edges; B of 1, below, at, one past and
# not a multiple of the frame group
@pytest.mark.parametrize("B, H, W", [
    (1, 1, 1), (2, 7, 9), (3, 37, 90), (9, 8, 32), (1, 9, 33), (16, 16, 64), (10, 5, 70),
    (2, 48, 64), (17, 3, 3), (1, 20, 29), (3, 2, 36), (2, 12, 31), (35, 4, 5)])
def test_blocks_equal_twin(B, H, W):
    K = np.array([[70.0, 0.0, W / 2 + 0.3], [0.0, 71.0, H / 2 - 0.4], [0.0, 0.0, 1.0]])
    fs = FusedScene(H, W, K, device="cpu")
    depth = _depth(np.random.RandomState(B + H + W), B, H, W)
    want = fs.plain(torch.as_tensor(depth)).numpy()
    got = scene(fs, depth)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.view(np.int32)[~np.isnan(want)],
                                  want.view(np.int32)[~np.isnan(want)])
    if H > 10 and W > 10:
        assert np.isfinite(want[:, 3]).any() and np.isnan(want[:, 3]).any()


def test_blocks_equal_twin_at_the_camera_of_the_main_path():
    """The detect benchmark's intrinsics at a cut-down frame (the tile
    grid's ragged right edge), all-invalid and all-valid frames included."""
    K = np.array([[572.4114, 0.0, 45.3], [0.0, 573.57043, 30.7], [0.0, 0.0, 1.0]])
    H, W = 60, 90
    fs = FusedScene(H, W, K, device="cpu")
    depth = _depth(np.random.RandomState(0), 4, H, W)
    depth[1] = 0
    depth[2] = 1000
    want = fs.plain(torch.as_tensor(depth)).numpy()
    got = scene(fs, depth)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert np.isnan(want[1, :6]).all() and (want[1, 6] == 0).all()
    assert (want[2, 6, 5:-5, 5:-5] == 1).all()
