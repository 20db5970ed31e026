"""A lane-level numpy model of kernel K2's walk (csrc/dn_quantize.cu)
against its plain twin ``dn_quantize_plain``, bit for bit.

The CUDA kernel runs only on a card. What can go wrong in it without a
card to say so is its bookkeeping: which lane holds which column, the
shuffles that fetch the columns 5 to the left and right, the slots of
the 11-row depth ring and the 5-row one-hot ring, the warm-up steps of a
strip, the packed 4-bit and 8-bit count fields and the find-first-set
that reads the median off them. The model below repeats that bookkeeping
step for step, 32 lanes at a time, with the constants of the source; the
float steps are numpy float32 operations, each rounded once, as the
kernel's ``__f*_rn`` intrinsics.
"""

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.ops.quantize import dn_quantize_plain

torch.set_num_threads(1)

CPL, HALO, RING, MED = 4, 8, 5, 2
SW = 32 * CPL - 2 * HALO
DROWS, QROWS = 2 * RING + 1, 2 * MED + 1
U32 = np.uint32
LANES = np.arange(32)


def _shfl_down(v, k):
    src = LANES + k
    return np.where(src < 32, v[np.minimum(src, 31)], v)


def _shfl_up(v, k):
    src = LANES - k
    return np.where(src >= 0, v[np.maximum(src, 0)], v)


def _shift5(v):
    """v [32, 4] -> the values 5 columns to the left and to the right."""
    r = np.stack([_shfl_down(v[:, 1], 1), _shfl_down(v[:, 2], 1),
                  _shfl_down(v[:, 3], 1), _shfl_down(v[:, 0], 2)], 1)
    left = np.stack([_shfl_up(v[:, 3], 2), _shfl_up(v[:, 0], 1),
                     _shfl_up(v[:, 1], 1), _shfl_up(v[:, 2], 1)], 1)
    return left, r


def _gate(v, dc, thr):
    delta = (v.astype(U32) - dc.astype(U32)).astype(np.int32)
    absd = np.where(delta < 0, (U32(0) - delta.astype(U32)).astype(np.int32), delta)
    f = absd < thr
    return f.astype(U32), np.where(f, delta.astype(U32), U32(0))


def _float2int_rz(x):
    x = np.nan_to_num(x, nan=0.0, posinf=2.0**31 - 1, neginf=-2.0**31)
    return np.trunc(np.clip(x, -2.0**31, 2.0**31 - 1)).astype(np.int64).astype(np.int32)


def _normal_word(interior, dc, ul, uc, ur, ml, mr, dl, dm, dr, dist_thr, diff_thr):
    ful, gul = _gate(ul, dc, diff_thr)
    fuc, guc = _gate(uc, dc, diff_thr)
    fur, gur = _gate(ur, dc, diff_thr)
    fml, gml = _gate(ml, dc, diff_thr)
    fmr, gmr = _gate(mr, dc, diff_thr)
    fdl, gdl = _gate(dl, dc, diff_thr)
    fdm, gdm = _gate(dm, dc, diff_thr)
    fdr, gdr = _gate(dr, dc, diff_thr)
    corners = ful + fur + fdl + fdr
    A0 = U32(25) * (corners + fml + fmr)
    A3 = U32(25) * (corners + fuc + fdm)
    A1 = U32(25) * (ful + fdr - fur - fdl)
    b0 = U32(5) * ((gur + gmr + gdr) - (gul + gml + gdl))
    b1 = U32(5) * ((gdl + gdm + gdr) - (gul + guc + gur))
    det = A0 * A3 - A1 * A1
    ddx = A3 * b0 - A1 * b1
    ddy = A0 * b1 - A1 * b0
    f32 = np.float32
    nx = (U32(1150) * ddx).astype(np.int32).astype(f32)
    ny = (U32(1150) * ddy).astype(np.int32).astype(f32)
    nz = ((U32(0) - det) * dc.astype(U32)).astype(np.int32).astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = np.sqrt(nx * nx + ny * ny + nz * nz)
        inv = f32(1.0) / norm
        vx = _float2int_rz(nx * inv * f32(10.0) + f32(10.0))
        vy = _float2int_rz(ny * inv * f32(10.0) + f32(10.0))
    fcx = (vx - 10).astype(f32)
    fcy = (vy - 10).astype(f32)
    tan22 = f32(0.41421356)
    acx, acy = np.abs(fcx), np.abs(fcy)
    horiz = acy <= tan22 * acx
    vert = acx <= tan22 * acy
    bin_h = np.where(fcx >= 0, 0, 4)
    bin_v = np.where(fcy >= 0, 2, 6)
    bin_d = np.where(fcy >= 0, np.where(fcx >= 0, 1, 3), np.where(fcx >= 0, 7, 5))
    bins = np.where(horiz, bin_h, np.where(vert, bin_v, bin_d))
    valid = interior & (dc < dist_thr) & (norm > 0)
    return np.where(valid, U32(1) << (4 * bins).astype(U32), U32(0))


def _median_code(lo, hi):
    ones = U32(0x01010101)
    pairs = (lo + hi) * ones
    zeros = U32(25) - (pairs >> U32(24))
    run_odd = pairs + zeros * ones
    run_even = run_odd - hi
    ge_even = (run_even + U32(0x73737373)) & U32(0x80808080)
    ge_odd = (run_odd + U32(0x73737373)) & U32(0x80808080)
    ge = (ge_even >> U32(1)) | ge_odd
    p = np.array([(int(g) & -int(g)).bit_length() - 1 for g in ge])  # __ffs - 1
    code = np.left_shift(1, np.maximum(2 * (p >> 3) + (p & 1), 0))
    return np.where(zeros >= 13, 0, code).astype(np.uint8)


def _walk_strip(depth, out, x0, y0, rh, dist_thr, diff_thr):
    """One warp: rh output rows of the 112-column strip at x0."""
    H, W = depth.shape
    cols = x0 - HALO + CPL * LANES[:, None] + np.arange(CPL)[None, :]  # [32, 4]
    in_frame = (cols >= 0) & (cols < W)
    col_interior = (cols >= RING) & (cols < W - RING - 1)
    col_out = (LANES >= HALO // CPL) & (LANES < 32 - HALO // CPL) & (cols[:, 0] < W)
    y_end = min(y0 + rh, H)

    def load_row(y):
        if y < 0 or y >= H:
            return np.zeros((32, CPL), np.int32)
        return np.where(in_frame, depth[y][np.clip(cols, 0, W - 1)], 0).astype(np.int32)

    dring = np.zeros((DROWS, 32, CPL), np.int32)
    qring = np.zeros((QROWS, 32, CPL), U32)
    vs = np.zeros((32, CPL), U32)
    dslot = qslot = 0
    for yi in range(y0 - RING - MED, y_end + RING + MED):
        dn = load_row(yi)
        dring[dslot] = dn
        yq = yi - RING
        if yq >= y0 - MED:
            w = np.zeros((32, CPL), U32)
            if RING <= yq < H - RING - 1:
                up = dring[dslot + 1 if dslot + 1 < DROWS else 0]
                mid = dring[dslot + 6 if dslot + 6 < DROWS else dslot + 6 - DROWS]
                ul, ur = _shift5(up)
                ml, mr = _shift5(mid)
                dl, dr = _shift5(dn)
                w = _normal_word(col_interior, mid, ul, up, ur, ml, mr, dl, dn, dr,
                                 dist_thr, diff_thr)
            old = qring[qslot].copy()
            qring[qslot] = w
            vs = vs + w - old
            qslot = qslot + 1 if qslot + 1 < QROWS else 0
            yo = yq - MED
            if yo >= y0:
                s = np.stack([_shfl_up(vs[:, 2], 1), _shfl_up(vs[:, 3], 1), vs[:, 0],
                              vs[:, 1], vs[:, 2], vs[:, 3], _shfl_down(vs[:, 0], 1),
                              _shfl_down(vs[:, 1], 1)], 1)  # [32, 8]
                lo = s & U32(0x0F0F0F0F)
                hi = (s >> U32(4)) & U32(0x0F0F0F0F)
                cl = lo[:, 0:5].sum(1, dtype=U32)
                ch = hi[:, 0:5].sum(1, dtype=U32)
                code = [_median_code(cl, ch)]
                for c in range(1, CPL):
                    cl = cl + lo[:, c + 4] - lo[:, c - 1]
                    ch = ch + hi[:, c + 4] - hi[:, c - 1]
                    code.append(_median_code(cl, ch))
                code = np.stack(code, 1)
                store = col_out[:, None] & (cols < W)
                out[yo, cols[store]] = code[store]
        dslot = dslot + 1 if dslot + 1 < DROWS else 0


def walk(depth, rh, dist_thr=2000, diff_thr=50):
    H, W = depth.shape
    out = np.full((H, W), 255, np.uint8)  # every pixel must be written
    for x0 in range(0, W, SW):
        for y0 in range(0, H, rh):
            _walk_strip(depth, out, x0, y0, rh, dist_thr, diff_thr)
    return out


def _frame(H, W, kind, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    if kind == "surface":  # smooth slopes with steps: every bin, gated samples
        d = 900 + 3 * xx - 2 * yy + 40 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
        d = d + 120 * ((xx // 19 + yy // 13) % 3) + rng.randint(0, 4, (H, W))
        d[rng.rand(H, W) < 0.03] = 0
        return d.astype(np.int32)
    if kind == "noise":  # steps around the difference threshold
        return (1000 + rng.randint(-60, 61, (H, W))).astype(np.int32)
    if kind == "far":  # depths at and above the distance threshold
        return (1990 + rng.randint(0, 21, (H, W))).astype(np.int32)
    if kind == "wrap":  # values whose normal equations wrap modulo 2^32
        return rng.randint(-2**31, 2**31 - 1, (H, W), dtype=np.int64).astype(np.int32)
    if kind == "zero":
        return np.zeros((H, W), np.int32)
    return np.full((H, W), 1234, np.int32)  # constant


@pytest.mark.parametrize("H, W, rh, kind", [
    (40, 150, 20, "surface"),   # two strips, the second ragged; two row blocks
    (37, 113, 10, "surface"),   # one column past a strip; odd width (scalar paths)
    (33, 111, 40, "noise"),     # one column short of a strip; one block
    (30, 112, 10, "far"),
    (24, 30, 10, "wrap"),
    (24, 30, 7, "wrap"),
    (12, 40, 10, "surface"),    # H - 11 = 1 interior row
    (10, 40, 10, "surface"),    # H < 11: nothing valid
    (40, 9, 20, "surface"),     # W < 11
    (30, 225, 20, "constant"),
    (16, 16, 10, "zero"),
])
def test_walk_equals_twin(H, W, rh, kind):
    depth = _frame(H, W, kind)
    want = dn_quantize_plain(torch.as_tensor(depth[None]))[0].numpy()
    got = walk(depth, rh)
    assert (got != 255).all(), "a pixel was never written"
    np.testing.assert_array_equal(got, want)
    if kind in ("surface", "noise") and H > 16 and W > 16:
        assert len(np.unique(want)) >= 5, "the frame exercises too few bins"


def test_walk_equals_twin_other_thresholds():
    depth = _frame(36, 130, "surface", seed=3)
    want = dn_quantize_plain(torch.as_tensor(depth[None]), 1000, 8)[0].numpy()
    np.testing.assert_array_equal(walk(depth, 10, 1000, 8), want)
    assert (want > 0).any() and (want == 0).any()
