"""A lane-level numpy model of kernel K6's sweep (csrc/coarse_sweep.cu)
against its plain twin ``coarse_sweep_plain``, bit for bit.

The CUDA kernel runs only on a card. What can go wrong in it without a
card to say so is its bookkeeping: which lane owns which output columns
and rows of which tile, the compaction of a template's table into the
fast and the careful list, the three aligned 32-bit words under a lane's
8-byte window and the two funnel shifts that cut the window out of them,
the byte masks of the zero fill, the packed 16-bit sums with their bias,
and the stores. The model below repeats that bookkeeping step for step,
32 lanes at a time, with the constants of the source. Its memory is the
tensor's bytes at a chosen misalignment between two runs of garbage: an
aligned load that holds no byte of the tensor fails the test (on the card
it could fault), and garbage that reached a sum would show.
"""

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.ops.refine import MAX_F, coarse_sweep_plain

torch.set_num_threads(1)

WARPS, NW, RP = 4, 2, 5
CPL = 4 * NW
FAR = -(1 << 28)
EDGE = 16
PAD = 64
U32 = np.uint32
LANES = np.arange(32)


class Memory:
    """The tensor's bytes at address ``PAD + mis``, garbage around them."""

    def __init__(self, D, mis, seed):
        self.t0 = PAD + mis
        self.t1 = self.t0 + D.size
        self.mem = np.random.RandomState(seed).randint(0, 256, self.t1 + PAD).astype(np.uint8)
        self.mem[self.t0:self.t1] = D.reshape(-1).view(np.uint8)

    def ldg32(self, addr, ok):
        """Aligned 32-bit loads of the lanes where ``ok``; 0 elsewhere."""
        out = np.zeros(32, U32)
        for lane in np.nonzero(ok)[0]:
            a = int(addr[lane])
            assert a % 4 == 0, "unaligned word load"
            assert a + 4 > self.t0 and a < self.t1, "a word that holds no byte of the tensor"
            out[lane] = int.from_bytes(self.mem[a:a + 4].tobytes(), "little")
        return out

    def ldg8(self, addr):
        assert self.t0 <= addr < self.t1, "a byte outside the tensor"
        return int(self.mem[addr])


def _byte_mask(lo, hi):
    lo = np.clip(lo, 0, 4)
    hi = np.clip(np.maximum(hi, lo), 0, 4)
    one = np.uint64(1)
    m = ((one << (8 * hi).astype(np.uint64)) - one) ^ ((one << (8 * lo).astype(np.uint64)) - one)
    return (m & np.uint64(0xFFFFFFFF)).astype(U32)


def _funnelshift_r(lo, hi, sh):
    both = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return ((both >> (sh & U32(31)).astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(U32)


def _add_bytes(v, lo, hi):
    lo += v & U32(0x00FF00FF)
    hi += (v >> U32(8)) & U32(0x00FF00FF)


def _stage(b, t, B, P, Hp, Wp, F, out_h, out_w, plane, dr, dc, nfeat):
    """The warp's compacted table: (fast list, careful list) of (off, dr, dc)."""
    n = min(max(int(nfeat[t]), 0), F)
    slots = [None] * MAX_F
    n_fast = n_slow = 0
    for f0 in range(0, n, 32):
        f = f0 + LANES
        inside = f < n
        fi = np.minimum(f, F - 1)
        p = np.where(inside, plane[t, fi], -1).astype(np.int64)
        fr = np.where(inside, dr[t, fi], 0).astype(np.int64)
        fc = np.where(inside, dc[t, fi], 0).astype(np.int64)
        live = (p >= 0) & (p < P) & (fr > -out_h) & (fr < Hp) & (fc > -out_w) & (fc < Wp)
        gp = b * P + p
        edge = live & ((gp * Hp * Wp < EDGE) | ((B * P - gp - 1) * Hp * Wp < EDGE))
        fast = live & ~edge
        for lane in LANES:
            if not live[lane]:
                continue
            if fast[lane]:
                slot = n_fast + int(fast[:lane].sum())  # popc(ballot & lanes below)
            else:
                slot = MAX_F - 1 - (n_slow + int(edge[:lane].sum()))
            assert slots[slot] is None, "two features in one slot"
            slots[slot] = (int((p[lane] * Hp + fr[lane]) * Wp + fc[lane]), int(fr[lane]),
                           int(fc[lane]))
        n_fast += int(fast.sum())
        n_slow += int(edge.sum())
    return slots[:n_fast], [slots[MAX_F - 1 - i] for i in range(n_slow)]


def sweep(D, plane, dr, dc, nfeat, out_h, out_w, mis=0, out_aligned=True):
    """Every warp of the launch, lane by lane. D int8 [B,P,Hp,Wp]."""
    B, P, Hp, Wp = D.shape
    nT, F = plane.shape
    assert F <= MAX_F
    out = np.full((B, nT, out_h, out_w), -(2 ** 31), np.int64)  # every output must be written
    if 0 in (B, nT, out_h, out_w):
        return out.astype(np.int32)
    mem = Memory(D, mis, seed=B + P + Hp + Wp)
    ncol = -(-out_w // CPL)
    LW = min(ncol, 32)
    RS = 32 // LW
    col_tiles = -(-ncol // LW)
    row_tiles = -(-out_h // (RS * RP))
    tiles = row_tiles * col_tiles
    n_warps = B * nT * tiles
    for w in range(-(-n_warps // WARPS) * WARPS):
        if w >= n_warps:
            continue
        tile, bt = w % tiles, w // tiles
        t, b = bt % nT, bt // nT
        fast, slow = _stage(b, t, B, P, Hp, Wp, F, out_h, out_w, plane, dr, dc, nfeat)

        fb = mem.t0 + b * P * Hp * Wp
        frame_mis = fb & 3
        fal = fb - frame_mis
        cw, rg = LANES % LW, LANES // LW
        c0 = ((tile % col_tiles) * LW + cw) * CPL
        has = (rg < RS) & (c0 < out_w)
        row = np.empty((RP, 32), np.int64)
        loff = np.empty((RP, 32), np.int64)
        for k in range(RP):
            r = (tile // col_tiles) * (RS * RP) + rg + RS * k
            row[k] = np.where(has & (r < out_h), r, FAR)
            loff[k] = np.where(row[k] == FAR, 0, r * Wp) + c0 + frame_mis

        lo = np.zeros((RP, NW, 32), U32)
        hi = np.zeros((RP, NW, 32), U32)
        for off, fr, fc in fast:
            cc = c0 + fc
            any_col = np.minimum(CPL, Wp - cc) > np.maximum(0, -cc)
            m = [_byte_mask(-cc - 4 * i, Wp - cc - 4 * i) for i in range(NW)]
            for k in range(RP):
                a = off + loff[k]
                ok = any_col & (row[k] + fr >= 0) & (row[k] + fr < Hp)
                words = [mem.ldg32(fal + (a & ~3) + 4 * i, ok) for i in range(NW)]
                words.append(mem.ldg32(fal + ((a + CPL - 1) & ~3), ok))
                sh = ((a << 3) & 0xFFFFFFFF).astype(U32)
                for i in range(NW):
                    raw = _funnelshift_r(words[i], words[i + 1], sh)
                    _add_bytes((raw & m[i]) ^ U32(0x80808080), lo[k, i], hi[k, i])
        for off, fr, fc in slow:
            for k in range(RP):
                row_ok = (row[k] + fr >= 0) & (row[k] + fr < Hp)
                for i in range(NW):
                    raw = np.zeros(32, U32)
                    for j in range(4):
                        c = c0 + 4 * i + j
                        for lane in np.nonzero(row_ok & (c + fc >= 0) & (c + fc < Wp))[0]:
                            byte = mem.ldg8(fb + off + int(row[k][lane]) * Wp + int(c[lane]))
                            raw[lane] |= U32(byte << (8 * j))
                    _add_bytes(raw ^ U32(0x80808080), lo[k, i], hi[k, i])

        bias = 128 * (len(fast) + len(slow))
        vec = out_w % 4 == 0 and out_aligned
        for k in range(RP):
            for lane in np.nonzero(row[k] != FAR)[0]:
                for i in range(NW):
                    l, h = int(lo[k, i, lane]), int(hi[k, i, lane])
                    v = [(l & 0xFFFF) - bias, (h & 0xFFFF) - bias, (l >> 16) - bias,
                         (h >> 16) - bias]
                    c = int(c0[lane]) + 4 * i
                    r = int(row[k][lane])
                    if vec and c < out_w:
                        assert c + 3 < out_w and (r * out_w + c) % 4 == 0
                        cols = range(4)
                    else:
                        cols = [j for j in range(4) if c + j < out_w]
                    for j in cols:
                        assert out[b, t, r, c + j] == -(2 ** 31), "an output written twice"
                        out[b, t, r, c + j] = v[j]
    assert (out != -(2 ** 31)).all(), "an output was never written"
    return out.astype(np.int32)


def _case(seed, B, P, Hp, Wp, nT, F, nfeat, dr_range, dc_range, values=(-128, 128)):
    rng = np.random.RandomState(seed)
    D = rng.randint(*values, (B, P, Hp, Wp)).astype(np.int8)
    plane = rng.randint(-1, P + 1, (nT, F)).astype(np.int32)  # some outside 0..P-1
    dr = rng.randint(*dr_range, (nT, F)).astype(np.int32)
    dc = rng.randint(*dc_range, (nT, F)).astype(np.int32)
    return D, plane, dr, dc, np.asarray(nfeat, np.int32)


def _equal(args, out_h, out_w, **kw):
    want = coarse_sweep_plain(*(torch.as_tensor(a) for a in args), out_h, out_w).numpy()
    np.testing.assert_array_equal(sweep(*args, out_h, out_w, **kw), want)
    return want


# plane and grid widths of every residue mod 4 (and mod 8, the lane's
# columns), at every misalignment of the tensor; negative dr / dc; planes
# outside 0..P-1; nfeat of 0 and F (and beyond F, below 0: clamped)
@pytest.mark.parametrize("Wp, out_w, mis", [
    (40, 40, 0), (41, 40, 1), (42, 39, 2), (43, 37, 3), (21, 17, 0), (21, 18, 1),
    (22, 19, 2), (23, 21, 3), (20, 24, 0), (9, 5, 1), (8, 8, 2), (7, 3, 3)])
def test_sweep_equals_twin_every_width_residue(Wp, out_w, mis):
    args = _case(Wp + out_w, 2, 6, 11, Wp, 5, 9, [9, 3, 0, 12, -2], (-4, 8), (-5, 9))
    want = _equal(args, 10, out_w, mis=mis)
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("out_h, out_w, Hp, Wp", [
    (30, 40, 30, 40),    # the main path's grid: one tile a (frame, template)
    (29, 37, 31, 43),    # the card check's odd plane
    (70, 50, 13, 21),    # a grid larger than the plane: several row tiles, zero fill
    (3, 300, 5, 290),    # more than 32 lane columns: two column tiles
    (33, 8, 40, 16),     # one lane column: 32 row groups
    (1, 1, 1, 1),        # planes smaller than the edge distance: every feature careful
    (4, 6, 2, 3),
])
def test_sweep_equals_twin_grids_and_planes(out_h, out_w, Hp, Wp):
    args = _case(out_h + Wp, 2, 4, Hp, Wp, 3, 7, [7, 0, 4], (-3, 8), (-3, 8))
    _equal(args, out_h, out_w, mis=out_h % 4)


def test_sweep_equals_twin_edge_planes_take_the_careful_list():
    """Features of the tensor's first and last plane, with windows that
    reach past both ends of the tensor, beside ordinary ones."""
    D, plane, dr, dc, nfeat = _case(5, 2, 3, 6, 10, 4, 8, [8, 8, 8, 8], (-2, 3), (-7, 8))
    plane[0, :] = 0
    plane[1, :] = 2
    plane[2, ::2] = 0
    dr[0, 0], dc[0, 0] = 0, -7   # frame 0, plane 0, row 0: the word before the tensor
    dr[1, 0], dc[1, 0] = 5, 7    # last plane, last row: the words past the tensor
    for mis in range(4):
        _equal((D, plane, dr, dc, nfeat), 6, 10, mis=mis)
    fast, slow = _stage(0, 0, 2, 3, 6, 10, 8, 6, 10, plane, dr, dc, nfeat)
    assert not fast and len(slow) == 8
    fast, slow = _stage(1, 0, 2, 3, 6, 10, 8, 6, 10, plane, dr, dc, nfeat)
    assert len(fast) == 8 and not slow


def test_sweep_equals_twin_256_features_of_extreme_bytes():
    """F = MAX_F features of -128 and of 127: the packed 16-bit fields hold
    256 x 255 without a carry into their neighbour."""
    B, P, Hp, Wp, nT, F = 1, 3, 4, 12, 2, MAX_F
    D = np.full((B, P, Hp, Wp), 127, np.int8)
    D[:, 1] = -128
    D[:, 2, ::2, 1::2] = -128
    plane = np.stack([np.zeros(F), np.ones(F)]).astype(np.int32)
    plane[:, 200:] = 2
    zeros = np.zeros((nT, F), np.int32)
    args = (D, plane, zeros, zeros, np.asarray([F, F], np.int32))
    want = _equal(args, Hp, Wp, mis=1)
    assert want.max() == 200 * 127 + 56 * 127 and want.min() == 256 * -128


def test_sweep_equals_twin_unaligned_out_and_empty_launches():
    args = _case(9, 1, 4, 9, 16, 2, 5, [5, 2], (0, 4), (0, 4))
    _equal(args, 8, 16, out_aligned=False)
    for dims in ((0, 16), (8, 0)):
        assert sweep(*args, *dims).size == 0


def test_sweep_equals_twin_main_path_tables():
    """The bank's own table shape: dr, dc in 0..7 over 30x40 planes with
    responses 0..4, 62 features (248 < 256, but the fields are 16 bits wide
    whatever the values)."""
    args = _case(11, 1, 64, 30, 40, 2, 62, [62, 31], (0, 8), (0, 8), values=(0, 5))
    args[1][:] = np.random.RandomState(12).randint(0, 64, args[1].shape)
    _equal(args, 30, 40)
