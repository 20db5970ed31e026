"""A block-level numpy model of kernel K7's select (csrc/select_topk.cu)
against ``exact_topk``, the stable descending sort, bit for bit.

The CUDA kernel runs only on a card. What can go wrong in it without a
card to say so is its bookkeeping: the tiles' histograms of value + 1 with
the -1 bin counted as the rest, each chunk's max, the scan's prefixes over
tiles and counts of greater values, v* and r, which chunks the collect
launch reads again, the tie ranks of a block scan in index order (4
consecutive cells a lane), and the slot each selected value takes. The
model repeats that step for step with the source's constants (read from
it) and checks that every output slot is written exactly once. The twin's
range check and the wrapper's argument errors are tested here too.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.ops import select
from object_detector_6d_tpu_torch.ops.select import exact_topk, select_topk, select_topk_plain

SRC = (pathlib.Path(__file__).resolve().parents[1] / "object_detector_6d_tpu_torch" / "csrc"
       / "select_topk.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, PER, CHUNKS = _const("THREADS"), _const("PER"), _const("CHUNKS")
MAX_BINS, OFF_BITS = _const("MAX_BINS"), _const("OFF_BITS")
CHUNK = THREADS * PER
TILE = CHUNK * CHUNKS
EMPTY = np.iinfo(np.int32).min


def test_wrapper_constants_are_the_sources():
    assert (select.TILE, select.CHUNKS, select.MAX_BINS) == (TILE, CHUNKS, MAX_BINS)
    assert TILE == 1 << OFF_BITS


def _load_cells(row, cell0, vmax):
    """One chunk: lane l reads cells cell0 + 4l .. 4l + 3 -> (cells, values)
    [THREADS, PER]; EMPTY past the row's end, values clamped to [-1, vmax]."""
    cells = cell0 + np.arange(THREADS)[:, None] * PER + np.arange(PER)[None, :]
    ok = cells < row.size
    v = np.full(cells.shape, EMPTY, np.int64)
    v[ok] = np.clip(row[cells[ok]], -1, vmax)
    return cells, v


def _hist(x, vmax):
    """hist_kernel: pre [B, T+1, nbins] (rows < T: the tiles' counts) and
    cmax [B, T, CHUNKS]."""
    B, N = x.shape
    T, nbins = -(-N // TILE), vmax + 2
    pre = np.full((B, T + 1, nbins), -7, np.int64)  # garbage: every entry is written
    cmax = np.full((B, T, CHUNKS), -7, np.int64)
    for b in range(B):
        for t in range(T):
            h = np.zeros(nbins, np.int64)
            nonneg = 0
            for c in range(CHUNKS):
                _, v = _load_cells(x[b], t * TILE + c * CHUNK, vmax)
                counted = v >= 0
                # __match_any_sync adds each warp's equal values once, by their count
                for w in range(THREADS // 32):
                    vals, counts = np.unique(v[w * 32:(w + 1) * 32][counted[w * 32:(w + 1) * 32]],
                                             return_counts=True)
                    h[vals + 1] += counts
                nonneg += int(counted.sum())
                cmax[b, t, c] = v.max()
            h[0] = min(TILE, N - t * TILE) - nonneg
            pre[b, t] = h
    return pre, cmax


def _scan(pre, K):
    """scan_kernel, in place on pre; returns (greater [B, nbins], meta [B, 2])."""
    B, T1, nbins = pre.shape
    T = T1 - 1
    greater = np.full((B, nbins), -7, np.int64)
    meta = np.full((B, 2), -7, np.int64)
    per = -(-nbins // THREADS)
    for b in range(B):
        tot = pre[b, :T].sum(0)
        pre[b, :T] = np.cumsum(pre[b, :T], 0) - pre[b, :T]
        pre[b, T] = tot
        mine = [tot[min(l * per, nbins):min(l * per + per, nbins)].sum() for l in range(THREADS)]
        below = np.cumsum(mine) - mine
        hits = 0
        for l in range(THREADS):
            lo = min(l * per, nbins)
            hi = min(lo + per, nbins)
            above = int(tot.sum() - below[l] - mine[l])
            for i in range(hi - 1, lo - 1, -1):
                greater[b, i] = above
                if above < K <= above + tot[i]:
                    meta[b] = (i, K - above)
                    hits += 1
                above += int(tot[i])
        assert hits == 1, "v* must be one bin of the frame"
    return greater, meta


def _collect(x, pre, greater, cmax, meta, K, vmax):
    """collect_kernel -> (vals, idx, writes per slot, chunks read)."""
    B, N = x.shape
    T = cmax.shape[1]
    vals = np.full((B, K), -7, np.int64)
    idx = np.full((B, K), -7, np.int64)
    writes = np.zeros((B, K), np.int64)
    reads = 0

    def put(b, slot, v, i):
        vals[b, slot], idx[b, slot] = v, i
        writes[b, slot] += 1

    for b in range(B):
        sb, r = (int(a) for a in meta[b])
        vstar = sb - 1
        for t in range(T):
            p, p_next = pre[b, t], pre[b, t + 1]
            ties_before = int(p[sb])
            got = ties_before if p_next[sb] > ties_before else r
            keys = []  # value << OFF_BITS | offset, in any order: the atomic slots
            for c in range(CHUNKS):
                m = int(cmax[b, t, c])
                ties = got < r and m >= vstar
                if m <= vstar and not ties:
                    continue
                reads += 1
                cells, v = _load_cells(x[b], t * TILE + c * CHUNK, vmax)
                above = v > vstar
                keys += list((v[above] << OFF_BITS) | (cells[above] - t * TILE))[::-1]
                if ties:
                    mine = (v == vstar).sum(1)
                    q0 = got + np.cumsum(mine) - mine  # the block scan, lanes in order
                    for lane in range(THREADS):
                        q = int(q0[lane])
                        for j in range(PER):
                            if v[lane, j] == vstar:
                                if q < r:
                                    put(b, K - r + q, vstar, cells[lane, j])
                                q += 1
                    got += int(mine.sum())
            assert len(keys) <= min(K - 1, TILE)
            # the bitonic sort of the next power of two (padded with INT_MAX),
            # then the first key of each value by a binary search
            P = 1 << max(len(keys) - 1, 0).bit_length()
            skeys = np.sort(np.array(keys + [2**31 - 1] * (P - len(keys)), np.int64))
            for i, key in enumerate(skeys[:len(keys)]):
                v = int(key >> OFF_BITS)
                lo = int(np.searchsorted(skeys[:i] >> OFF_BITS, v, "left"))
                put(b, int(greater[b, v + 1] + p[v + 1] + i - lo), v,
                    t * TILE + int(key & (TILE - 1)))
    return vals, idx, writes, reads


def model_select(x, K, vmax):
    """The three launches on an int32 grid [B, N] -> (vals, idx, chunks read)."""
    x = np.asarray(x, np.int64)
    pre, cmax = _hist(x, vmax)
    greater, meta = _scan(pre, K)
    vals, idx, writes, reads = _collect(x, pre, greater, cmax, meta, K, vmax)
    assert (writes == 1).all(), "every output slot is written exactly once"
    return vals, idx, reads


def _equal_to_sort(x, K, vmax):
    xt = torch.as_tensor(np.asarray(x, np.int32))
    want_v, want_i = exact_topk(xt, K)
    got_v, got_i, reads = model_select(x, K, vmax)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    got_v, got_i = select_topk(xt, K, vmax)  # the CPU twin
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    return reads


def _sparse(rng, B, N, n_above, lo, hi):
    """-1 grids with n_above[b] cells of values in [lo, hi] at random places."""
    x = np.full((B, N), -1, np.int64)
    for b in range(B):
        x[b, rng.choice(N, n_above[b], replace=False)] = rng.randint(lo, hi + 1, n_above[b])
    return x


VMAX = 248  # 4 x 62 features, the cell's coarse tables


@pytest.mark.parametrize("B,N,K", [(1, 100, 64), (2, TILE, 64), (3, 2 * TILE + 1000, 16)])
def test_all_invalid(B, N, K):
    _equal_to_sort(np.full((B, N), -1), K, VMAX)


def test_fewer_than_k_above_the_threshold():
    rng = np.random.RandomState(1)
    _equal_to_sort(_sparse(rng, 3, 3 * TILE + 77, [0, 5, 63], 150, VMAX), 64, VMAX)


def test_exactly_k_above_the_threshold():
    rng = np.random.RandomState(2)
    _equal_to_sort(_sparse(rng, 2, 2 * TILE + 3, [64, 64], 150, 160), 64, VMAX)


def test_more_than_k_with_ties_straddling_the_kth_place():
    rng = np.random.RandomState(3)
    x = _sparse(rng, 2, 3 * TILE, [300, 200], 190, 200)
    vals = np.sort(x, 1)[:, ::-1]
    assert (vals[:, 63] == vals[:, 64]).all()  # the K-th value ties past K
    _equal_to_sort(x, 64, VMAX)


@pytest.mark.parametrize("value", [-1, 0, 37, VMAX])
def test_every_value_equal(value):
    _equal_to_sort(np.full((2, TILE + 5), value), 64, VMAX)


def test_values_at_vmax():
    rng = np.random.RandomState(4)
    x = _sparse(rng, 2, 2 * TILE + 11, [40, 90], VMAX - 1, VMAX)
    x[0, :3] = VMAX
    _equal_to_sort(x, 64, VMAX)


@pytest.mark.parametrize("N", [TILE - 1, TILE + 1, 3 * TILE + CHUNK + 3, 1031, 65])
def test_rows_that_end_inside_a_tile(N):
    rng = np.random.RandomState(N)
    x = rng.randint(-1, 6, (2, N))
    x[1] = np.where(rng.uniform(size=N) < 0.98, -1, x[1])
    _equal_to_sort(x, 64, 20)


def test_frames_that_differ():
    """B > 1: one frame all -1, one sparse, one overflowing, one dense."""
    rng = np.random.RandomState(5)
    N = 2 * TILE + 500
    x = np.stack([np.full(N, -1), _sparse(rng, 1, N, [30], 150, VMAX)[0],
                  _sparse(rng, 1, N, [500], 150, 170)[0], rng.randint(-1, VMAX + 1, N)])
    _equal_to_sort(x, 64, VMAX)


@pytest.mark.parametrize("K", [1, 7, 1024, 3 * TILE])
def test_k_from_one_to_the_row(K):
    """Up to K = N: every tile's values above v* fill its shared keys."""
    rng = np.random.RandomState(K)
    x = _sparse(rng, 2, 3 * TILE, [K // 2, min(2 * K, 3 * TILE)], 10, 12)
    _equal_to_sort(x, K, 12)


def test_sparse_grid_reads_few_chunks_again():
    """The match's grid: 28-55 candidates a frame, v* = -1. The collect
    launch reads again only the chunks that hold candidates and the first
    chunk (for the r lowest -1 ties)."""
    rng = np.random.RandomState(6)
    x = _sparse(rng, 3, 12 * TILE, [28, 40, 55], 150, VMAX)
    reads = _equal_to_sort(x, 64, VMAX)
    chunks = sum(len(set((np.nonzero(row >= 0)[0] // CHUNK).tolist()) | {0}) for row in x)
    assert reads == chunks


def test_twin_range_check():
    x = torch.full((2, 100), -1, dtype=torch.int32)
    select_topk_plain(x, 4, 10)
    for bad in (-2, 11):
        y = x.clone()
        y[1, 50] = bad
        with pytest.raises(ValueError, match="outside"):
            select_topk(y, 4, 10)


def test_wrapper_argument_errors():
    x = torch.full((2, 10), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="fewer than k"):
        select_topk(x, 11, 10)
    with pytest.raises(ValueError, match="int32"):
        select_topk(x.to(torch.int64), 4, 10)
    with pytest.raises(ValueError, match="bins"):
        select_topk(x, 4, MAX_BINS - 1)
    with pytest.raises(ValueError, match="< 0"):
        select_topk(x, -1, 10)
