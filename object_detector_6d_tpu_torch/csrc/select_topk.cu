// K7: the exact top-K of the match program's thresholded score grid.
//
//   vals[b, :K], idx[b, :K] = the K largest of x[b, :N] by (value descending,
//                             index ascending)
//
// which is lax.top_k's order and that of torch.sort(x, -1, descending=True,
// stable=True)[..., :K]: ties go to the lower flat index, and the slots of
// value -1 (below the threshold) carry the lowest indices at -1.
//
// x [B,N] int32, every value in [-1, vmax] (the flat score: -1, or a K6 sum
// of responses 0..4 over at most F features, so vmax = 4 F); vals [B,K]
// int32; idx [B,K] int64. A value outside [-1, vmax] is read as the nearest
// end of that range (the wrapper cannot check without reading the grid back;
// the CPU twin raises).
//
// Replaces no Pallas kernel: the reference takes lax.top_k, and the port's
// first form was a stable torch.sort of each frame (a radix sort of 1.44M
// cells a frame, ~12 launches each, to keep 64).
//
// Bound on the H100: bytes, one read of the grid (738 MB at B=128 and 1202
// templates of 30x40 cells: 0.22 ms at 3.35 TB/s). Values are small
// integers, so the K-th largest is found from histograms, not by sorting.
// Three launches for the whole batch; no atomics in device memory, no fill of
// the scratch, nothing read back by the host:
//
// 1. hist (grid tiles x B): a block reads a tile of TILE cells with 16-byte
//    loads (4 consecutive cells a lane, all 8 loads in flight), builds a
//    shared histogram of value + 1, and writes it with each CHUNK's max. The
//    dominant -1 is counted as the tile's cells less the rest; equal values
//    of a warp add once (__match_any_sync).
// 2. scan (one block a frame): per bin, the exclusive prefix of the tiles'
//    counts (in place) and the frame's total in row T; per bin G, the count of
//    greater values; v*, the K-th largest value, and r = K - G[v*], the
//    number of v*-ties to take.
// 3. collect (grid tiles x B): a chunk is read again only if its max exceeds
//    v*, or if it may hold one of the frame's first r ties; in the match's
//    grid (28-55 values above the threshold, v* = -1) that is one chunk of
//    the first tile and the chunks that hold candidates. A value v > v* goes
//    to slot G[v] + (v's count in earlier tiles) + (its rank among the tile's
//    equal values by index: the tile's values above v* are sorted in shared
//    memory as keys v << 13 | offset, a bitonic sort of the next power of two,
//    any K); the tie of rank q < r in index order (a block scan) to slot
//    K - r + q. Every slot is written once.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;                  // consecutive cells a lane: one 16-byte load
constexpr int CHUNK = THREADS * PER;    // cells a block reads per step
constexpr int CHUNKS = 8;               // chunks a tile
constexpr int TILE = CHUNK * CHUNKS;    // cells a block
constexpr int MAX_BINS = 12000;         // vmax + 2 ints of shared memory, under 48 KB
constexpr int OFF_BITS = 13;            // a cell's offset in its tile
static_assert(TILE == 1 << OFF_BITS, "a tile's offsets fill OFF_BITS");
static_assert((MAX_BINS << OFF_BITS) > 0, "value << OFF_BITS | offset fits an int");
constexpr int EMPTY = INT_MIN;          // a cell past the row's end; a chunk with no cell
constexpr unsigned FULL = 0xFFFFFFFFu;

// the 4 cells from `cell` of a row (EMPTY past its end), clamped to [-1, vmax];
// vec: the row is 16-byte aligned and N % 4 == 0
__device__ __forceinline__ void load_cells(const int32_t* __restrict__ row, int cell, int N,
                                           int vmax, bool vec, int v[PER]) {
  if (cell >= N) {
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = EMPTY;
    return;
  }
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(row + cell));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = cell + j < N ? __ldg(row + cell + j) : EMPTY;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (cell + j < N) v[j] = min(max(v[j], -1), vmax);
}

// exclusive prefix sum of x over the block's threads in order; *total = the sum
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int s = s_warp[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + inc - x;
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ pre,
            int32_t* __restrict__ cmax, int N, int T, int nbins, int vmax, int vec) {
  extern __shared__ int32_t s_hist[];
  __shared__ int32_t s_cmax[CHUNKS];
  __shared__ int32_t s_nonneg;
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < nbins; i += THREADS) s_hist[i] = 0;
  if (tid < CHUNKS) s_cmax[tid] = EMPTY;
  if (tid == 0) s_nonneg = 0;
  __syncthreads();

  const int32_t* row = x + (size_t)b * N;
  const int base = t * TILE + tid * PER;
  int v[CHUNKS][PER];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) load_cells(row, base + c * CHUNK, N, vmax, vec, v[c]);
  int nonneg = 0;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    int m = EMPTY;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int val = v[c][j];
      m = max(m, val);
      const bool counted = val >= 0;
      const unsigned any = __ballot_sync(FULL, counted);
      if (counted) {
        const unsigned peers = __match_any_sync(any, val);
        if (lane == __ffs(peers) - 1) atomicAdd(&s_hist[val + 1], __popc(peers));
      }
      nonneg += counted;
    }
    m = __reduce_max_sync(FULL, m);
    if (lane == 0) atomicMax(&s_cmax[c], m);
  }
  nonneg = __reduce_add_sync(FULL, nonneg);
  if (lane == 0) atomicAdd(&s_nonneg, nonneg);
  __syncthreads();

  const int n_tile = min(TILE, N - t * TILE);
  int32_t* out = pre + ((size_t)b * (T + 1) + t) * nbins;
  for (int i = tid; i < nbins; i += THREADS) out[i] = i ? s_hist[i] : n_tile - s_nonneg;
  if (tid < CHUNKS) cmax[((size_t)b * T + t) * CHUNKS + tid] = s_cmax[tid];
}

constexpr int SCAN_BATCH = 32;  // tiles' counts a lane has in flight

__global__ void __launch_bounds__(THREADS)
scan_kernel(int32_t* __restrict__ pre, int32_t* __restrict__ greater,
            int32_t* __restrict__ meta, int T, int nbins, int K) {
  extern __shared__ int32_t s_tot[];
  __shared__ int32_t s_warp[THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  int32_t* p = pre + (size_t)b * (T + 1) * nbins;
  for (int bin = tid; bin < nbins; bin += THREADS) {
    int run = 0;
    for (int t0 = 0; t0 < T; t0 += SCAN_BATCH) {
      int c[SCAN_BATCH];
#pragma unroll
      for (int u = 0; u < SCAN_BATCH; ++u)
        c[u] = t0 + u < T ? p[(size_t)(t0 + u) * nbins + bin] : 0;
#pragma unroll
      for (int u = 0; u < SCAN_BATCH; ++u) {
        if (t0 + u < T) p[(size_t)(t0 + u) * nbins + bin] = run;
        run += c[u];
      }
    }
    p[(size_t)T * nbins + bin] = run;
    s_tot[bin] = run;
  }
  __syncthreads();

  // this lane's bins [lo, hi); G[bin] = the count of cells in higher bins
  const int per = (nbins + THREADS - 1) / THREADS;
  const int lo = min(tid * per, nbins), hi = min(lo + per, nbins);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += s_tot[i];
  int total;
  const int below = block_exclusive_scan(mine, s_warp, &total);
  int above = total - below - mine;
  int32_t* g = greater + (size_t)b * nbins;
  for (int i = hi - 1; i >= lo; --i) {
    g[i] = above;
    if (above < K && above + s_tot[i] >= K) {  // one bin of the frame: v* + 1
      meta[2 * b] = i;
      meta[2 * b + 1] = K - above;
    }
    above += s_tot[i];
  }
}

__global__ void __launch_bounds__(THREADS)
collect_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ pre,
               const int32_t* __restrict__ greater, const int32_t* __restrict__ cmax,
               const int32_t* __restrict__ meta, int32_t* __restrict__ vals,
               int64_t* __restrict__ idx, int N, int T, int nbins, int K, int vmax, int vec) {
  __shared__ int32_t s_key[TILE];  // value << OFF_BITS | offset of the tile's values above v*
  __shared__ int32_t s_n;
  __shared__ int32_t s_warp[THREADS / 32];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int sb = meta[2 * b], r = meta[2 * b + 1];
  const int vstar = sb - 1;
  const int32_t* p = pre + ((size_t)b * (T + 1) + t) * nbins;  // row t; row t + 1 follows
  const int32_t* cm = cmax + ((size_t)b * T + t) * CHUNKS;
  int m[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) m[c] = cm[c];
  const int ties_before = p[sb];
  // ties of lower rank already counted; a tile without ties takes none
  int got = p[nbins + sb] > ties_before ? ties_before : r;
  bool busy = false;  // most tiles have no value above v* and no tie to take
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) busy |= m[c] > vstar || (got < r && m[c] >= vstar);
  if (!busy) return;
  if (tid == 0) s_n = 0;
  __syncthreads();

  const int32_t* row = x + (size_t)b * N;
  int32_t* vb = vals + (size_t)b * K;
  int64_t* ib = idx + (size_t)b * K;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const bool ties = got < r && m[c] >= vstar;  // the same in every lane
    if (m[c] <= vstar && !ties) continue;
    const int cell = t * TILE + c * CHUNK + tid * PER;
    int v[PER];
    load_cells(row, cell, N, vmax, vec, v);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (v[j] > vstar) {
        s_key[atomicAdd(&s_n, 1)] = v[j] << OFF_BITS | (cell + j - t * TILE);
      }
    }
    if (ties) {
      int mine = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) mine += v[j] == vstar;
      int total;
      int q = got + block_exclusive_scan(mine, s_warp, &total);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (v[j] == vstar) {
          if (q < r) {
            vb[K - r + q] = vstar;
            ib[K - r + q] = cell + j;
          }
          ++q;
        }
      }
      got += total;
    }
  }
  __syncthreads();

  // values above v*: fewer than K in the frame, all of this tile's here
  const int n = s_n;
  if (n == 0) return;
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + tid; i < P; i += THREADS) s_key[i] = INT_MAX;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += THREADS) {
        const int o = i ^ j;
        if (o > i) {
          const int a = s_key[i], c = s_key[o];
          if ((a > c) == ((i & k) == 0)) {
            s_key[i] = c;
            s_key[o] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n; i += THREADS) {
    const int key = s_key[i], v = key >> OFF_BITS;
    int lo = 0, hi = i;  // the first key of value v
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_key[mid] >> OFF_BITS < v) lo = mid + 1; else hi = mid;
    }
    const int slot = greater[(size_t)b * nbins + v + 1] + p[v + 1] + (i - lo);
    vb[slot] = v;
    ib[slot] = t * TILE + (key & (TILE - 1));
  }
}

}  // namespace

extern "C" int odc_select_topk(const void* x, void* vals, void* idx, void* scratch, int B,
                               int N, int K, int vmax, int vec, void* stream) {
  if (B == 0 || K == 0) return 0;
  const int nbins = vmax + 2;
  if (K > N || vmax < 0 || nbins > MAX_BINS || N >= (1 << 30) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int T = odc::ceil_div(N, TILE);
  // scratch (int32): pre [B, T+1, nbins], greater [B, nbins], cmax [B, T, CHUNKS], meta [B, 2]
  int32_t* pre = (int32_t*)scratch;
  int32_t* greater = pre + (size_t)B * (T + 1) * nbins;
  int32_t* cmax = greater + (size_t)B * nbins;
  int32_t* meta = cmax + (size_t)B * T * CHUNKS;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)nbins * sizeof(int32_t);
  hist_kernel<<<dim3(T, B), THREADS, smem, s>>>((const int32_t*)x, pre, cmax, N, T, nbins,
                                                 vmax, vec);
  scan_kernel<<<B, THREADS, smem, s>>>(pre, greater, meta, T, nbins, K);
  collect_kernel<<<dim3(T, B), THREADS, 0, s>>>((const int32_t*)x, pre, greater, cmax, meta,
                                                (int32_t*)vals, (int64_t*)idx, N, T, nbins, K,
                                                vmax, vec);
  return (int)cudaGetLastError();
}
