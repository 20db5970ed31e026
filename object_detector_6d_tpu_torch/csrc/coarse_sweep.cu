// K6: sparse full-grid coarse sweep.
//
//   out[b,t,r,c] = sum_{f < nfeat[t]} D[b, plane[t,f], r+dr[t,f], c+dc[t,f]]
//
// for r < out_h, c < out_w; a read outside the plane (or of a plane
// outside 0..P-1) is zero. D [B,P,Hp,Wp] int8 decimated level-1 responses
// (both modalities stacked along P); plane/dr/dc [nT,F] int32; nfeat [nT]
// int32; out [B,nT,out_h,out_w] int32.
//
// Replaces object_detector_6d_tpu/ops/refine_pallas.py coarse_sweep
// (_coarse_kernel), which the TPU keeps experimental: there each grid step
// holds a frame's planes in VMEM and rolls whole rows per feature, so it
// needs power-of-two planes and wraps columns. Here the reads outside the
// plane are zero, which is the zero padding of the reference main path's
// int8 conv over the one-hot kernels_low: the raw grid equals that conv's.
//
// Bound on the H100: the windows' way from L2 to the SMs and their load
// latency, not the adds. A 480x640 frame's D is 1024 planes x 30 x 40 =
// 1.2 MB and a B=32 batch stays in the 50 MB L2, but each (frame, template)
// reads ~62 windows of 30x40 bytes, ~290 MB a batch. The design spends few
// instructions on each loaded byte and keeps many loads in flight:
//
// - One warp owns one tile of one (frame, template): a lane owns CPL = 8
//   neighbouring output columns of RP rows, RS row groups side by side (30
//   x 40 outputs: 5 lanes a row, 6 row groups, 5 rows a lane, 30 of 32
//   lanes busy). The sums stay in registers; `out` is written once, 16
//   bytes a store where its rows are aligned.
// - A lane's 8 source bytes of a row start at any address: three aligned
//   32-bit words (the third is the word of the window's last byte, so no
//   word is read that holds no byte of the window) and two funnel shifts.
// - The bytes are added as packed 16-bit fields, biased to u8 (2 outputs
//   an add; <= 256 features x 255 < 2^16), and unbiased at the end by 128
//   times the number of features added. This holds for any int8 D.
// - Zero fill without per-output compares: the valid source columns of a
//   lane are the same for all its rows, so a feature costs a lane one byte
//   mask, applied before the bias; a source row outside the plane skips
//   the loads and adds the bias alone.
// - The warp stages its template's table once, compacted: a feature whose
//   plane is outside 0..P-1 or whose window misses every output is dropped
//   there. The aligned words of a window may hold bytes of the neighbouring
//   row or plane (masked). Only a plane that starts or ends within 16
//   bytes of the tensor's ends could lead a word outside the tensor: its
//   features go to a second list that is swept byte by byte with range
//   checks (two planes of a batch).
// - The loads of feature f+1 are issued before the adds of feature f.
#include "common.cuh"

namespace {

constexpr int MAX_F = 256;      // features per template
constexpr int WARPS = 4;        // warps (tiles) per block
constexpr int NW = 2;           // 32-bit words of 4 output columns a lane
constexpr int CPL = 4 * NW;     // output columns a lane
constexpr int RP = 5;           // output rows a lane
constexpr int FAR = -(1 << 28); // row of an output slot outside the grid
constexpr int MAX_DIM = 1 << 24;
constexpr int EDGE = 16;        // bytes from the tensor's ends that need the careful sweep

// bytes lo..hi-1 of a word (clipped to 0..4) set to 0xFF
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  lo = min(max(lo, 0), 4);
  hi = min(max(hi, lo), 4);
  const uint64_t one = 1;
  return (uint32_t)(((one << (8 * hi)) - 1) ^ ((one << (8 * lo)) - 1));
}

// the aligned words under one feature's windows of a lane's RP rows
struct Window {
  uint32_t w[RP][NW + 1];
  int off, fc;
};

struct Lane {
  const char* fal;  // the frame's D, rounded down to a 32-bit word
  int c0;           // first output column
  int row[RP];      // output rows (FAR: none)
  int loff[RP];     // row * Wp + c0 + (the frame's offset in its first word)
  int Hp, Wp;
};

__device__ __forceinline__ bool any_column(const Lane& L, int fc) {
  return min(CPL, L.Wp - (L.c0 + fc)) > max(0, -(L.c0 + fc));
}

__device__ __forceinline__ void load_window(const Lane& L, int off, int fr, int fc, Window& x) {
  x.off = off;
  x.fc = fc;
  const bool any = any_column(L, fc);
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const int a = off + L.loff[k];
    const bool ok = any && (unsigned)(L.row[k] + fr) < (unsigned)L.Hp;
#pragma unroll
    for (int i = 0; i <= NW; ++i) x.w[k][i] = 0u;
    if (ok) {
#pragma unroll
      for (int i = 0; i < NW; ++i)
        x.w[k][i] = __ldg(reinterpret_cast<const uint32_t*>(L.fal + ((a & ~3) + 4 * i)));
      x.w[k][NW] = __ldg(reinterpret_cast<const uint32_t*>(L.fal + ((a + CPL - 1) & ~3)));
    }
  }
}

__device__ __forceinline__ void add_bytes(uint32_t v, uint32_t& lo, uint32_t& hi) {
  lo += v & 0x00FF00FFu;         // columns 0 and 2 of the word
  hi += (v >> 8) & 0x00FF00FFu;  // columns 1 and 3
}

__device__ __forceinline__ void add_window(const Lane& L, const Window& x,
                                           uint32_t lo[RP][NW], uint32_t hi[RP][NW]) {
  const int cc = L.c0 + x.fc;  // source column of the lane's first output
  uint32_t m[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) m[i] = byte_mask(-cc - 4 * i, L.Wp - cc - 4 * i);
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const uint32_t sh = (uint32_t)(x.off + L.loff[k]) << 3;  // the shift uses its low 5 bits
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t raw = __funnelshift_r(x.w[k][i], x.w[k][i + 1], sh);
      add_bytes((raw & m[i]) ^ 0x80808080u, lo[k][i], hi[k][i]);  // zero fill, then int8 -> u8
    }
  }
}

// the same sum for a feature of a plane at the tensor's ends: byte loads,
// each with its range check
__device__ __forceinline__ void add_window_careful(const Lane& L, const char* fb, int off,
                                                   int fr, int fc, uint32_t lo[RP][NW],
                                                   uint32_t hi[RP][NW]) {
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const bool row_ok = (unsigned)(L.row[k] + fr) < (unsigned)L.Hp;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint32_t raw = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = L.c0 + 4 * i + j;
        if (row_ok && (unsigned)(c + fc) < (unsigned)L.Wp)
          raw |= (uint32_t)(uint8_t)fb[off + L.row[k] * L.Wp + c] << (8 * j);
      }
      add_bytes(raw ^ 0x80808080u, lo[k][i], hi[k][i]);
    }
  }
}

__global__ void __launch_bounds__(32 * WARPS)
coarse_sweep_kernel(const int8_t* __restrict__ D, const int32_t* __restrict__ plane,
                    const int32_t* __restrict__ dr, const int32_t* __restrict__ dc,
                    const int32_t* __restrict__ nfeat, int32_t* __restrict__ out, int B,
                    int P, int Hp, int Wp, int nT, int F, int out_h, int out_w, int LW,
                    int RS, int row_tiles, int col_tiles, long long n_warps) {
  // the warp's live features: the fast list from slot 0 up, the careful
  // list from slot MAX_F - 1 down
  __shared__ int32_t s_off[WARPS][MAX_F];
  __shared__ int32_t s_dr[WARPS][MAX_F];
  __shared__ int32_t s_dc[WARPS][MAX_F];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w = (long long)blockIdx.x * WARPS + warp;
  if (w >= n_warps) return;  // whole warps; the block never synchronises
  const int tiles = row_tiles * col_tiles;
  const int tile = (int)(w % tiles);
  const long long bt = w / tiles;
  const int t = (int)(bt % nT), b = (int)(bt / nT);

  // stage and compact the template's table
  const int n = min(max(nfeat[t], 0), F);
  const long long plane_bytes = (long long)Hp * Wp;
  int n_fast = 0, n_slow = 0;
  for (int f0 = 0; f0 < n; f0 += 32) {
    const int f = f0 + lane;
    int p = -1, fr = 0, fc = 0;
    if (f < n) {
      p = plane[(size_t)t * F + f];
      fr = dr[(size_t)t * F + f];
      fc = dc[(size_t)t * F + f];
    }
    const bool live = p >= 0 && p < P && fr > -out_h && fr < Hp && fc > -out_w && fc < Wp;
    const long long gp = (long long)b * P + p;  // the plane's index in the tensor
    const bool edge = live && (gp * plane_bytes < EDGE
                               || ((long long)B * P - gp - 1) * plane_bytes < EDGE);
    const bool fast = live && !edge;
    const uint32_t mf = __ballot_sync(0xFFFFFFFFu, fast);
    const uint32_t ms = __ballot_sync(0xFFFFFFFFu, edge);
    const uint32_t below = (1u << lane) - 1u;
    if (live) {
      const int slot = fast ? n_fast + __popc(mf & below)
                            : MAX_F - 1 - (n_slow + __popc(ms & below));
      s_off[warp][slot] = (p * Hp + fr) * Wp + fc;
      s_dr[warp][slot] = fr;
      s_dc[warp][slot] = fc;
    }
    n_fast += __popc(mf);
    n_slow += __popc(ms);
  }
  __syncwarp();

  // the lane's outputs
  const uintptr_t fb = reinterpret_cast<uintptr_t>(D) + (size_t)b * P * Hp * Wp;
  const int mis = (int)(fb & 3);
  const int cw = lane % LW, rg = lane / LW;
  Lane L;
  L.fal = reinterpret_cast<const char*>(fb - mis);
  L.Hp = Hp;
  L.Wp = Wp;
  L.c0 = ((tile % col_tiles) * LW + cw) * CPL;
  const bool has = rg < RS && L.c0 < out_w;
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const int r = (tile / col_tiles) * (RS * RP) + rg + RS * k;
    L.row[k] = has && r < out_h ? r : FAR;
    L.loff[k] = (L.row[k] == FAR ? 0 : r * Wp) + L.c0 + mis;
  }

  uint32_t lo[RP][NW], hi[RP][NW];
#pragma unroll
  for (int k = 0; k < RP; ++k)
#pragma unroll
    for (int i = 0; i < NW; ++i) lo[k][i] = hi[k][i] = 0u;

  // the loads of feature f + 1 are in flight while feature f is added
  Window cur, nxt;
  if (n_fast > 0) load_window(L, s_off[warp][0], s_dr[warp][0], s_dc[warp][0], cur);
  for (int f = 0; f < n_fast; ++f) {
    if (f + 1 < n_fast)
      load_window(L, s_off[warp][f + 1], s_dr[warp][f + 1], s_dc[warp][f + 1], nxt);
    add_window(L, cur, lo, hi);
    cur = nxt;
  }
  for (int f = 0; f < n_slow; ++f) {
    const int s = MAX_F - 1 - f;
    add_window_careful(L, reinterpret_cast<const char*>(fb), s_off[warp][s], s_dr[warp][s],
                       s_dc[warp][s], lo, hi);
  }

  // unbias and store
  const int bias = 128 * (n_fast + n_slow);
  int32_t* ob = out + ((size_t)b * nT + t) * out_h * out_w;
  const bool vec = (out_w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    if (L.row[k] == FAR) continue;
    int32_t* q = ob + (size_t)L.row[k] * out_w + L.c0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int4 v = make_int4((int)(lo[k][i] & 0xFFFFu) - bias, (int)(hi[k][i] & 0xFFFFu) - bias,
                               (int)(lo[k][i] >> 16) - bias, (int)(hi[k][i] >> 16) - bias);
      const int c = L.c0 + 4 * i;
      if (vec && c < out_w) {
        *reinterpret_cast<int4*>(q + 4 * i) = v;
      } else {
        if (c + 0 < out_w) q[4 * i + 0] = v.x;
        if (c + 1 < out_w) q[4 * i + 1] = v.y;
        if (c + 2 < out_w) q[4 * i + 2] = v.z;
        if (c + 3 < out_w) q[4 * i + 3] = v.w;
      }
    }
  }
}

}  // namespace

extern "C" int odc_coarse_sweep(const void* D, const void* plane, const void* dr,
                                const void* dc, const void* nfeat, void* out,
                                int B, int P, int Hp, int Wp, int nT, int F,
                                int out_h, int out_w, void* stream) {
  if (F > MAX_F) return (int)cudaErrorInvalidValue;
  if (B == 0 || nT == 0 || out_h == 0 || out_w == 0) return 0;
  // every byte offset within a frame, and a window's reach past it, fits int32
  if (Hp >= MAX_DIM || Wp >= MAX_DIM || out_h >= MAX_DIM || out_w >= MAX_DIM
      || ((long long)(P + 2) * Hp + out_h + 1024) * Wp + out_w + 64 > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int ncol = odc::ceil_div(out_w, CPL);  // lane columns of the grid
  const int LW = ncol < 32 ? ncol : 32;              // lanes side by side in a tile row
  const int RS = 32 / LW;                      // row groups of a tile
  const int col_tiles = odc::ceil_div(ncol, LW);
  const int row_tiles = odc::ceil_div(out_h, RS * RP);
  const long long n_warps = (long long)B * nT * row_tiles * col_tiles;
  const long long blocks = (n_warps + WARPS - 1) / WARPS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  coarse_sweep_kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)D, (const int32_t*)plane, (const int32_t*)dr,
      (const int32_t*)dc, (const int32_t*)nfeat, (int32_t*)out, B, P, Hp, Wp,
      nT, F, out_h, out_w, LW, RS, row_tiles, col_tiles, n_warps);
  return (int)cudaGetLastError();
}
