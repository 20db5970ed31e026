// K3: fused OR-spread + response maps, [B,H,W] u8 -> [B,8,H,W] u8.
//
// Replaces object_detector_6d_tpu/ops/response_pallas.py
// response_spread_batched (_make_kernel): the forward T x T OR-spread of
// the one-hot orientation byte (zero beyond the frame), then for each of
// the 8 orientations the best similarity 4 - circular distance against
// any bit of the spread byte, by the rotate-and-priority rule.
//
// Bound on the H100: bytes. A pixel must read 1 byte and write 8 (one a
// response plane): 9 bytes. The two-modality main path's 4 launches of a
// B=32 batch ([32,480,640] at T=5 and [32,240,320] at T=8, per modality)
// move 221 MB, 0.066 ms at 3.35 TB/s; their ~40 integer operations a
// pixel would take ~0.06 ms at the int32 peak.
//
// The first design (one thread a pixel on a 32x8 shared tile) paid far
// more than that: the tile's (T-1)-pixel halo read each input byte
// 1.7-2.3 times from device memory, the spread took T*T single-byte
// shared loads and ORs a pixel (25 at T=5, 64 at T=8), and the response
// a 5-way select and one single-byte store per plane. This design:
//
// - Packed words, one read of the input. A lane owns 4 consecutive
//   pixels of a row as one 32-bit word; a warp owns a strip of 128
//   columns and walks down RH rows of it, each input row one aligned
//   4-byte load a lane, prefetched a row ahead. The <= 4 words past the
//   strip that the last lanes' windows reach are loaded by the first
//   lanes and passed on by shuffles, with the neighbours' words. The
//   vertical halo (T-1 rows a strip of RH) is all that is read twice.
// - Horizontal OR: the window x..x+T-1 of each of the lane's 4 bytes is
//   T funnel shifts of the lane's and the next words, ORed, at constant
//   shift amounts.
// - Vertical OR: a register ring of the last T horizontal words, so the
//   T*T taps become ~T + T ORs a word; the walk is unrolled by the ring's
//   length so every slot index is a constant. T = 5 and T = 8 (the main
//   path's) are instantiations of their own; every other T in 1..16
//   takes a 16-slot ring and ORs the slots younger than T.
// - Response: byte i of the response of spread byte s depends only on
//   (s, i), so each block builds the 256 x 8-byte table from v4..v0 in
//   shared memory at its start by the same priority rule; a word takes 4
//   8-byte lookups, and 16 byte permutes transpose them into the 8
//   planes' words.
// - Stores: each plane's 4 pixels go out as one 32-bit store, so a warp
//   writes 128 contiguous bytes to each plane. A frame whose width is not
//   a multiple of 4 (or an unaligned tensor) takes the same walk with
//   byte loads and stores.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int SPAN = 128;  // columns of a warp's strip: 32 lanes x 4 pixels
constexpr int MAX_T = 16;
constexpr unsigned FULL = 0xFFFFFFFFu;

// similarity by circular distance 4, 3, 2, 1, 0
struct DistVals {
  int v4, v3, v2, v1, v0;
};

// The response bytes of spread byte s: orientations 0..3 in x, 4..7 in y.
__device__ uint2 response_entry(int s, DistVals d) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // rotate so orientation i sits at bit 0; the nearest set bit wins
    const int r = ((s >> i) | (s << (8 - i))) & 0xFF;
    int v = 0;
    if (r & (1 << 4)) v = d.v4;
    if (r & ((1 << 3) | (1 << 5))) v = d.v3;
    if (r & ((1 << 2) | (1 << 6))) v = d.v2;
    if (r & ((1 << 1) | (1 << 7))) v = d.v1;
    if (r & 1) v = d.v0;
    w[i >> 2] |= (uint32_t)(v & 0xFF) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

// 4 pixels' 4 response bytes (a, b, c, d: byte i = plane i) -> the 4
// planes' words (word i: byte j = pixel j)
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* p) {
  const uint32_t ab0 = __byte_perm(a, b, 0x5140), ab1 = __byte_perm(a, b, 0x7362);
  const uint32_t cd0 = __byte_perm(c, d, 0x5140), cd1 = __byte_perm(c, d, 0x7362);
  p[0] = __byte_perm(ab0, cd0, 0x5410);
  p[1] = __byte_perm(ab0, cd0, 0x7632);
  p[2] = __byte_perm(ab1, cd1, 0x5410);
  p[3] = __byte_perm(ab1, cd1, 0x7632);
}

// pixels x..x+3 of a row as a word, zero past the row's end
template <bool ALIGNED>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int x, int W) {
  if (ALIGNED) return x < W ? __ldg(reinterpret_cast<const uint32_t*>(row + x)) : 0u;
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x + j < W) w |= (uint32_t)__ldg(row + x + j) << (8 * j);
  return w;
}

// TT: the spread T, or 0 for any T in 1..16 (runtime t). ALIGNED: W % 4
// == 0 and 4-byte aligned tensors. Each warp walks RH rows of one strip.
template <int TT, bool ALIGNED>
__global__ void __launch_bounds__(32 * WARPS)
response_spread_kernel(const uint8_t* __restrict__ q, uint8_t* __restrict__ out, int H,
                       int W, int t, int RH, DistVals d) {
  constexpr int RING = TT ? TT : MAX_T;
  // words past the lane's own that its windows reach: bytes up to 3 + T - 1
  constexpr int NH = (RING + 2) / 4;
  __shared__ uint2 lut[256];
  for (int s = threadIdx.x; s < 256; s += 32 * WARPS) lut[s] = response_entry(s, d);
  __syncthreads();

  const int T = TT ? TT : t;
  const int lane = threadIdx.x & 31;
  const int y0 = (blockIdx.y * WARPS + (threadIdx.x >> 5)) * RH;
  if (y0 >= H) return;  // the whole warp
  const int y_end = min(y0 + RH, H);
  const int x = blockIdx.x * SPAN + 4 * lane;
  const int xe = (blockIdx.x + 1) * SPAN + 4 * lane;  // lanes < NH: the words past the strip
  const uint8_t* qb = q + (size_t)blockIdx.z * H * W;
  const size_t plane = (size_t)H * W;
  uint8_t* ob = out + (size_t)blockIdx.z * 8 * plane + x;

  // row r's own and past-the-strip words; rows past the frame are zero
  uint32_t w_next = 0u, e_next = 0u;
  auto load = [&](int r) {
    w_next = e_next = 0u;
    if (r < H) {
      const uint8_t* row = qb + (size_t)r * W;
      w_next = load_word<ALIGNED>(row, x, W);
      if (lane < NH) e_next = load_word<ALIGNED>(row, xe, W);
    }
  };
  load(y0);
  uint32_t ring[RING];
#pragma unroll
  for (int i = 0; i < RING; ++i) ring[i] = 0u;

  for (int r0 = y0;; r0 += RING) {
#pragma unroll
    for (int s = 0; s < RING; ++s) {
      // input row r completes the window of output row y = r - (T - 1)
      const int r = r0 + s;
      const int y = r - (T - 1);
      if (y >= y_end) return;  // the whole warp
      const uint32_t w = w_next, e = e_next;
      load(r + 1);

      // bytes x .. x + 4 * NH + 3 of row r as words
      uint32_t wd[NH + 2];
      wd[0] = w;
#pragma unroll
      for (int k = 1; k <= NH; ++k) {
        const uint32_t inside = __shfl_down_sync(FULL, w, k);
        const uint32_t past = __shfl_sync(FULL, e, (lane + k) & 31);
        wd[k] = lane + k < 32 ? inside : past;
      }
      wd[NH + 1] = 0u;
      uint32_t h = 0u;
#pragma unroll
      for (int k = 0; k < RING; ++k)
        if (TT || k < T) h |= __funnelshift_r(wd[k >> 2], wd[(k >> 2) + 1], 8 * (k & 3));
      ring[s] = h;
      if (y < y0) continue;  // the walk's first T - 1 rows

      uint32_t sp = 0u;
#pragma unroll
      for (int k = 0; k < RING; ++k)
        if (TT || k < T) sp |= ring[(s - k + RING) % RING];
      const uint2 e0 = lut[sp & 0xFF], e1 = lut[(sp >> 8) & 0xFF];
      const uint2 e2 = lut[(sp >> 16) & 0xFF], e3 = lut[sp >> 24];
      uint32_t p[8];
      transpose4(e0.x, e1.x, e2.x, e3.x, p);
      transpose4(e0.y, e1.y, e2.y, e3.y, p + 4);
      uint8_t* o = ob + (size_t)y * W;
      if (ALIGNED) {
        if (x < W) {
#pragma unroll
          for (int i = 0; i < 8; ++i) *reinterpret_cast<uint32_t*>(o + i * plane) = p[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (x + j < W) o[i * plane + j] = (uint8_t)(p[i] >> (8 * j));
      }
    }
  }
}

using Kernel = void (*)(const uint8_t*, uint8_t*, int, int, int, int, DistVals);

template <bool ALIGNED>
Kernel pick(int T) {
  if (T == 5) return response_spread_kernel<5, ALIGNED>;
  if (T == 8) return response_spread_kernel<8, ALIGNED>;
  return response_spread_kernel<0, ALIGNED>;
}

}  // namespace

extern "C" int odc_response_spread(const void* q, void* out, int B, int H, int W, int T,
                                   int v4, int v3, int v2, int v1, int v0, void* stream) {
  if (T < 1 || T > MAX_T) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const bool aligned = W % 4 == 0 && ((uintptr_t)q | (uintptr_t)out) % 4 == 0;
  const int strips = odc::ceil_div(W, SPAN);
  // rows a warp walks: long walks amortise the T - 1 rows of vertical
  // halo; shorter ones while the grid holds fewer than 16 warps per SM
  auto warps = [&](int rh) { return (long long)strips * odc::ceil_div(H, rh) * B; };
  int rh = 64;
  while (rh > 8 && warps(rh) < 132 * 16) rh /= 2;
  const dim3 grid(strips, odc::ceil_div(odc::ceil_div(H, rh), WARPS), B);
  const Kernel k = aligned ? pick<true>(T) : pick<false>(T);
  k<<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>((const uint8_t*)q, (uint8_t*)out, H, W,
                                                   T, rh, DistVals{v4, v3, v2, v1, v0});
  return (int)cudaGetLastError();
}
