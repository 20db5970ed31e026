// K1: color-gradient quantize, [B,H,W,3] u8 BGR -> [B,H,W] u8 one-hot bins.
//
// Replaces object_detector_6d_tpu/ops/quantize_pallas.py
// cg_quantize_batched (_make_cg_kernel): exact integer 7x7 Gaussian, 3x3
// Sobel per channel, the channel of largest squared magnitude (first on
// ties), cv::fastAtan2's float32 polynomial, 16 bins folded to 8, the
// frame border forced to bin 0, a 3x3 vote (>= 5 of 9) and the weak
// magnitude gate. Bit-identical to quant/color_gradient.py.
//
// Bound on the H100: integer operations. A pixel reads 3 bytes and writes
// 1 (49 MB for both levels of a B=32 batch of 480x640 frames: 15 us at
// 3.35 TB/s), but the algorithm needs ~136 int32 operations a pixel (two
// symmetric 7-tap passes and the Sobel on 3 channels, channel select,
// vote) and ~23 float ones (fastAtan2, bin): ~0.10 ms for the batch at
// 16.7 T int32 operations a second. So the design spends as few
// instructions a pixel as it can, and no block-wide barrier:
//
// - Each warp owns a strip of 32 columns (28 outputs: the Sobel and the
//   vote each take a column of halo on each side) and walks down RH rows
//   of it (10 rows of warm-up: Gaussian 3 + Sobel 1 + vote 1 on each
//   side; RH + 10 is a multiple of 7). A row of the strip's input (38
//   pixels, 114 contiguous bytes of the BGR row) comes in as one aligned
//   4-byte load a lane, prefetched a row ahead, through one of 7 per-warp
//   shared buffers; the only barrier is a __syncwarp a row.
// - The horizontal Gaussian (symmetric taps 8, 28, 56, 72: 4 multiplies)
//   reads the lane's 7 edge-clamped columns from that buffer; its rows
//   go into a 7-row register ring, so the vertical pass is a sliding
//   window in registers and the vertical halo is paid once per strip.
// - The Sobel's and the vote's horizontal neighbours come by warp
//   shuffles; their vertical parts are register rings too. Every ring
//   has 7 slots and the walk is unrolled by 7, so each slot index is a
//   constant and no register moves from slot to slot.
// - The vote uses the reference's packed 4-bit fields (one add per
//   neighbour). At most one bin can hold >= 5 of 9 votes, so that bin,
//   found with one add and a mask, is the first maximum the gate wants.
//
// Float steps are spelled as __f*_rn intrinsics in the reference's order
// (and the library is built -fmad=false): one fused multiply-add or an
// approximate division would move angles across bin edges.
#include "common.cuh"

namespace {

// cv::fastAtan2's coefficients in degrees as float32, the values of
// quant/color_gradient.py ATAN_P / ATAN_EPS / BIN_SCALE
constexpr float P1 = 0x1.ca44dcp+5f;
constexpr float P3 = -0x1.2aaddcp+4f;
constexpr float P5 = 0x1.1d3f7ep+3f;
constexpr float P7 = -0x1.4515b2p+1f;
constexpr float EPS = 0x1.0p-23f;
constexpr float BIN_SCALE = 0x1.6c16c2p-5f;  // float32(16 / 360)

__device__ __forceinline__ float fast_atan2_deg(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool swap = ax < ay;
  const float c = swap ? __fdiv_rn(ax, __fadd_rn(ay, EPS))
                       : __fdiv_rn(ay, __fadd_rn(ax, EPS));
  const float c2 = __fmul_rn(c, c);
  float a = __fmul_rn(P7, c2);
  a = __fmul_rn(__fadd_rn(a, P5), c2);
  a = __fmul_rn(__fadd_rn(a, P3), c2);
  a = __fmul_rn(__fadd_rn(a, P1), c);
  if (swap) a = __fsub_rn(90.0f, a);
  if (x < 0.0f) a = __fsub_rn(180.0f, a);
  if (y < 0.0f) a = __fsub_rn(360.0f, a);
  return a;
}

constexpr int WARPS = 4;
constexpr int SW = 28;    // output columns of a warp's strip
constexpr int RING = 7;   // rows of every register ring; the walk is unrolled by it

__device__ __forceinline__ int32_t gauss7(int32_t a0, int32_t a1, int32_t a2, int32_t a3,
                                          int32_t a4, int32_t a5, int32_t a6) {
  return 8 * (a0 + a6) + 28 * (a1 + a5) + 56 * (a2 + a4) + 72 * a3;
}

// What a lane knows of its strip for the whole walk.
struct Strip {
  const uint8_t* img;
  uint8_t* out;
  int H, W, cl, cr, cx, y0, y_end, lane;
  int tap[7];  // byte offsets of the 7 edge-clamped input columns of the Gaussian
  bool col_in, col_inner, col_out;
  float weak2;
};

// A lane's register rings, indexed by step mod RING: the horizontal pass
// (h), the Sobel's row parts of the blurred rows (gx: right - left, gs:
// left + 2 mid + right), the 3-wide packed vote sums (hv) and the selected
// squared magnitude (mag); plus the next input word, prefetched.
struct Rings {
  int32_t h[RING][3], gx[RING][3], gs[RING][3], mag[RING];
  uint32_t hv[RING];
  uint32_t wnext;
  int dnext;
};

// one input row (edge-clamped) of the strip as aligned words: <= 3 + 3 * 38 bytes
__device__ __forceinline__ uint32_t load_row(const Strip& t, int yi, int& delta) {
  const int yc = min(max(yi, 0), t.H - 1);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(t.img + ((size_t)yc * t.W + t.cl) * 3);
  delta = (int)(sa & 3);
  const uint32_t* A = reinterpret_cast<const uint32_t*>(sa & ~uintptr_t(3));
  return 4 * t.lane < 3 * (t.cr - t.cl) + delta ? __ldg(A + t.lane) : 0u;
}

// One step of the walk at input row yi, ring slot S: horizontal pass of
// row yi, blur row yi-3, Sobel and bin at row yi-4, vote at row yi-5.
template <int S>
__device__ __forceinline__ void walk_step(const Strip& t, Rings& g, uint32_t* buf, int yi) {
  constexpr int P1 = (S + RING - 1) % RING, P2 = (S + RING - 2) % RING;
  const unsigned full = 0xFFFFFFFFu;
  const int delta = g.dnext;
  buf[t.lane] = g.wnext;
  g.wnext = load_row(t, yi + 1, g.dnext);
  __syncwarp();
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(buf) + delta;

  int32_t bl[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    g.h[S][ch] = gauss7(rb[t.tap[0] + ch], rb[t.tap[1] + ch], rb[t.tap[2] + ch],
                        rb[t.tap[3] + ch], rb[t.tap[4] + ch], rb[t.tap[5] + ch],
                        rb[t.tap[6] + ch]);
    const int32_t acc = gauss7(g.h[(S + 1) % RING][ch], g.h[(S + 2) % RING][ch],
                               g.h[(S + 3) % RING][ch], g.h[(S + 4) % RING][ch],
                               g.h[(S + 5) % RING][ch], g.h[(S + 6) % RING][ch], g.h[S][ch]);
    bl[ch] = min((acc + (1 << 15)) >> 16, 255);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int32_t L = __shfl_up_sync(full, bl[ch], 1);
    const int32_t R = __shfl_down_sync(full, bl[ch], 1);
    g.gx[S][ch] = R - L;
    g.gs[S][ch] = L + 2 * bl[ch] + R;
  }

  // Sobel, channel select and bin at row ys = yi-4. Only interior pixels
  // need the Sobel (the border is bin 0 and never strong), and their 3x3
  // neighbourhood lies inside the frame. v is the pixel's vote as a 4-bit
  // field; no vote outside the frame.
  const int ys = yi - 4;
  uint32_t v = 0u;
  int32_t smag = 0;
  if (ys >= 0 && ys < t.H && t.col_in) {
    v = 1u;
    if (ys > 0 && ys < t.H - 1 && t.col_inner) {
      int32_t bdx = 0, bdy = 0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int32_t dx = g.gx[P2][ch] + 2 * g.gx[P1][ch] + g.gx[S][ch];
        const int32_t dy = g.gs[S][ch] - g.gs[P2][ch];
        const int32_t m = dx * dx + dy * dy;  // exact, < 2^24
        if (ch == 0 || m > smag) {  // strict: the first channel wins ties
          smag = m;
          bdx = dx;
          bdy = dy;
        }
      }
      const float ang = fast_atan2_deg(__int2float_rn(bdy), __int2float_rn(bdx));
      const int q16 = min(max(__float2int_rn(__fmul_rn(ang, BIN_SCALE)), 0), 255);
      v = 1u << (4 * (q16 & 7));
    }
  }
  g.hv[S] = __shfl_up_sync(full, v, 1) + v + __shfl_down_sync(full, v, 1);
  g.mag[S] = smag;

  // vote at row yo = yi-5 over rows yi-6 .. yi-4
  const int yo = yi - 5;
  if (yo >= t.y0 && yo < t.y_end && t.col_out) {
    const uint32_t votes = g.hv[P2] + g.hv[P1] + g.hv[S];  // 8 fields, each <= 9
    const uint32_t ge5 = (votes + 0x33333333u) & 0x88888888u;
    const bool border = yo == 0 || yo == t.H - 1 || t.cx == 0 || t.cx == t.W - 1;
    const bool strong = ge5 != 0u && !border && __int2float_rn(g.mag[P1]) > t.weak2;
    t.out[(size_t)yo * t.W + t.cx] =
        strong ? (uint8_t)(1u << ((__ffs(ge5) - 1) >> 2)) : (uint8_t)0;
  }
}

// RH rows of a strip, RH + 10 a multiple of RING (the walk's steps)
__global__ void __launch_bounds__(32 * WARPS)
cg_quantize_kernel(const uint8_t* __restrict__ bgr, uint8_t* __restrict__ out, int H,
                   int W, int RH, float weak2) {
  __shared__ uint32_t s_raw[WARPS][RING][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = (blockIdx.x * WARPS + warp) * SW;
  if (x0 >= W) return;  // the whole warp
  Strip t;
  t.img = bgr + (size_t)blockIdx.z * H * W * 3;
  t.out = out + (size_t)blockIdx.z * H * W;
  t.H = H;
  t.W = W;
  t.lane = lane;
  t.y0 = blockIdx.y * RH;
  t.y_end = min(t.y0 + RH, H);
  t.weak2 = weak2;
  // this lane's column (of the blurred, binned and voted planes); the
  // strip's input columns are [cl, cr), edge-clamped taps index into them
  t.cx = x0 - 2 + lane;
  t.cl = max(x0 - 5, 0);
  t.cr = min(x0 + SW + 5, W);
#pragma unroll
  for (int k = 0; k < 7; ++k) t.tap[k] = 3 * (min(max(t.cx + k - 3, 0), W - 1) - t.cl);
  t.col_in = t.cx >= 0 && t.cx < W;
  t.col_inner = t.cx > 0 && t.cx < W - 1;
  t.col_out = lane >= 2 && lane < 2 + SW && t.cx < W;

  Rings g = {};
  g.wnext = load_row(t, t.y0 - 5, g.dnext);
  uint32_t(*bufs)[32] = s_raw[warp];
  for (int yi = t.y0 - 5; yi < t.y0 + RH + 5; yi += RING) {
    walk_step<0>(t, g, bufs[0], yi);
    walk_step<1>(t, g, bufs[1], yi + 1);
    walk_step<2>(t, g, bufs[2], yi + 2);
    walk_step<3>(t, g, bufs[3], yi + 3);
    walk_step<4>(t, g, bufs[4], yi + 4);
    walk_step<5>(t, g, bufs[5], yi + 5);
    walk_step<6>(t, g, bufs[6], yi + 6);
  }
}

}  // namespace

extern "C" int odc_cg_quantize(const void* bgr, void* out, int B, int H, int W,
                               float weak2, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const int strips = odc::ceil_div(W, SW);
  // rows per warp (RH + 10 steps, a multiple of 7): long walks amortise
  // the 10-row warm-up; shorter ones while the grid holds fewer than 16
  // warps per SM
  auto warps = [&](int rh) { return (long long)strips * odc::ceil_div(H, rh) * B; };
  int rh = 60;
  if (warps(rh) < 132 * 16) rh = 25;
  if (warps(rh) < 132 * 16) rh = 11;
  const dim3 grid(odc::ceil_div(strips, WARPS), odc::ceil_div(H, rh), B);
  cg_quantize_kernel<<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bgr, (uint8_t*)out, H, W, rh, weak2);
  return (int)cudaGetLastError();
}
