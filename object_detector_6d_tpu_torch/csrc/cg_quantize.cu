// K1: color-gradient quantize, [B,H,W,3] u8 BGR -> [B,H,W] u8 one-hot bins.
//
// Replaces object_detector_6d_tpu/ops/quantize_pallas.py
// cg_quantize_batched (_make_cg_kernel): exact integer 7x7 Gaussian, 3x3
// Sobel per channel, the channel of largest squared magnitude (first on
// ties), cv::fastAtan2's float32 polynomial, 16 bins folded to 8, the
// frame border forced to bin 0, a 3x3 vote (>= 5 of 9) and the weak
// magnitude gate. Bit-identical to quant/color_gradient.py.
//
// Bound on the H100: memory and latency. Per pixel it reads 3 bytes and
// writes 1, with ~100 integer and ~15 float operations; a 480x640 frame
// is 0.9 MB in. The simple design: one block per 32x8 output tile, one
// thread per output pixel, every stage over shared memory: the input
// with a 5-pixel halo (Gaussian 3 + Sobel 1 + vote 1, edge-replicated by
// clamping the index), the horizontal then vertical Gaussian pass, then
// Sobel + channel select + angle on the tile and a 1-pixel halo, then the
// vote. Float steps are spelled as __f*_rn intrinsics in the reference's
// order (and the library is built -fmad=false): one fused multiply-add
// or an approximate division would move angles across bin edges.
#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HALO = 5;               // Gaussian 3 + Sobel 1 + vote 1
constexpr int IW = TX + 2 * HALO;     // input tile
constexpr int IH = TY + 2 * HALO;
constexpr int SW = TX + 4;            // blurred tile: halo 2 (Sobel + vote)
constexpr int SH = TY + 4;
constexpr int QW = TX + 2;            // bins tile: halo 1 (vote)
constexpr int QH = TY + 2;
constexpr uint8_t NO_VOTE = 0xFF;     // outside the frame: no vote at all

__constant__ int kGauss[7] = {8, 28, 56, 72, 56, 28, 8};

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

__global__ void cg_quantize_kernel(const uint8_t* __restrict__ bgr,
                                   uint8_t* __restrict__ out, int H, int W,
                                   float weak2) {
  __shared__ uint8_t s_in[IH][IW][3];
  __shared__ int32_t s_h[IH][SW][3];    // horizontal Gaussian pass
  __shared__ uint8_t s_blur[SH][SW][3];
  __shared__ uint8_t s_q[QH][QW];
  __shared__ int32_t s_mag[QH][QW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthr = TX * TY;
  const uint8_t* img = bgr + (size_t)b * H * W * 3;

  // input tile, edge-replicated by clamping (the Gaussian's border rule)
  for (int i = tid; i < IH * IW; i += nthr) {
    const int ty = i / IW, tx = i % IW;
    const int y = min(max(y0 + ty - HALO, 0), H - 1);
    const int x = min(max(x0 + tx - HALO, 0), W - 1);
    const uint8_t* p = img + ((size_t)y * W + x) * 3;
    s_in[ty][tx][0] = p[0];
    s_in[ty][tx][1] = p[1];
    s_in[ty][tx][2] = p[2];
  }
  __syncthreads();
  // horizontal 7-tap pass onto columns x0-2 .. x0+TX+1
  for (int i = tid; i < IH * SW * 3; i += nthr) {
    const int ch = i % 3, j = (i / 3) % SW, r = i / (3 * SW);
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) acc += kGauss[k] * s_in[r][j + k][ch];
    s_h[r][j][ch] = acc;
  }
  __syncthreads();
  // vertical 7-tap pass onto rows y0-2 .. y0+TY+1, one rounding shift
  for (int i = tid; i < SH * SW * 3; i += nthr) {
    const int ch = i % 3, j = (i / 3) % SW, r = i / (3 * SW);
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) acc += kGauss[k] * s_h[r + k][j][ch];
    s_blur[r][j][ch] = (uint8_t)min((acc + (1 << 15)) >> 16, 255);
  }
  __syncthreads();
  // Sobel, channel select and angle bin on the tile + 1-pixel halo. Only
  // interior pixels need the Sobel (the border is bin 0 and never strong),
  // and their 3x3 neighbourhood lies inside the frame.
  for (int i = tid; i < QH * QW; i += nthr) {
    const int r = i / QW, j = i % QW;
    const int y = y0 + r - 1, x = x0 + j - 1;
    uint8_t q = NO_VOTE;
    int32_t smag = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      q = 0;
      if (y > 0 && y < H - 1 && x > 0 && x < W - 1) {
        const int sr = r + 1, sc = j + 1;  // this pixel in s_blur
        int32_t bdx = 0, bdy = 0;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const int32_t gxm = s_blur[sr - 1][sc + 1][ch] - s_blur[sr - 1][sc - 1][ch];
          const int32_t gx0 = s_blur[sr][sc + 1][ch] - s_blur[sr][sc - 1][ch];
          const int32_t gxp = s_blur[sr + 1][sc + 1][ch] - s_blur[sr + 1][sc - 1][ch];
          const int32_t gym = s_blur[sr + 1][sc - 1][ch] - s_blur[sr - 1][sc - 1][ch];
          const int32_t gy0 = s_blur[sr + 1][sc][ch] - s_blur[sr - 1][sc][ch];
          const int32_t gyp = s_blur[sr + 1][sc + 1][ch] - s_blur[sr - 1][sc + 1][ch];
          const int32_t dx = gxm + 2 * gx0 + gxp;
          const int32_t dy = gym + 2 * gy0 + gyp;
          const int32_t m = dx * dx + dy * dy;  // exact, < 2^24
          if (ch == 0 || m > smag) {  // strict: the first channel wins ties
            smag = m;
            bdx = dx;
            bdy = dy;
          }
        }
        const float ang = fast_atan2_deg(__int2float_rn(bdy), __int2float_rn(bdx));
        const int q16 = min(max(__float2int_rn(__fmul_rn(ang, BIN_SCALE)), 0), 255);
        q = (uint8_t)(q16 & 7);
      }
    }
    s_q[r][j] = q;
    s_mag[r][j] = smag;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  int votes[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const uint8_t q = s_q[threadIdx.y + dy][threadIdx.x + dx];
#pragma unroll
      for (int k = 0; k < 8; ++k) votes[k] += (q == k);
    }
  }
  int best = 0, best_votes = votes[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    if (votes[k] > best_votes) {  // strict: the first maximum wins
      best = k;
      best_votes = votes[k];
    }
  }
  const bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
  const float smag = __int2float_rn(s_mag[threadIdx.y + 1][threadIdx.x + 1]);
  const bool strong = !border && best_votes >= 5 && smag > weak2;
  out[(size_t)b * H * W + (size_t)y * W + x] = strong ? (uint8_t)(1 << best) : (uint8_t)0;
}

}  // namespace

extern "C" int odc_cg_quantize(const void* bgr, void* out, int B, int H, int W,
                               float weak2, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 block(TX, TY);
  const dim3 grid(odc::ceil_div(W, TX), odc::ceil_div(H, TY), B);
  cg_quantize_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bgr, (uint8_t*)out, H, W, weak2);
  return (int)cudaGetLastError();
}
