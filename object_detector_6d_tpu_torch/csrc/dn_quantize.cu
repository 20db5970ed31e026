// K2: depth-normal quantize, [B,H,W] int32 depth -> [B,H,W] u8 one-hot bins.
//
// Replaces object_detector_6d_tpu/ops/quantize_pallas.py
// dn_quantize_batched (_make_dn_kernel): ring least-squares depth gradient
// (8 samples at radius 5, bilateral-gated), normal (1150 ddx, 1150 ddy,
// -det d), normalize, x10+10 truncation, octant rule, validity, then the
// 5x5 numeric median over the one-hot bytes.
//
// Bound on the H100: memory and latency. Per pixel it reads 4 bytes and
// writes 1, with ~60 integer and ~15 float operations; a 480x640 frame is
// 1.2 MB in. The simple design: two passes, each one thread per pixel over
// a shared-memory tile (pass 1 with the ring's 5-pixel depth halo, pass 2
// with the median's 2-pixel halo on the u8 scratch), so every global byte
// is read about once per pass and all stencil taps hit shared memory.
#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int RING = 5;
constexpr int MED = 2;

__global__ void dn_ring_kernel(const int32_t* __restrict__ depth,
                               uint8_t* __restrict__ q, int H, int W,
                               int distance_threshold,
                               int difference_threshold) {
  __shared__ int32_t tile[TY + 2 * RING][TX + 2 * RING];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int32_t* d = depth + (size_t)b * H * W;
  for (int i = threadIdx.y * TX + threadIdx.x;
       i < (TY + 2 * RING) * (TX + 2 * RING); i += TX * TY) {
    const int ty = i / (TX + 2 * RING), tx = i % (TX + 2 * RING);
    const int y = y0 + ty - RING, x = x0 + tx - RING;
    // zero beyond the frame, as the reference's zero padding
    tile[ty][tx] = (y >= 0 && y < H && x >= 0 && x < W) ? d[(size_t)y * W + x] : 0;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + RING, cx = threadIdx.x + RING;
  const int32_t dc = tile[cy][cx];

  int32_t A0 = 0, A1 = 0, A3 = 0, b0 = 0, b1 = 0;
#pragma unroll
  for (int sdy = -RING; sdy <= RING; sdy += RING) {
#pragma unroll
    for (int sdx = -RING; sdx <= RING; sdx += RING) {
      if (sdx == 0 && sdy == 0) continue;
      const int32_t delta = odc::wsub(tile[cy + sdy][cx + sdx], dc);
      const int32_t f = odc::wabs(delta) < difference_threshold ? 1 : 0;
      A0 += f * (sdx * sdx);
      A1 += f * (sdx * sdy);
      A3 += f * (sdy * sdy);
      b0 = odc::wadd(b0, odc::wmul(f * sdx, delta));
      b1 = odc::wadd(b1, odc::wmul(f * sdy, delta));
    }
  }
  const int32_t det = odc::wsub(odc::wmul(A0, A3), odc::wmul(A1, A1));
  const int32_t ddx = odc::wsub(odc::wmul(A3, b0), odc::wmul(A1, b1));
  const int32_t ddy = odc::wadd(odc::wmul(odc::wneg(A1), b0), odc::wmul(A0, b1));

  const float nx = __int2float_rn(odc::wmul(1150, ddx));
  const float ny = __int2float_rn(odc::wmul(1150, ddy));
  const float nz = __int2float_rn(odc::wmul(odc::wneg(det), dc));
  const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)),
                                          __fmul_rn(nz, nz)));
  const float inv = __fdiv_rn(1.0f, norm);
  // truncation toward zero; saturating, so a masked NaN is not UB
  const int vx = __float2int_rz(__fadd_rn(__fmul_rn(__fmul_rn(nx, inv), 10.0f), 10.0f));
  const int vy = __float2int_rz(__fadd_rn(__fmul_rn(__fmul_rn(ny, inv), 10.0f), 10.0f));

  // arithmetic octant rule == the oracle's NORMAL_LUT (ops/lut.py)
  const float fcx = __int2float_rn(vx - 10);
  const float fcy = __int2float_rn(vy - 10);
  const float t = 0.41421356f;
  const float acx = fabsf(fcx), acy = fabsf(fcy);
  const bool horiz = acy <= __fmul_rn(t, acx);
  const bool vert = acx <= __fmul_rn(t, acy);
  const int bin_h = fcx >= 0.0f ? 0 : 4;
  const int bin_v = fcy >= 0.0f ? 2 : 6;
  const int bin_d = fcy >= 0.0f ? (fcx >= 0.0f ? 1 : 3) : (fcx >= 0.0f ? 7 : 5);
  const int bin = horiz ? bin_h : (vert ? bin_v : bin_d);

  // the oracle's interior: asymmetric -1 on the far edges
  const bool interior = y >= RING && y < H - RING - 1 && x >= RING && x < W - RING - 1;
  const bool valid = interior && dc < distance_threshold && norm > 0.0f;
  q[(size_t)b * H * W + (size_t)y * W + x] = valid ? (uint8_t)(1 << bin) : (uint8_t)0;
}

__global__ void dn_median_kernel(const uint8_t* __restrict__ q,
                                 uint8_t* __restrict__ out, int H, int W) {
  __shared__ uint8_t tile[TY + 2 * MED][TX + 2 * MED];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const uint8_t* qb = q + (size_t)b * H * W;
  for (int i = threadIdx.y * TX + threadIdx.x;
       i < (TY + 2 * MED) * (TX + 2 * MED); i += TX * TY) {
    const int ty = i / (TX + 2 * MED), tx = i % (TX + 2 * MED);
    const int y = y0 + ty - MED, x = x0 + tx - MED;
    // q is zero within 5 px of every border, so zero fill equals the
    // reference's edge-replicate padding
    tile[ty][tx] = (y >= 0 && y < H && x >= 0 && x < W) ? qb[(size_t)y * W + x] : 0;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  int counts[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int dy = 0; dy < 2 * MED + 1; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2 * MED + 1; ++dx) {
      const int v = tile[threadIdx.y + dy][threadIdx.x + dx];
#pragma unroll
      for (int k = 0; k < 8; ++k) counts[k] += (v >> k) & 1;
    }
  }
  // median = first code whose running count reaches 13 of 25, starting
  // from the count of code 0 (25 minus the rest)
  int cum = 25;
#pragma unroll
  for (int k = 0; k < 8; ++k) cum -= counts[k];
  int val = 0;
  if (cum < 13) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cum += counts[k];
      if (cum >= 13) {
        val = 1 << k;
        break;
      }
    }
  }
  out[(size_t)b * H * W + (size_t)y * W + x] = (uint8_t)val;
}

}  // namespace

extern "C" int odc_dn_quantize(const void* depth, void* scratch, void* out,
                               int B, int H, int W, int distance_threshold,
                               int difference_threshold, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid(odc::ceil_div(W, TX), odc::ceil_div(H, TY), B);
  cudaStream_t s = (cudaStream_t)stream;
  dn_ring_kernel<<<grid, block, 0, s>>>((const int32_t*)depth, (uint8_t*)scratch,
                                        H, W, distance_threshold, difference_threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dn_median_kernel<<<grid, block, 0, s>>>((const uint8_t*)scratch, (uint8_t*)out, H, W);
  return (int)cudaGetLastError();
}
